"""The port's native NIfTI loader (``mslesions3d_tpu_torch/native``) on the CPU.

The eight cases of the JAX package's ``tests/test_native.py`` (decode,
nonzero normalisation, int16 uncompressed, a rewritten file not served
stale, a missing file, a truncated gzip, 4-D decode, 4-D per-channel
normalisation), each held against the port's Python loader
(``data.nifti.load_nifti`` + ``data.transforms.t_normalize_intensity``, the
loader's plain version) at the JAX test's tolerances, and against the JAX
package's native loader on the same file: the same C++ source built with
the same flags, so bit for bit. Then the build (into ``build/native/``,
never into the package; a failed build raises with the compiler's output)
and ``SyntheticDataModule``'s samples against the JAX package's.
"""

import gzip
import os
import time

import numpy as np
import pytest

from mslesions3d_tpu.data import datasets as jax_datasets
from mslesions3d_tpu.native import load_nifti_fast as jax_load_nifti_fast
from mslesions3d_tpu_torch.native import native
from mslesions3d_tpu_torch.data import datasets
from mslesions3d_tpu_torch.data.generate import generate_dataset
from mslesions3d_tpu_torch.data.nifti import load_nifti, save_nifti
from mslesions3d_tpu_torch.data.transforms import t_normalize_intensity
from mslesions3d_tpu_torch.kernels.build import build_library
from mslesions3d_tpu_torch.native import load_nifti_fast


def _against_jax(path, normalize: bool = False):
    """The port's load of ``path``, bit-equal to the JAX package's native load."""
    ours, pixdim = load_nifti_fast(path, normalize=normalize)
    theirs, jax_pixdim = jax_load_nifti_fast(path, normalize=normalize)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    assert pixdim == jax_pixdim
    return ours, pixdim


def case_decode(tmp_path):
    data = np.random.default_rng(0).normal(size=(20, 24, 28)).astype(np.float32)
    path = tmp_path / "a.nii.gz"
    save_nifti(path, data, np.diag([1.0, 2.0, 1.5, 1.0]))
    fast, pixdim = _against_jax(path)
    ref = load_nifti(path)
    np.testing.assert_allclose(fast, ref.data, rtol=1e-6)
    np.testing.assert_allclose(pixdim, ref.pixdim, rtol=1e-5)


def case_normalize(tmp_path):
    data = np.random.default_rng(1).normal(size=(16, 16, 16)).astype(np.float32)
    data[data < 0] = 0  # a mix of zero and nonzero
    path = tmp_path / "b.nii.gz"
    save_nifti(path, data)
    fast, _ = _against_jax(path, normalize=True)
    expected = t_normalize_intensity({"img": load_nifti(path).data}, nonzero=True)["img"]
    np.testing.assert_allclose(fast, expected, rtol=1e-4, atol=1e-4)


def case_int16_uncompressed(tmp_path):
    data = (np.arange(4 * 5 * 6).reshape(4, 5, 6) % 13).astype(np.int16)
    path = tmp_path / "c.nii"
    save_nifti(path, data)
    fast, _ = _against_jax(path)
    np.testing.assert_array_equal(fast, data.astype(np.float32))
    np.testing.assert_array_equal(fast, load_nifti(path).data.astype(np.float32))


def case_rewritten_not_stale(tmp_path):
    path = tmp_path / "d.nii.gz"
    save_nifti(path, np.ones((8, 8, 8), np.float32))
    first, _ = load_nifti_fast(path)
    time.sleep(0.01)
    save_nifti(path, np.full((8, 8, 8), 2.0, np.float32))
    os.utime(path, (time.time() + 5, time.time() + 5))
    second, _ = _against_jax(path)
    assert second.max() == 2.0 and first.max() == 1.0
    np.testing.assert_array_equal(second, load_nifti(path).data)


def case_missing_file(tmp_path):
    with pytest.raises(RuntimeError, match="msl_nifti_shape4 failed with code 1"):
        load_nifti_fast(tmp_path / "nope.nii.gz")
    with pytest.raises(RuntimeError):
        jax_load_nifti_fast(tmp_path / "nope.nii.gz")


def case_truncated_gzip(tmp_path):
    """A truncated .nii.gz raises cleanly (the header declares 12*13*14
    voxels, the stream holds 100 bytes of them), as in the JAX package."""
    path = tmp_path / "x.nii.gz"
    save_nifti(path, np.ones((12, 13, 14), np.float32))
    plain = gzip.decompress(path.read_bytes())
    trunc = tmp_path / "trunc.nii.gz"
    trunc.write_bytes(gzip.compress(plain[: 348 + 100]))
    for load in (load_nifti_fast, jax_load_nifti_fast):
        with pytest.raises(RuntimeError, match="msl_nifti_load failed with code 7"):
            load(trunc, normalize=True)


def case_4d_decode(tmp_path):
    data = np.random.default_rng(2).normal(size=(10, 12, 14, 3)).astype(np.float32)
    path = tmp_path / "mc.nii.gz"
    save_nifti(path, data)
    fast, _ = _against_jax(path)
    assert fast.shape == (10, 12, 14, 3)
    ref = load_nifti(path)
    assert ref.data.shape == (10, 12, 14, 3)
    np.testing.assert_allclose(fast, ref.data, rtol=1e-6)


def case_4d_normalize_per_channel(tmp_path):
    rng = np.random.default_rng(3)
    data = rng.uniform(0.5, 3.0, size=(8, 9, 10, 2)).astype(np.float32)
    data[..., 1] *= 50.0  # a very different scale a channel
    data[data < 1.0] = 0  # zeros for the nonzero mask
    path = tmp_path / "mcn.nii.gz"
    save_nifti(path, data)
    fast, _ = _against_jax(path, normalize=True)
    expected = t_normalize_intensity({"img": load_nifti(path).data}, nonzero=True)["img"]
    np.testing.assert_allclose(fast, expected, rtol=1e-4, atol=1e-4)
    for c in range(2):  # each channel's nonzero voxels ~ N(0, 1)
        vals = fast[..., c][fast[..., c] != 0]
        assert abs(vals.mean()) < 1e-3 and abs(vals.std() - 1.0) < 1e-3


CASES = [case_decode, case_normalize, case_int16_uncompressed, case_rewritten_not_stale,
         case_missing_file, case_truncated_gzip, case_4d_decode, case_4d_normalize_per_channel]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.removeprefix("case_") for c in CASES])
def test_native_loader(case, tmp_path):
    case(tmp_path)


def test_builds_into_build_native():
    lib, _ = native.build()
    assert native.available()
    assert lib.parent == native.BUILD_DIR and lib.parent.parts[-2:] == ("build", "native")
    assert lib.name.startswith("libnifti_loader-") and lib.is_file()
    package = native.SOURCE.parent
    assert not any(p.suffix == ".so" for p in package.iterdir())


def test_failed_build_raises_with_compiler_output(tmp_path):
    broken = tmp_path / "broken.cc"
    broken.write_text("int msl_nifti_load( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on .*broken.cc:\n.*error"):
        build_library(broken, "g++", native.GXX_FLAGS, tmp_path / "out", native.LIBS)
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.mark.parametrize("device_boxes", [False, True])
def test_synthetic_samples_equal_jax(tmp_path, device_boxes):
    """``SyntheticDataModule`` reads through the native loader: its samples
    (image, segmentation, boxes, labels, the identity affine) equal the JAX
    package's, which take the same loader."""
    generate_dataset(tmp_path, num_images=3, n_classes=2, image_size=(16, 18, 20),
                     object_size=(3, 6), num_objects=(1, 3), seed=5, num_processes=1)
    kw = dict(n_classes=2, max_objects=6, device_boxes=device_boxes)
    if device_boxes:
        kw["device"] = "cpu"
    ours = datasets.SyntheticDataModule(tmp_path, **kw)
    theirs = jax_datasets.SyntheticDataModule(tmp_path, n_classes=2, max_objects=6,
                                              device_boxes=device_boxes)
    for subject in ours.subjects_list:
        a, b = ours.get_sample(subject), theirs.get_sample(subject)
        for key in ("img", "seg", "affine"):
            assert a[key].dtype == np.asarray(b[key]).dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        np.testing.assert_array_equal(a["affine"], np.eye(4))
        np.testing.assert_allclose(np.asarray(a["boxes"], np.float32),
                                   np.asarray(b["boxes"], np.float32), rtol=0, atol=0)
        np.testing.assert_array_equal(a["labels"], b["labels"])
