"""The port's host data pipeline against the JAX package's, on the same files.

* NIfTI written by either package reads back in the other with equal
  arrays, affine and pixdim.
* ``generate_dataset`` at 16^3, 6 images (one class, two classes with and
  without the legacy shell bug, three contrasts), seeds 0 and 1: the same
  volumes and masks, exactly.
* ``boxes_from_segmentation`` in each mode and ``segmentation_from_boxes``:
  equal. Each ``t_*`` and ``inverse_map_boxes``: within 1e-6.
* The numpy split and k-fold equal sklearn's ``train_test_split`` and
  ``KFold(4, shuffle=True)`` for n in 2..60 (sklearn is imported by the test
  only; the port does not need it).
* ``SyntheticDataModule.materialize``: boxes, labels and masks exact; images
  within rtol = atol = 1e-4, the bound ``tests/test_native.py`` sets between
  the JAX package's native and Python loaders (the JAX module reads through
  its native loader where that builds, the port through the Python one).
  The order of ``train_batches`` is the same.
* ``LesionsDataModule`` on the fake BIDS tree of
  ``tests/test_lesions_datamodule.py``, a fold included: equal batches.
* ``prefetch_batches`` keeps order and re-raises the producer's error.
"""

import numpy as np
import pytest
import torch
from test_lesions_datamodule import make_bids_tree

from mslesions3d_tpu.data import boxes_from_seg as jax_boxes
from mslesions3d_tpu.data import datasets as jax_datasets
from mslesions3d_tpu.data import generate as jax_generate
from mslesions3d_tpu.data import nifti as jax_nifti
from mslesions3d_tpu.data import transforms as jax_transforms
from mslesions3d_tpu_torch.data import boxes_from_seg, datasets, generate, nifti, transforms
from mslesions3d_tpu_torch.data.prefetch import prefetch_batches

SEEDS = (970205, 0, 1, 12345)


# ---------------------------------------------------------------- NIfTI
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_nifti_written_by_either_reads_in_the_other(tmp_path, writer):
    save, load = ((jax_nifti.save_nifti, nifti.load_nifti) if writer == "jax"
                  else (nifti.save_nifti, jax_nifti.load_nifti))
    rng = np.random.default_rng(0)
    affine = np.array([[0, 0, -2.0, 10], [0, -1.0, 0, 5], [1.5, 0, 0, -3], [0, 0, 0, 1]])
    cases = {"a.nii.gz": rng.normal(size=(7, 9, 11)).astype(np.float32),
             "b.nii": (np.arange(4 * 5 * 6).reshape(4, 5, 6) % 13).astype(np.int16),
             "c.nii.gz": rng.uniform(size=(5, 6, 7, 3)).astype(np.float32)}
    for name, data in cases.items():
        save(tmp_path / name, data, affine)
        ours = load(tmp_path / name)
        ref = (jax_nifti if writer == "jax" else nifti).load_nifti(tmp_path / name)
        assert ours.data.dtype == data.dtype
        np.testing.assert_array_equal(ours.data, data)
        np.testing.assert_array_equal(ours.data, ref.data)
        np.testing.assert_array_equal(ours.affine, ref.affine)
        assert ours.pixdim == ref.pixdim == pytest.approx((1.5, 1.0, 2.0))


# ---------------------------------------------------------------- generator
GEN_CASES = {
    "one_class": dict(n_classes=1),
    "two_classes": dict(n_classes=2),
    "two_classes_legacy_shell": dict(n_classes=2, legacy_shell_bug=True),
    "three_contrasts": dict(n_classes=2, n_contrasts=3),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_dataset_writes_the_jax_volumes(tmp_path, case, seed):
    kw = dict(num_images=6, image_size=(16, 16, 16), object_size=(4, 8), num_objects=(1, 4),
              object_width=1, seed=seed, **GEN_CASES[case])
    roots = [mod.generate_dataset(tmp_path / name, **kw)
             for name, mod in (("jax", jax_generate), ("port", generate))]
    files = sorted(p.relative_to(roots[0]) for p in roots[0].rglob("*.nii.gz"))
    assert len(files) == 12
    assert files == sorted(p.relative_to(roots[1]) for p in roots[1].rglob("*.nii.gz"))
    for rel in files:
        a, b = (nifti.load_nifti(root / rel) for root in roots)
        np.testing.assert_array_equal(a.data, b.data, err_msg=str(rel))
    seg = nifti.load_nifti(roots[1] / "labels" / "sub-0000_seg.nii.gz").data
    img = nifti.load_nifti(roots[1] / "images" / "sub-0000_image.nii.gz").data
    assert seg.any()
    assert img.shape == ((16, 16, 16, 3) if "contrasts" in case else (16, 16, 16))


def test_generate_cli_writes_the_jax_volumes(tmp_path):
    args = ["--num_images", "3", "--image_size", "12", "12", "12", "--object_size", "3", "6",
            "--num_processes", "1", "--random_seed", "5"]
    jax_generate.main([*args, "--output_dir", str(tmp_path / "jax")])
    generate.main([*args, "--output_dir", str(tmp_path / "port")])
    for path in sorted((tmp_path / "jax").rglob("*.nii.gz")):
        theirs = nifti.load_nifti(path).data
        ours = nifti.load_nifti(tmp_path / "port" / path.relative_to(tmp_path / "jax")).data
        np.testing.assert_array_equal(ours, theirs)


# ---------------------------------------------------------------- boxes
def _two_class_seg():
    rng = np.random.RandomState(3)
    seg = np.zeros((20, 18, 16), np.float32)
    for c, (lo, size) in enumerate([((2, 2, 2), 4), ((9, 3, 8), 5), ((3, 11, 2), 3),
                                    ((12, 10, 9), 6), ((15, 2, 1), 1)]):
        seg[tuple(slice(a, a + size) for a in lo)] = 1 + c % 2
    seg[rng.uniform(size=seg.shape) > 0.995] = 2  # specks: one-voxel boxes, dropped
    return seg


@pytest.mark.parametrize("mode", ["instances", "binary", "classes"])
def test_boxes_from_segmentation_equals_jax(mode):
    seg = _two_class_seg()
    if mode == "instances":  # instance ids grouped into classes by ranges
        seg = np.round(seg * 3 + (seg > 0) * np.arange(seg.shape[0])[:, None, None] % 4)
    kw = dict(thresholds=[(1, 6), (6, np.inf)] if mode == "instances" else None,
              n_classes=2)
    ours = boxes_from_seg.boxes_from_segmentation(seg, mode, **kw)
    ref = jax_boxes.boxes_from_segmentation(seg, mode, **kw)
    assert ours[0].shape[0] > 2
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_segmentation_from_boxes_equals_jax():
    boxes, labels = jax_boxes.boxes_from_segmentation(_two_class_seg(), "classes", n_classes=2)
    labels = np.concatenate([labels, [0]])  # the background label is skipped
    boxes = np.concatenate([boxes, [[0.1, 0.1, 0.1, 0.5, 0.5, 0.5]]]).astype(np.float32)
    ours = boxes_from_seg.segmentation_from_boxes(boxes, labels, (20, 18, 16))
    for a, b in zip(ours, jax_boxes.segmentation_from_boxes(boxes, labels, (20, 18, 16))):
        np.testing.assert_array_equal(a, b)
    assert ours[0].max() == len(boxes) - 1


# ---------------------------------------------------------------- transforms
def _sample(channels=False):
    rng = np.random.default_rng(4)
    shape = (20, 24, 18)
    img = np.zeros(shape + ((2,) if channels else ()), np.float32)
    img[3:17, 5:20, 2:15] = rng.uniform(0.5, 1.5, img[3:17, 5:20, 2:15].shape)
    seg = np.zeros(shape, np.float32)
    seg[6:10, 8:13, 5:9] = 1
    seg[12:15, 14:18, 10:13] = 1
    affine = np.array([[0, 0, -1.0, 0], [0, -1.0, 0, 0], [2.0, 0, 0, 0], [0, 0, 0, 1]])
    return {"img": img, "seg": seg, "affine": affine, "pixdim": (2.0, 1.0, 1.0),
            "subject": "s1"}


def _copy(sample):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in sample.items()}


TRANSFORMS = {
    "orientation": (lambda m: m.t_orientation, dict(axcodes="LPI")),
    "spacing": (lambda m: m.t_spacing, dict(pixdim=(1.0, 1.5, 1.0))),
    "crop_foreground": (lambda m: m.t_crop_foreground, dict(margin=2)),
    "normalize_intensity": (lambda m: m.t_normalize_intensity, dict(nonzero=True)),
    "normalize_intensity_all": (lambda m: m.t_normalize_intensity, dict(nonzero=False)),
    "resize_pad": (lambda m: m.t_resize_with_pad_or_crop, dict(spatial_size=(24, 28, 22))),
    "resize_crop": (lambda m: m.t_resize_with_pad_or_crop,
                    dict(spatial_size=(16, 20, 14), mode="constant")),
    "bounding_boxes": (lambda m: m.t_bounding_boxes_generator,
                       dict(segmentation_mode="binary")),
    "scale_intensity": (lambda m: m.t_scale_intensity, dict(minv=-1.0, maxv=2.0)),
}


def _assert_samples_close(ours, ref):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
            np.testing.assert_allclose(ours[k], v, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            assert ours[k] == v, k


@pytest.mark.parametrize("name, channels", [
    (name, channels) for name in TRANSFORMS for channels in (False, True)
    if not (name == "bounding_boxes" and channels)  # boxes come from the 3-D seg alone
])
def test_transform_equals_jax(name, channels):
    fn, kw = TRANSFORMS[name]
    sample = _sample(channels)
    ours = fn(transforms)(_copy(sample), **kw)
    ref = fn(jax_transforms)(_copy(sample), **kw)
    _assert_samples_close(ours, ref)


def test_pipeline_and_inverse_map_boxes_equal_jax():
    """The LesionsDataModule pipeline by registry name and ``compose``, then
    the boxes mapped back to the on-disk grid."""
    steps = [("orientation", dict(axcodes="LPI")), ("spacing", dict(pixdim=(1.0, 1.0, 1.0))),
             ("crop_foreground", dict(margin=3)), ("normalizeintensity", dict(nonzero=True)),
             ("resize_with_pad_or_crop", dict(spatial_size=(32, 26, 20))),
             ("bounding_boxes_generator", dict(segmentation_mode="binary"))]
    outs = []
    for mod in (transforms, jax_transforms):
        run = mod.compose([mod.get_transform_from_name(n, **kw) for n, kw in steps])
        out = run(_copy(_sample()))
        boxes = mod.inverse_map_boxes(out["boxes"], out["img"].shape[:3], out["transform_meta"],
                                      pixdim_zoom=(0.5, 1.0, 1.0))
        outs.append((out, boxes))
    _assert_samples_close(outs[0][0], outs[1][0])
    assert outs[0][1].shape == (2, 6)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-6, atol=1e-6)


def test_printer_and_show_image_equal_jax(tmp_path, capsys):
    sample = _sample()
    for mod in (transforms, jax_transforms):
        assert mod.t_printer(_copy(sample), prefix="x") is not None
    ours, ref = capsys.readouterr().out.splitlines()
    assert ours == ref and "img: float32[20, 24, 18]" in ours
    for name, mod in (("port", transforms), ("jax", jax_transforms)):
        mod.t_show_image(_copy(sample), out_dir=tmp_path / name, axis=1)
    written = [sorted(p.name for p in (tmp_path / name).iterdir()) for name in ("port", "jax")]
    assert written[0] == written[1] and len(written[0]) == 2


# ---------------------------------------------------------------- splits
@pytest.mark.parametrize("seed", SEEDS)
def test_train_test_split_equals_sklearn(seed):
    from sklearn.model_selection import train_test_split

    for n in range(2, 61):
        items = [f"s{i}" for i in range(n)]
        ref = train_test_split(items, train_size=0.8, test_size=0.2, random_state=seed)
        assert list(datasets.train_test_split(items, seed)) == [list(r) for r in ref], n


@pytest.mark.parametrize("seed", SEEDS)
def test_kfold_equals_sklearn(seed):
    from sklearn.model_selection import KFold

    for n in range(4, 61):
        ref = list(KFold(n_splits=4, shuffle=True, random_state=seed).split(np.arange(n)))
        ours = datasets.kfold_split(n, 4, seed)
        assert len(ours) == len(ref) == 4
        for (a_train, a_test), (b_train, b_test) in zip(ours, ref):
            np.testing.assert_array_equal(a_train, b_train)
            np.testing.assert_array_equal(a_test, b_test)
    with pytest.raises(ValueError):
        datasets.kfold_split(3, 4, seed)


# ---------------------------------------------------------------- datamodules
@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    jax_generate.generate_dataset(root, num_images=13, n_classes=2, image_size=(16, 16, 16),
                                  object_size=(4, 8), num_objects=(1, 4), object_width=1,
                                  seed=0)
    return root


def _modules(root, **kw):
    mods = (jax_datasets.SyntheticDataModule(root, n_classes=2, batch_size=4, max_objects=6, **kw),
            datasets.SyntheticDataModule(root, n_classes=2, batch_size=4, max_objects=6, **kw))
    for m in mods:
        m.setup("fit")
    return mods


def _assert_batches_equal(ours, ref, image_tol):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if k == "image":
            np.testing.assert_allclose(ours[k], v, rtol=image_tol, atol=image_tol)
        elif isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype, k
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k


def test_synthetic_materialize_equals_jax(synthetic_root):
    jm, pm = _modules(synthetic_root)
    assert pm.subjects_list == jm.subjects_list and len(pm.subjects_list) == 13
    assert (pm.trainsubs, pm.testsubs) == (list(jm.trainsubs), list(jm.testsubs))
    for subs in (pm.trainsubs, pm.testsubs):
        _assert_batches_equal(pm.materialize(subs), jm.materialize(subs), 1e-4)
    assert pm.materialize(pm.trainsubs)["box_mask"].sum() > 10


def test_synthetic_batches_equal_jax(synthetic_root):
    jm, pm = _modules(synthetic_root, random_state=7)
    assert pm.steps_per_epoch() == jm.steps_per_epoch() == 2
    for epoch in (0, 1):
        ours, ref = list(pm.train_batches(epoch=epoch)), list(jm.train_batches(epoch=epoch))
        assert [b["subjects"] for b in ours] == [b["subjects"] for b in ref]
        for a, b in zip(ours, ref):
            _assert_batches_equal(a, b, 1e-4)
    ours, ref = list(pm.val_batches()), list(jm.val_batches())
    assert [b["subjects"] for b in ours] == [b["subjects"] for b in ref]
    assert ours[-1]["batch_mask"].tolist() == ref[-1]["batch_mask"].tolist() == [
        True, True, True, False]  # 3 validation volumes padded to the batch of 4
    for a, b in zip(ours, ref):
        _assert_batches_equal(a, b, 1e-4)


def test_synthetic_device_boxes_is_not_ported(synthetic_root):
    """device_boxes=True now works: connected components on the device (here
    the CPU) give every sample the host path's boxes and labels, as sets,
    for both classes (tests/test_torch_port_connected_components.py holds
    the labelling against the JAX package's)."""
    host = datasets.SyntheticDataModule(synthetic_root, n_classes=2, max_objects=6)
    dev = datasets.SyntheticDataModule(synthetic_root, n_classes=2, max_objects=6,
                                       device_boxes=True, device="cpu")
    for s in host.subjects_list:
        h, d = host.get_sample(s), dev.get_sample(s)
        order_h, order_d = np.lexsort(h["boxes"].T), np.lexsort(d["boxes"].T)
        np.testing.assert_array_equal(d["labels"][order_d], h["labels"][order_h])
        np.testing.assert_allclose(d["boxes"][order_d], h["boxes"][order_h], rtol=0, atol=1e-6)
    assert sum(len(host.get_sample(s)["labels"]) for s in host.subjects_list) > 13


@pytest.mark.parametrize("fold", [None, 1])
def test_lesions_datamodule_equals_jax(tmp_path, fold):
    root = make_bids_tree(tmp_path, subjects=tuple(f"{i:03d}" for i in range(1, 9)))
    kw = dict(data_dir=root, centers=("CHUV_RIM_OK",), batch_size=2, fold=fold,
              spatial_size=(40, 44, 44), max_objects=4, cache=True)
    jm, pm = jax_datasets.LesionsDataModule(**kw), datasets.LesionsDataModule(**kw)
    for m in (jm, pm):
        m.setup("fit")
    assert pm.subjects_list == jm.subjects_list
    assert (pm.trainsubs, pm.testsubs) == (list(jm.trainsubs), list(jm.testsubs))
    assert len(pm.trainsubs) == (6 if fold is None else 4)
    for ours, ref in ((pm.train_batches(epoch=1), jm.train_batches(epoch=1)),
                      (pm.val_batches(), jm.val_batches())):
        ours, ref = list(ours), list(ref)
        assert len(ours) == len(ref) > 0
        for a, b in zip(ours, ref):
            _assert_batches_equal(a, b, 0.0)  # the same Python loader and transforms


# ---------------------------------------------------------------- prefetch
def test_prefetch_keeps_order_and_moves_arrays():
    batches = [{"image": np.full((2, 3), i, np.float32), "subjects": [f"s{i}", None]}
               for i in range(7)]
    out = list(prefetch_batches(iter(batches), prefetch=2, device="cpu"))
    assert [int(b["image"][0, 0]) for b in out] == list(range(7))
    assert all(isinstance(b["image"], torch.Tensor) for b in out)
    assert out[3]["subjects"] == ["s3", None]


def test_prefetch_defaults_to_the_card():
    """The JAX package's prefetch puts batches on the default (accelerator)
    device; the port's defaults to the card and raises without one."""
    import inspect

    assert inspect.signature(prefetch_batches).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test checks the behaviour without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(prefetch_batches(iter([{"image": np.zeros(2)}])))


def test_prefetch_reraises_the_producers_error():
    def produce():
        yield {"image": np.zeros(2)}
        raise OSError("disk went away")

    it = prefetch_batches(produce(), device="cpu")
    assert next(it)["image"].shape == (2,)
    with pytest.raises(OSError, match="disk went away"):
        next(it)


@pytest.mark.parametrize("kind", ["synthetic", "lesions"])
def test_stats_foreground_equals_jax(synthetic_root, tmp_path, kind):
    """The dataset survey: each subject's segmentation shape and voxel
    spacing, (1.0, 1.0, 1.0) where no pixdim is recorded (the synthetic
    volumes), the BIDS files' own where it is."""
    if kind == "synthetic":
        jm, pm = _modules(synthetic_root)
    else:
        root = make_bids_tree(tmp_path, subjects=("001", "002", "003"))
        kw = dict(data_dir=root, centers=("CHUV_RIM_OK",), batch_size=2,
                  spatial_size=(40, 44, 44), max_objects=4)
        jm, pm = jax_datasets.LesionsDataModule(**kw), datasets.LesionsDataModule(**kw)
    ours, ref = datasets.stats_foreground(pm), jax_datasets.stats_foreground(jm)
    assert ours == ref and len(ours[0]) == len(pm.subjects_list) > 0
    subset = pm.subjects_list[:2]
    assert datasets.stats_foreground(pm, subset) == jax_datasets.stats_foreground(jm, subset)
    if kind == "synthetic":
        assert ours[0] == [(16, 16, 16)] * 13 and ours[1] == [(1.0, 1.0, 1.0)] * 13
