"""The port's sliding-window detector against the JAX package's.

- ``patch_offsets`` equals JAX's on the JAX tests' shapes, and both refuse
  a volume smaller than the patch.
- ``make_sliding_window_detector`` on a non-cubic 24x28x20 volume with 16^3
  patches (width 0.25, BN randomised, weights carried by
  ``from_jax_variables``), at ``volume_batch`` 1 and 2 and with
  ``per_patch_k`` set: counts equal, labels, boxes and scores within 1e-5.
  The classification heads are scaled x10 so that scores spread (random
  weights crowd them); detections whose scores lie within 1e-6 of each
  other are matched as a set, as the predict tests match near ties. No cut
  falls on a near tie: the stitch keeps fewer than top_k, a patch has 12-13
  candidates over min_score (under the default cap of 50), and at the cap
  of 4 its 4th and 5th scores lie more than 2.9e-5 apart.
- ``volume_batch=2`` equals two single calls exactly; the stitch suppresses some
  candidates on these volumes (overlapping patches see the same boxes), so
  its NMS is exercised; the build-time announcement names the cap.
- ``mesh=("cpu", "cpu")`` (patches in two shards) equals the unsharded
  detector exactly and matches JAX's ``mesh=make_mesh(8)``; a
  ``patch_batch`` that does not divide over the mesh raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_forward import randomized_variables

from mslesions3d_tpu import sliding_window as jax_sw
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.parallel import make_mesh as jax_make_mesh
from mslesions3d_tpu.utils.cache import quarantine_from_persistent_cache
from mslesions3d_tpu_torch import sliding_window as sw
from mslesions3d_tpu_torch.kernels import nms as nms_kernels
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig
from mslesions3d_tpu_torch.ops import nms as nms_ops
from mslesions3d_tpu_torch.train import create_train_state
from mslesions3d_tpu_torch.weights import from_jax_variables

VOL = (24, 28, 20)
KW = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25,
          min_score=0.5, top_k=100)
TOL = 1e-5
TIE = 1e-6


@pytest.mark.parametrize("shape,patch,overlap", [
    ((32, 32, 32), (16, 16, 16), 0.25), ((24, 28, 20), (16, 16, 16), 0.25),
    ((40, 40, 40), (16, 16, 16), 0.5), ((16, 16, 16), (16, 16, 16), 0.25),
    ((50, 17, 33), (16, 16, 16), 0.0),
])
def test_patch_offsets_equal_jax(shape, patch, overlap):
    ours = sw.patch_offsets(shape, patch, overlap)
    np.testing.assert_array_equal(ours, jax_sw.patch_offsets(shape, patch, overlap))
    assert ours.dtype == np.int32
    assert (ours + np.asarray(patch) <= np.asarray(shape)).all()


def test_patch_offsets_refuse_a_small_volume():
    with pytest.raises(ValueError, match="smaller than patch"):
        sw.patch_offsets((8, 16, 16), (16, 16, 16))


@pytest.fixture(scope="module")
def setup():
    _, params, stats = randomized_variables(KW, seed=3)
    for name, head in params["heads"].items():
        if name.startswith("cls_"):
            head["kernel"] = head["kernel"] * np.float32(10.0)
    cfg = SSD3DConfig.create(**KW)
    state = create_train_state(cfg, device="cpu",
                               state_dict=from_jax_variables(params, stats, cfg))
    rng = np.random.default_rng(0)
    volumes = rng.normal(0, 1, (2, *VOL, 1)).astype(np.float32)
    return {"variables": {"params": params, "batch_stats": stats},
            "jcfg": JaxConfig.create(**KW), "cfg": cfg, "state": state, "volumes": volumes}


def _assert_detections_match(ours, ref):
    """Per volume: equal counts; within runs of scores <= TIE apart the
    detections match as a set (label, box and score within TOL)."""
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ours = {k: v.numpy() for k, v in ours.items()}
    np.testing.assert_array_equal(ours["count"], ref["count"])
    for v in range(ref["count"].shape[0]):
        n = int(ref["count"][v])
        assert n > 0
        scores = ref["scores"][v, :n]
        start = 0
        for i in range(1, n + 1):
            if i < n and scores[i - 1] - scores[i] <= TIE:
                continue
            left = list(range(start, i))
            for j in range(start, i):
                match = [m for m in left
                         if ours["labels"][v, m] == ref["labels"][v, j]
                         and abs(ours["scores"][v, m] - ref["scores"][v, j]) <= TOL
                         and np.abs(ours["boxes"][v, m] - ref["boxes"][v, j]).max() <= TOL]
                assert match, (v, j)
                left.remove(match[0])
            start = i
        # the padding past the count is zero on both sides
        assert not ours["scores"][v, n:].any() and not ours["boxes"][v, n:].any()


@pytest.mark.parametrize("volume_batch,per_patch_k", [(1, None), (2, None), (1, 4), (2, 4)])
def test_detector_matches_jax(setup, volume_batch, per_patch_k, capsys):
    vol = setup["volumes"] if volume_batch == 2 else setup["volumes"][0]
    ref = jax_sw.make_sliding_window_detector(
        setup["jcfg"], VOL, volume_batch=volume_batch, per_patch_k=per_patch_k)(
        setup["variables"], jnp.asarray(vol))
    run = sw.make_sliding_window_detector(setup["cfg"], VOL, volume_batch=volume_batch,
                                          per_patch_k=per_patch_k)
    cap = per_patch_k or max(KW["top_k"] // 2, 16)
    assert f"keeping <= {cap} detections/patch" in capsys.readouterr().out
    assert run.n_patches == 8 and run.volume_batch == volume_batch
    assert run.patch_batch == (8 if volume_batch == 1 else 16)
    ours = run(setup["state"], vol)
    # (V, min(top_k, candidates), 6): 8 patches x 4 candidates cap it at 32
    assert ours["boxes"].shape == (volume_batch, 32 if per_patch_k else KW["top_k"], 6)
    assert ours["boxes"].shape == ref["boxes"].shape
    _assert_detections_match(ours, ref)


def test_volume_batch_equals_single_calls(setup):
    single = sw.make_sliding_window_detector(setup["cfg"], VOL)
    pair = sw.make_sliding_window_detector(setup["cfg"], VOL, volume_batch=2)(
        setup["state"], torch.from_numpy(setup["volumes"]))
    for v in range(2):
        one = single(setup["state"], setup["volumes"][v])
        for key in pair:
            assert torch.equal(pair[key][v], one[key][0]), key
    with pytest.raises(ValueError, match="do not match"):
        single(setup["state"], setup["volumes"])


def test_stitch_suppresses_duplicates(setup, monkeypatch):
    """The stitch's NMS sees valid candidates and removes some: overlapping
    patches report the same lesion."""
    seen = []

    def spy(boxes, valid, max_overlap, plan=None):
        keep = nms_kernels.greedy_nms(boxes, valid, max_overlap)
        seen.append((int(valid.sum()), int(keep.sum())))
        return keep

    monkeypatch.setattr(sw, "greedy_nms_cuda", spy)
    sw.make_sliding_window_detector(setup["cfg"], VOL)(setup["state"], setup["volumes"][0])
    (n_valid, n_kept), = seen
    assert n_valid > n_kept > 0


@pytest.mark.parametrize("volume_batch", [1, 2])
def test_mesh_equals_unsharded_and_jax(setup, volume_batch, monkeypatch):
    """``mesh=("cpu", "cpu")``: each chunk in two shards of patches, each with
    its own per-patch NMS (2 calls a chunk), and the stitch in two shards
    when its rows divide (V = 2); the detections equal the unsharded
    detector's exactly, and JAX's ``mesh=make_mesh(8)`` run as
    ``test_detector_matches_jax`` matches."""
    vol = setup["volumes"] if volume_batch == 2 else setup["volumes"][0]
    plain = sw.make_sliding_window_detector(setup["cfg"], VOL, volume_batch=volume_batch)(
        setup["state"], vol)
    calls = {"patch": 0, "stitch": 0}

    def counted(site):
        def nms(boxes, valid, max_overlap, plan=None):
            calls[site] += 1
            return nms_kernels.greedy_nms(boxes, valid, max_overlap)
        return nms

    monkeypatch.setattr(sw, "greedy_nms_cuda", counted("stitch"))
    monkeypatch.setattr(nms_ops, "greedy_nms_cuda", counted("patch"))
    run = sw.make_sliding_window_detector(setup["cfg"], VOL, volume_batch=volume_batch,
                                          mesh=("cpu", "cpu"))
    ours = run(setup["state"], vol)
    assert run.patch_batch == (8 if volume_batch == 1 else 16)
    assert calls == {"patch": 2, "stitch": volume_batch}
    for key in plain:
        assert torch.equal(ours[key], plain[key]), key
    # a multi-device program taken from the persistent compile cache can
    # corrupt the heap on the forced 8-device CPU backend (the JAX package's
    # bug D): this one compiles fresh
    ref = quarantine_from_persistent_cache(jax_sw.make_sliding_window_detector(
        setup["jcfg"], VOL, volume_batch=volume_batch, mesh=jax_make_mesh(8)))(
        setup["variables"], jnp.asarray(vol))
    _assert_detections_match(ours, ref)


def test_mesh_patch_batch_must_divide(setup):
    run = sw.make_sliding_window_detector(setup["cfg"], VOL, patch_batch=3,
                                          mesh=("cpu", "cpu", "cpu"))
    assert run.patch_batch == 3
    with pytest.raises(ValueError, match="patch_batch=7 not divisible by the mesh's 2 devices"):
        sw.make_sliding_window_detector(setup["cfg"], VOL, patch_batch=7, mesh=("cpu", "cpu"))
    # the default rounds up to a multiple of the devices: 8 patches over 3
    assert sw.make_sliding_window_detector(setup["cfg"], VOL,
                                           mesh=("cpu",) * 3).patch_batch == 9
