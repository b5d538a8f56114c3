"""The sliding-window detector on the card: K1 at both call sites, against the CPU.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_sliding_window.py

A width-0.25 16^3 model of random weights from seed 1, its BN parameters
and statistics drawn by numpy from the same seed (as the CPU tests'
``randomized_variables`` draws them), float32 with TF32 off, on seeded
24x28x20 volumes:

- every K1 launch of a call (one per chunk of patches in
  ``detect_objects``, one at the stitch) keeps what the plain NMS keeps on
  the same candidates, and a call launches exactly that many;
- the card's detections equal the CPU's, end to end (the forward, the
  per-patch detection, the stitch): equal counts and labels, boxes and
  scores within 1e-5, in the same order (every selection breaks ties
  towards the lower index on both devices). The case is strict: a
  perturbation of the CPU's forward ten times the card's difference from
  it (1e-5 relative, equal values kept equal) moves no detection, so no
  score cut, order or IoU decision lies within the forward's noise;
- the card's stitch (the map to the volume, the class-wise top-K, K1, the
  top-k) equals the CPU's plain stitch of the same per-patch detections
  (the card's, replayed on the CPU), bit for bit;
- ``volume_batch=2`` on the card equals two single calls within 1e-5.
"""

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch import sliding_window as sw
from mslesions3d_tpu_torch.kernels import nms as nms_kernels
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig
from mslesions3d_tpu_torch.ops import nms as nms_ops
from mslesions3d_tpu_torch.train import create_train_state
from mslesions3d_tpu_torch.train.steps import eval_forward

pytestmark = pytest.mark.gpu

VOL = (24, 28, 20)
CFG = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25,
           min_score=0.5, top_k=100)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _states(seed=1):
    cfg = SSD3DConfig.create(**CFG)
    source = SSD3D(cfg, generator=torch.Generator().manual_seed(seed)).state_dict()
    rng = np.random.default_rng(seed)
    for key in sorted(source):
        if key.endswith("running_mean"):
            bn, shape = key.removesuffix("running_mean"), source[key].shape
            for name, low, high in (("weight", 0.5, 1.5), ("bias", -0.2, 0.2),
                                    ("running_mean", -0.5, 0.5), ("running_var", 0.5, 2.0)):
                source[bn + name] = torch.from_numpy(
                    rng.uniform(low, high, shape).astype(np.float32))
    return cfg, {dev: create_train_state(cfg, device=dev, state_dict=source)
                 for dev in ("cpu", "cuda")}


def _volumes(n=2):
    return np.random.default_rng(0).normal(0, 1, (n, *VOL, 1)).astype(np.float32)


def test_every_k1_launch_equals_the_plain_nms(no_tf32, monkeypatch):
    _need_card()
    cfg, states = _states()
    calls = []
    kernel = nms_kernels.greedy_nms_cuda

    def recording(boxes, valid, max_overlap, plan=None):
        keep = kernel(boxes, valid, max_overlap, plan)
        calls.append((boxes.clone(), valid.clone(), max_overlap, keep))
        return keep

    monkeypatch.setattr(nms_ops, "greedy_nms_cuda", recording)
    monkeypatch.setattr(sw, "greedy_nms_cuda", recording)
    for volume_batch in (1, 2):
        run = sw.make_sliding_window_detector(cfg, VOL, volume_batch=volume_batch)
        calls.clear()
        kernel.launches = 0
        vol = _volumes() if volume_batch == 2 else _volumes()[0]
        det = run(states["cuda"], vol)
        torch.cuda.synchronize()
        chunks = -(-run.n_patches * volume_batch // run.patch_batch)
        assert kernel.launches == len(calls) == chunks + 1
        n_stitch_rows = calls[-1][0].shape[0]
        assert n_stitch_rows == volume_batch  # one foreground class
        for boxes, valid, max_overlap, keep in calls:
            assert boxes.is_cuda
            assert torch.equal(keep, nms_kernels.greedy_nms(boxes, valid, max_overlap))
        assert int(calls[-1][1].sum()) > int(calls[-1][3].sum()) > 0  # the stitch suppresses
        assert int(det["count"].min()) > 0


def _perturbed_forward(model, phase):
    """The plain forward with every output x moved by 1e-5 * sin(1e4 * phase * x)
    relative: a perturbation that keeps equal values equal."""
    def forward(state, patches):
        locs, scores = eval_forward(model, state, patches)
        return tuple(t * (1 + 1e-5 * torch.sin(t * 1e4 * phase)) for t in (locs, scores))
    return forward


def test_card_detections_equal_the_cpu(no_tf32):
    _need_card()
    cfg, states = _states()
    vol = _volumes()
    cpu = sw.make_sliding_window_detector(cfg, VOL, volume_batch=2)(states["cpu"], vol)
    assert int(cpu["count"].min()) > 0
    model = SSD3D(cfg)
    for phase in (1.0, 2.0, 3.0):  # the case is strict
        moved = sw.make_sliding_window_detector(
            cfg, VOL, volume_batch=2, patch_forward=_perturbed_forward(model, phase))(
            states["cpu"], vol)
        for key in ("count", "labels"):
            assert torch.equal(moved[key], cpu[key]), key
        for key in ("boxes", "scores"):
            torch.testing.assert_close(moved[key], cpu[key], rtol=0, atol=1e-4)
    card = sw.make_sliding_window_detector(cfg, VOL, volume_batch=2)(states["cuda"], vol)
    for key in ("count", "labels"):
        assert torch.equal(card[key].cpu(), cpu[key]), key
    for key in ("boxes", "scores"):
        torch.testing.assert_close(card[key].cpu(), cpu[key], rtol=0, atol=1e-5)


def test_card_stitch_equals_the_cpu(no_tf32, monkeypatch):
    _need_card()
    cfg, states = _states()
    vol = _volumes()
    chunks = []
    detect = sw.detect_objects

    def recording(*args, **kwargs):
        chunks.append(detect(*args, **kwargs))
        return chunks[-1]

    monkeypatch.setattr(sw, "detect_objects", recording)
    run = sw.make_sliding_window_detector(cfg, VOL, volume_batch=2)
    card = run(states["cuda"], vol)
    assert len(chunks) == 1 and chunks[0]["boxes"].is_cuda
    replay = iter([{k: v.cpu() for k, v in det.items()} for det in chunks])
    monkeypatch.setattr(sw, "detect_objects", lambda *args, **kwargs: next(replay))
    cpu = run(states["cpu"], vol)
    assert int(cpu["count"].min()) > 0
    for key, value in cpu.items():
        assert torch.equal(card[key].cpu(), value), key


def test_volume_batch_equals_single_calls_on_the_card(no_tf32):
    _need_card()
    cfg, states = _states()
    vol = _volumes()
    pair = sw.make_sliding_window_detector(cfg, VOL, volume_batch=2)(states["cuda"], vol)
    single = sw.make_sliding_window_detector(cfg, VOL)
    for v in range(2):
        one = single(states["cuda"], vol[v])
        assert torch.equal(pair["count"][v], one["count"][0])
        for key in ("boxes", "scores"):
            torch.testing.assert_close(pair[key][v], one[key][0], rtol=0, atol=1e-5)
