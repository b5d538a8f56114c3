"""Data parallelism on the card: a world of one rank, and the sliding window's mesh.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_parallel.py

16^3, width 0.25, float32, TF32 off. A train step over a one-rank NCCL mesh
(``parallel.make_mesh``, formed in the process) equals the plain step bit
for bit: a sum over one rank is the rank's own value. The sliding window
over ``mesh=("cuda:0", "cuda:0")`` on a 24x28x20 volume launches K1 once a
shard of the chunk and at the stitch, and its detections equal the
unsharded detector's.
"""

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch import sliding_window as sw
from mslesions3d_tpu_torch.kernels.nms import greedy_nms_cuda
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.parallel import make_mesh
from mslesions3d_tpu_torch.train import create_train_state, make_train_step

pytestmark = pytest.mark.gpu

KW = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=1e-3,
          threshold=(0.1, 0.2), min_score=0.2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _batch(seed=0, b=8, d=16):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (b, d, d, d, 1)).astype(np.float32)
    boxes = np.tile(np.array([[0.2, 0.2, 0.2, 0.6, 0.6, 0.6]], np.float32), (b, 1, 1))
    images[:, 3:10, 3:10, 3:10] += 3.0
    return {"image": images, "boxes": boxes, "labels": np.ones((b, 1), np.int32),
            "box_mask": np.ones((b, 1), bool)}


def test_one_rank_nccl_step_equals_plain(no_tf32):
    _need_card()
    cfg = SSD3DConfig.create(**KW)
    model, priors = SSD3D(cfg), model_priors(cfg)
    mesh = make_mesh(device="cuda")
    try:
        assert (mesh.size, mesh.backend) == (1, "nccl")
        outs = []
        for m in (None, mesh):
            state = create_train_state(cfg, seed=0, device="cuda")
            step = make_train_step(cfg, model, priors, mesh=m, with_detections=True)
            torch.backends.cudnn.deterministic = True
            outs.append(step(state, _batch()))
        (plain, pm), (dp, dm) = outs
        for key in ("total_loss", "grad_norm", "n_positives"):
            assert torch.equal(pm[key], dm[key]), key
        for name, p in plain.params.items():
            assert torch.equal(dp.params[name], p), name
        for key in pm["detections"]:
            assert torch.equal(dm["detections"][key], pm["detections"][key]), key
    finally:
        torch.backends.cudnn.deterministic = False
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("volume_batch", [1, 2])
def test_sliding_window_mesh_on_one_card(no_tf32, volume_batch):
    _need_card()
    cfg = SSD3DConfig.create(**dict(KW, min_score=0.5, top_k=100))
    state = create_train_state(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(0)
    vol = torch.from_numpy(rng.normal(0, 1, (volume_batch, 24, 28, 20, 1)).astype(np.float32))
    x = vol[0] if volume_batch == 1 else vol
    ref = sw.make_sliding_window_detector(cfg, (24, 28, 20), volume_batch=volume_batch)(state, x)
    run = sw.make_sliding_window_detector(cfg, (24, 28, 20), volume_batch=volume_batch,
                                          mesh=("cuda:0", "cuda:0"))
    greedy_nms_cuda.launches = 0
    det = run(state, x)
    torch.cuda.synchronize()
    # one chunk in two shards, and the stitch (in two shards when V = 2)
    assert greedy_nms_cuda.launches == 2 + volume_batch
    np.testing.assert_array_equal(det["count"].cpu(), ref["count"].cpu())
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(det[key].cpu(), ref[key].cpu(), rtol=1e-5, atol=1e-6)
    assert torch.equal(det["labels"], ref["labels"])
