"""The 3^3 weight-gradient kernel of one input channel a group
(``kernels/dw_wgrad.py``) on the card.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_dw_wgrad.py

* At each chunk shape of the benchmark's recipe cell (batch 64 at 64^3,
  width 1) of the stem (one input channel into 32) and the seven depthwise
  convs, float32 and bfloat16 inputs: the kernel against the plain version
  on the card. Both sum the same float32
  products (a bf16 product is exact in float32) in other orders: the
  kernel's longest chain of adds is 70-140 (a worker's positions, then the
  workers, then the workspace rows), the bound of its error in the worst
  case that many float32 eps of S, the sum of the products' magnitudes.
  Each weight entry is held within 64 eps of S: rounding errors of random
  sign grow as the square root of the chain, far inside it, and a dropped
  or doubled product (~S / 4096 and more) lies far outside.
* Odd shapes: C of 6, 7 (bf16, copied 2 bytes at a time) and 12, mixed
  strides, paddings of 0 (a depth-split slab) and a one-channel x into 6,
  against the plain version within the same bound.
* Two launches on the same inputs are bit-equal, with cuDNN's deterministic
  flag on and off (the kernel has no float atomics); a forced tile of
  another shape agrees within the same bound.
* The recipe's ``GraphedEpoch`` at batch 64 launches the kernel 23 times a
  step (8 chunks of the stem, 8 of block 1, 2 of block 2, 1 each of blocks
  3-7), at each warm-up step and at the capture, and never from the host at
  a replay; each of the 23 launches is marked ``msl.train.dw_wgrad``, a node
  of the graph inside the backward, read by ``phase_ms()`` while a profiler
  records, below ``msl.step.backward``.
* At 64^3, batch 16 (two chunks of the stem and of block 1), under
  deterministic cuDNN, TF32 off: the graphed epoch equals the stepped loop
  bit for bit.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mslesions3d_tpu_torch.kernels.dw_wgrad import (
    depthwise_wgrad,
    depthwise_wgrad_cuda,
    plan_dw_wgrad,
)
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.parallel.mesh import tree_tensors
from mslesions3d_tpu_torch.train import (
    create_train_state,
    make_gathered_train_epoch,
    make_gathered_train_step,
)
from mslesions3d_tpu_torch.train.graphs import EPOCH_METRICS, WARMUP_STEPS

pytestmark = pytest.mark.gpu

FMT = torch.channels_last_3d
ROOT = Path(__file__).resolve().parents[1]
RECIPE = json.loads((ROOT / "perfbench/configs/ssd3d_mobilenet_recipe64_f32.json").read_text())
# x of a chunk, the output channels, the stride
CELL = {"stem": ((8, 1, 64, 64, 64), 32, 2), "block1": ((8, 32, 32, 32, 32), 32, 2),
        "block2": ((32, 64, 16, 16, 16), 64, 2), "block3": ((64, 128, 8, 8, 8), 128, 1),
        "block4": ((64, 128, 8, 8, 8), 128, 2), "block5": ((64, 256, 4, 4, 4), 256, 1),
        "block6": ((64, 256, 4, 4, 4), 256, 2), "block7": ((64, 512, 2, 2, 2), 512, 1)}
BOUND_EPS = 64 * 2.0 ** -23
DW = "msl.train.dw_wgrad"


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def deterministic():
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _operands(shape, c, stride, dtype, seed=0):
    n, _, d, h, w = shape
    out = [(v + 2 - 3) // stride + 1 for v in (d, h, w)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(memory_format=FMT)
    gz = torch.randn((n, c, *out), generator=gen, device="cuda").to(dtype).contiguous(
        memory_format=FMT)
    return x, gz


def _kernel(x, gz, stride, plan=None):
    grad_w = torch.zeros((gz.shape[1], 1, 3, 3, 3), device="cuda")
    depthwise_wgrad_cuda(x, gz, grad_w, (stride,) * 3, (1, 1, 1), plan=plan)
    return grad_w


def _within_bound(ours, x, gz, stride):
    s3 = (stride,) * 3
    plain = depthwise_wgrad(x, gz, s3, (1, 1, 1)).double()
    magnitude = depthwise_wgrad(x.float().abs(), gz.float().abs(), s3, (1, 1, 1)).double()
    ratio = (ours.double() - plain).abs() / (BOUND_EPS * magnitude)
    assert float(ratio.max()) <= 1.0, float(ratio.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("conv", list(CELL))
def test_kernel_against_the_plain_version(conv, dtype):
    _need_card()
    shape, c, stride = CELL[conv]
    x, gz = _operands(shape, c, stride, dtype)
    launches = depthwise_wgrad_cuda.launches
    ours = _kernel(x, gz, stride)
    torch.cuda.synchronize()
    assert depthwise_wgrad_cuda.launches == launches + 1
    _within_bound(ours, x, gz, stride)


@pytest.mark.parametrize("cudnn_deterministic", [True, False], ids=["deterministic", "free"])
@pytest.mark.parametrize("conv", ["stem", "block1", "block7"])
def test_two_launches_are_bit_equal(conv, cudnn_deterministic):
    _need_card()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = cudnn_deterministic
    try:
        shape, c, stride = CELL[conv]
        x, gz = _operands(shape, c, stride, torch.float32, seed=1)
        first, second = _kernel(x, gz, stride), _kernel(x, gz, stride)
        start = torch.randn(first.shape, device="cuda")
        added = start.clone()
        depthwise_wgrad_cuda(x, gz, added, (stride,) * 3, (1, 1, 1))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
    assert torch.equal(first, second)
    assert float(first.abs().sum()) > 0
    # it adds: the kernel's one rounding of start + sum per entry
    assert torch.equal(added, start + first)


def test_a_forced_tile_agrees():
    _need_card()
    shape, c, stride = CELL["block1"]
    x, gz = _operands(shape, c, stride, torch.float32, seed=2)
    plan = plan_dw_wgrad(torch.float32, shape, (2, 2, 2), cs=32, tn=1, td=2, th=2, tw=16)
    assert plan != plan_dw_wgrad(torch.float32, shape, (2, 2, 2))
    _within_bound(_kernel(x, gz, stride, plan=plan), x, gz, stride)


# (x's shape, output channels, stride, padding, dtype): odd and even C
# outside multiples of 4 (one channel a thread; bf16 C = 7 copied 2 bytes at
# a time), mixed strides, a depth-split slab's padding and a one-channel x
ODD = [((2, 6, 9, 10, 11), 6, (1, 2, 1), (1, 1, 1), torch.float32),
       ((3, 7, 8, 9, 10), 7, (2, 1, 2), (0, 1, 1), torch.bfloat16),
       ((2, 12, 10, 7, 6), 12, (1, 1, 1), (0, 1, 0), torch.float32),
       ((2, 1, 12, 10, 9), 6, (2, 2, 2), (1, 1, 1), torch.bfloat16)]


@pytest.mark.parametrize("shape, c, stride, padding, dtype", ODD,
                         ids=["c6", "c7_bf16_slab", "c12_pad0", "one_channel_bf16"])
def test_odd_shapes_against_the_plain_version(shape, c, stride, padding, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = [(v + 2 * p - 3) // s + 1 for v, s, p in zip(shape[2:], stride, padding)]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(memory_format=FMT)
    gz = torch.randn((shape[0], c, *out), generator=gen, device="cuda").to(dtype).contiguous(
        memory_format=FMT)
    grad_w = torch.zeros((c, 1, 3, 3, 3), device="cuda")
    depthwise_wgrad_cuda(x, gz, grad_w, stride, padding)
    plain = depthwise_wgrad(x, gz, stride, padding).double()
    magnitude = depthwise_wgrad(x.float().abs(), gz.float().abs(), stride, padding).double()
    ratio = (grad_w.double() - plain).abs() / (BOUND_EPS * magnitude)
    assert float(ratio.max()) <= 1.0, float(ratio.max())


def _dataset(n, d, seed=0):
    """Seeded volumes with a painted cube each and its box, on the card."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (n, d, d, d, 1)).astype(np.float32)
    boxes = np.zeros((n, 2, 6), np.float32)
    for b in range(n):
        lo = rng.uniform(0.05, 0.6, 3)
        boxes[b, 0] = np.concatenate([lo, lo + rng.uniform(0.1, 0.3, 3)]).clip(0, 1)
        vox = (boxes[b, 0] * d).astype(int)
        images[b, vox[0]:vox[3], vox[1]:vox[4], vox[2]:vox[5], 0] += 3.0
    host = {"image": images, "boxes": boxes, "labels": np.ones((n, 2), np.int32),
            "box_mask": np.array([[True, False]] * n)}
    return {k: torch.from_numpy(v).cuda() for k, v in host.items()}


def _recipe():
    cfg = SSD3DConfig.from_json_dict(RECIPE["model"])
    model, priors = SSD3D(cfg), model_priors(cfg)
    state = create_train_state(cfg, seed=3, device="cuda")
    epoch = make_gathered_train_epoch(cfg, model, priors, hard_negative_mining=True)
    step = make_gathered_train_step(cfg, model, priors, hard_negative_mining=True)
    return state, epoch, step


def test_recipe_epoch_launches_23_a_step_and_marks_them(deterministic):
    _need_card()
    state, epoch, _ = _recipe()
    data = _dataset(64, 64)
    idx = torch.arange(64, device="cuda").view(1, 64)
    gen = torch.Generator(device="cuda").manual_seed(5)
    launches = depthwise_wgrad_cuda.launches
    state, _ = epoch(state, data, idx, gen)  # warm-up steps, then the capture
    torch.cuda.synchronize()
    assert depthwise_wgrad_cuda.launches - launches == 23 * (WARMUP_STEPS + 1)
    marks = [name for name, *_ in epoch.graphed.captured.marks]
    assert marks.count(DW) == 23
    # inside the backward: after the forward's mark, before the backward's
    inside = [i for i, name in enumerate(marks) if name == DW]
    assert marks.index("msl.step.forward") < inside[0]
    assert inside[-1] < marks.index("msl.step.backward")
    launches = depthwise_wgrad_cuda.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            state, _ = epoch(state, data, torch.cat([idx, idx]), gen)
            torch.cuda.synchronize()
    assert depthwise_wgrad_cuda.launches == launches  # replays launch nothing from the host
    ms = epoch.graphed.phase_ms()
    assert 0 < ms[DW] < ms["msl.step.backward"], ms


def test_recipe_epoch_equals_stepped_loop(deterministic):
    _need_card()
    state, epoch, step = _recipe()
    data = _dataset(32, 64, seed=1)
    idx = torch.stack([torch.from_numpy(np.random.default_rng(i).permutation(32)[:16])
                       for i in range(2)]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    launches = depthwise_wgrad_cuda.launches
    state_g, m = epoch(state, data, idx, gen)
    gen.manual_seed(11)
    rows = []
    ref = state
    for i in range(2):
        ref, mi = step(ref, data, idx[i], gen)
        rows.append(mi)
    torch.cuda.synchronize()
    # 10 chunks a step at batch 16 (2 of the stem and of block 1, 1 of blocks 2-7)
    assert depthwise_wgrad_cuda.launches - launches == 10 * (WARMUP_STEPS + 1 + 2)
    for key in EPOCH_METRICS:
        assert torch.equal(m[key], torch.stack([r[key] for r in rows])), key
    for a, b in zip(tree_tensors(state_g), tree_tensors(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b)
