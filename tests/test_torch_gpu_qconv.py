"""The int8 conv Q1, every variant and tile, against its plain version on the card.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_qconv.py

Every plan ``plan_qconv`` can pick for a shape (its own choice, every igemm
tile, a small stem or depthwise tile, the direct variant) is held bit for
bit against the plain version in all four output forms: the int32 sums,
float32 y, the int8 codes of one and two scales, and the split heads. The
shapes are the 96^3 model's convs at batch 1 and 8 (width 1.0), and ragged
ones: M not a multiple of a tile, Cin 1 on odd sizes at stride 2, Cout 4,
12 and 16, dense 3^3 at stride 2 on odd sizes, channel slices that do not
divide C, layer 7's small M with K split over warps, float32 and bf16
images quantized as they load. The fused int8 forward (``run_program``)
equals the float32-mode chain (``quantized_forward_chain``) bit for bit, in
18 launches at the 96^3 model's depth, and so do their detections.
"""

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch import quant
from mslesions3d_tpu_torch.kernels.qconv import (
    IGEMM_TILES,
    plan_qconv,
    qconv_codes_cuda,
    qconv_codes_reference,
    qconv_cuda,
    qconv_heads_cuda,
    qconv_heads_reference,
    qconv_reference,
    qconv_s32,
    qconv_s32_cuda,
)
from mslesions3d_tpu_torch.models.mobilenet import mobilenet_layer_plan
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.serving import DetectionProgram

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def model_convs(side=96, width=1.0):
    """{name: (input shape at batch 1, weight shape, strides, groups)} of the model's convs."""
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(side,) * 3,
                             width_mult=width)
    plan = mobilenet_layer_plan(cfg.base_network_config, cfg.width_mult, cfg.cube,
                                truncate_after=max(cfg.feature_layers))
    convs, c, n = {}, 1, side
    for i, spec in enumerate(plan):
        s, f = spec["strides"][0], spec["features"]
        if spec["kind"] == "conv_bn":
            convs[f"stem{i}"] = ((1, n, n, n, c), (3, 3, 3, c, f), (s,) * 3, 1)
        else:
            convs[f"dw{i}"] = ((1, n, n, n, c), (3, 3, 3, 1, c), (s,) * 3, c)
        n = (n - 1) // s + 1
        if spec["kind"] != "conv_bn":
            convs[f"pw{i}"] = ((1, n, n, n, c), (1, 1, 1, c, f), (1, 1, 1), 1)
        c = f
        if i in cfg.feature_layers:
            convs[f"heads{i}"] = ((1, n, n, n, c), (3, 3, 3, c, 16), (1, 1, 1), 1)
    return convs


MODEL = model_convs()
RAGGED = {  # name: (input shape, weight shape, strides, groups)
    "pointwise_ragged_m": ((3, 5, 7, 9, 32), (1, 1, 1, 32, 48), (1, 1, 1), 1),
    "pointwise_cout4": ((2, 5, 5, 5, 64), (1, 1, 1, 64, 4), (1, 1, 1), 1),
    "pointwise_cin48": ((2, 3, 4, 5, 48), (1, 1, 1, 48, 24), (1, 1, 1), 1),
    "pointwise_s2": ((2, 7, 6, 5, 32), (1, 1, 1, 32, 32), (2, 2, 2), 1),
    "dense_s2_odd": ((2, 7, 9, 5, 16), (3, 3, 3, 16, 24), (2, 2, 2), 1),
    "dense_cin16_cout12": ((2, 6, 5, 7, 16), (3, 3, 3, 16, 12), (1, 1, 1), 1),
    "heads_layer7_split_k": ((8, 3, 3, 3, 512), (3, 3, 3, 512, 16), (1, 1, 1), 1),
    "heads_small": ((1, 2, 3, 2, 128), (3, 3, 3, 128, 16), (1, 1, 1), 1),
    "stem_odd_s2": ((1, 7, 9, 11, 1), (3, 3, 3, 1, 12), (2, 2, 2), 1),
    "stem_cout4": ((2, 5, 6, 7, 1), (3, 3, 3, 1, 4), (1, 2, 2), 1),
    "stem_cout64": ((1, 9, 9, 9, 1), (3, 3, 3, 1, 64), (2, 2, 2), 1),
    "dw_s2_odd": ((2, 7, 5, 9, 12), (3, 3, 3, 1, 12), (2, 2, 2), 12),
    "dw_s1_c96": ((2, 5, 6, 7, 96), (3, 3, 3, 1, 96), (1, 1, 1), 96),
    "dw_c6_direct": ((2, 4, 5, 6, 6), (3, 3, 3, 1, 6), (1, 1, 1), 6),
    "dense_cin6_direct": ((2, 4, 4, 4, 6), (1, 1, 1, 6, 10), (1, 1, 1), 1),
}


def plans_for(shape, wshape, stride, groups, dtype=torch.int8):
    """Every plan the planner can give the shape: its own, each igemm tile,
    a small stem or depthwise tile, the direct variant."""
    cin = shape[-1]
    plans = {plan_qconv(shape, wshape, stride, groups, dtype)}
    if groups == 1 and dtype == torch.int8 and cin % 16 == 0:
        plans |= {plan_qconv(shape, wshape, stride, groups, variant="igemm", tile=t)
                  for t in IGEMM_TILES}
    if groups == 1 and cin == 1 and wshape[0] == 3 and wshape[-1] <= 64:
        plans.add(plan_qconv(shape, wshape, stride, groups, dtype, variant="stem", tz=1, ty=2,
                             tx=3))
    if groups == cin > 1 and cin % 4 == 0 and wshape[0] == 3:
        plans.add(plan_qconv(shape, wshape, stride, groups, variant="depthwise",
                             cs=8 if cin % 8 == 0 else 4, tz=1, ty=1))
    if groups == 1 or dtype == torch.int8:
        plans.add(plan_qconv(shape, wshape, stride, groups, dtype, variant="direct"))
    return sorted(plans, key=str)


def operands(shape, wshape, seed):
    rng = np.random.default_rng(seed)
    cout = wshape[-1]
    q = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).cuda()
    wq = torch.from_numpy(rng.integers(-127, 128, wshape).astype(np.int8)).cuda()
    # scales that keep y's codes spread over the int8 range
    k3cin = np.prod(wshape[:4])
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, cout) / (64 * 64 * np.sqrt(k3cin))).astype(
        np.float32)).cuda()
    bias = torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32)).cuda()
    sx = torch.from_numpy(rng.uniform(0.01, 0.03, 2).astype(np.float32)).cuda()
    return q, wq, scale, bias, sx


def check_plans(shape, wshape, stride, groups, seed=0):
    q, wq, scale, bias, sx = operands(shape, wshape, seed)
    sums = qconv_s32(q, wq, stride, groups)
    ran = []
    for plan in plans_for(shape, wshape, stride, groups):
        before = qconv_cuda.launches
        got = qconv_s32_cuda(q, wq, stride, groups, plan=plan)
        assert torch.equal(got, sums), plan
        for relu in (False, True):
            y = qconv_cuda(q, wq, scale, bias, stride, groups, relu, plan=plan)
            assert torch.equal(y, qconv_reference(q, wq, scale, bias, stride, groups, relu)), plan
        for n in (1, 2):
            codes = qconv_codes_cuda(q, wq, scale, bias, sx[:n], stride, groups, True, plan=plan)
            want = qconv_codes_reference(q, wq, scale, bias, sx[:n], stride, groups, True)
            assert torch.equal(codes, want), (plan, n)
        launches = 5
        if groups == 1 and stride == (1, 1, 1) and wshape[-1] > 4 and wshape[0] == 3:
            split = wshape[-1] - 4
            got = qconv_heads_cuda(q, wq, scale, bias, split, plan=plan)
            want = qconv_heads_reference(q, wq, scale, bias, split)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), plan
            launches += 1
        torch.cuda.synchronize()
        assert qconv_cuda.launches - before == launches
        ran.append(plan.variant)
    return ran


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", list(MODEL))
def test_model_convs_every_plan_bit_for_bit(name, batch):
    _need_card()
    shape, wshape, stride, groups = MODEL[name]
    ran = check_plans((batch, *shape[1:]), wshape, stride, groups, seed=batch)
    assert set(ran) >= {"direct"} and len(ran) >= 2


@pytest.mark.parametrize("name", list(RAGGED))
def test_ragged_shapes_every_plan_bit_for_bit(name):
    _need_card()
    check_plans(*RAGGED[name], seed=sorted(RAGGED).index(name))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["stem_odd_s2", "stem_cout64", "dense_cin2"])
def test_images_quantized_as_they_load(name, dtype):
    """A float image through every plan: the codes equal requantize of the
    image, the plain conv, then requantize of y."""
    _need_card()
    shape, wshape, stride, groups = RAGGED.get(
        name, ((2, 5, 6, 7, 2), (3, 3, 3, 2, 8), (2, 2, 2), 1))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).cuda().to(dtype)
    _, wq, scale, bias, sx = operands(shape, wshape, 4)
    sx_in = torch.tensor(0.02, device="cuda")
    for plan in plans_for(shape, wshape, stride, groups, dtype):
        codes = qconv_codes_cuda(x, wq, scale, bias, sx, stride, groups, True, sx_in, plan=plan)
        want = qconv_codes_reference(x, wq, scale, bias, sx, stride, groups, True, sx_in)
        assert torch.equal(codes, want), plan


def _quantized(width=1.0, side=32, batch=2):
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(side,) * 3,
                             width_mult=width, min_score=0.0, top_k=10)
    state_dict = SSD3D(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    x = np.random.default_rng(1).normal(size=(batch, *cfg.input_size, 1)).astype(np.float32)
    return cfg, quant.quantize_ssd3d(cfg, state_dict, x, device="cuda"), x


@pytest.mark.parametrize("width", [1.0, 0.25])
def test_fused_forward_equals_the_float32_chain(width):
    """The fused forward (codes in every epilogue, one head launch a
    feature layer) equals the float32-mode chain with torch's requantize,
    bit for bit, from float32 and bf16 images; 18 launches at width 1.0."""
    _need_card()
    cfg, qm, x = _quantized(width)
    module = quant.QuantizedSSD3D(qm).cuda()
    n_launches = len(qm["layers"]) + len(qm["feature_layers"])
    for dtype in (torch.float32, torch.bfloat16):
        xi = torch.from_numpy(x).cuda().to(dtype)
        with torch.inference_mode():
            before = qconv_cuda.launches
            locs, scores = module(xi)
            torch.cuda.synchronize()
            assert qconv_cuda.launches - before == n_launches
            want_l, want_s = quant.quantized_forward_chain(module.qmodel(), xi)
        assert torch.equal(locs, want_l) and torch.equal(scores, want_s), dtype
    if width == 1.0:
        assert n_launches == 18


def test_int8_detections_equal_the_float32_chain():
    _need_card()
    cfg, qm, x = _quantized(1.0, batch=3)
    module = quant.QuantizedSSD3D(qm)

    class Chain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.module = module

        def forward(self, images):
            return quant.quantized_forward_chain(self.module.qmodel(), images)

    out = {}
    for name, model in (("fused", module), ("chain", Chain())):
        program = DetectionProgram(model, model_priors(cfg), n_classes=cfg.n_classes,
                                   min_score=cfg.min_score, max_overlap=cfg.max_overlap,
                                   top_k=cfg.top_k).cuda()
        with torch.inference_mode():
            out[name] = program(torch.from_numpy(x).cuda())
    for k in out["chain"]:
        assert torch.equal(out["fused"][k], out["chain"][k]), k
    assert int(out["fused"]["count"].min()) > 0


@pytest.mark.parametrize("sx", [2.0, 0.5, 3.0, 0.1, 1 / 3, 1.7e-3])
def test_codes_at_ties_round_half_to_even(sx):
    """y = the input codes exactly (one-hot weights, scale 1, bias 0), so
    y / sx lands on half-integers and near them: the kernels' fast path
    (y times the reciprocal) must hand those to the exact division. The
    float images quantized as they load meet the same ties."""
    _need_card()
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.integers(-127, 128, (2, 5, 6, 7, 32)).astype(np.int8)).cuda()
    ones, zeros = torch.ones(32, device="cuda"), torch.zeros(32, device="cuda")
    sx_out = torch.tensor([sx, 2.0], dtype=torch.float32, device="cuda")
    pointwise = torch.eye(32, dtype=torch.int8, device="cuda").reshape(1, 1, 1, 32, 32)
    centre = torch.zeros((3, 3, 3, 1, 32), dtype=torch.int8, device="cuda")
    centre[1, 1, 1] = 1
    for wq, groups in ((pointwise, 1), (centre, 32)):
        for plan in plans_for(tuple(q.shape), tuple(wq.shape), (1, 1, 1), groups):
            got = qconv_codes_cuda(q, wq, ones, zeros, sx_out, 1, groups, False, plan=plan)
            want = qconv_codes_reference(q, wq, ones, zeros, sx_out, 1, groups, False)
            assert torch.equal(got[1], torch.round(q.float() / 2).to(torch.int8)), plan
            assert torch.equal(got, want), plan
    image = torch.from_numpy(rng.integers(-300, 300, (2, 7, 8, 9, 1)).astype(np.float32)).cuda()
    stem = torch.zeros((3, 3, 3, 1, 8), dtype=torch.int8, device="cuda")
    stem[1, 1, 1] = 1
    sx_in = torch.tensor(sx, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        x = image.to(dtype)
        for plan in plans_for(tuple(x.shape), tuple(stem.shape), (1, 1, 1), 1, dtype):
            got = qconv_codes_cuda(x, stem, ones[:8], zeros[:8], sx_out, 1, 1, False, sx_in,
                                   plan=plan)
            want = qconv_codes_reference(x, stem, ones[:8], zeros[:8], sx_out, 1, 1, False, sx_in)
            assert torch.equal(got, want), (dtype, plan)
