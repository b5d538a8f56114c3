"""Q1's planner, torch mirrors of its kernels' tiling, its new ops' plain
versions and the fused int8 forward, on the CPU.

``plan_qconv`` picks a variant and tile of ``csrc/qconv.cu`` from the
shapes; the tests hold its choice for the 96^3 model's convs and its shared
memory for every shape. The mirrors below rebuild what the kernels do, from
the plan, with the kernels' own index arithmetic:

- ``igemm_mirror``: CTA tiles of BM rows x BN columns, K = taps x Cin in
  stages of KC bytes copied as 16-byte chunks (a chunk's tap is k // Cin,
  its channel k % Cin; zero-filled for taps outside the volume, rows past M,
  columns past Cout and the K tail), k-steps of 32 handed to the WK warps in
  turn and their partial sums added in warp order;
- ``stem_mirror``: a CTA's quantized input patch, a row's 27 taps padded to
  32 gathered through the tap offsets, one k-step, the rows mapped back;
- ``depthwise_mirror``: a CTA's patch of whole runs of 4 outputs, each
  (kd, kh) row read once into a register window, tap kw of output r at
  window column r * stride + kw.

Each equals ``qconv_s32`` bit for bit on ragged shapes. The new ops' plain
versions are ``requantize(qconv_reference(...))`` and its column split, and
the fused forward equals the float32-mode chain bit for bit and stays within
``test_quantized_forward_matches_jax``'s bound of JAX's ``quantized_forward``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu import quant as jq
from mslesions3d_tpu_torch import quant
from mslesions3d_tpu_torch.kernels.qconv import (
    DW_RUN,
    IGEMM_TILES,
    SMEM_DEFAULT,
    SMEM_MAX,
    igemm_smem,
    plan_qconv,
    qconv_codes_cuda,
    qconv_codes_reference,
    qconv_heads_cuda,
    qconv_heads_reference,
    qconv_reference,
    qconv_s32,
    requantize,
    stem_n8,
)
from mslesions3d_tpu_torch.models.mobilenet import mobilenet_layer_plan
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig
from mslesions3d_tpu_torch.weights import from_jax_variables
from test_quant import _model_and_variables


def model_convs(side=96, width=1.0, batch=8):
    """{name: (input shape, weight shape, strides, groups)} of the model's convs."""
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(side,) * 3,
                             width_mult=width)
    plan = mobilenet_layer_plan(cfg.base_network_config, cfg.width_mult, cfg.cube,
                                truncate_after=max(cfg.feature_layers))
    convs, c, n = {}, 1, side
    for i, spec in enumerate(plan):
        s, f = spec["strides"][0], spec["features"]
        if spec["kind"] == "conv_bn":
            convs[f"stem{i}"] = ((batch, n, n, n, c), (3, 3, 3, c, f), (s,) * 3, 1)
        else:
            convs[f"dw{i}"] = ((batch, n, n, n, c), (3, 3, 3, 1, c), (s,) * 3, c)
        n = (n - 1) // s + 1
        if spec["kind"] != "conv_bn":
            convs[f"pw{i}"] = ((batch, n, n, n, c), (1, 1, 1, c, f), (1, 1, 1), 1)
        c = f
        if i in cfg.feature_layers:
            convs[f"heads{i}"] = ((batch, n, n, n, c), (3, 3, 3, c, 16), (1, 1, 1), 1)
    return convs


def _plan(conv, dtype=torch.int8, **kw):
    shape, wshape, stride, groups = conv
    return plan_qconv(shape, wshape, stride, groups, dtype, **kw)


# ---------------------------------------------------------------- the planner
HEADLINE_TILES = {  # the 96^3 model at batch 8: what each conv runs on
    "stem0": "stem", "pw1": "igemm/m128n64", "pw2": "igemm/m128n64", "pw3": "igemm/m128n64",
    "heads3": "igemm/m64n16k4", "pw4": "igemm/m32n64k4", "pw5": "igemm/m32n64k4",
    "heads5": "igemm/m16n16k8", "pw6": "igemm/m32n64k4", "pw7": "igemm/m32n64k4",
    "heads7": "igemm/m16n16k8",
}


@pytest.mark.parametrize("name", list(model_convs()))
def test_headline_variant_and_tile(name):
    conv = model_convs()[name]
    plan = _plan(conv, torch.bfloat16 if name.startswith("stem") else torch.int8)
    got = plan.variant + (f"/{plan.tile}" if plan.tile else "")
    assert got == HEADLINE_TILES.get(name, "depthwise")


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("width", [0.25, 0.5, 1.0])
def test_every_model_plan_fits_shared_memory(width, batch):
    """Under 227 KB, and under the 48 KB a block has without opting in but
    for the heads' split-K tile (49.5 KB); the heads of every width and the
    pointwise convs of width >= 0.5 take the tensor cores."""
    for name, conv in model_convs(width=width, batch=batch).items():
        plan = _plan(conv)
        limit = SMEM_MAX if plan.tile == "m16n16k8" else SMEM_DEFAULT
        assert 0 < plan.smem <= limit <= SMEM_MAX or plan.variant == "direct", (name, plan)
        assert plan.threads <= 256 and plan.grid > 0
        if name.startswith("heads") or (name.startswith("pw") and conv[0][-1] >= 16):
            assert plan.variant == "igemm", (name, plan)


def test_igemm_tiles_shared_memory():
    """The ring of stages against the staged sums, tile by tile."""
    want = {"m128n64": 3 * 192 * 80, "m64n64": 3 * 128 * 80, "m32n64k4": 3 * 96 * 144,
            "m64n16k4": 3 * 80 * 144, "m16n16k8": 3 * 32 * 528}
    for tile, (bm, bn, wm, wn, wk, kc, _) in IGEMM_TILES.items():
        assert igemm_smem(tile) == max(want[tile], wk * bm * (bn + 8) * 4)
        assert bm % (16 * wm) == 0 and bn % (8 * wn) == 0 and (kc // 32) % wk == 0


@pytest.mark.parametrize("cin,align,variant", [
    (32, 16, "igemm"), (48, 16, "igemm"), (32, 8, "direct"), (8, 16, "direct"), (6, 16, "direct")])
def test_dense_variant_follows_channels_and_alignment(cin, align, variant):
    plan = plan_qconv((2, 4, 4, 4, cin), (1, 1, 1, cin, 32), 1, 1, torch.int8, align)
    assert plan.variant == variant
    assert plan.vec == (4 if variant == "direct" and cin % 4 == 0 and align % 4 == 0 else 0)


@pytest.mark.parametrize("c,align,variant,vec", [
    (64, 16, "depthwise", 16), (12, 16, "depthwise", 4), (96, 4, "depthwise", 4),
    (6, 16, "direct", 0), (64, 2, "direct", 0)])
def test_depthwise_variant_and_copy_width(c, align, variant, vec):
    plan = plan_qconv((2, 6, 6, 6, c), (3, 3, 3, 1, c), 1, c, torch.int8, align)
    assert (plan.variant, plan.vec) == (variant, vec)


def test_float_images_take_the_stem_or_direct():
    assert plan_qconv((2, 9, 9, 9, 1), (3, 3, 3, 1, 32), 2, 1, torch.bfloat16).variant == "stem"
    assert plan_qconv((2, 9, 9, 9, 2), (3, 3, 3, 2, 32), 2, 1, torch.float32).variant == "direct"
    assert plan_qconv((2, 9, 9, 9, 1), (3, 3, 3, 1, 96), 2, 1, torch.float32).variant == "direct"
    with pytest.raises(ValueError, match="does not take"):
        plan_qconv((2, 9, 9, 9, 32), (1, 1, 1, 32, 32), 1, 1, torch.float32, variant="igemm")
    with pytest.raises(ValueError, match="does not take"):
        plan_qconv((2, 9, 9, 9, 8), (3, 3, 3, 1, 8), 1, 8, torch.float32)


def test_forced_plans_that_do_not_fit_raise():
    with pytest.raises(ValueError, match="does not take"):
        plan_qconv((2, 4, 4, 4, 8), (1, 1, 1, 8, 16), 1, 1, variant="igemm")
    with pytest.raises(ValueError, match="tile"):
        plan_qconv((2, 4, 4, 4, 32), (1, 1, 1, 32, 16), 1, 1, variant="igemm", tile="m256n8")
    with pytest.raises(ValueError, match="shared memory"):
        plan_qconv((1, 200, 200, 200, 1), (3, 3, 3, 1, 64), 1, 1, variant="stem", tz=32, ty=32,
                   tx=64)
    with pytest.raises(ValueError, match="no depthwise tile"):
        plan_qconv((1, 4, 4, 20000, 64), (3, 3, 3, 1, 64), 1, 64, tz=4, ty=8)


def test_heads_split_k_when_m_is_small():
    """Layer 7's heads at batch 8 (M = 216, K = 13824): eight warps split K."""
    plan = _plan(model_convs()["heads7"])
    bm, bn, wm, wn, wk, kc, _ = IGEMM_TILES[plan.tile]
    assert (bm, bn, wk) == (16, 16, 8) and plan.grid == 216 // 16 + 1


# ---------------------------------------------------------------- the mirrors
def cdiv(a, b):
    return -(-a // b)


def out_dims(dims, k, strides):
    return tuple((n + 2 * (k // 2) - k) // s + 1 for n, s in zip(dims, strides))


def igemm_mirror(q, wq, strides, plan):
    """The igemm kernel's sums, CTA tile by CTA tile, from its copies."""
    b, d, h, w, cin = q.shape
    k, cout = wq.shape[0], wq.shape[-1]
    od, oh, ow = out_dims((d, h, w), k, strides)
    bm, bn, _, _, wk, kc, _ = IGEMM_TILES[plan.tile]
    big_k, m = k ** 3 * cin, b * od * oh * ow
    wrows = wq.permute(4, 0, 1, 2, 3).reshape(cout, big_k).long()  # pack_weights
    xl = q.long().reshape(-1)
    out = torch.zeros((m, cout), dtype=torch.long)
    for m0 in range(0, cdiv(m, bm) * bm, bm):
        rows = torch.arange(m0, m0 + bm)
        live = rows < m
        v = rows.clamp(max=m - 1)
        ox, oy, oz, n = v % ow, v // ow % oh, v // (ow * oh) % od, v // (ow * oh * od)
        for n0 in range(0, cdiv(cout, bn) * bn, bn):
            cols = torch.arange(n0, n0 + bn)
            partial = torch.zeros((wk, bm, bn), dtype=torch.long)
            for kt in range(cdiv(big_k, kc)):
                a = torch.zeros((bm, kc), dtype=torch.long)
                bt = torch.zeros((bn, kc), dtype=torch.long)
                for j in range(kc // 16):
                    kk = kt * kc + j * 16
                    if kk >= big_k:
                        continue
                    tap, c = kk // cin, kk % cin
                    kd, kh, kw = tap // (k * k), tap // k % k, tap % k
                    iz = oz * strides[0] - k // 2 + kd
                    iy = oy * strides[1] - k // 2 + kh
                    ix = ox * strides[2] - k // 2 + kw
                    ok = live & (iz >= 0) & (iz < d) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                    src = (((n * d + iz) * h + iy) * w + ix) * cin + c
                    idx = src[:, None] + torch.arange(16)[None, :]
                    a[:, j * 16:(j + 1) * 16] = torch.where(
                        ok[:, None], xl[idx.clamp(0, xl.numel() - 1)], 0)
                    colok = cols < cout
                    bt[:, j * 16:(j + 1) * 16] = torch.where(
                        colok[:, None], wrows[cols.clamp(max=cout - 1), kk:kk + 16], 0)
                for ks in range(kc // 32):
                    sl = slice(ks * 32, ks * 32 + 32)
                    partial[ks % wk] += a[:, sl] @ bt[:, sl].T
            total = partial[0]
            for p in partial[1:]:
                total = total + p
            keep = live[:, None] & (cols < cout)[None, :]
            sub = out[m0:min(m0 + bm, m), n0:min(n0 + bn, cout)]
            sub += total[keep].reshape(sub.shape)
    assert out.abs().max() < 2 ** 31
    return out.reshape(b, od, oh, ow, cout).to(torch.int32)


def stem_mirror(q, wq, strides, plan):
    """The stem kernel's sums: a patch a CTA, a row's taps padded to 32."""
    b, d, h, w, _ = q.shape
    cout = wq.shape[-1]
    od, oh, ow = out_dims((d, h, w), 3, strides)
    sd, sh, sw = strides
    tz, ty, tx = plan.tz, plan.ty, plan.tx
    pz, py, px = (tz - 1) * sd + 3, (ty - 1) * sh + 3, (tx - 1) * sw + 3
    bn = 8 * stem_n8(cout)
    wb = torch.zeros((bn, 32), dtype=torch.long)
    wb[:cout, :27] = wq.reshape(27, cout).T.long()
    taps = torch.arange(32)
    offs = ((taps // 9) * py + (taps // 3) % 3) * px + taps % 3
    offs = torch.where(taps < 27, offs, 0)
    rows = tz * ty * tx
    r = torch.arange(cdiv(rows, 16) * 16)
    lz, ly, lx = r // (ty * tx), r // tx % ty, r % tx
    base = torch.where(r < rows, (lz * sd * py + ly * sh) * px + lx * sw, 0)
    out = torch.zeros((b, od, oh, ow, cout), dtype=torch.int32)
    xp = torch.nn.functional.pad(q[..., 0].long(), (1, 1 + px, 1, 1 + py, 1, 1 + pz))
    for n in range(b):
        for oz0 in range(0, od, tz):
            for oy0 in range(0, oh, ty):
                for ox0 in range(0, ow, tx):
                    z0, y0, x0 = oz0 * sd, oy0 * sh, ox0 * sw  # patch origin, padded coords
                    patch = xp[n, z0:z0 + pz, y0:y0 + py, x0:x0 + px].reshape(-1)
                    a = torch.where(taps[None, :] < 27, patch[base[:, None] + offs[None, :]], 0)
                    sums = a @ wb.T
                    for i in range(rows):
                        z, y, x = oz0 + int(lz[i]), oy0 + int(ly[i]), ox0 + int(lx[i])
                        if z < od and y < oh and x < ow:
                            out[n, z, y, x] = sums[i, :cout].to(torch.int32)
    return out


def depthwise_mirror(q, wq, strides, plan):
    """The depthwise kernel's sums: a patch a CTA and channel slice, runs of
    4 outputs from each (kd, kh) row's register window."""
    b, d, h, w, c = q.shape
    od, oh, ow = out_dims((d, h, w), 3, strides)
    sd, sh, sw = strides
    tz, ty, cs = plan.tz, plan.ty, plan.cs
    runs = cdiv(ow, DW_RUN)
    pz, py, px = (tz - 1) * sd + 3, (ty - 1) * sh + 3, (runs * DW_RUN - 1) * sw + 3
    nw = (DW_RUN - 1) * sw + 3
    wl = wq.reshape(27, c).long()
    xp = torch.nn.functional.pad(q.long(), (0, 0, 1, px, 1, 1 + py, 1, 1 + pz))
    out = torch.zeros((b, od, oh, ow, c), dtype=torch.int32)
    for n in range(b):
        for oz0 in range(0, od, tz):
            for oy0 in range(0, oh, ty):
                for c0 in range(0, c, cs):
                    z0, y0 = oz0 * sd, oy0 * sh
                    patch = xp[n, z0:z0 + pz, y0:y0 + py, :px, c0:c0 + cs].reshape(-1, min(cs, c - c0))
                    for it in range(tz * ty * runs):
                        xr, ly, lz = it % runs, it // runs % ty, it // (runs * ty)
                        if oz0 + lz >= od or oy0 + ly >= oh:
                            continue
                        acc = torch.zeros((DW_RUN, patch.shape[1]), dtype=torch.long)
                        for kd in range(3):
                            for kh in range(3):
                                row = ((lz * sd + kd) * py + ly * sh + kh) * px + xr * DW_RUN * sw
                                win = patch[row:row + nw]
                                for kw in range(3):
                                    wt = wl[(kd * 3 + kh) * 3 + kw, c0:c0 + cs]
                                    for rr in range(DW_RUN):
                                        acc[rr] += win[rr * sw + kw] * wt
                        for rr in range(DW_RUN):
                            ox = xr * DW_RUN + rr
                            if ox < ow:
                                out[n, oz0 + lz, oy0 + ly, ox, c0:c0 + cs] = acc[rr].to(torch.int32)
    return out


def _ints(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


IGEMM_CASES = {  # input shape, weight shape, strides
    "pointwise_ragged_m": ((3, 3, 5, 7, 32), (1, 1, 1, 32, 48), (1, 1, 1)),
    "pointwise_k_tail": ((2, 3, 3, 4, 48), (1, 1, 1, 48, 20), (1, 1, 1)),
    "pointwise_s2": ((2, 5, 4, 5, 16), (1, 1, 1, 16, 8), (2, 2, 2)),
    "dense_s2_odd": ((1, 5, 7, 3, 16), (3, 3, 3, 16, 24), (2, 2, 2)),
    "heads_zero_taps": ((2, 3, 4, 2, 32), (3, 3, 3, 32, 16), (1, 1, 1)),
    "heads_split_k": ((1, 2, 2, 3, 64), (3, 3, 3, 64, 16), (1, 1, 1)),
}


@pytest.mark.parametrize("tile", list(IGEMM_TILES))
@pytest.mark.parametrize("case", list(IGEMM_CASES))
def test_igemm_mirror_equals_the_plain_conv(case, tile):
    shape, wshape, strides = IGEMM_CASES[case]
    q, wq = _ints(shape, 1), _ints(wshape, 2)
    plan = plan_qconv(shape, wshape, strides, 1, variant="igemm", tile=tile)
    assert torch.equal(igemm_mirror(q, wq, strides, plan), qconv_s32(q, wq, strides))


STEM_CASES = {  # input shape, Cout, strides, tile (tz, ty, tx)
    "odd_s2": ((1, 7, 9, 11, 1), 12, (2, 2, 2), (1, 2, 3)),
    "s122_cout4": ((2, 5, 6, 7, 1), 4, (1, 2, 2), (2, 3, 4)),
    "planned": ((1, 9, 8, 10, 1), 32, (2, 2, 2), None),
    "cout64": ((1, 5, 5, 5, 1), 64, (1, 1, 1), (3, 2, 5)),
}


@pytest.mark.parametrize("case", list(STEM_CASES))
def test_stem_mirror_equals_the_plain_conv(case):
    """27 taps padded to 32, zero-filled edges, ragged CTA tiles."""
    shape, cout, strides, tile = STEM_CASES[case]
    q, wq = _ints(shape, 3), _ints((3, 3, 3, 1, cout), 4)
    kw = dict(zip(("tz", "ty", "tx"), tile)) if tile else {}
    plan = plan_qconv(shape, (3, 3, 3, 1, cout), strides, 1, variant="stem", **kw)
    assert torch.equal(stem_mirror(q, wq, strides, plan), qconv_s32(q, wq, strides))


DW_CASES = {  # input shape, strides, tile (cs, tz, ty)
    "s2_odd": ((2, 7, 5, 9, 12), (2, 2, 2), (8, 1, 2)),
    "s1_slices": ((1, 5, 6, 7, 20), (1, 1, 1), (8, 2, 3)),
    "s1_planned": ((2, 6, 6, 6, 64), (1, 1, 1), None),
    "s2_planned": ((1, 9, 7, 10, 32), (2, 2, 2), None),
}


@pytest.mark.parametrize("case", list(DW_CASES))
def test_depthwise_mirror_equals_the_plain_conv(case):
    shape, strides, tile = DW_CASES[case]
    c = shape[-1]
    q, wq = _ints(shape, 5), _ints((3, 3, 3, 1, c), 6)
    kw = dict(zip(("cs", "tz", "ty"), tile)) if tile else {}
    plan = plan_qconv(shape, (3, 3, 3, 1, c), strides, c, **kw)
    assert plan.variant == "depthwise"
    assert torch.equal(depthwise_mirror(q, wq, strides, plan), qconv_s32(q, wq, strides, c))


# ---------------------------------------------------------------- the new ops' plain versions
def _operands(shape, wshape, seed):
    rng = np.random.default_rng(seed)
    cout = wshape[-1]
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, cout) / (64 * 64 * np.sqrt(
        np.prod(wshape[:4])))).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32))
    sx = torch.from_numpy(rng.uniform(0.01, 0.03, 2).astype(np.float32))
    return _ints(shape, seed), _ints(wshape, seed + 1), scale, bias, sx


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("groups", [1, 8])
def test_codes_op_is_requantize_of_the_float32_conv(groups, n):
    wshape = (3, 3, 3, 8 // groups, 8)
    q, wq, scale, bias, sx = _operands((2, 5, 6, 7, 8), wshape, 7)
    got = qconv_codes_cuda(q, wq, scale, bias, sx[:n], 2, groups, True)
    y = qconv_reference(q, wq, scale, bias, 2, groups, True)
    want = torch.stack([requantize(y, s) for s in sx[:n]])
    assert got.dtype == torch.int8 and got.shape == (n, 2, 3, 3, 4, 8)
    assert torch.equal(got, want)
    assert torch.equal(got, qconv_codes_reference(q, wq, scale, bias, sx[:n], 2, groups, True))
    assert len(got.unique()) > 20  # the codes spread over the int8 range


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codes_op_quantizes_an_image_as_it_loads(dtype):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(0, 1, (2, 6, 6, 6, 1)).astype(np.float32)).to(dtype)
    _, wq, scale, bias, sx = _operands((2, 6, 6, 6, 1), (3, 3, 3, 1, 16), 9)
    sx_in = torch.tensor(0.02)
    got = qconv_codes_cuda(x, wq, scale, bias, sx[:1], 2, 1, True, sx_in)
    q = requantize(x.float(), sx_in)
    want = requantize(qconv_reference(q, wq, scale, bias, 2, 1, True), sx[0])[None]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="needs sx_in"):
        qconv_codes_cuda(x, wq, scale, bias, sx[:1], 2)


def test_heads_op_is_the_float32_conv_split():
    q, wq, scale, bias, _ = _operands((2, 3, 4, 5, 32), (3, 3, 3, 32, 16), 10)
    lo, cl = qconv_heads_cuda(q, wq, scale, bias, 12)
    y = qconv_reference(q, wq, scale, bias)
    assert lo.is_contiguous() and cl.is_contiguous()
    assert torch.equal(lo, y[..., :12]) and torch.equal(cl, y[..., 12:])
    assert all(torch.equal(a, b) for a, b in zip((lo, cl), qconv_heads_reference(
        q, wq, scale, bias, 12)))
    with pytest.raises(ValueError, match="split"):
        qconv_heads_cuda(q, wq, scale, bias, 16)


def test_new_ops_export_with_their_fakes():
    """The codes and heads ops trace under torch.export (their fakes give
    the shapes) and run from the exported program."""
    q, wq, scale, bias, sx = _operands((1, 4, 4, 4, 16), (3, 3, 3, 16, 16), 11)

    class Two(torch.nn.Module):
        def forward(self, x):
            codes = qconv_codes_cuda(x, wq, scale, bias, sx, 1, 1, True)
            return qconv_heads_cuda(codes[1], wq, scale, bias, 12)

    ep = torch.export.export(Two(), (q,))
    ops = {n.target.name() for n in ep.graph.nodes if n.op == "call_function"
           and isinstance(n.target, torch._ops.OpOverload) and n.target.namespace == "msl"}
    assert ops == {"msl::qconv_codes", "msl::qconv_heads"}
    got = ep.module()(q)
    want = Two()(q)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------- the fused forward
@pytest.fixture(scope="module")
def carried():
    """JAX's quantized model (``tests/test_quant.py``'s, 32^3, width 0.25)
    carried to the port, and its input."""
    jcfg, _, variables, x = _model_and_variables()
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(32, 32, 32),
                             width_mult=0.25)
    jfolded = jq.fold_ssd3d(jcfg, variables)
    ref = jq.quantize(jfolded, jq.calibrate(jfolded, np.asarray(x)))

    def carry(spec):
        out = {k: v for k, v in spec.items() if k not in ("wq", "sx", "scale", "b")}
        out.update({k: torch.from_numpy(np.array(spec[k])) for k in ("wq", "sx", "scale", "b")})
        return out

    ours = dict(layers=[carry(s) for s in ref["layers"]],
                heads={k: tuple(carry(s) for s in v) for k, v in ref["heads"].items()},
                feature_layers=ref["feature_layers"], config=cfg)
    state_dict = from_jax_variables(variables["params"], variables["batch_stats"], cfg)
    return ref, ours, np.asarray(x), cfg, state_dict


def test_fused_forward_equals_the_float32_chain(carried):
    _, ours, x, _, _ = carried
    with torch.no_grad():
        fused = quant.quantized_forward(ours, torch.from_numpy(x))
        chain = quant.quantized_forward_chain(ours, torch.from_numpy(x))
    assert all(torch.equal(a, b) for a, b in zip(fused, chain))


def test_fused_forward_within_the_jax_bound(carried):
    """Within ``test_quantized_forward_matches_jax``'s 1e-3 (relative,
    Frobenius) of JAX's ``quantized_forward`` on a seeded numpy input."""
    ref, ours, _, _, _ = carried
    x = np.random.default_rng(12).normal(0, 1, (2, 32, 32, 32, 1)).astype(np.float32)
    jl, js = jax.jit(lambda v: jq.quantized_forward(ref, v))(jnp.asarray(x))
    with torch.no_grad():
        locs, scores = quant.quantized_forward(ours, torch.from_numpy(x))

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(locs.numpy(), jl) < 1e-3 and rel(scores.numpy(), js) < 1e-3


def test_module_runs_the_fused_program(carried):
    """QuantizedSSD3D holds the fused program (sx_out a conv, one head conv
    a feature layer); its forward, from float32 and bf16 images, equals the
    chain over its own qmodel(), whose heads are views of the fused head."""
    _, ours, x, _, _ = carried
    module = quant.QuantizedSSD3D(ours)
    program = module.program()
    layers = program["layers"]
    for i, spec in enumerate(layers):
        want = ([layers[i + 1]["sx"]] if i + 1 < len(layers) else []) + (
            [program["heads"][spec["emit"]]["sx"]] if spec["emit"] is not None else [])
        assert torch.equal(spec["sx_out"], torch.stack(want))
    assert [len(s["sx_out"]) for s in layers].count(2) == 2  # layers 3 and 5 feed their heads
    qm = module.qmodel()
    for k, (loc, cls) in qm["heads"].items():
        fused = program["heads"][k]
        assert fused["split"] == loc["wq"].shape[-1] == 12 and cls["wq"].shape[-1] == 4
        assert torch.equal(torch.cat([loc["wq"], cls["wq"]], -1), fused["wq"])
        assert torch.equal(loc["wq"], torch.as_tensor(ours["heads"][k][0]["wq"]))
    for dtype in (torch.float32, torch.bfloat16):
        xi = torch.from_numpy(x).to(dtype)
        with torch.no_grad():
            got = module(xi)
            want = quant.quantized_forward_chain(qm, xi)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), dtype


def test_heads_with_two_scales_raise(carried):
    _, ours, _, _, _ = carried
    k = ours["feature_layers"][0]
    loc, cls = ours["heads"][k]
    with pytest.raises(ValueError, match="share one activation scale"):
        quant.fuse_heads(loc, {**cls, "sx": cls["sx"] * 2})


def test_fast_code_path_equals_the_division():
    """csrc/qconv.cu's ``code``: y times the reciprocal RN(1 / sx), with the
    exact division where that lies within 1e-3 of a half-integer, rounds
    and clamps as ``requantize`` (the correctly rounded y / sx) does: on
    random values, on exact ties (integers over 2, 0.5, 0.25) and next to
    them, for many scales. float32 arithmetic in numpy rounds as the
    card's __fmul_rn, __frcp_rn and __fdiv_rn do."""
    rng = np.random.default_rng(14)
    scales = np.concatenate([rng.uniform(1e-6, 10, 200), [2.0, 0.5, 0.25, 1 / 3, 0.1, 1.0]])
    for sx in scales.astype(np.float32):
        ties = (np.arange(-300, 300) + 0.5).astype(np.float32) * sx
        near = np.concatenate([np.nextafter(ties, np.float32(np.inf)),
                               np.nextafter(ties, np.float32(-np.inf))])
        y = np.concatenate([ties, near, rng.normal(0, 130, 2000).astype(np.float32) * sx,
                            rng.normal(0, 1e4, 100).astype(np.float32)]).astype(np.float32)
        rcp = np.float32(1) / sx
        q = (y * rcp).astype(np.float32)
        exact = np.abs(q - np.floor(q) - np.float32(0.5)) < np.float32(1e-3)
        q = np.where(exact, y / sx, q)
        fast = np.clip(np.rint(q), -127, 127).astype(np.int8)
        want = requantize(torch.from_numpy(y), torch.tensor(sx)).numpy()
        np.testing.assert_array_equal(fast, want, err_msg=f"sx={sx}")


def test_heads_op_on_a_single_voxel():
    """A feature map of one voxel at batch 1 (the deepest layer of a small
    model): the two outputs are new tensors, as a registered op's must be."""
    q, wq, scale, bias, _ = _operands((1, 1, 1, 1, 32), (3, 3, 3, 32, 16), 15)
    lo, cl = qconv_heads_cuda(q, wq, scale, bias, 12)
    y = qconv_reference(q, wq, scale, bias)
    assert lo.data_ptr() != cl.data_ptr()
    assert torch.equal(lo, y[..., :12]) and torch.equal(cl, y[..., 12:])
