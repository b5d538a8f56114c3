"""The fused depthwise kernel's planner (K2) and a torch mirror of its tiled walk.

``plan_depthwise`` is pure Python, so it runs here without a card. The
mirror below rebuilds what ``csrc/depthwise.cu::dw_tiled_kernel`` does from
a plan: CTA ``blockIdx.x`` decomposed into (slice, band, slab, sample), the
CTA's input planes with their zero halo, the loader's walk over pixels with
carries, and each output row summed with a three-column register window in
(kd, kh, kw) order. It must equal the plain version bit for bit,
and the JAX kernel within the tolerance ``tests/test_torch_port_depthwise.py``
states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu.kernels.depthwise import fused_depthwise_bn_relu
from mslesions3d_tpu_torch.kernels.depthwise import (
    MAX_THREADS,
    SMEM_MAX,
    SMEM_TWO_PER_SM,
    DepthwisePlan,
    depthwise_bn_relu,
    fold_bn,
    plan_depthwise,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# K2's inputs in the 96^3 model at width 1.0 (layers 3, 5, 7): (C, spatial)
LAYERS = {3: (128, 12), 5: (256, 6), 7: (512, 3)}
# the card tests' shapes (tests/test_torch_gpu_depthwise.py)
CARD_SHAPES = [(8, 128, 12, 12, 12), (8, 256, 6, 6, 6), (8, 512, 3, 3, 3), (2, 128, 1, 8, 8),
               (2, 128, 2, 5, 7), (3, 130, 3, 4, 4), (1, 6, 2, 3, 3), (32, 128, 12, 12, 12),
               (1, 128, 16, 16, 16), (2, 128, 4, 9, 17), (3, 256, 1, 1, 1)]


def ceil_div(a, b):
    return -(-a // b)


def element_size(dtype):
    return torch.empty((), dtype=dtype).element_size()


def model_shapes():
    """K2's shapes at inputs 64^3-128^3 (spatial / 8, / 16, / 32), batch 1-32."""
    for size in (64, 96, 128):
        for layer, (c, _) in LAYERS.items():
            n = size // 2 ** (layer // 2 + 2)
            for b in (1, 8, 32):
                yield b, c, n, n, n


def slices(plan, c):
    return [(lo, min(c, lo + plan.cs)) for lo in range(0, c, plan.cs)]


def cta_tiles(plan, shape):
    """(sample, c0, c1, d0, depths, h0) of every CTA, as the kernel decomposes blockIdx."""
    b, c, d, h, _ = shape
    ns, nbands, nslabs = ceil_div(c, plan.cs), ceil_div(h, plan.th), ceil_div(d, plan.td)
    assert plan.grid == b * nslabs * nbands * ns
    for cta in range(plan.grid):
        r = cta
        sl, r = r % ns, r // ns
        band, r = r % nbands, r // nbands
        slab, bi = r % nslabs, r // nslabs
        c0 = sl * plan.cs
        yield bi, c0, min(c, c0 + plan.cs), slab * plan.td, min(plan.td, d - slab * plan.td), \
            band * plan.th


def loader_pixels(plan, shape, csv, e):
    """The (pixel, chunk) pairs the kernel's threads copy or zero, walking with carries."""
    w = shape[-1]
    wp, npix = w + 2, (plan.th + 2) * (w + 2)
    nch = csv * e // plan.vec
    pstep = plan.threads // nch
    step_r, step_c = divmod(pstep, wp)
    seen = []
    for tid in range(pstep * nch):
        q, p0 = tid % nch, tid // nch
        row, col = divmod(p0, wp)
        for p in range(p0, npix, pstep):
            assert (row, col) == divmod(p, wp)
            seen.append((p, q))
            col, row = col + step_c, row + step_r
            if col >= wp:
                col, row = col - wp, row + 1
    return seen


def tiled_mirror(x, weights, gamma, beta, plan):
    """The tiled kernel's walk in torch: x (B, C, D, H, W) -> out, and writes per element."""
    b, c, d, h, w = x.shape
    e = x.element_size()
    xs = x.permute(0, 2, 3, 4, 1).float()
    wt, g, bt = weights.float(), gamma.float(), beta.float()
    out = torch.zeros((b, d, h, w, c), dtype=torch.float32)
    writes = torch.zeros((b, d, h, w, c), dtype=torch.int32)
    for bi, c0, c1, d0, td, h0 in cta_tiles(plan, x.shape):
        # the CTA's planes d0-1 .. d0+td, rows h0-1 .. h0+th, columns -1 .. W, zero outside
        assert (c1 - c0) * e % plan.vec == 0 and plan.cs * e % plan.vec == 0
        npix = (plan.th + 2) * (w + 2)
        pixels = loader_pixels(plan, x.shape, c1 - c0, e)
        assert sorted(pixels) == [(p, q) for p in range(npix)
                                  for q in range((c1 - c0) * e // plan.vec)]
        tile = torch.zeros((td + 2, plan.th + 2, w + 2, c1 - c0))
        for pl in range(td + 2):
            for row in range(plan.th + 2):
                gd, gh = d0 - 1 + pl, h0 - 1 + row
                if 0 <= gd < d and 0 <= gh < h:
                    tile[pl, row, 1:w + 1] = xs[bi, gd, gh, :, c0:c1]
        for i in range(td):
            rows = min(plan.th, h - h0)
            # column j of every output row of plane i: (9, rows, channels), (kd, kh) order
            def column(j):
                return torch.stack([tile[i + kd, kh:kh + rows, j] for kd in range(3)
                                    for kh in range(3)])
            win = [column(0), column(1)]
            for wi in range(w):
                win.append(column(wi + 2))
                acc = torch.zeros((rows, c1 - c0))
                for k in range(9):
                    kd, kh = divmod(k, 3)
                    for kw in range(3):
                        acc = acc + win[kw][k] * wt[kd, kh, kw, c0:c1]
                out[bi, d0 + i, h0:h0 + rows, wi, c0:c1] = torch.relu(acc * g[c0:c1] + bt[c0:c1])
                writes[bi, d0 + i, h0:h0 + rows, wi, c0:c1] += 1
                win.pop(0)
    return out.to(x.dtype).permute(0, 4, 1, 2, 3), writes


def inputs(shape, dtype, seed):
    """x (B, C, D, H, W) channels_last_3d, weights, gamma, beta from numpy."""
    rng = np.random.default_rng(seed)
    b, c, d, h, w = shape
    x = torch.from_numpy(rng.normal(size=(b, d, h, w, c)).astype(np.float32))
    weights = torch.from_numpy(rng.normal(0, 0.3, (3, 3, 3, c)).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    beta = torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32))
    return x.to(dtype).permute(0, 4, 1, 2, 3), weights.to(dtype), gamma, beta


# ---------------------------------------------------------------- the planner
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_model_shapes_take_the_tiled_kernel(dtype):
    dt, e = DTYPES[dtype], element_size(DTYPES[dtype])
    for shape in model_shapes():
        b, c, d, h, w = shape
        plan = plan_depthwise(dt, shape)
        assert plan.variant == "tiled", shape
        assert plan.smem == (plan.td + 2) * (plan.th + 2) * (w + 2) * plan.cs * e
        assert plan.smem <= SMEM_MAX
        assert plan.cs == 64 and plan.vec == 16 and c % plan.cs == 0
        assert plan.threads == 32 * min(8, plan.th)  # a walker a row, at most 8
        assert 1 <= plan.td <= 4 and 1 <= plan.th <= h
        list(cta_tiles(plan, shape))  # the grid is the decomposition's


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layer", list(LAYERS))
def test_headline_batch_8_fills_the_card(layer, dtype):
    c, n = LAYERS[layer]
    plan = plan_depthwise(DTYPES[dtype], (8, c, n, n, n))
    assert plan.grid >= 132  # a CTA for each of the H100's 132 SMs, at least
    assert plan.variant == "tiled" and plan.smem <= SMEM_TWO_PER_SM


def test_headline_layer_3_tiles():
    """Batch 8: slabs of 3 depths and bands of 3 rows, 256 CTAs of 3 walkers,
    so every SM has work (slabs of 3 and all 12 rows would leave 4 idle).
    Batch 32: slabs of 3 and all rows, 256 CTAs of 8 walkers."""
    assert plan_depthwise(torch.bfloat16, (8, 128, 12, 12, 12)) == DepthwisePlan(
        "tiled", grid=256, threads=96, smem=44_800, cs=64, td=3, th=3, vec=16)
    assert plan_depthwise(torch.bfloat16, (32, 128, 12, 12, 12)) == DepthwisePlan(
        "tiled", grid=256, threads=256, smem=125_440, cs=64, td=3, th=12, vec=16)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_card_test_shapes_take_the_tiled_kernel(shape, dtype):
    plan = plan_depthwise(DTYPES[dtype], shape)
    assert plan.variant == "tiled" and plan.smem <= SMEM_MAX
    assert plan.threads % (plan.cs // 2) == 0 and plan.threads <= MAX_THREADS
    list(cta_tiles(plan, shape))


@pytest.mark.parametrize("c, widths", [(130, [64, 64, 2]), (6, [6]), (66, [64, 2]),
                                       (512, [64] * 8)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_channel_slices_cover_c(c, widths, dtype):
    plan = plan_depthwise(DTYPES[dtype], (2, c, 3, 4, 4))
    assert [hi - lo for lo, hi in slices(plan, c)] == widths
    assert plan.threads % (plan.cs // 2) == 0
    e = element_size(DTYPES[dtype])
    assert all((hi - lo) * e % plan.vec == 0 for lo, hi in slices(plan, c))


@pytest.mark.parametrize("dtype, align, c, vec", [
    ("bfloat16", 16, 128, 16), ("bfloat16", 16, 130, 4), ("bfloat16", 4, 128, 4),
    ("bfloat16", 8, 128, 8), ("float32", 16, 130, 8), ("float32", 8, 128, 8)])
def test_copy_width_follows_channels_and_alignment(dtype, align, c, vec):
    assert plan_depthwise(DTYPES[dtype], (1, c, 2, 3, 4), align).vec == vec


@pytest.mark.parametrize("dtype, widest", [("float32", 3226), ("bfloat16", 6454)])
def test_direct_variant_only_where_no_tile_fits(dtype, widest):
    dt = DTYPES[dtype]
    tiled = plan_depthwise(dt, (1, 2, 1, 1, widest))
    assert tiled.variant == "tiled" and (tiled.cs, tiled.th, tiled.td) == (2, 1, 1)
    assert tiled.smem <= SMEM_MAX
    assert plan_depthwise(dt, (1, 2, 1, 1, widest + 1)) == DepthwisePlan("direct")
    wide = plan_depthwise(dt, (1, 128, 2, 3, 4000))
    assert wide.variant == ("direct" if dtype == "float32" else "tiled")


def test_large_planes_shrink_rows_then_channels():
    plan = plan_depthwise(torch.float32, (1, 128, 4, 64, 32))
    assert plan.cs == 64 and plan.th <= 2 and plan.smem <= SMEM_MAX
    plan = plan_depthwise(torch.float32, (1, 128, 4, 64, 64))  # one row exceeds two a SM
    assert (plan.cs, plan.th) == (64, 1) and SMEM_TWO_PER_SM < plan.smem <= SMEM_MAX
    plan = plan_depthwise(torch.float32, (1, 128, 4, 8, 1000))
    assert (plan.cs, plan.th) == (4, 1) and plan.smem <= SMEM_MAX


def test_fixed_tile_that_does_not_fit_raises():
    with pytest.raises(ValueError, match="shared memory"):
        plan_depthwise(torch.float32, (1, 128, 12, 12, 12), cs=64, td=8, th=12)
    with pytest.raises(ValueError, match="td <= 8"):
        plan_depthwise(torch.bfloat16, (1, 2, 12, 1, 1), td=9)
    unfixed = plan_depthwise(torch.float32, (1, 128, 12, 12, 12), td=8, th=12)
    assert unfixed.cs < 64 and unfixed.smem <= SMEM_MAX  # cs gives way
    with pytest.raises(ValueError, match="variant"):
        plan_depthwise(torch.float32, (1, 128, 12, 12, 12), variant="fast")
    forced = plan_depthwise(torch.float32, (1, 128, 12, 12, 12), variant="direct")
    assert forced.variant == "direct"


# ---------------------------------------------------------------- the mirror
RAGGED = {
    # name: (shape, fixed tile); slabs, bands and slices with remainders
    "slices 64+64+2": ((2, 130, 3, 4, 4), {}),
    "slice of 6": ((1, 6, 2, 3, 3), {}),
    "one voxel": ((3, 256, 1, 1, 1), {}),
    "slab 2+2+1, band 3+3+1": ((2, 130, 5, 7, 9), dict(td=2, th=3)),
    "slices 4+4+2, slab 2+1": ((1, 10, 3, 3, 5), dict(cs=4, td=2)),
    "layer 3 tile in float32": ((1, 128, 12, 12, 12), {}),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(RAGGED))
def test_mirror_equals_the_plain_version(case, dtype):
    shape, tile = RAGGED[case]
    dt = DTYPES[dtype]
    if case == "layer 3 tile in float32":  # the plan the float32 model's layer 3 takes
        tile = {k: getattr(plan_depthwise(torch.float32, (8, *shape[1:])), k) for k in ("td", "th")}
    plan = plan_depthwise(dt, shape, **tile)
    assert plan.variant == "tiled"
    x, w, gamma, beta = inputs(shape, dt, seed=sum(shape))
    out, writes = tiled_mirror(x, w, gamma, beta, plan)
    assert bool((writes == 1).all())  # every output element once
    plain = depthwise_bn_relu(x, w, gamma, beta)
    assert float((plain == 0).float().mean()) > 0.1  # ReLU bites
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_mirror_keeps_nan_like_the_plain_version():
    x, w, gamma, beta = inputs((1, 8, 3, 3, 3), torch.float32, seed=2)
    x[0, 5, 1, 1, 1] = float("nan")
    plan = plan_depthwise(torch.float32, x.shape, cs=4, th=2)
    out, _ = tiled_mirror(x, w, gamma, beta, plan)
    assert int(torch.isnan(out[0, 5]).sum()) == 27
    torch.testing.assert_close(out, depthwise_bn_relu(x, w, gamma, beta), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mirror_matches_jax_kernel(dtype):
    """The same walk against the Pallas kernel in interpret mode, on numpy
    inputs from a seed: rtol/atol 1e-5 in float32 (XLA may contract an FMA),
    one bf16 ulp in bfloat16."""
    shape = (2, 128, 4, 6, 5)  # (B, C, D, H, W)
    rng = np.random.default_rng(11)
    b, c, d, h, w = shape
    x = rng.normal(size=(b, d, h, w, c)).astype(np.float32)
    wts = rng.normal(size=(3, 3, 3, c)).astype(np.float32)
    bn = [np.abs(rng.normal(size=c)) + 0.5, rng.normal(size=c), rng.normal(size=c),
          np.abs(rng.normal(size=c)) + 0.5]
    bn = [v.astype(np.float32) for v in bn]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    gamma, beta = fold_bn(*(torch.from_numpy(v) for v in bn))
    ref = np.asarray(fused_depthwise_bn_relu(
        jnp.asarray(x).astype(jdt), jnp.asarray(wts).astype(jdt), jnp.asarray(gamma.numpy()),
        jnp.asarray(beta.numpy()), interpret=True), np.float32)
    dt = DTYPES[dtype]
    xt = torch.from_numpy(x).to(dt).permute(0, 4, 1, 2, 3)
    plan = plan_depthwise(dt, shape, td=3, th=4)  # a ragged slab and band
    out, _ = tiled_mirror(xt, torch.from_numpy(wts).to(dt), gamma, beta, plan)
    ours = out.permute(0, 2, 3, 4, 1).float().numpy()
    assert float(np.abs(ref).max()) > 1.0 and float((ref == 0).mean()) > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    else:
        mag = np.maximum(np.maximum(np.abs(ours), np.abs(ref)), 2.0 ** -126)
        assert (np.abs(ours - ref) <= 2.0 ** (np.floor(np.log2(mag)) - 7)).all()
