"""The PyTorch port's NMS and detect path against the JAX package.

The port's plain greedy NMS (the version CPU tensors use, and the one the
CUDA kernel is held to on the card) must equal JAX ``greedy_nms`` and the
Pallas kernel in interpret mode exactly: keep masks are booleans, so there
is no tolerance. A numpy emulation of the CUDA kernel's bitmask algorithm
(the mask words with the transposed diagonal blocks, and the walks that
resolve one 64-candidate word at a time: the warp walk up to K = 2048, the
wide walk with 3, 2, 1 or 0 staged words past it) checks its design here,
where the kernel itself cannot run, up to K = 3942, the 96^3 headline's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu.kernels.nms import greedy_nms_pallas
from mslesions3d_tpu.models.priors import default_scales, generate_priors
from mslesions3d_tpu.ops.nms import detect_objects as jax_detect_objects
from mslesions3d_tpu.ops.nms import greedy_nms as jax_greedy_nms
from mslesions3d_tpu_torch.kernels.nms import greedy_nms_cuda, mask_words, plan_nms
from mslesions3d_tpu_torch.ops.boxes import pairwise_iou
from mslesions3d_tpu_torch.ops.nms import (
    detect_objects,
    detections_to_lists,
    greedy_nms,
    greedy_nms_sequential,
    top_k_stable,
)


def _clustered_case():
    """tests/test_kernels.py: K=200 (not a multiple of 32 or 128), random validity."""
    rng = np.random.default_rng(3)
    n, k = 4, 200
    centers = rng.uniform(0.2, 0.8, size=(n, 25, 3))
    idx = rng.integers(0, 25, size=(n, k))
    lo = np.clip(
        np.take_along_axis(centers, idx[..., None], 1)
        + rng.normal(0, 0.03, (n, k, 3)) - 0.04, 0, 1,
    )
    hi = np.clip(lo + rng.uniform(0.04, 0.12, (n, k, 3)), 0, 1)
    boxes = np.concatenate([lo, hi], -1).astype(np.float32)
    return boxes, rng.uniform(size=(n, k)) > 0.15


def _prefix_case():
    """tests/test_kernels.py: prefix validity 90 / 200 / all of 384."""
    rng = np.random.default_rng(9)
    n, k = 3, 384
    lo = rng.uniform(0, 0.7, (n, k, 3)).astype(np.float32)
    hi = np.clip(lo + rng.uniform(0.05, 0.3, (n, k, 3)), 0, 1).astype(np.float32)
    valid = np.zeros((n, k), bool)
    valid[0, :90] = True
    valid[1, :200] = True
    valid[2, :] = True
    return np.concatenate([lo, hi], -1), valid


def _near_threshold_case():
    """Pairs whose IoU straddles 0.5 by a few ulps, plus empty boxes (0/0).

    Two unit-size cubes offset by s along one axis have IoU (1-s)/(1+s),
    which is 0.5 at s = 1/3; s steps through the float32 neighbours of 1/3.
    """
    rng = np.random.default_rng(11)
    third = np.float32(1.0) / np.float32(3.0)
    shifts = [third]
    for _ in range(6):
        shifts = [np.nextafter(shifts[0], np.float32(0)), *shifts, np.nextafter(shifts[-1], np.float32(1))]
    rows = []
    for s in shifts:
        scale = np.float32(rng.choice([0.125, 0.25, 0.1, 0.3]))
        base = rng.uniform(0, 0.3, 3).astype(np.float32)
        a = np.concatenate([base, base + scale])
        b = a.copy()
        axis = rng.integers(0, 3)
        b[axis] += s * scale
        b[axis + 3] += s * scale
        empty = np.concatenate([base, base])  # zero volume: IoU 0/0 with itself
        rows.append(np.stack([a, b, empty, empty]).astype(np.float32))
    boxes = np.stack(rows)  # (13, 4, 6)
    return boxes, np.ones(boxes.shape[:2], bool)


def _chain_case():
    """Box i suppresses box i + 1 only (IoU 0.54, then 0.25): the greedy
    answer alternates, so each word's fixpoint needs all of its rounds.
    Row 1 drops every seventh candidate and ends before K."""
    k = 150
    lo = np.zeros((2, k, 3), np.float32)
    lo[:, :, 0] = np.arange(k, dtype=np.float32) * np.float32(0.3)
    valid = np.ones((2, k), bool)
    valid[1, 5::7] = False
    valid[1, 140:] = False
    return np.concatenate([lo, lo + 1], -1), valid


CASES = {"clustered_k200": _clustered_case, "prefix_k384": _prefix_case,
         "near_threshold": _near_threshold_case, "chain_k150": _chain_case}


def _large_case(k):
    """Clustered candidates past the warp walk's 2048; row 1 ends its valid
    candidates early, so the walk stops before the last word."""
    def make():
        rng = np.random.default_rng(k)
        n = 2
        centers = rng.uniform(0.2, 0.8, size=(n, 60, 3))
        idx = rng.integers(0, 60, size=(n, k))
        lo = np.clip(np.take_along_axis(centers, idx[..., None], 1)
                     + rng.normal(0, 0.03, (n, k, 3)) - 0.04, 0, 1)
        hi = np.clip(lo + rng.uniform(0.04, 0.12, (n, k, 3)), 0, 1)
        valid = rng.uniform(size=(n, k)) > 0.15
        valid[1, k - 700:] = False
        return np.concatenate([lo, hi], -1).astype(np.float32), valid
    return make


LARGE_CASES = {"clustered_k2049": _large_case(2049), "clustered_k3942": _large_case(3942)}


def _jax_keep(boxes, valid):
    return np.stack([
        np.asarray(jax_greedy_nms(jnp.asarray(boxes[i]), jnp.asarray(valid[i]), 0.5))
        for i in range(boxes.shape[0])
    ])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_nms_equals_jax_and_pallas(case):
    boxes, valid = CASES[case]()
    ours = greedy_nms(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5).numpy()
    np.testing.assert_array_equal(ours, _jax_keep(boxes, valid))
    pallas = np.asarray(
        greedy_nms_pallas(jnp.asarray(boxes), jnp.asarray(valid), 0.5, interpret=True)
    )
    np.testing.assert_array_equal(ours, pallas)
    if case == "near_threshold":  # the case must really sit on both sides of t
        assert ours[:, 1].any() and not ours[:, 1].all()


@pytest.mark.parametrize("case", list(CASES))
def test_sequential_oracle_equals_fixpoint(case):
    boxes, valid = CASES[case]()
    fix = greedy_nms(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    for i in range(boxes.shape[0]):
        seq = greedy_nms_sequential(torch.from_numpy(boxes[i]), torch.from_numpy(valid[i]), 0.5)
        np.testing.assert_array_equal(seq.numpy(), fix[i].numpy())


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    boxes, valid = _clustered_case()
    before = greedy_nms_cuda.launches
    keep = greedy_nms_cuda(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    assert greedy_nms_cuda.launches == before  # no kernel was launched
    np.testing.assert_array_equal(keep.numpy(), _jax_keep(boxes, valid))


def walk_smem_bytes(k, stages=None):
    """csrc/nms.cu walk_smem_bytes (the warp walk, stages None): three
    buffers of 64 mask rows and of one 64-word diagonal block; and
    wide_smem_bytes: ``stages`` such buffers, then the removed bitset of
    mask_words(k) words, the kept word and the count."""
    if stages is None:
        return 3 * 64 * (mask_words(k) + 1) * 8
    return (stages * 64 * (mask_words(k) + 1) + mask_words(k) + 2) * 8


def test_max_k_is_the_largest_that_fits_shared_memory():
    # the warp walk holds one 64-candidate word per lane: 32 words, K <= 2048
    assert plan_nms(2048).walk == "warp" and plan_nms(2049).walk == "wide"
    assert walk_smem_bytes(2048) <= 232_448
    assert walk_smem_bytes(1000) == 26_112  # the headline K: 16 words per row
    assert [mask_words(k) for k in (1, 64, 65, 1000, 1025, 2048)] == [2, 2, 2, 16, 18, 32]
    # each wide stage count takes K up to the largest whose buffers fit 227 KB
    for stages, k_max in ((3, 9472), (2, 14336), (1, 28544)):
        assert walk_smem_bytes(k_max, stages) <= 232_448 < walk_smem_bytes(k_max + 64, stages)
        assert plan_nms(k_max).stages == stages
        assert plan_nms(k_max + 1).stages == stages - 1
    with pytest.raises(ValueError, match="warp walk"):
        plan_nms(2049, walk="warp")
    with pytest.raises(ValueError, match="no wide walk with 3 stages fits K=9473"):
        plan_nms(9473, walk="wide", stages=3)


@pytest.mark.parametrize("k, walk, stages", [
    (1000, "warp", 3), (2048, "warp", 3), (3942, "wide", 3), (9600, "wide", 2),
    (9601, "wide", 2), (30000, "wide", 0),
])
def test_stage_plan(k, walk, stages):
    """The walk and staged words plan_nms picks, its shared memory, and a
    mask grid with no dimension past 65535 that covers the triangle."""
    plan = plan_nms(k)
    assert (plan.walk, plan.stages) == (walk, stages)
    assert plan.smem == walk_smem_bytes(k, None if walk == "warp" else stages) <= 232_448
    nw = -(-k // 64)
    gy, gz = plan.mask_grid
    assert max(gy, gz) <= 65_535 and gy * gz >= nw * (nw + 1) // 2 > gy * (gz - 1)
    if k == 30000:  # past what one staged word's rows take; 2 grid planes
        assert walk_smem_bytes(k, 1) > 232_448 and gz == 2


ALL64 = (1 << 64) - 1


def _pack_words(bits):
    """(..., 64 w) bools -> (..., w) uint64 words, bit c of word i = bits[64 i + c]."""
    return np.ascontiguousarray(np.packbits(bits, axis=-1, bitorder="little")).view("<u8")


def _bitmask_emulation(boxes, valid, t, rng, plan=None):
    """numpy mirror of csrc/nms.cu: mask words, diagonal blocks, block skips, walks.

    Words the kernel never writes, and shared-memory words the walk never
    stages, are filled with random bits, which proves the walk never reads
    them. The mask rows have mask_words(k) words; a diagonal block is also
    written transposed (word i: the j < i of the same 64 that suppress i).
    The walk resolves a word at a time: the fixpoint of kept = live &
    ~(suppressed by kept) from kept = live, then the kept rows OR into the
    later words' removed bits, from staged rows (the warp walk stages words
    c0 = (w+1) & ~1 up to nwp, the wide walk up to the even count of words
    in play) or, with 0 stages, from the mask rows in global memory.
    """
    n, k, _ = boxes.shape
    plan = plan or plan_nms(k)
    nw, nwp = -(-k // 64), mask_words(k)
    iou = pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    jj, ii = np.arange(k)[:, None], np.arange(k)[None, :]
    sup = np.zeros((n, k, nw * 64), bool)
    sup[:, :, :k] = (iou > t) & (ii > jj)
    words = _pack_words(sup)  # (n, k, nw)
    mask = rng.integers(0, 2**63, size=(n, k, nwp), dtype=np.uint64)  # torch.empty garbage
    diag_t = rng.integers(0, 2**63, size=(n, nwp, 64), dtype=np.uint64)
    for row in range(n):
        for cb in range(nw):
            if not valid[row, cb * 64:].any():
                continue  # block skipped: nothing past its first column is valid
            rows = slice(0, min(k, cb * 64 + 64))  # blocks rb <= cb
            mask[row, rows, cb] = words[row, rows, cb]
            block = np.zeros((64, 64), bool)
            r = min(64, k - cb * 64)
            block[:r] = sup[row, cb * 64:cb * 64 + r, cb * 64:cb * 64 + 64]
            diag_t[row, cb] = _pack_words(block.T)[:, 0]
    keep = np.zeros((n, k), bool)
    for row in range(n):
        idx = np.nonzero(valid[row])[0]
        count = int(idx[-1]) + 1 if idx.size else 0
        used = -(-count // 64)
        staged_to = nwp if plan.walk == "warp" else used + (used & 1)
        removed = [ALL64] * nw  # invalid candidates count as removed
        for i in idx.tolist():
            removed[i // 64] &= ~(1 << (i % 64))
        for w in range(used):
            live = ~removed[w] & ALL64
            cols = [int(diag_t[row, w, lane]) for lane in range(64)]
            kept = live
            while True:  # one round: two ballots in the kernel
                nxt = sum(1 << b for b in range(64) if (live >> b) & 1 and not cols[b] & kept)
                if nxt == kept:
                    break
                kept = nxt
            for b in range(64):
                if w * 64 + b < k:
                    keep[row, w * 64 + b] = bool((kept >> b) & 1)
            src = mask[row, w * 64:w * 64 + 64]  # global memory (0 stages)
            if plan.stages > 0:  # the staged buffer: rows up to count, words c0 ..
                src = rng.integers(0, 2**63, size=(64, nwp), dtype=np.uint64)
                c0, nr = (w + 1) & ~1, min(64, count - w * 64)
                src[:nr, c0:staged_to] = mask[row, w * 64:w * 64 + nr, c0:staged_to]
            kept_rows = [r for r in range(64) if (kept >> r) & 1]  # rows past count: bit 0
            for c in range(w + 1, used):
                for r in kept_rows:
                    removed[c] |= int(src[r, c])
    return keep


def _pallas_keep(boxes, valid):
    return np.asarray(
        greedy_nms_pallas(jnp.asarray(boxes), jnp.asarray(valid), 0.5, interpret=True))


@pytest.mark.parametrize("case", list(CASES) + list(LARGE_CASES))
def test_kernel_bitmask_design_is_exact(case):
    boxes, valid = {**CASES, **LARGE_CASES}[case]()
    rng = np.random.default_rng(1)
    ours = _bitmask_emulation(boxes, valid, 0.5, rng)
    np.testing.assert_array_equal(ours, _jax_keep(boxes, valid))
    np.testing.assert_array_equal(ours, _pallas_keep(boxes, valid))
    if case in LARGE_CASES:
        assert plan_nms(boxes.shape[1]).walk == "wide" and ours.any() and not ours[valid].all()


@pytest.mark.parametrize("stages", [0, 1, 2, 3])
def test_wide_walk_design_is_exact_at_every_stage_count(stages):
    """The wide walk, forced to each staged-word count, on the small cases
    and at the 96^3 headline's K = 3942, against JAX's greedy_nms."""
    rng = np.random.default_rng(stages)
    for case in (*CASES.values(), LARGE_CASES["clustered_k3942"]):
        boxes, valid = case()
        plan = plan_nms(boxes.shape[1], walk="wide", stages=stages)
        ours = _bitmask_emulation(boxes, valid, 0.5, rng, plan)
        np.testing.assert_array_equal(ours, _jax_keep(boxes, valid))


def _detect_inputs(seed=0, batch=3, n_classes=3, size=64):
    priors = generate_priors(
        {3: (size // 16,) * 3, 5: (size // 32,) * 3, 7: (size // 64,) * 3},
        default_scales((3, 5, 7), (size,) * 3, 6.0, 14.0), {3: [1.0], 5: [1.0], 7: [1.0]},
    )
    rng = np.random.default_rng(seed)
    p = priors.shape[0]
    locs = rng.normal(0, 0.5, (batch, p, 6)).astype(np.float32)
    scores = rng.normal(0, 2.0, (batch, p, n_classes)).astype(np.float32)
    return locs, scores, priors


@pytest.mark.parametrize("top_k", [100, 7, 395])
def test_detect_objects_matches_jax(top_k):
    """The test's 64^3 priors (P=146): top_k 100 and 7 give K = 146 and 70.
    top_k = 395 on its 192^3
    priors (P=3942, the 96^3 headline model's count) gives K = 3942, past
    the warp walk's 2048, on one image and one foreground class (the plain
    NMS holds K x K pairs).

    count and labels must be equal; boxes and scores agree to 1e-6 (both
    sides run the same float32 softmax and decode, which may round
    differently by an ulp). Scores are distinct, so top-k order is unique.
    """
    if top_k == 395:
        locs, scores, priors = _detect_inputs(batch=1, n_classes=2, size=192)
        assert min(10 * top_k, priors.shape[0]) == 3942
    else:
        locs, scores, priors = _detect_inputs()
    kw = dict(n_classes=scores.shape[-1], min_score=0.5, max_overlap=0.5, top_k=top_k)
    ref = jax_detect_objects(jnp.asarray(locs), jnp.asarray(scores), jnp.asarray(priors), **kw)
    ours = detect_objects(torch.from_numpy(locs), torch.from_numpy(scores),
                          torch.from_numpy(priors), **kw)
    assert int(np.asarray(ref["count"]).min()) > 0
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(np.shape(v)) for k, v in ref.items()}
    np.testing.assert_array_equal(ours["count"].numpy(), np.asarray(ref["count"]))
    np.testing.assert_array_equal(ours["labels"].numpy(), np.asarray(ref["labels"]))
    np.testing.assert_allclose(ours["scores"].numpy(), np.asarray(ref["scores"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours["boxes"].numpy(), np.asarray(ref["boxes"]), rtol=1e-6, atol=1e-6)


def test_detections_to_lists_placeholder():
    det = {
        "boxes": torch.zeros((2, 3, 6)), "labels": torch.ones((2, 3), dtype=torch.int32),
        "scores": torch.full((2, 3), 0.9), "count": torch.tensor([0, 2], dtype=torch.int32),
    }
    b, l, s = detections_to_lists(det)
    np.testing.assert_array_equal(b[0], [[0, 0, 0, 1, 1, 1]])
    assert l[0].tolist() == [0] and s[0].tolist() == [0.0]
    assert b[1].shape == (2, 6) and l[1].tolist() == [1, 1]


@pytest.mark.parametrize("rows,cols,k,levels", [(3, 40, 10, 4), (2, 1000, 1000, 7), (5, 146, 70, 2)])
def test_top_k_stable_breaks_ties_as_lax_top_k(rows, cols, k, levels):
    """Scores drawn from a few values, so most are tied: values and indices
    equal ``lax.top_k``'s (ties to the lower index)."""
    scores = np.random.default_rng(rows).integers(0, levels, (rows, cols)).astype(np.float32) / 8
    values, idx = top_k_stable(torch.from_numpy(scores), k)
    ref_values, ref_idx = jax.lax.top_k(jnp.asarray(scores), k)
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


@pytest.mark.parametrize("top_k", [100, 7])
def test_detect_objects_with_tied_scores_matches_jax(top_k):
    """Class logits drawn from three values, so most candidates tie (as
    priors whose features are all zero do, on a scan's empty background):
    the selections break ties as the JAX package's ``lax.top_k`` does, so
    the detections equal JAX's in order too (boxes and scores within 1e-6,
    as above)."""
    locs, scores, priors = _detect_inputs(seed=1)
    scores = np.random.default_rng(1).integers(0, 3, scores.shape).astype(np.float32)
    kw = dict(n_classes=scores.shape[-1], min_score=0.3, max_overlap=0.5, top_k=top_k)
    ref = jax_detect_objects(jnp.asarray(locs), jnp.asarray(scores), jnp.asarray(priors), **kw)
    ours = detect_objects(torch.from_numpy(locs), torch.from_numpy(scores),
                          torch.from_numpy(priors), **kw)
    assert int(np.asarray(ref["count"]).min()) > 0
    np.testing.assert_array_equal(ours["count"].numpy(), np.asarray(ref["count"]))
    np.testing.assert_array_equal(ours["labels"].numpy(), np.asarray(ref["labels"]))
    np.testing.assert_allclose(ours["scores"].numpy(), np.asarray(ref["scores"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours["boxes"].numpy(), np.asarray(ref["boxes"]), rtol=1e-6, atol=1e-6)
