"""The port's patch sampling (data/patches.py) and patch steps against the JAX package.

- ``crop_patches``, ``boxes_to_patch`` (boxes inside, straddling and
  outside the patch, degenerate after the clip, padded slots) and
  ``deterministic_patch_starts`` equal the JAX functions exactly on seeded
  non-cubic volumes.
- ``patch_starts_from_draws`` equals a numpy mirror of
  ``mslesions3d_tpu/data/patches.py:46-69`` on the same draws; drawn starts
  have the JAX tests' properties (``tests/test_patches.py``): with
  ``pos_fraction=1`` the chosen box's centre lies in the patch, and with no
  box the starts are uniform.
- The patch train step against JAX's on the same starts: the JAX step reads
  ``data.patches.sample_patch_starts`` while it traces, so the test hands it
  the port's starts (monkeypatched; nothing in the JAX package changes).
  Losses and grad_norm within 1e-5 relative and each gradient leaf within
  1e-4 of its norm, the step tests' bounds; the training forward's
  detections and the patch-frame GT it saw. The gathered patch step equals
  the plain one on the gathered rows.
- The patch eval step (deterministic crop) and its remapped GT against
  JAX's (the GT's boxes within one float32 ulp: XLA fuses the jitted
  step's boxes x volume - start into one multiply-add).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_step import Pair, _close_rel, _np, assert_params_close

import mslesions3d_tpu.data.patches as jax_patches
from mslesions3d_tpu.train import steps as jax_steps
from mslesions3d_tpu_torch.data import patches
from mslesions3d_tpu_torch.train import (
    make_eval_step,
    make_gathered_train_step,
    make_train_step,
)
from mslesions3d_tpu_torch.weights import from_jax_params

VOL = (24, 28, 20)
PATCH = (16, 16, 16)


def _boxes(rng, b, m, n_real):
    """(B, M, 6) fractional boxes over VOL, the first n_real of each row real."""
    lo = rng.uniform(0.0, 0.8, (b, m, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.35, (b, m, 3))], -1).clip(0, 1)
    mask = np.zeros((b, m), bool)
    mask[:, :n_real] = True
    boxes[~mask] = 0.0
    return boxes.astype(np.float32), mask


def test_crop_patches_equals_jax():
    rng = np.random.default_rng(0)
    vols = rng.normal(0, 1, (4, *VOL, 2)).astype(np.float32)
    starts = np.array([[0, 0, 0], [8, 12, 4], [3, 7, 1], [8, 12, 0]], np.int32)
    ref = np.asarray(jax_patches.crop_patches(jnp.asarray(vols), jnp.asarray(starts), PATCH))
    ours = patches.crop_patches(torch.from_numpy(vols), torch.from_numpy(starts), PATCH)
    np.testing.assert_array_equal(ours.numpy(), ref)
    # crops from chosen volumes (the sliding window's work list)
    rows = torch.tensor([2, 2, 0, 3])
    picked = patches.crop_patches(torch.from_numpy(vols), torch.from_numpy(starts), PATCH, rows)
    for i, (r, s) in enumerate(zip(rows.tolist(), starts)):
        np.testing.assert_array_equal(
            picked[i].numpy(), vols[r, s[0]:s[0] + 16, s[1]:s[1] + 16, s[2]:s[2] + 16])


def test_boxes_to_patch_equals_jax():
    rng = np.random.default_rng(1)
    boxes, mask = _boxes(rng, 8, 6, 4)
    v = np.asarray(VOL, np.float32)
    # a box inside, one straddling the patch's low edge, one whose centre is
    # outside, and one that the clip leaves degenerate (its centre inside,
    # but zero extent on one axis)
    boxes[0, :4] = np.array([
        [10, 14, 6, 14, 20, 12], [6, 14, 6, 20, 20, 12], [0, 0, 0, 4, 4, 4],
        [12, 13, 10, 12, 19, 14]], np.float32) / np.concatenate([v, v])
    starts = np.stack([rng.integers(0, s - p + 1, 8) for s, p in zip(VOL, PATCH)], -1)
    starts[0] = (8, 8, 4)
    starts = starts.astype(np.int32)
    ref_boxes, ref_mask = jax_patches.boxes_to_patch(
        jnp.asarray(boxes), jnp.asarray(mask), jnp.asarray(starts), VOL, PATCH)
    ours, our_mask = patches.boxes_to_patch(torch.from_numpy(boxes), torch.from_numpy(mask),
                                            torch.from_numpy(starts), VOL, PATCH)
    np.testing.assert_array_equal(our_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref_boxes))
    assert our_mask[0].tolist() == [True, True, False, False, False, False]
    assert not ours[~our_mask].any()


@pytest.mark.parametrize("n_real", [0, 1, 3])
def test_deterministic_patch_starts_equal_jax(n_real):
    rng = np.random.default_rng(2 + n_real)
    boxes, mask = _boxes(rng, 8, 4, n_real)
    ref = jax_patches.deterministic_patch_starts(VOL, PATCH, jnp.asarray(boxes),
                                                 jnp.asarray(mask))
    ours = patches.deterministic_patch_starts(VOL, PATCH, torch.from_numpy(boxes),
                                              torch.from_numpy(mask))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    if n_real == 0:  # the volume's centre
        assert ours.tolist() == [[4, 6, 2]] * 8


def _mirror_starts(draws, vol_shape, patch, boxes, box_mask, pos_fraction):
    """patches.py:46-69 in numpy, per sample, on given draws: the box as
    jax.random.choice picks it with p (cumulative shares against total x
    (1 - u), first index reaching it)."""
    vol, pat = np.asarray(vol_shape, np.float32), np.asarray(patch, np.float32)
    max_start = vol - pat
    out = []
    for i in range(boxes.shape[0]):
        msk = box_mask[i]
        probs = np.where(msk, 1.0, 0.0).astype(np.float32)
        probs = probs / np.float32(max(probs.sum(), 1.0))
        cdf = np.cumsum(probs, dtype=np.float32)
        r = cdf[-1] * (np.float32(1.0) - draws["choice"][i])
        idx = min(int(np.searchsorted(cdf, r, side="left")), len(msk) - 1)
        center = (boxes[i, idx, :3] + boxes[i, idx, 3:]) * np.float32(0.5) * vol
        lo = np.clip(center - pat + np.float32(1.0), 0.0, max_start)
        hi = np.clip(center, 0.0, max_start)
        pos = lo + draws["jitter"][i] * np.maximum(hi - lo, 0.0)
        uni = draws["uniform"][i] * max_start
        take = (draws["positive"][i] < pos_fraction) and msk.sum() > 0
        out.append(np.floor(pos if take else uni).astype(np.int64))
    return np.stack(out)


@pytest.mark.parametrize("pos_fraction", [0.0, 0.7, 1.0])
def test_starts_from_draws_equal_numpy_mirror(pos_fraction):
    rng = np.random.default_rng(7)
    boxes, mask = _boxes(rng, 16, 5, 3)
    mask[:, :3] = rng.uniform(size=(16, 3)) < 0.6  # real boxes anywhere, some rows none
    mask[3] = False
    gen = torch.Generator().manual_seed(int(pos_fraction * 10))
    draws = patches.draw_patch_params(gen, 16)
    ours = patches.patch_starts_from_draws(draws, VOL, PATCH, torch.from_numpy(boxes),
                                           torch.from_numpy(mask), pos_fraction)
    ref = _mirror_starts({k: v.numpy() for k, v in draws.items()}, VOL, PATCH, boxes, mask,
                         pos_fraction)
    np.testing.assert_array_equal(ours.numpy(), ref)
    max_start = np.asarray(VOL) - np.asarray(PATCH)
    assert (ours.numpy() >= 0).all() and (ours.numpy() <= max_start).all()


def test_drawn_starts_hold_the_chosen_box():
    """pos_fraction=1: every patch holds its one box's centre (the JAX
    test's property, tests/test_patches.py)."""
    vol, b = (48, 48, 48), 16
    rng = np.random.default_rng(1)
    centers = rng.uniform(0.15, 0.85, (b, 3)).astype(np.float32)
    half = 2 / 48
    boxes = torch.from_numpy(np.concatenate([centers - half, centers + half], -1)[:, None])
    starts = patches.sample_patch_starts(torch.Generator().manual_seed(0), vol, PATCH, boxes,
                                         torch.ones((b, 1), dtype=torch.bool), 1.0).numpy()
    vox = centers * 48
    assert ((vox >= starts) & (vox < starts + 16)).all()


def test_drawn_starts_are_uniform_without_boxes():
    starts = patches.sample_patch_starts(
        torch.Generator().manual_seed(3), (40, 40, 40), PATCH, torch.zeros((64, 2, 6)),
        torch.zeros((64, 2), dtype=torch.bool), 1.0).numpy()
    assert (starts >= 0).all() and (starts <= 24).all()
    assert len(np.unique(starts[:, 0])) > 8
    # a uniform start over 0..24: its mean near 12
    assert abs(starts.mean() - 12.0) < 2.5


def _full_batch(seed=0, batch=8):
    """Seeded full volumes of VOL with two painted boxes each."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (batch, *VOL, 1)).astype(np.float32)
    boxes, mask = _boxes(rng, batch, 3, 2)
    v = np.asarray(VOL)
    for i in range(batch):
        for j in range(2):
            lo, hi = (boxes[i, j, :3] * v).astype(int), (boxes[i, j, 3:] * v).astype(int)
            images[i, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2], 0] += 3.0
    labels = mask.astype(np.int32)
    return {"image": images, "boxes": boxes, "labels": labels, "box_mask": mask,
            "batch_mask": np.ones(batch, bool)}


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_patch_train_step_matches_jax(pair, monkeypatch):
    batch = _full_batch()
    gen = torch.Generator().manual_seed(5)
    starts = patches.sample_patch_starts(
        torch.Generator().manual_seed(5), VOL, PATCH, torch.from_numpy(batch["boxes"]),
        torch.from_numpy(batch["box_mask"]), 0.7)
    monkeypatch.setattr(jax_patches, "sample_patch_starts",
                        lambda *a, **k: jnp.asarray(starts.numpy().astype(np.int32)))
    jstep = jax_steps.make_train_step(pair.jcfg, pair.jmodel, pair.priors, donate=False,
                                      return_grads=True, with_detections=True,
                                      patch_training=True)
    step = make_train_step(pair.cfg, pair.model, pair.priors, return_grads=True,
                           with_detections=True, patch_training=True)
    _, jm = jstep(pair.jstate, batch, jax.random.PRNGKey(0))
    new, m = step(pair.state, batch, gen)
    for key in ("total_loss", "conf_loss", "loc_loss", "grad_norm", "n_positives"):
        _close_rel(m[key], jm[key], 1e-5)
    ref_grads = from_jax_params(jax.device_get(jm["grads"]), pair.cfg)
    for name, ref in ref_grads.items():
        norm = float(np.linalg.norm(_np(ref)))
        np.testing.assert_allclose(_np(m["grads"][name]), _np(ref), rtol=0,
                                   atol=1e-4 * max(norm, 1e-12), err_msg=name)
    # the GT the training forward saw: re-mapped into the patch
    np.testing.assert_array_equal(m["aug_box_mask"].numpy(), np.asarray(jm["aug_box_mask"]))
    np.testing.assert_allclose(m["aug_boxes"].numpy(), np.asarray(jm["aug_boxes"]), atol=1e-6)
    assert 0 < int(m["aug_box_mask"].sum()) < int(batch["box_mask"].sum())
    det, jdet = m["detections"], jm["detections"]
    np.testing.assert_array_equal(det["count"].numpy(), np.asarray(jdet["count"]))
    np.testing.assert_allclose(det["scores"].numpy(), np.asarray(jdet["scores"]), atol=1e-5)

    # the gathered step crops the gathered full volumes the same way
    data = {k: torch.from_numpy(v) for k, v in batch.items() if k != "batch_mask"}
    idx = torch.tensor([5, 1, 6, 0, 2, 7, 3, 4])
    rows = {k: v[idx] for k, v in data.items()}
    gstate, gm = make_gathered_train_step(pair.cfg, pair.model, pair.priors,
                                          patch_training=True)(
        pair.state, data, idx, torch.Generator().manual_seed(9))
    pstate, pm = make_train_step(pair.cfg, pair.model, pair.priors, patch_training=True)(
        pair.state, rows, torch.Generator().manual_seed(9))
    assert torch.equal(gm["total_loss"], pm["total_loss"])
    assert_params_close(gstate.params, pstate.params)
    with pytest.raises(ValueError, match="generator"):
        step(pair.state, batch)


def test_patch_eval_step_matches_jax(pair):
    batch = _full_batch(seed=3)
    batch["batch_mask"][2] = False
    batch["box_mask"][2] = False
    batch["box_mask"][5] = False  # no box: the volume's centre
    ref = jax_steps.make_eval_step(pair.jcfg, pair.jmodel, pair.priors,
                                   patch_training=True)(pair.jstate, batch)
    out = make_eval_step(pair.cfg, pair.model, pair.priors, patch_training=True)(
        pair.state, batch)
    for key in ("total_loss", "conf_loss", "loc_loss", "n_valid"):
        _close_rel(out[key], ref[key], 1e-5)
    np.testing.assert_array_equal(out["gt_box_mask"].numpy(), np.asarray(ref["gt_box_mask"]))
    # XLA fuses the jitted step's boxes * volume - start into one
    # multiply-add (one rounding, where the eager function rounds twice):
    # one float32 ulp apart
    np.testing.assert_allclose(out["gt_boxes"].numpy(), np.asarray(ref["gt_boxes"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(out["gt_labels"].numpy(), np.asarray(ref["gt_labels"]))
    det, jdet = out["detections"], ref["detections"]
    np.testing.assert_array_equal(det["count"].numpy(), np.asarray(jdet["count"]))
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(det[key].numpy(), np.asarray(jdet[key]), rtol=1e-4, atol=1e-5)
    # without patch training the eval step hands back no GT
    plain = make_eval_step(pair.cfg, pair.model, pair.priors)(
        pair.state, {k: v[:, :16, :16, :16] if k == "image" else v for k, v in batch.items()})
    assert "gt_boxes" not in plain
