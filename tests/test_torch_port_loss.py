"""The port's MultiBox loss against the JAX package's, same seeded inputs.

Predictions (locs, logits) and padded ground truth are drawn by numpy on the
1168 priors of the 64^3 training geometry and go through
``mslesions3d_tpu.models.losses.multibox_loss`` and the port's. float32:
conf and loc loss within 1e-5 relative, with and without hard-negative
mining, focal loss and ``batch_mask``; the gradients with respect to the
predictions within 1e-5 of their largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.models import losses as jax_losses
from mslesions3d_tpu_torch.models import losses
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig, model_priors

# torch's first CPU log of a process can come back off by up to ~1e3 float32
# ulp in one thread's block (ROADMAP.md §3, tests/probe_torch_first_log.py);
# one small single-threaded call first avoids it
torch.log(torch.ones(8))

GEOMETRY = dict(n_classes=2, input_channels=1, input_size=(64, 64, 64))
RTOL = 1e-5


@pytest.fixture(scope="module")
def inputs():
    priors = model_priors(SSD3DConfig.create(**GEOMETRY))
    rng = np.random.default_rng(0)
    b, m, p = 4, 5, priors.shape[0]
    lo = rng.uniform(0.05, 0.6, (b, m, 3))
    boxes = np.clip(np.concatenate([lo, lo + rng.uniform(0.1, 0.35, (b, m, 3))], -1), 0, 1)
    mask = rng.uniform(size=(b, m)) < 0.6
    mask[:, 0] = True
    mask[3] = False  # an image with no object
    return {
        "locs": rng.normal(0, 1, (b, p, 6)).astype(np.float32),
        "scores": rng.normal(0, 2, (b, p, 2)).astype(np.float32),
        "boxes": boxes.astype(np.float32),
        "labels": np.ones((b, m), np.int32),
        "mask": mask,
        "batch_mask": np.array([True, False, True, True]),
        "priors": priors,
    }


OPTIONS = {
    "default": {},
    "hnm": dict(hard_negative_mining=True),
    "focal": dict(focal_gamma=2.0, focal_alpha=0.25),
    "hnm_focal": dict(hard_negative_mining=True, focal_gamma=2.0),
    "hnm_ratio1": dict(hard_negative_mining=True, neg_pos_ratio=1),
}


def _jax_loss(d, lo, hi, soft, with_batch_mask, opts):
    def f(locs, scores):
        conf, loc = jax_losses.multibox_loss(
            locs, scores, jnp.asarray(d["boxes"]), jnp.asarray(d["labels"]),
            jnp.asarray(d["mask"]), jnp.asarray(d["priors"]), lo, hi,
            jnp.asarray(d["batch_mask"]) if with_batch_mask else None, soft=soft, **opts)
        return conf + loc, (conf, loc)

    (_, (conf, loc)), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(d["locs"]), jnp.asarray(d["scores"]))
    return float(conf), float(loc), [np.asarray(g) for g in grads]


def _port_loss(d, lo, hi, soft, with_batch_mask, opts):
    locs = torch.tensor(d["locs"], requires_grad=True)
    scores = torch.tensor(d["scores"], requires_grad=True)
    conf, loc = losses.multibox_loss(
        locs, scores, torch.from_numpy(d["boxes"]), torch.from_numpy(d["labels"]),
        torch.from_numpy(d["mask"]), torch.from_numpy(d["priors"]), lo, hi,
        torch.from_numpy(d["batch_mask"]) if with_batch_mask else None, soft=soft, **opts)
    grads = torch.autograd.grad(conf + loc, (locs, scores))
    return float(conf.detach()), float(loc.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("with_batch_mask", [False, True], ids=["all_rows", "batch_mask"])
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
def test_loss_and_gradients_match_jax(inputs, option, with_batch_mask, soft):
    lo, hi = (0.1, 0.2) if soft else (0.5, 0.0)
    args = (inputs, lo, hi, soft, with_batch_mask, OPTIONS[option])
    ref_conf, ref_loc, ref_grads = _jax_loss(*args)
    conf, loc, grads = _port_loss(*args)
    assert ref_conf > 0 and ref_loc > 0
    np.testing.assert_allclose(conf, ref_conf, rtol=RTOL)
    np.testing.assert_allclose(loc, ref_loc, rtol=RTOL)
    for g, r in zip(grads, ref_grads):
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g, r, rtol=0, atol=RTOL * np.abs(r).max())
    if with_batch_mask:  # the masked row carries no gradient
        assert not grads[0][1].any() and not grads[1][1].any()


def test_hard_negative_mining_keeps_fewer_negatives(inputs):
    full = _port_loss(inputs, 0.1, 0.2, True, False, {})
    mined = _port_loss(inputs, 0.1, 0.2, True, False, dict(hard_negative_mining=True))
    assert mined[0] < full[0] and mined[1] == full[1]


@pytest.mark.parametrize("threshold", [0.5, (0.1, 0.2)], ids=["hard", "soft"])
def test_loss_from_config_matches_jax(inputs, threshold):
    kw = dict(GEOMETRY, threshold=threshold, focal_gamma=2.0, focal_alpha=0.3)
    d = inputs
    ref = jax_losses.multibox_loss_from_config(
        JaxConfig.create(**kw), jnp.asarray(d["locs"]), jnp.asarray(d["scores"]),
        jnp.asarray(d["boxes"]), jnp.asarray(d["labels"]), jnp.asarray(d["mask"]),
        jnp.asarray(d["priors"]), batch_mask=jnp.asarray(d["batch_mask"]),
        hard_negative_mining=True)
    ours = losses.multibox_loss_from_config(
        SSD3DConfig.create(**kw), torch.from_numpy(d["locs"]), torch.from_numpy(d["scores"]),
        torch.from_numpy(d["boxes"]), torch.from_numpy(d["labels"]), torch.from_numpy(d["mask"]),
        torch.from_numpy(d["priors"]), batch_mask=torch.from_numpy(d["batch_mask"]),
        hard_negative_mining=True)
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(float(a), float(r), rtol=RTOL)
