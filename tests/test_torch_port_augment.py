"""The port's device-side augmentation against the JAX package's.

* Flips and rot90 at probability 0 and 1, where the JAX draws are fixed:
  ``mslesions3d_tpu.data.augment.augment_batch`` and the port's give the
  same images and boxes exactly (flips are exact permutation matrices in
  both), on a cube and on a volume where a rot90 plane is skipped.
* Warps (affine, zoom, grid distortion), flips and intensity on given
  parameters: the port's ``apply_augment`` against the JAX package's math
  (its ``separable_resample``, ``_flip_boxes``, ``_rot90_boxes`` and
  ``jnp.interp``) on the same parameters, within 1e-5.
* The draws come from an explicit generator.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu.data import augment as jax_aug
from mslesions3d_tpu_torch.data import augment as aug

NAME_SETS = [(), ("flip",), ("rotate90",), ("flip", "rotate90d", "translate", "zoom"),
             ("scale", "griddistortion", "shiftintensity", "scaleintensity")]


@pytest.mark.parametrize("names", NAME_SETS, ids=lambda n: "+".join(n) or "none")
def test_config_from_names_matches_jax(names):
    ours, ref = aug.AugmentConfig.from_names(names), jax_aug.AugmentConfig.from_names(names)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.identity == ref.identity
    with pytest.raises(ValueError, match="unknown augmentation"):
        aug.AugmentConfig.from_names(["elastic"])


def _volume(shape, b=3, m=3, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (b, *shape, 1)).astype(np.float32)
    lo = rng.uniform(0.05, 0.5, (b, m, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, (b, m, 3))], -1).astype(np.float32)
    return images, boxes


FIXED = {
    "flips": dict(flip_axes=(0, 1, 2)),
    "rot90": dict(rot90_planes=((1, 2), (0, 1), (0, 2))),
    "bench": dict(flip_axes=(0, 1, 2), rot90_planes=((1, 2),)),
}


@pytest.mark.parametrize("shape", [(8, 8, 8), (6, 8, 8)], ids=["cube", "non_cube"])
@pytest.mark.parametrize("prob", [0.0, 1.0])
@pytest.mark.parametrize("kind", list(FIXED))
def test_flips_and_rot90_at_probability_0_and_1_are_exact(kind, prob, shape):
    cfg_kw = dict(FIXED[kind], flip_prob=prob, rot90_prob=prob)
    images, boxes = _volume(shape)
    ref_img, ref_boxes = jax_aug.augment_batch(jax.random.PRNGKey(0), jnp.asarray(images),
                                               jnp.asarray(boxes),
                                               jax_aug.AugmentConfig(**cfg_kw))
    img, bx = aug.augment_batch(torch.Generator().manual_seed(0), torch.from_numpy(images),
                                torch.from_numpy(boxes), aug.AugmentConfig(**cfg_kw))
    np.testing.assert_array_equal(img.numpy(), np.asarray(ref_img))
    np.testing.assert_array_equal(bx.numpy(), np.asarray(ref_boxes))
    if prob == 0.0:
        np.testing.assert_array_equal(img.numpy(), images)
    else:
        assert not np.array_equal(img.numpy(), images)


def _jax_apply(img, boxes, p: dict, cfg: aug.AugmentConfig):
    """The JAX package's augment_sample math (data/augment.py) on one sample
    with given parameters in place of its draws."""
    img, boxes = jnp.asarray(img), jnp.asarray(boxes)
    shape = jnp.asarray(img.shape[:3], jnp.float32)
    planes = [(a, b) for a, b in cfg.rot90_planes if img.shape[a] == img.shape[b]]
    for j, (a, b) in enumerate(planes):
        do = p["rot90"][j]
        img = jnp.where(do, jnp.rot90(img, 1, axes=(a, b)), img)
        boxes = jnp.where(do, jax_aug._rot90_boxes(boxes, a, b, 1.0 / img.shape[a]), boxes)
    coords = [jnp.arange(img.shape[ax], dtype=jnp.float32) for ax in range(3)]
    center = (shape - 1.0) / 2.0
    knots = []
    deltas = jnp.where(p["distort"], jnp.asarray(p["deltas"]), 0.0)
    n_cells = cfg.grid_distort_cells
    for ax in range(3):
        size = float(img.shape[ax])
        widths = (size / n_cells) * (1.0 + deltas[ax])
        knots_in = jnp.concatenate([jnp.zeros(1), jnp.cumsum(widths)])
        knots_in = knots_in * (size / knots_in[-1])
        knots_out = jnp.linspace(0.0, size, n_cells + 1)
        knots.append((knots_in, knots_out))
        coords[ax] = jnp.interp(coords[ax], knots_out, knots_in)
    z = jnp.where(p["zoom"], p["z"], 1.0)
    coords = [center[ax] + (coords[ax] - center[ax]) / z for ax in range(3)]
    t = jnp.where(p["affine"], jnp.asarray(p["t"]), 0.0)
    s = jnp.where(p["affine"], jnp.asarray(p["s"]), 1.0)
    coords = [(coords[ax] - center[ax] - t[ax]) / s[ax] + center[ax] for ax in range(3)]
    for j, axis in enumerate(cfg.flip_axes):
        size = float(img.shape[axis])
        coords[axis] = jnp.where(p["flip"][j], (size - 1.0) - coords[axis], coords[axis])
    img = jax_aug.separable_resample(img, coords)
    for j, axis in enumerate(cfg.flip_axes):
        boxes = jnp.where(p["flip"][j], jax_aug._flip_boxes(boxes, axis, 1.0 / img.shape[axis]),
                          boxes)
    lo = s * (boxes[..., :3] * shape - center) + center + t
    hi = s * (boxes[..., 3:] * shape - center) + center + t
    boxes = jnp.concatenate([lo / shape, hi / shape], axis=-1)
    lo = center + (boxes[..., :3] * shape - center) * z
    hi = center + (boxes[..., 3:] * shape - center) * z
    boxes = jnp.concatenate([lo / shape, hi / shape], axis=-1)
    cols = []
    for ax in range(3):
        size = float(img.shape[ax])
        knots_in, knots_out = knots[ax]
        cols.append((jnp.interp(boxes[..., ax] * size, knots_in, knots_out) / size,
                     jnp.interp(boxes[..., ax + 3] * size, knots_in, knots_out) / size))
    boxes = jnp.stack([cols[0][0], cols[1][0], cols[2][0], cols[0][1], cols[1][1], cols[2][1]],
                      axis=-1)
    img = img + jnp.where(p["shift"], p["offset"], 0.0)
    img = img * (1.0 + jnp.where(p["scale"], p["factor"], 0.0))
    return np.asarray(img), np.asarray(boxes)


WARPS = aug.AugmentConfig(flip_axes=(0, 1, 2), flip_prob=0.5, rot90_planes=((1, 2),),
                          affine_prob=0.7, zoom_prob=0.5, grid_distort_prob=0.5,
                          shift_intensity=0.1, shift_prob=0.5, scale_intensity=0.1,
                          scale_prob=0.5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warps_on_given_parameters_match_jax_math(seed):
    images, boxes = _volume((8, 10, 10), b=4, seed=seed)
    params = aug.draw_augment_params(WARPS, 4, images.shape[1:4],
                                     torch.Generator().manual_seed(seed))
    img, bx = aug.apply_augment(torch.from_numpy(images), torch.from_numpy(boxes), params, WARPS)
    np_params = {k: v.numpy() for k, v in params.items()}
    for i in range(4):
        ref_img, ref_boxes = _jax_apply(images[i], boxes[i],
                                        {k: v[i] for k, v in np_params.items()}, WARPS)
        np.testing.assert_allclose(img[i].numpy(), ref_img, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bx[i].numpy(), ref_boxes, rtol=1e-5, atol=1e-5)


def test_draws_come_from_the_generator():
    draw = lambda seed: aug.draw_augment_params(  # noqa: E731
        WARPS, 64, (8, 8, 8), torch.Generator().manual_seed(seed))
    a, b, c = draw(5), draw(5), draw(6)
    assert a.keys() == b.keys() == {"rot90", "distort", "deltas", "zoom", "z", "affine", "t",
                                    "s", "flip", "shift", "offset", "scale", "factor"}
    for key in a:
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["t"], c["t"])
    share = float(a["flip"].float().mean())
    assert 0.3 < share < 0.7
    assert a["rot90"].shape == (64, 1) and a["flip"].shape == (64, 3)
    assert ((a["s"] >= 0.85) & (a["s"] <= 1.15)).all()


def test_interpolation_helpers_match_jax():
    rng = np.random.default_rng(4)
    coords = rng.uniform(-2, 11, (3, 12)).astype(np.float32)
    ours = aug._axis_interp_matrix(torch.from_numpy(coords), 10)
    for i in range(3):
        ref = jax_aug._axis_interp_matrix(jnp.asarray(coords[i]), 10)
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    xp = np.sort(rng.uniform(0, 10, (3, 6)), axis=1).astype(np.float32)
    fp = rng.uniform(-1, 1, (3, 6)).astype(np.float32)
    x = rng.uniform(-1, 11, (3, 20)).astype(np.float32)
    got = aug._interp(*(torch.from_numpy(a) for a in (x, xp, fp)))
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(jnp.interp(x[i], xp[i], fp[i])),
                                   rtol=1e-6, atol=1e-7)


def test_augment_sample_is_one_row_of_the_batch():
    images, boxes = _volume((8, 8, 8), b=1)
    img, bx = aug.augment_sample(torch.Generator().manual_seed(3), torch.from_numpy(images[0]),
                                 torch.from_numpy(boxes[0]), WARPS)
    bimg, bbx = aug.augment_batch(torch.Generator().manual_seed(3), torch.from_numpy(images),
                                  torch.from_numpy(boxes), WARPS)
    torch.testing.assert_close(img, bimg[0], rtol=0, atol=0)
    torch.testing.assert_close(bx, bbx[0], rtol=0, atol=0)
