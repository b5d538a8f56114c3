"""The port's connected components and component boxes against the JAX package's.

- ``connected_components_3d``: the labels (each component's root linear
  index, INT32 max outside) equal JAX's exactly on seeded random masks of
  several densities and shapes, on the JAX tests' snake and diagonal pair,
  and on an empty mask.
- ``component_boxes`` and ``boxes_from_segmentation_device``: boxes equal
  to JAX's, a ``max_objects`` smaller than the component count;
  ``compact_device_boxes`` strips the padding. Validity equals JAX's but
  for one difference, counted: a component one voxel thick on some axis
  has zero volume and is dropped (lesions3d/utils.py:476-481, and the host
  path), while the JAX package keeps some of them, as the product of its
  float32 extents comes out a hair above 0 under XLA's fused multiply-adds
  (3 of the first 64 of the 108 components of the 12x10x9 mask, where 7
  have volume).
- ``SyntheticDataModule(device_boxes=True, device="cpu")``: each sample's
  boxes and labels are the host path's (scipy) set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu.data.generate import generate_dataset
from mslesions3d_tpu.ops import connected_components as jax_cc
from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
from mslesions3d_tpu_torch.ops import connected_components as cc


def _masks():
    rng = np.random.default_rng(0)
    out = {f"random {p} {shape}": rng.uniform(size=shape) < p
           for p, shape in ((0.2, (12, 10, 9)), (0.35, (16, 16, 16)), (0.6, (8, 14, 11)))}
    snake = np.zeros((16, 16, 16), bool)
    snake[2:12, 2:4, 2:4] = True
    snake[10:12, 2:10, 2:4] = True
    snake[10:12, 8:10, 2:12] = True
    out["snake"] = snake
    diagonal = np.zeros((8, 8, 8), bool)
    diagonal[2, 2, 2] = diagonal[3, 3, 3] = True
    out["diagonal"] = diagonal
    out["empty"] = np.zeros((8, 8, 8), bool)
    return out


MASKS = _masks()


@pytest.mark.parametrize("name", sorted(MASKS))
def test_labels_equal_jax(name):
    mask = MASKS[name]
    ref = np.asarray(jax_cc.connected_components_3d(jnp.asarray(mask)))
    ours = cc.connected_components_3d(torch.from_numpy(mask))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    n = len(np.unique(ref[ref != cc.INF]))
    assert n == {"snake": 1, "diagonal": 2, "empty": 0}.get(name, n)


@pytest.mark.parametrize("name,max_objects", [("random 0.2 (12, 10, 9)", 64),
                                              ("random 0.2 (12, 10, 9)", 5),
                                              ("diagonal", 4), ("empty", 4)])
def test_component_boxes_equal_jax(name, max_objects):
    labels = jax_cc.connected_components_3d(jnp.asarray(MASKS[name]))
    ref_boxes, ref_valid = jax_cc.component_boxes(labels, max_objects=max_objects)
    boxes, valid = cc.component_boxes(torch.from_numpy(np.array(labels)), max_objects)
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(ref_boxes))
    kept_flat = _jax_keeps_flat(ref_boxes, ref_valid, MASKS[name].shape)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid) & ~kept_flat)
    assert int(kept_flat.sum()) == {64: 3, 5: 0}.get(max_objects, 0)
    if name == "diagonal":  # two single voxels: zero-volume boxes, dropped
        assert not valid.any()


def _jax_keeps_flat(boxes, valid, shape):
    """The JAX package's valid boxes that are one voxel thick on some axis."""
    corners = np.rint(np.asarray(boxes) * np.asarray(shape * 2, np.float32)).astype(int)
    return np.asarray(valid) & (corners[:, 3:] <= corners[:, :3]).any(1)


def test_boxes_from_segmentation_equal_jax():
    rng = np.random.default_rng(5)
    seg = np.zeros((20, 22, 18), np.float32)
    for c in (1, 2, 1, 2, 1):
        lo = rng.integers(0, 12, 3)
        size = rng.integers(2, 6, 3)
        seg[lo[0]:lo[0] + size[0], lo[1]:lo[1] + size[1], lo[2]:lo[2] + size[2]] = c
    ref = jax_cc.boxes_from_segmentation_device(jnp.asarray(seg), n_classes=2, max_objects=6)
    ours = cc.boxes_from_segmentation_device(torch.from_numpy(seg), n_classes=2,
                                             max_objects=6)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    kept_flat = _jax_keeps_flat(ref[0], ref[2], seg.shape)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]) & ~kept_flat)
    b, lab = cc.compact_device_boxes(*ours)
    rb, rl = jax_cc.compact_device_boxes(ref[0], ref[1], np.asarray(ref[2]) & ~kept_flat)
    np.testing.assert_array_equal(b, rb)
    np.testing.assert_array_equal(lab, rl)
    assert sorted(set(lab.tolist())) == [1, 2]


def test_datamodule_device_boxes_equal_host_path(tmp_path):
    generate_dataset(tmp_path / "d", num_images=4, n_classes=1, image_size=(20, 20, 20),
                     object_size=(5, 8), num_objects=(1, 3), seed=0)
    host = SyntheticDataModule(tmp_path / "d", n_classes=1, batch_size=2)
    dev = SyntheticDataModule(tmp_path / "d", n_classes=1, batch_size=2, device_boxes=True,
                              device="cpu")
    host.setup("fit")
    dev.setup("fit")
    assert host.subjects_list == dev.subjects_list
    for s in host.subjects_list:
        h, d = host.get_sample(s), dev.get_sample(s)
        assert d["labels"].dtype == h["labels"].dtype and d["boxes"].dtype == h["boxes"].dtype
        assert sorted(h["labels"].tolist()) == sorted(d["labels"].tolist())
        assert len(d["boxes"]) > 0
        np.testing.assert_allclose(np.sort(d["boxes"], axis=0), np.sort(h["boxes"], axis=0),
                                   atol=1e-6)
    # the materialized dataset (what the trainer copies to the device) too
    a, b = host.materialize(host.trainsubs), dev.materialize(dev.trainsubs)
    np.testing.assert_array_equal(a["box_mask"].sum(1), b["box_mask"].sum(1))
