"""The port's MultiBox matching and detection metrics against the JAX package's.

Same seeded numpy inputs through ``mslesions3d_tpu.ops.matching`` and
``mslesions3d_tpu_torch.ops.matching``, on the 1168 priors of the 64^3
training geometry, float32: class targets equal, regression targets within
1e-6. Cases: objects colliding on one best prior (the highest index wins),
an image with no valid object, padding, hard and soft thresholds. Then the
metrics: the port's numpy copy of ``calculate_mAP`` equals the JAX
package's, and perfect predictions score mAP 1.0 end to end.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.models import model_priors as jax_model_priors
from mslesions3d_tpu.ops import matching as jax_matching
from mslesions3d_tpu.ops import metrics as jax_metrics
from mslesions3d_tpu.ops.boxes import center_to_corner as jax_center_to_corner
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig, model_priors
from mslesions3d_tpu_torch.ops import metrics
from mslesions3d_tpu_torch.ops.boxes import center_to_corner
from mslesions3d_tpu_torch.ops.matching import match_priors_batch, match_priors_single
from mslesions3d_tpu_torch.ops.nms import detect_objects, detections_to_lists

# torch's first CPU log of a process can come back off by up to ~1e3 float32
# ulp in one thread's block (ROADMAP.md §3, tests/probe_torch_first_log.py);
# one small single-threaded call first avoids it
torch.log(torch.ones(8))

GEOMETRY = dict(n_classes=2, input_channels=1, input_size=(64, 64, 64))
MODES = {"hard": (0.5, 0.0, False), "soft": (0.1, 0.2, True)}


@pytest.fixture(scope="module")
def priors():
    center = model_priors(SSD3DConfig.create(**GEOMETRY))
    np.testing.assert_array_equal(center, jax_model_priors(JaxConfig.create(**GEOMETRY)))
    assert center.shape == (1168, 6)
    corner = np.array(jax_center_to_corner(jnp.asarray(center)))
    return center, corner


def gt_case(name, rng, b=4, m=6):
    """(boxes, labels, mask) of a named case, corner form in [0, 1]."""
    lo = rng.uniform(0.05, 0.6, (b, m, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.08, 0.35, (b, m, 3))], -1)
    boxes = np.clip(boxes, 0.0, 1.0).astype(np.float32)
    labels = rng.integers(1, 3, (b, m)).astype(np.int32)
    mask = rng.uniform(size=(b, m)) < 0.7
    mask[:, 0] = True
    if name == "collisions":
        # objects 0, 2 and 4 share a box, so their best prior too: 4 must win
        boxes[:, 2] = boxes[:, 4] = boxes[:, 0]
        labels[:, 0], labels[:, 2], labels[:, 4] = 2, 2, 1
        mask[:, [0, 2, 4]] = True
        boxes[1, 1] = boxes[1, 3] = boxes[1, 5]  # and an unlabeled duplicate set
    elif name == "no_object":
        mask[1] = False
        mask[3] = False
    elif name == "padded":
        boxes[~mask] = 0.0
        labels[~mask] = 0
    return boxes, labels, mask


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", ["random", "collisions", "no_object", "padded"])
def test_matching_matches_jax(priors, case, mode):
    center, corner = priors
    boxes, labels, mask = gt_case(case, np.random.default_rng(len(case)))
    lo, hi, soft = MODES[mode]
    ref_loc, ref_cls = jax_matching.match_priors_batch(
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(corner),
        jnp.asarray(center), lo, hi, soft=soft)
    loc, cls = match_priors_batch(torch.from_numpy(boxes), torch.from_numpy(labels),
                                  torch.from_numpy(mask), torch.from_numpy(corner),
                                  torch.from_numpy(center), lo, hi, soft=soft)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(ref_cls))
    np.testing.assert_allclose(loc.numpy(), np.asarray(ref_loc), rtol=1e-6, atol=1e-6)
    # not vacuous: positives exist where objects do, and none where none is valid
    assert (cls.numpy()[mask.any(1)] > 0).any()
    if soft:
        assert (cls.numpy() == -1).any()
    if case == "no_object":
        assert not cls[1].any() and not loc[1].any()
    if case == "collisions":
        best = int(np.argmax(np.asarray(jax_matching.pairwise_iou(
            jnp.asarray(boxes[0, :1]), jnp.asarray(corner)))[0]))
        assert int(cls[0, best]) == labels[0, 4]  # object 4 beat 0 and 2


def test_single_image_matches_batch(priors):
    center, corner = priors
    boxes, labels, mask = gt_case("collisions", np.random.default_rng(5))
    args = [torch.from_numpy(a) for a in (center, corner)]
    loc, cls = match_priors_batch(*(torch.from_numpy(a) for a in (boxes, labels, mask)),
                                  args[1], args[0], 0.1, 0.2, soft=True)
    loc1, cls1 = match_priors_single(torch.from_numpy(boxes[2]), torch.from_numpy(labels[2]),
                                     torch.from_numpy(mask[2]), args[1], args[0], 0.1, 0.2,
                                     soft=True)
    torch.testing.assert_close(loc1, loc[2], rtol=0, atol=0)
    torch.testing.assert_close(cls1, cls[2], rtol=0, atol=0)


def _random_detections(rng, n_images, n_classes):
    det, gt = ([], [], []), ([], [], [])
    for _ in range(n_images):
        n_gt, n_det = rng.integers(0, 4), rng.integers(0, 6)
        g = np.clip(np.sort(rng.uniform(0, 1, (n_gt, 2, 3)), 1).reshape(n_gt, 6), 0, 1)
        gt[0].append(g[:, [0, 2, 4, 1, 3, 5]].astype(np.float32))
        gt[1].append(rng.integers(1, n_classes, n_gt))
        gt[2].append(np.zeros(n_gt, bool))
        d = np.clip(np.sort(rng.uniform(0, 1, (n_det, 2, 3)), 1).reshape(n_det, 6), 0, 1)
        det[0].append(d[:, [0, 2, 4, 1, 3, 5]].astype(np.float32))
        det[1].append(rng.integers(1, n_classes, n_det))
        det[2].append(rng.uniform(0, 1, n_det).astype(np.float32))
    return det, gt


@pytest.mark.parametrize("n_classes", [2, 3])
def test_calculate_map_matches_jax(n_classes):
    det, gt = _random_detections(np.random.default_rng(n_classes), 12, n_classes)
    for iou in (0.1, 0.5):
        ours = metrics.calculate_mAP(*det, *gt, n_classes=n_classes, min_overlap=iou,
                                     return_detail=True)
        ref = jax_metrics.calculate_mAP(*det, *gt, n_classes=n_classes, min_overlap=iou,
                                        return_detail=True)
        assert metrics.to_jsonable(ours) == jax_metrics.to_jsonable(ref)


def test_perfect_predictions_score_map_one(priors):
    """GT -> matching -> its regression targets as predictions, positives
    scored confidently -> decode + NMS -> detections_to_lists -> mAP 1.0."""
    center_t = torch.from_numpy(priors[0])
    rng = np.random.default_rng(11)
    lo = rng.uniform(0.1, 0.3, (3, 3))
    boxes = np.stack([np.concatenate([lo, lo + 0.25], -1),
                      np.concatenate([lo + 0.45, lo + 0.65], -1)], 1).astype(np.float32)
    labels = np.ones((3, 2), np.int32)
    mask = np.ones((3, 2), bool)
    mask[2, 1] = False
    locs, cls = match_priors_batch(torch.from_numpy(boxes), torch.from_numpy(labels),
                                   torch.from_numpy(mask), center_to_corner(center_t),
                                   center_t, 0.5)
    positive = cls > 0
    scores = torch.stack([torch.where(positive, -5.0, 5.0), torch.where(positive, 5.0, -5.0)], -1)
    det = detect_objects(locs, scores, center_t, n_classes=2, min_score=0.5, max_overlap=0.5,
                         top_k=10)
    db, dl, ds = detections_to_lists(det)
    gt_b = [boxes[i][mask[i]] for i in range(3)]
    gt_l = [labels[i][mask[i]] for i in range(3)]
    diffs = [np.zeros(len(g), bool) for g in gt_l]
    detail = metrics.calculate_mAP(db, dl, ds, gt_b, gt_l, diffs, n_classes=2,
                                   min_overlap=0.5, return_detail=True)
    assert [len(b) for b in db] == [2, 2, 1]
    assert detail["mAP"] == 1.0 and detail["recall"] == 1.0 and detail["precision"] == 1.0
