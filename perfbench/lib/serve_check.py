"""Whether served detections are the reference's, for one batch of volumes.

The reference forward (float32) gives every prior's decoded box and class
probability. The first number, ``answer_gap``: the worst volume's larger of
two means,

* over its served detections, how far each lies from a sound answer: the
  larger of (a) its distance from the prior that best explains it, the
  smallest, over the priors, of the larger of the box's greatest coordinate
  difference and the score's difference, and (b) how far it overlaps a
  served box of its class that ranks above it, beyond what greedy NMS lets
  stand (IoU - ``max_overlap``, clamped at 0): a K1 that suppresses nothing,
  or a top-k that serves a box twice, reads up to 0.5 there;
* over the reference's candidates (priors whose class probability passes
  ``min_score``), how far each lies above what would excuse its absence
  from the answer. A candidate is excused by being served (the gap above),
  by its score (below ``min_score``, or below the 10 x top_k-th best, the
  candidates greedy NMS looks at), by the top_k cut (the volume's ``top_k``
  slots all hold scores above it), or by a served box of its class that
  suppresses it (IoU above ``max_overlap``, score above it): each excuse
  needs a margin, and the candidate's gap is the least margin any needs.

The second, ``overlap_excess``, is the widest of (b) over every served
detection: greedy NMS guarantees it is 0, up to the rounding of one IoU. A
K1 that lets a few overlapping boxes through moves a volume's mean by their
share, but each of them breaks the guarantee by its whole overlap.

A sound program differs from the reference by its rounding, so every
volume's means stay near the rounding of its precision; the next precision
down moves every volume's. A mean, not a median, so that a fault in a few of
a volume's detections moves it by their share of a score or an IoU. (Two
narrower numbers were tried first: the widest gap of one detection does not
tell bf16 from int8, whose worst detections lie within 3x, set by bf16's
rounding of the largest output logits; the candidates' mean alone moves
little under int8 but is what sees a missing answer.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import boxes as bx
from ..reference import ssd3d as ref

ANSWER_GAP = "volume_mean"  # the statistic compared (``summaries``)


def volume_gaps(served: dict, locs: torch.Tensor, logits: torch.Tensor, priors_c: torch.Tensor,
                *, min_score: float, max_overlap: float, top_k: int) -> list:
    """[(served detections' gaps, candidates' gaps, served detections'
    overlaps beyond ``max_overlap``)] of each volume of a batch: ``served``
    holds numpy boxes (B, top_k, 6), labels (B, top_k), scores (B, top_k)
    and count (B,); locs and logits (B, P, ·) are the reference's for the
    same volumes."""
    dev = locs.device
    probs = torch.softmax(logits.float(), -1)
    boxes = bx.to_corner(bx.decode(locs.float(), priors_c))
    k = min(10 * top_k, priors_c.shape[0])
    out = []
    for v in range(locs.shape[0]):
        served_v, missed_v, overlap_v = [], [], []
        n = int(served["count"][v])
        sb = torch.as_tensor(served["boxes"][v][:n], device=dev).float()
        ss = torch.as_tensor(served["scores"][v][:n], device=dev).float()
        sl = torch.as_tensor(served["labels"][v][:n], device=dev).long()
        full = n >= top_k
        floor = float(ss.min()) if n else 1.0
        for c in range(1, probs.shape[-1]):
            p = probs[v, :, c]
            mine = sl == c
            bc, sc = sb[mine], ss[mine]
            if len(sc):
                dist = torch.maximum((bc[:, None, :] - boxes[v][None]).abs().amax(-1),
                                     (sc[:, None] - p[None]).abs())  # (served, P)
                order = torch.arange(len(sc), device=dev)
                above = (sc[None, :] > sc[:, None]) | ((sc[None, :] == sc[:, None])
                                                       & (order[None, :] < order[:, None]))
                overlap = torch.where(above, bx.iou(bc, bc) - max_overlap, 0.0)
                overlap_v.append(overlap.amax(1).clamp(min=0))
                served_v.append(torch.maximum(dist.amin(1), overlap_v[-1]))
            cand = torch.nonzero(p > min_score).flatten()
            if len(cand) == 0:
                continue
            pc = p[cand]
            kth = float(torch.topk(p, k).values[-1])
            excuse = torch.minimum(pc - min_score, pc - kth)
            if full:
                excuse = torch.minimum(excuse, pc - floor)
            if len(sc):
                explained = dist[:, cand].amin(0)
                over = max_overlap - bx.iou(boxes[v][cand], bc)  # (cand, served)
                suppressed = torch.maximum(pc[:, None] - sc[None, :], over).amin(1)
                excuse = torch.minimum(excuse, torch.minimum(explained, suppressed))
            missed_v.append(excuse.clamp(min=0))
        out.append(tuple(torch.cat(g).cpu() if g else torch.zeros(0)
                         for g in (served_v, missed_v, overlap_v)))
    return out


def summaries(volumes: list) -> dict:
    """Statistics of the volumes' gaps: the worst volume's mean and median
    and the pooled mean and median, each the larger of served and missed,
    and the widest overlap beyond ``max_overlap``."""
    out = {}
    for name, fn in (("mean", torch.mean), ("median", torch.median)):
        per_volume = [float(fn(g)) for gaps in volumes for g in gaps[:2] if len(g)]
        pooled = [float(fn(torch.cat([gaps[i] for gaps in volumes]))) for i in (0, 1)
                  if sum(len(gaps[i]) for gaps in volumes)]
        out[f"volume_{name}"] = max(per_volume, default=0.0)
        out[f"pooled_{name}"] = max(pooled, default=0.0)
    out["overlap_excess"] = max((float(gaps[2].max()) for gaps in volumes if len(gaps[2])),
                                default=0.0)
    return out


def break_answers(out: dict, previous, faults) -> dict:
    """The faults the tests and calibration plant in a predict call's answer:
    ``stale`` hands back the previous call's, ``altered`` lowers the scores
    of the first volume's answer by 0.05, ``half`` drops the second half's
    detections. (``nosuppress``, K1 keeping every candidate, is planted in
    the program underneath: ``closed_predict``.)"""
    if "stale" in faults and previous is not None:
        return previous
    out = {k: v.copy() for k, v in out.items()}
    if "altered" in faults:
        out["scores"][0] -= 0.05
    if "half" in faults:
        out["count"][out["count"].shape[0] // 2:] = 0
    return out


def as_served(detections: list, top_k: int) -> dict:
    """Per-volume lists of (box, label, score), as ``reference.boxes.detect``
    gives them, in the padded form a predict call answers with."""
    n = len(detections)
    out = {"boxes": np.zeros((n, top_k, 6), np.float32), "labels": np.zeros((n, top_k), np.int64),
           "scores": np.zeros((n, top_k), np.float32), "count": np.zeros((n,), np.int64)}
    for v, dets in enumerate(detections):
        out["count"][v] = len(dets)
        for j, (box, label, score) in enumerate(dets):
            out["boxes"][v, j] = box.cpu().numpy()
            out["labels"][v, j], out["scores"][v, j] = label, score
    return out


def reference_gaps(sd: dict, cfg: dict, images, served: dict, priors_c, dtype) -> tuple:
    """(the program's volume gaps, a plain ``dtype`` computation's): both
    against the float32 reference on ``images``; the second answers with the
    reference's own decode, greedy NMS and top-k on its ``dtype`` outputs,
    the rounding a sound program in that dtype should come near."""
    opts = dict(min_score=float(cfg["min_score"]), max_overlap=float(cfg["max_overlap"]),
                top_k=int(cfg["top_k"]))
    locs, logits = ref.forward(sd, cfg, images)
    program = volume_gaps(served, locs, logits, priors_c, **opts)
    rlocs, rlogits = ref.forward(sd, cfg, images, dtype=dtype)
    own = as_served([bx.detect(rlocs[v], rlogits[v], priors_c, **opts)
                     for v in range(len(images))], opts["top_k"])
    return program, volume_gaps(own, locs, logits, priors_c, **opts)
