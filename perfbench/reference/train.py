"""One training step of SSD3D written out in plain PyTorch: the benchmark's
reference for the training cells.

Augmentation (rot90 in each plane of equal sides, then flips and an
isotropic zoom about the centre by linear interpolation), MultiBox matching
with a soft band, the MultiBox loss with hard-negative mining, autograd's
backward through :func:`..ssd3d.forward` in training mode (a backbone's
dropout draws from the step's generator after the augmentation), and Adam
with L2 decay added to the gradient, biases at twice the learning rate and a
half-cosine schedule (Medical-Image-Analysis-Laboratory/MSLesions3D,
lesions3d/ssd3d.py ``configure_optimizers`` and ``MultiBoxLoss``). The
random draws are taken from a ``torch.Generator`` in the reference
repository's augmentation order, so a generator in the same state draws the
same values. Nothing of the program under test is imported.
"""

from __future__ import annotations

import math

import torch

from . import boxes as bx
from . import ssd3d

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 5e-4
NEG_POS_RATIO = 3
ROT90_PLANES = ((1, 2), (0, 1), (0, 2))
FLIP_AXES = (0, 1, 2)


def draw_augment(gen: torch.Generator, batch: int, spatial, aug: dict) -> dict:
    """The batch's random switches and values, drawn in a fixed order:
    rot90 (one Bernoulli a plane of equal sides), zoom (switch, factor),
    flips (one Bernoulli an axis)."""
    dev = gen.device

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    out = {}
    planes = [(a, b) for a, b in ROT90_PLANES if spatial[a] == spatial[b]]
    if aug["rotate90"] and planes:
        out["rot90"] = torch.stack([rand((batch,)) < aug["rot90_prob"] for _ in planes], 1)
    if aug["zoom"]:
        out["zoom"] = rand((batch,)) < aug["zoom_prob"]
        lo, hi = aug["min_zoom"], aug["max_zoom"]
        out["z"] = lo + (hi - lo) * rand((batch,))
    if aug["flip"]:
        out["flip"] = torch.stack([rand((batch,)) < aug["flip_prob"] for _ in FLIP_AXES], 1)
    return out


def _lerp_axis(x: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    """Sample x (B, D, H, W) along ``axis`` (1-3) at fractional positions
    ``coords`` (B, S): linear interpolation between the two neighbouring
    voxels, a neighbour outside the volume weighing nothing, and the weights
    renormalised to sum to one where any is left (else 0)."""
    size = x.shape[axis]
    lo = torch.floor(coords)
    frac = coords - lo
    lo = lo.long()
    hi = lo + 1
    w_lo = torch.where((lo >= 0) & (lo < size), 1.0 - frac, 0.0)
    w_hi = torch.where((hi >= 0) & (hi < size), frac, 0.0)
    total = torch.clamp(w_lo + w_hi, min=1e-8)
    xm = x.movedim(axis, 1)  # (B, S_in, ...)
    rest = xm.shape[2:]
    flat = xm.reshape(xm.shape[0], size, -1)

    def take(idx):
        idx = idx.clamp(0, size - 1)[:, :, None].expand(-1, -1, flat.shape[2])
        return torch.gather(flat, 1, idx)

    out = (take(lo) * w_lo[..., None] + take(hi) * w_hi[..., None]) / total[..., None]
    return out.reshape(xm.shape[0], coords.shape[1], *rest).movedim(1, axis)


def augment(images: torch.Tensor, boxes: torch.Tensor, params: dict):
    """Apply drawn parameters to images (B, D, H, W, 1) and corner boxes (B, M, 6)."""
    spatial = images.shape[1:4]
    x = images[..., 0].float()
    boxes = boxes.float()
    planes = [(a, b) for a, b in ROT90_PLANES if spatial[a] == spatial[b]]
    for j, (a, b) in enumerate(planes):
        if "rot90" not in params:
            break
        do = params["rot90"][:, j]
        x = torch.where(do.view(-1, 1, 1, 1), torch.rot90(x, 1, (a + 1, b + 1)), x)
        edge = 1.0 - 1.0 / spatial[a]
        turned = boxes.clone()
        turned[..., a] = edge - boxes[..., b + 3]
        turned[..., a + 3] = edge - boxes[..., b]
        turned[..., b] = boxes[..., a]
        turned[..., b + 3] = boxes[..., a + 3]
        boxes = torch.where(do.view(-1, 1, 1), turned, boxes)
    n, dev = x.shape[0], x.device
    z = torch.where(params["zoom"], params["z"], 1.0) if "zoom" in params else \
        torch.ones(n, device=dev)
    flip = params.get("flip", torch.zeros((n, 3), dtype=torch.bool, device=dev))
    for ax in range(3):
        size = spatial[ax]
        center = (size - 1.0) / 2.0
        coords = torch.arange(size, dtype=torch.float32, device=dev).expand(n, size)
        coords = center + (coords - center) / z[:, None]
        coords = torch.where(flip[:, ax:ax + 1], (size - 1.0) - coords, coords)
        x = _lerp_axis(x, coords, ax + 1)
    for ax in range(3):
        edge = 1.0 - 1.0 / spatial[ax]
        flipped = boxes.clone()
        flipped[..., ax] = edge - boxes[..., ax + 3]
        flipped[..., ax + 3] = edge - boxes[..., ax]
        boxes = torch.where(flip[:, ax].view(-1, 1, 1), flipped, boxes)
    shape = torch.tensor([float(s) for s in spatial], device=dev)
    center = (shape - 1.0) / 2.0
    z3 = z[:, None, None]
    lo = center + (boxes[..., :3] * shape - center) * z3
    hi = center + (boxes[..., 3:] * shape - center) * z3
    boxes = torch.cat([lo / shape, hi / shape], -1)
    return x[..., None], boxes


def match(gt: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, priors_c: torch.Tensor,
          lo: float, hi: float):
    """MultiBox targets of one batch: (loc targets (B, P, 6), classes (B, P)).
    Each prior takes its best-overlapping object; each object is forced onto
    its best prior (the later object winning a shared prior); overlap below
    ``lo`` is background (0), in [lo, hi) ignored (-1)."""
    b, m = labels.shape
    p = priors_c.shape[0]
    pc = bx.to_corner(priors_c)
    loc_t = torch.zeros((b, p, 6), device=gt.device)
    cls_t = torch.zeros((b, p), dtype=torch.long, device=gt.device)
    for i in range(b):
        valid = torch.nonzero(mask[i]).flatten()
        if len(valid) == 0:
            continue
        g = gt[i, valid]
        ov = bx.iou(g, pc)  # (V, P)
        best_ov, best_obj = ov.max(0)
        best_prior = ov.argmax(1)
        for j in range(len(valid)):  # later objects overwrite earlier ones
            best_obj[best_prior[j]] = j
            best_ov[best_prior[j]] = 1.0
        cls = labels[i, valid][best_obj].long()
        cls = torch.where(best_ov < lo, 0, cls)
        cls = torch.where((best_ov >= lo) & (best_ov < hi), -1, cls)
        cls_t[i] = cls
        loc_t[i] = bx.encode(bx.to_center(g[best_obj]), priors_c)
    return loc_t, cls_t


def multibox_loss(locs, logits, loc_t, cls_t, alpha: float):
    """(total, conf, loc): L1 over the positives' offsets / (6 n_pos); cross
    entropy over the positives and the 3 n_pos hardest negatives of each
    volume / n_pos; ignored priors count nothing."""
    pos = cls_t > 0
    n_pos = pos.sum()
    loc = ((locs - loc_t).abs() * pos[..., None]).sum() / torch.clamp(n_pos * 6, min=1)
    ce = torch.logsumexp(logits, -1) - torch.gather(logits, -1, cls_t.clamp(min=0)[..., None])[..., 0]
    ce = torch.where(cls_t < 0, 0.0, ce)
    neg = torch.where(pos, 0.0, ce).detach()
    hard = torch.zeros_like(pos)
    for i in range(neg.shape[0]):
        n_hard = int(NEG_POS_RATIO * pos[i].sum())
        order = torch.argsort(-neg[i], stable=True)[:n_hard]
        hard[i, order] = True
    hard &= ~pos
    conf = torch.where(pos | hard, ce, 0.0).sum() / torch.clamp(n_pos, min=1).float()
    return conf + alpha * loc, conf, loc


def learning_rate(cfg: dict, count: int) -> float:
    """The half-cosine schedule over t_max updates, held at 0 after it."""
    t = min(count, int(cfg["t_max"]))
    return float(cfg["lr"]) * (1 + math.cos(math.pi * t / int(cfg["t_max"]))) / 2


class Trainer:
    """The reference's training state: float32 parameters (every kind that is
    neither a statistic nor a counter), the statistics and Adam's moments,
    by the state dict's names."""

    def __init__(self, cfg: dict, state_dict: dict, aug: dict, device):
        self.cfg, self.aug = cfg, aug
        roles = ssd3d.roles(cfg)
        role = {name: roles[kind] for name, _, kind, _ in ssd3d.param_specs(cfg)}
        self.params = {n: v.detach().float().clone().to(device) for n, v in state_dict.items()
                       if role[n] not in ("statistic", "counter")}
        self.stats = {n: v.detach().float().clone().to(device) for n, v in state_dict.items()
                      if role[n] == "statistic"}
        self.mu = {n: torch.zeros_like(v) for n, v in self.params.items()}
        self.nu = {n: torch.zeros_like(v) for n, v in self.params.items()}
        self.count = 0
        self.priors = bx.priors(cfg, ssd3d.tower_plan(cfg), device)

    def step(self, batch: dict, gen: torch.Generator) -> dict:
        """One update on ``batch`` (image, boxes, labels, box_mask); returns
        the loss terms and the gradients by name."""
        cfg = self.cfg
        images, boxes = batch["image"], batch["boxes"]
        params = draw_augment(gen, images.shape[0], images.shape[1:4], self.aug)
        images, boxes = augment(images, boxes, params)
        boxes = boxes.clamp(0.0, 1.0)
        mask = batch["box_mask"] & ~(boxes[..., 3:] <= boxes[..., :3]).any(-1)
        lo, hi = cfg["threshold"]
        loc_t, cls_t = match(boxes, batch["labels"], mask, self.priors, lo, hi)
        leaves = {n: p.clone().requires_grad_() for n, p in self.params.items()}
        moved = {}
        locs, logits = ssd3d.forward({**leaves, **self.stats}, cfg, images, train=True,
                                     moved=moved, generator=gen)
        total, conf, loc = multibox_loss(locs, logits, loc_t, cls_t, float(cfg["alpha"]))
        names = list(leaves)
        grads = torch.autograd.grad(total, [leaves[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(leaves[n]) if g is None else g for n, g in zip(names, grads)}
        lr = learning_rate(cfg, self.count)
        self.count += 1
        for n in names:
            g = grads[n] + WEIGHT_DECAY * self.params[n]
            self.mu[n] = ADAM_B1 * self.mu[n] + (1 - ADAM_B1) * g
            self.nu[n] = ADAM_B2 * self.nu[n] + (1 - ADAM_B2) * g * g
            m_hat = self.mu[n] / (1 - ADAM_B1 ** self.count)
            v_hat = self.nu[n] / (1 - ADAM_B2 ** self.count)
            mult = 2.0 if n.rsplit(".", 1)[-1] == "bias" else 1.0
            self.params[n] = self.params[n] - mult * lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        self.stats.update(moved)
        return {"total": float(total.detach()), "conf": float(conf.detach()), "loc": float(loc.detach()),
                "grads": grads}
