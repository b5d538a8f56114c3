"""LR finder: exponential learning-rate sweep with loss tracking.

Usage:
  python -m mslesions3d_tpu_torch.cli.tune_lr -d <dataset_root> [-b 8] [-n 60] [--device cpu]

Counterpart of ``mslesions3d_tpu/cli/tune_lr.py`` (the reference's
tune_lr(), lesions3d/train.py:94-118, which wraps Lightning's auto_lr_find),
with the same flags except that ``--platform`` is ``--device`` (the card by
default; it raises without one). It sweeps lr geometrically from lr_min to
lr_max over n_steps single batches with plain SGD and train-mode BatchNorm,
records the (smoothed) loss per lr, stops when the smoothed loss passes 4x
its minimum or turns non-finite, and suggests the lr at the steepest
descent (the Leslie-Smith heuristic).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch.func import functional_call

from ..data.datasets import SyntheticDataModule
from ..models.losses import multibox_loss_from_config
from ..models.ssd3d import SSD3D, SSD3DConfig, model_priors
from ..train.state import create_train_state, resolve_device, use_ieee_float32


def lr_find(config: SSD3DConfig, datamodule, lr_min=1e-6, lr_max=1.0, n_steps=60,
            smoothing=0.8, seed=0, device="cuda", state_dict=None):
    """(suggested lr, history of {"lr", "loss", "smoothed"}) on ``device``.

    The weights are ``config.init_scheme``'s from ``seed``, or
    ``state_dict`` (the reference schema) when given.
    """
    state = create_train_state(config, seed=seed, device=device, state_dict=state_dict)
    device = state.device
    model = SSD3D(config).train()
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    priors = torch.as_tensor(model_priors(config), device=device)

    def step(params, batch_stats, lr, batch):
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        stats = {n: s.clone() for n, s in batch_stats.items()}  # moved in place by BN
        locs, scores = functional_call(
            model, ({n: p.to(dtypes[n]) for n, p in leaves.items()}, stats), (batch["image"],))
        conf, loc = multibox_loss_from_config(
            config, locs, scores, batch["boxes"], batch["labels"], batch["box_mask"], priors)
        loss = conf + config.alpha * loc
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        new = {n: params[n] if g is None else params[n] - lr * g for n, g in zip(names, grads)}
        return new, stats, loss.detach()

    params, batch_stats = state.params, state.batch_stats
    history = []
    smoothed = None
    batch_cache = [
        {k: torch.as_tensor(v, device=device) for k, v in b.items() if isinstance(v, np.ndarray)}
        for b in datamodule.train_batches(epoch=0, drop_partial=False)
    ]

    for i, lr in enumerate(np.geomspace(lr_min, lr_max, n_steps)):
        batch = batch_cache[i % len(batch_cache)]
        params, batch_stats, loss = step(params, batch_stats, float(np.float32(lr)), batch)
        loss = float(loss)
        if not np.isfinite(loss):
            history.append({"lr": float(lr), "loss": float("inf")})
            break
        smoothed = loss if smoothed is None else smoothing * smoothed + (1 - smoothing) * loss
        history.append({"lr": float(lr), "loss": loss, "smoothed": smoothed})
        if smoothed > 4 * min(h.get("smoothed", np.inf) for h in history):
            break  # diverged

    finite = [h for h in history if np.isfinite(h["loss"]) and "smoothed" in h]
    if len(finite) < 3:
        suggestion = lr_min
    else:
        losses = np.array([h["smoothed"] for h in finite])
        suggestion = finite[int(np.argmin(np.gradient(losses)))]["lr"]
    return suggestion, history


def build_parser():
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-d", "--dataset_path", type=str, required=True)
    p.add_argument("-dn", "--dataset_name", type=str, default=None)
    p.add_argument("--n_classes", type=int, default=1)
    p.add_argument("-b", "--batch_size", type=int, default=8)
    p.add_argument("-wm", "--width_mult", type=float, default=1.0)
    p.add_argument("-n", "--n_steps", type=int, default=60)
    p.add_argument("--lr_min", type=float, default=1e-6)
    p.add_argument("--lr_max", type=float, default=1.0)
    p.add_argument("-o", "--output", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="where to sweep: cuda (the card; raises without one) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, "cli.tune_lr")
    use_ieee_float32()

    dm = SyntheticDataModule(
        data_dir=args.dataset_path, dataset_name=args.dataset_name,
        n_classes=args.n_classes, batch_size=args.batch_size, cache=True,
    )
    dm.setup("fit")
    input_size = dm.get_sample(dm.trainsubs[0])["img"].shape[:3]
    config = SSD3DConfig.create(
        n_classes=args.n_classes + 1, input_channels=1,
        input_size=tuple(input_size), width_mult=args.width_mult,
        threshold=[0.1, 0.2],
    )
    suggestion, history = lr_find(
        config, dm, args.lr_min, args.lr_max, args.n_steps, device=device,
    )
    print(f"[tune_lr] suggested learning rate: {suggestion:.2e}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"suggestion": suggestion, "history": history}, f, indent=2)
    return suggestion


if __name__ == "__main__":
    main()
