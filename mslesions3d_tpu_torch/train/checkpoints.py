"""Checkpointing: top-k retention on a monitored metric, hparams in the
checkpoint, resume.

Counterpart of ``mslesions3d_tpu/train/checkpoints.py``, with the
reference's ModelCheckpoint semantics (lesions3d/train.py:171-176:
monitor=avg_val_loss, save_top_k=3, mode=min; hparams embedded so a
checkpoint rebuilds its model). The directory names, the ``last``
directory and the ``meta.json`` schema are the JAX package's. The state
file is the port's own: ``state.pt``, written by ``torch.save`` as a dict of
tensors (step, params, batch_stats, opt_state, ema_params,
nonfinite_streak) and read back with ``weights_only=True``.
"""

from __future__ import annotations

import json
import shutil
import warnings
from pathlib import Path

import torch

from ..models.ssd3d import SSD3DConfig
from .state import AdamState, TrainState

STATE_FILE = "state.pt"


def _host(tree: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_checkpoint(directory, state: TrainState, config: SSD3DConfig,
                    metrics: dict | None = None, extra: dict | None = None):
    """Write one checkpoint: state.pt + meta.json."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    payload = {
        "step": state.step.detach().cpu(),
        "params": _host(state.params),
        "batch_stats": _host(state.batch_stats),
        "opt_state": {"count": state.opt_state.count.detach().cpu(),
                      "mu": _host(state.opt_state.mu), "nu": _host(state.opt_state.nu)},
        "nonfinite_streak": state.nonfinite_streak.detach().cpu(),
    }
    if state.ema_params is not None:
        payload["ema_params"] = _host(state.ema_params)
    torch.save(payload, directory / STATE_FILE)
    meta = {
        "step": int(state.step),
        "config": config.to_json_dict(),
        "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        "extra": extra or {},
    }
    (directory / "meta.json").write_text(json.dumps(meta, indent=2))
    return directory


def _onto(template: dict, stored: dict, name: str) -> dict:
    """``stored`` on the template's devices and dtypes, with the strides it
    was saved with: the state a run left, whose layout the convs see, so a
    resumed run computes what the run straight through would have."""
    if set(stored) != set(template):
        raise ValueError(f"checkpoint {name}: names differ from the model's: "
                         f"{sorted(set(stored) ^ set(template))[:5]}")
    out = {}
    for k, t in template.items():
        if stored[k].shape != t.shape:
            raise ValueError(f"checkpoint {name}.{k}: shape {tuple(stored[k].shape)}, the "
                             f"model's {tuple(t.shape)}")
        out[k] = stored[k].to(device=t.device, dtype=t.dtype)
    return out


def load_checkpoint(directory, state_template: TrainState | None = None):
    """Load (config, state or payload, meta) from a checkpoint directory.

    With a state_template (a TrainState from ``create_train_state``) the
    full training state is restored onto the template's device; otherwise
    the raw payload of CPU tensors returns (enough for inference: params +
    batch_stats).
    """
    directory = Path(directory)
    meta = json.loads((directory / "meta.json").read_text())
    config = SSD3DConfig.from_json_dict(meta["config"])
    stored = torch.load(directory / STATE_FILE, map_location="cpu", weights_only=True)
    if state_template is None:
        return config, stored, meta

    t = state_template
    params = _onto(t.params, stored["params"], "params")
    if "ema_params" in stored and t.ema_params is None:
        # EMA-trained checkpoint resumed with ema_decay=0: the step would
        # never update the stale average, yet eval_view prefers it. Drop it.
        warnings.warn(
            "checkpoint holds ema_params but the resumed run has ema_decay=0 — dropping the "
            "stale EMA; raw params will be trained and evaluated", stacklevel=2,
        )
        ema = None
    elif "ema_params" in stored:
        ema = _onto(t.ema_params, stored["ema_params"], "ema_params")
    else:
        # pre-EMA checkpoint resumed with ema_decay on: seed it from the params
        ema = {k: v.clone() for k, v in params.items()} if t.ema_params is not None else None
    opt = stored["opt_state"]
    state = t.replace(
        step=stored["step"].to(t.step),
        params=params,
        batch_stats=_onto(t.batch_stats, stored["batch_stats"], "batch_stats"),
        opt_state=AdamState(count=opt["count"].to(t.opt_state.count),
                            mu=_onto(t.opt_state.mu, opt["mu"], "opt_state.mu"),
                            nu=_onto(t.opt_state.nu, opt["nu"], "opt_state.nu")),
        nonfinite_streak=stored["nonfinite_streak"].to(t.nonfinite_streak),
        ema_params=ema,
    )
    return config, state, meta


class CheckpointManager:
    """Top-k retention on a monitored metric (min or max)."""

    def __init__(self, root, monitor: str = "avg_val_loss", mode: str = "min",
                 save_top_k: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self._kept: list[tuple[float, Path]] = []
        self._restore_index()

    def _restore_index(self):
        for d in sorted(self.root.glob("checkpoint-*")):
            meta_path = d / "meta.json"
            if not meta_path.exists():
                continue
            meta = json.loads(meta_path.read_text())
            value = meta["metrics"].get(self.monitor)
            if value is not None:
                self._kept.append((value, d))
        self._sort()

    def _sort(self):
        self._kept.sort(key=lambda t: t[0], reverse=(self.mode == "max"))

    def save(self, state, config, metrics: dict, epoch: int):
        value = float(metrics[self.monitor])
        name = f"checkpoint-epoch={epoch:03d}-{self.monitor}={value:.4f}"
        path = save_checkpoint(self.root / name, state, config, metrics,
                               extra={"epoch": epoch})
        self._kept.append((value, path))
        self._sort()
        while len(self._kept) > self.save_top_k:
            _, worst = self._kept.pop()
            shutil.rmtree(worst, ignore_errors=True)
        # always keep the most recent state for resume, independent of top-k
        save_checkpoint(self.root / "last", state, config, metrics, extra={"epoch": epoch})
        return path

    @property
    def best(self) -> Path | None:
        return self._kept[0][1] if self._kept else None

    @property
    def latest(self) -> Path | None:
        if not self._kept:
            return None
        return max(
            self._kept,
            key=lambda t: json.loads((t[1] / "meta.json").read_text())["step"],
        )[1]
