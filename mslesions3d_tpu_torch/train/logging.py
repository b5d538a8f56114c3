"""Metrics logging: JSONL always; TensorBoard and wandb when installed.

Counterpart of ``mslesions3d_tpu/train/logging.py``: the same
``metrics.jsonl`` records and scalar names (total_loss/training,
mAP/validation_IoU_0.1, hp_metric/lr, ...) as the reference's
TensorBoardLogger / WandbLogger pair (lesions3d/train.py:166-170).
tensorboardX and wandb stay optional imports; without either,
:meth:`MetricsLogger.log_histograms` does nothing.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


class MetricsLogger:
    def __init__(self, logdir, experiment_name: str = "default", use_wandb: bool = False,
                 use_tensorboard: bool = True, wandb_config: dict | None = None):
        self.logdir = Path(logdir) / experiment_name
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "metrics.jsonl", "a")

        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(logdir=str(self.logdir / "tb"))

        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                wandb.init(project="mslesions3d-tpu", dir=str(self.logdir),
                           config=wandb_config or {})
                self._wandb = wandb

    def log(self, metrics: dict, step: int):
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)
        if self._wandb is not None:
            self._wandb.log({k: float(v) for k, v in metrics.items()}, step=step)

    def log_histograms(self, tree: dict, step: int, prefix: str = "epoch/"):
        """Per-tensor histograms of a name -> tensor dict (e.g. the gradients).

        Parity: the reference's on_after_backward logs every parameter's
        gradient histogram to TB as "epoch/<name>" every 25 steps
        (lesions3d/ssd3d.py:729-738). JSONL gets nothing (too big); wandb
        gets wandb.Histogram when active.
        """
        if self._tb is None and self._wandb is None:
            return
        for name, leaf in tree.items():
            values = np.asarray(leaf.detach().float().cpu(), np.float32).ravel()
            if self._tb is not None:
                self._tb.add_histogram(prefix + name, values, step)
            if self._wandb is not None:
                self._wandb.log({prefix + name: self._wandb.Histogram(values)}, step=step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
