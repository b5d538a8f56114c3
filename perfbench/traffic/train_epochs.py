"""Recipe training over a device cache, epochs drawn as ``Trainer.fit`` draws
them: each epoch a permutation of the training rows from
``numpy.random.default_rng(seed + epoch)``, batches its consecutive rows,
and the step's generator (on the card) reseeded with ``seed + epoch``.

The program is ``make_gathered_train_epoch``: one call an epoch, on the card
one CUDA graph replayed a step. Parameters: ``batch``, ``trace_seconds``.

Set-up builds the training state and the program, and drives them through
the run's first ``CHECK_CALLS`` calls (epochs 0 and 1) as the window calls
them, a whole epoch a call (two chained replays at batch 64). Those steps
are the ones the reference follows after the window; the state after the
first call and after the last is kept. The window then carries on from
there for ``--seconds``; a step counts when it has ended (the window ends
with a wait for the card).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.lib import data, train_check, weights

CHECK_CALLS = 2


class Run:
    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config["model"]
        self.steps = 0

    def setup(self):
        from mslesions3d_tpu_torch.data.augment import AugmentConfig
        from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
        from mslesions3d_tpu_torch.train import create_train_state
        from mslesions3d_tpu_torch.train.state import use_ieee_float32
        from mslesions3d_tpu_torch.train.steps import make_gathered_train_epoch

        cell, p = self.cell, self.cell.params
        dev = torch.device(cell.device)
        train = cell.config["train"]
        if train["ieee_float32"]:
            use_ieee_float32()
        config = SSD3DConfig.from_json_dict(self.cfg)
        self.state_dict = weights.make_state_dict(self.cfg, cell.seed, dev, "init")
        inputs = cell.config["inputs"]
        n = int(inputs["num_images"])
        volumes = data.make_volumes(n, config.input_size, inputs["objects"],
                                    inputs["object_size"], cell.seed + 1, dev)
        n_train = int(round(n * float(inputs["train_share"])))
        self.data = {k: v[:n_train].contiguous() for k, v in volumes.items()}
        augment = AugmentConfig.from_names(train["augment_names"])
        model = SSD3D(config)
        options = dict(hard_negative_mining=bool(train["hard_negative_mining"]))
        self.batch = int(p["batch"])
        self.fn = make_gathered_train_epoch(config, model, model_priors(config), augment,
                                            **options)
        self.generator = torch.Generator(device=dev)
        self.state = create_train_state(config, device=dev, state_dict=self.state_dict)
        self.n_train = n_train
        self.epoch = -1
        # the first calls, kept for the check: each step's rows, epoch and
        # loss, and the states before the first call, after it and after the last
        self.first = {"state0": self._snapshot(self.state), "rows": [], "epochs": [],
                      "losses": [], "calls": []}
        for _ in range(CHECK_CALLS):
            epoch, idx = self._next_epoch()
            losses = self._advance(idx)
            self.first["rows"] += list(idx.clone())
            self.first["epochs"] += [epoch] * len(idx)
            self.first["losses"] += [float(x) for x in losses.reshape(-1)]
            self.first["calls"].append(len(self.first["rows"]))
            if len(self.first["calls"]) == 1:
                self.first["state1"] = self._snapshot(self.state)
        self.first["last"] = self._snapshot(self.state)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _next_epoch(self):
        """(epoch, its batches' rows (n, B)): the next epoch's permutation in
        whole batches, the rows left over dropped as ``Trainer.fit`` drops them."""
        self.epoch += 1
        rg = np.random.default_rng(self.cell.seed + self.epoch)
        perm = torch.from_numpy(rg.permutation(self.n_train)).to(self.cell.device)
        self.generator.manual_seed(self.cell.seed + self.epoch)
        n = self.n_train // self.batch
        return self.epoch, perm[:n * self.batch].view(n, self.batch)

    def _advance(self, idx_matrix):
        """Run the rows of ``idx_matrix`` (n, B) through the program; returns
        each step's total loss (n,) on the device."""
        faults = self.cell.faults
        if "half" in faults:  # half of the batch left out, the mean over the rest
            idx_matrix = idx_matrix[:, : self.batch // 2]
        before = self.state
        self.state, m = self.fn(self.state, self.data, idx_matrix, self.generator)
        if faults:
            self.state = train_check.break_state(self.state, before, faults, self.cfg)
        return m["total_loss"]

    @staticmethod
    def _snapshot(state) -> dict:
        return {"params": {k: v.clone() for k, v in state.params.items()},
                "stats": {k: v.clone() for k, v in state.batch_stats.items()},
                "mu": {k: v.clone() for k, v in state.opt_state.mu.items()}}

    def window(self, seconds: float) -> dict:
        if self.cell.trace:
            seconds = min(seconds, float(self.cell.params["trace_seconds"]))
        steps = 0
        t0 = time.perf_counter()
        while steps == 0 or time.perf_counter() - t0 < seconds:
            _, rows = self._next_epoch()
            with torch.profiler.record_function("perfbench.step"):
                self._advance(rows)
            steps += len(rows)
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        self.steps = steps
        return {"attempted": steps * self.batch, "failed": 0,
                "metrics": {"train_volumes_per_s": steps * self.batch / elapsed}}

    def release(self):
        for name in ("fn", "state"):
            self.__dict__.pop(name, None)
        if self.cell.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        self.readings, checks = train_check.check(self.cell, self.cfg, self.state_dict,
                                                  self.data, self.first, self.generator.device)
        return checks
