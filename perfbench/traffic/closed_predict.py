"""Closed loop of batch scoring: one client calls ``Detector.predict`` back to
back with ``batch`` host float32 volumes a call, cycling through a pool of
``pool`` seeded volumes.

Parameters: ``batch``, ``pool`` (a multiple of ``batch``), ``batch_sizes``
(the detector's routes), ``flags`` (config fields switched on, such as
``use_pallas``), ``warmup_calls``, ``trace_seconds`` (the traced window's
length at most), ``check_calls`` (calls of the window compared with the
reference, drawn from the seed, besides the last call on each pool batch),
``ref_block`` (volumes a reference forward) and ``host_threads`` (torch's
intra-op threads on the host, which cast each call's float32 volumes into a
pinned buffer of the served type, whose one copy to the card the call then
queues).
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from perfbench.lib import data, serve_check, weights
from perfbench.reference import boxes as bx
from perfbench.reference import ssd3d as ref


class Run:
    def __init__(self, cell):
        self.cell = cell
        self.control = cell.control  # "int8": the program's int8 path in the bf16 one's place
        self.cfg = cell.model
        self.outs = []
        self._nms = None

    def setup(self):
        from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig
        from mslesions3d_tpu_torch.serving import DetectionProgram, Detector, route

        cell, p = self.cell, self.cell.params
        if "host_threads" in p:
            torch.set_num_threads(int(p["host_threads"]))
        dev = torch.device(cell.device)
        config = SSD3DConfig.from_json_dict(self.cfg)
        self.state_dict = weights.make_state_dict(
            self.cfg, cell.seed, dev, "served", config.compute_dtype,
            box_size_gain=float(cell.config["weights"]["box_size_gain"]))
        inputs = cell.config["inputs"]
        self.pool = data.make_volumes(int(p["pool"]), config.input_size, inputs["objects"],
                                      inputs["object_size"], cell.seed + 1, dev)["image"]
        host = self.pool.cpu().numpy()
        b = int(p["batch"])
        self.batches = [np.ascontiguousarray(host[i:i + b]) for i in range(0, len(host), b)]
        if self.control == "int8":
            from mslesions3d_tpu_torch import quant

            calib = data.make_volumes(8, config.input_size, inputs["objects"],
                                      inputs["object_size"], cell.seed + 2, dev)["image"]
            qmodel = quant.quantize_ssd3d(config, self.state_dict, calib.cpu().numpy(),
                                          device=dev)
            program = DetectionProgram.for_config(quant.QuantizedSSD3D(qmodel), config).to(dev)

            @torch.inference_mode()
            def call(x):
                return program(x)

            sizes = sorted(int(s) for s in p["batch_sizes"])
            self.predict = lambda images: route(np.asarray(images), sizes, dev,
                                                config.compute_dtype, call)
            self.model = program.model
        else:
            self.detector = Detector(config, self.state_dict, device=dev,
                                     batch_sizes=p["batch_sizes"])
            self.predict = self.detector.predict
            self.model = self.detector.model
        self.config = config
        if "nosuppress" in cell.faults:  # K1 keeps every candidate
            from mslesions3d_tpu_torch.ops import nms as port_nms

            self._k1 = port_nms.greedy_nms_cuda
            port_nms.greedy_nms_cuda = lambda boxes, valid, max_overlap, plan=None: valid.clone()
        if cell.trace and self.control is None:
            dw12_spans(self.model)
        for i in range(int(p["warmup_calls"])):
            self.predict(self.batches[i % len(self.batches)])

    def window(self, seconds: float) -> dict:
        if self.cell.trace:
            seconds = min(seconds, float(self.cell.params["trace_seconds"]))
        faults = self.cell.faults
        b = int(self.cell.params["batch"])
        calls, previous = 0, None
        # ``stale`` needs a previous call to hand back, however short the window
        least = 2 if "stale" in faults else 1
        t0 = time.perf_counter()
        while calls < least or time.perf_counter() - t0 < seconds:
            which = calls % len(self.batches)
            with torch.profiler.record_function("perfbench.call"):
                out = self.predict(self.batches[which])
            out = serve_check.break_answers(out, previous, faults) if faults else out
            previous = out
            self.outs.append((which, out))
            calls += 1
        elapsed = time.perf_counter() - t0
        self.calls, self.elapsed = calls, elapsed
        return {"attempted": calls * b, "failed": 0,
                "metrics": {"volumes_per_s": calls * b / elapsed}}

    def nms_last_valid(self) -> list:
        """Each pool batch's K1 rows: the 1-based position of the last valid
        candidate of every (volume, class) row, from the program's own
        outputs on the pool (run after the window)."""
        if self._nms is None:
            cfg = self.config
            k = None
            rows = []
            with torch.inference_mode():
                for x in self.batches:
                    locs, logits = self.model(torch.as_tensor(x, device=self.cell.device)
                                              .to(cfg.compute_dtype))
                    probs = torch.softmax(logits.float(), -1)[..., 1:]
                    k = min(10 * cfg.top_k, probs.shape[1])
                    top = torch.sort(probs.transpose(1, 2).reshape(-1, probs.shape[1]), dim=1,
                                     descending=True).values[:, :k]
                    rows.append((top > cfg.min_score).sum(1).tolist())
            self._nms = (k, rows)
        return self._nms

    def release(self):
        if "_k1" in self.__dict__:
            from mslesions3d_tpu_torch.ops import nms as port_nms

            port_nms.greedy_nms_cuda = self.__dict__.pop("_k1")
        for name in ("detector", "predict", "model"):
            self.__dict__.pop(name, None)
        if self.cell.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        """The window's calls drawn from the seed, and the last call on each
        batch of the pool (every volume served is compared at least once),
        against the reference."""
        p, cfg = self.cell.params, self.cfg
        rng = random.Random(self.cell.seed)
        picks = rng.sample(range(len(self.outs)), min(int(p["check_calls"]), len(self.outs)))
        last = {which: i for i, (which, _) in enumerate(self.outs)}
        picks = sorted(set(picks) | set(last.values()))
        priors_c = bx.priors(cfg, ref.tower_plan(cfg), self.pool.device)
        b, block = int(p["batch"]), int(p["ref_block"])
        program, plain = [], []
        with torch.no_grad(), ref.float32_exact():
            for i in picks:
                which, out = self.outs[i]
                for s in range(0, b, block):
                    x = self.pool[which * b + s: which * b + s + block]
                    part = {k: v[s:s + block] for k, v in out.items()}
                    mine, theirs = serve_check.reference_gaps(self.state_dict, cfg, x, part,
                                                              priors_c, self.config.compute_dtype)
                    program += mine
                    plain += theirs
        self.readings = serve_check.summaries(program)
        plain_stats = serve_check.summaries(plain)
        self.readings.update({f"plain_{k}": v for k, v in plain_stats.items()})
        self.readings["answer_ratio"] = (self.readings[serve_check.ANSWER_GAP]
                                         / plain_stats[serve_check.ANSWER_GAP])
        limits = self.cell.workload["limits"]
        return [("answer_ratio", self.readings["answer_ratio"], limits["answer_ratio"]),
                ("overlap_excess", self.readings["overlap_excess"], limits["overlap_excess"])]



def dw12_spans(model) -> None:
    """A ``perfbench.dw12`` range around the depthwise conv of blocks 1 and 2:
    opened as the block starts, closed as its first BatchNorm does. A block
    with no ``bn1`` is no depthwise block (the ConvNet's towers have none)
    and gets no range, so ``dw12_roofline.serve`` reads nothing there."""
    for i in (1, 2):
        block, open_range = model.base.features[i], {}
        if not hasattr(block, "bn1"):
            continue

        def start(module, args, open_range=open_range):
            open_range["range"] = torch.profiler.record_function("perfbench.dw12")
            open_range["range"].__enter__()

        def stop(module, args, open_range=open_range):
            if "range" in open_range:
                open_range.pop("range").__exit__(None, None, None)

        block.register_forward_pre_hook(start)
        block.bn1.register_forward_pre_hook(stop)
