"""The benchmark's harness: one cell, one run, one result line.

A cell is ``workloads/<name>.json``: its configuration (``configs/<config>.json``),
its traffic module (``traffic/<name>.py``, with a ``Run`` class) and
that module's parameters, the limits of the numbers that decide
``correct``, and why it exists. A per-layer metric is read by a module with
``read(ctx) -> float | None``: ``metrics/<name>.py``, or where there is none
the module of the name with its last dotted part taken off, and so on
(``idle_share.batch`` and ``idle_share.train`` are both read by
``metrics/idle_share.py``). Everything is found by the name
``BENCHMARK.json`` gives it, so a cell or a metric is added as files.

A traffic module's ``Run(cell)`` has ``setup()`` (everything up to the window,
every shape warmed), ``window(seconds) -> {"attempted", "failed",
"metrics"}`` (the measured loop; its end-to-end metrics by name),
``release()`` (drops the program's state) and ``check() -> [(name, value,
limit)]`` (the comparison with the plain reference, run after the window).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PERFBENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "mslesions3d_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    faults: tuple = ()  # broken paths planted by the tests and the calibration runs
    control: str | None = None  # the lower precision put in the program's place

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @property
    def model(self) -> dict:
        """The configuration's model fields, with the cell's ``flags`` switched on."""
        return {**self.config["model"], **{k: True for k in self.params.get("flags", ())}}


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def make_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
              faults: tuple = (), overrides: dict | None = None,
              control: str | None = None) -> Cell:
    """The cell ``name`` from its files; ``overrides`` replaces workload
    parameters (the CPU tests shrink a cell with it)."""
    workload = load_json(PERFBENCH / "workloads" / f"{name}.json")
    config = load_json(PERFBENCH / "configs" / f"{workload['config']}.json")
    if overrides:
        workload = {**workload, "params": {**workload["params"], **overrides.get("params", {})}}
        config = {**config, "model": {**config["model"], **overrides.get("model", {})}}
    return Cell(name, workload, config, int(seed), float(seconds), bool(trace), device, faults,
                control)


def traffic(cell: Cell):
    return load_module(PERFBENCH / "traffic" / f"{cell.workload['traffic']}.py",
                       f"perfbench_traffic_{cell.workload['traffic']}")


def reports(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def forbidden_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def reader_path(metric: str) -> Path:
    """The module that reads the per-layer metric ``metric``."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = PERFBENCH / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for the metric {metric!r} under perfbench/metrics")


def layer_metrics(bench: dict, cell: Cell, ctx) -> dict:
    out = {}
    for entry in bench["per_layer"]:
        if not reports(entry, cell.name):
            continue
        path = reader_path(entry["name"])
        module = load_module(path, "perfbench_metric_" + path.stem.replace(".", "_"))
        value = module.read(ctx)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """A torch.profiler session of the CPU and the card, or nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
