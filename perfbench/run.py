"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs made on the card from the seed, the program
built and every shape of the cell warmed), a measured window of
``--seconds``, then the comparison with the plain reference that decides
``correct``. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics from a torch.profiler trace of the window. The
last line of standard output is the result as one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
Without a card (or with fewer than the cell asks for) it exits 2 and
prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from perfbench.lib import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str, code: int = 2):
    print(f"perfbench: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def execute(cell: harness.Cell, t0: float = T0, require_chips: bool = True,
            readings: dict | None = None) -> dict:
    """Set up, measure and check one run of ``cell``; returns the result dict
    (``checks`` last). ``require_chips`` off lets the CPU tests drive a run
    at a tiny size; ``readings`` receives every statistic the check read."""
    import torch

    bench = harness.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == cell.name), None)
    if entry is None:
        fail(f"no workload {cell.name!r} in BENCHMARK.json")
    if require_chips:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: this benchmark runs on the card")
        if torch.cuda.device_count() < int(entry["chips"]):
            fail(f"{cell.name} needs {entry['chips']} cards; "
                 f"{torch.cuda.device_count()} visible")
    on_card = cell.device == "cuda"
    run = harness.traffic(cell).Run(cell)
    run.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    trace = None
    with harness.profiled(cell.trace and on_card) as prof:
        with torch.profiler.record_function("perfbench.window"):
            out = run.window(cell.seconds)
        if on_card:
            torch.cuda.synchronize()
    if prof is not None:
        from perfbench.lib.trace import Trace

        trace = Trace(prof)
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": int(entry["chips"]) if on_card else 1,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0}
    if cell.trace:
        ctx = types.SimpleNamespace(cell=cell, run=run, out=out, trace=trace)
        metrics = harness.layer_metrics(bench, cell, ctx)
        if trace is not None:
            device["busy_s"] = trace.busy_s()
            device["window_s"] = trace.window_s
    else:
        metrics = {}
        for m in bench["end_to_end"]:
            if not harness.reports(m, cell.name):
                continue
            value = setup_s if m["name"] == "setup_s" else out["metrics"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    run.release()
    checks = run.check()
    if readings is not None:
        readings.update(getattr(run, "readings", {}))
    correct = all(value <= limit for _, value, limit in checks)
    result = {"correct": correct, "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": device}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["checks"] = {name: {"value": float(value), "limit": float(limit)}
                        for name, value, limit in checks}
    return result


def main(argv=None):
    args = parse(argv)
    cell = harness.make_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    result = execute(cell)
    found = harness.forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {', '.join(found)}", 3)
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"card: {smi.stdout.strip()}", file=sys.stderr)
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
