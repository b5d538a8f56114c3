"""Probe: is torch's first float32 log in a fresh CPU process right?

Starts fresh interpreters; each takes ``torch.log`` of ``--size`` float32
values (by default 14016, the encoded box sizes at the 64^3 geometry,
batch 4) twice and reports whether the first call's bits differ from the second's,
where they differ and by how many float32 ulp of the float64 log each call
is off. With ``--warm`` each process first takes the log of a tiny tensor,
as the port's CPU tests do before they compare box encodings:

    python tests/probe_torch_first_log.py --processes 200
    python tests/probe_torch_first_log.py --processes 200 --warm

The last line is a JSON summary with torch's version and CPU capability.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = r"""
import json, sys
import numpy as np
import torch
if sys.argv[1] == "1":
    torch.log(torch.ones(8))
x = torch.linspace(0.01, 10.0, int(sys.argv[2]))
first, later = torch.log(x), torch.log(x)
exact = np.log(x.double().numpy())
ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
off = [float((np.abs(t.double().numpy() - exact) / ulp).max()) for t in (first, later)]
idx = np.nonzero((first != later).numpy())[0]
print(json.dumps({"differing": int(idx.size), "span": [int(idx.min()), int(idx.max())]
                  if idx.size else None, "ulp_first": off[0], "ulp_later": off[1],
                  "threads": torch.get_num_threads()}))
"""


def one(warm: bool, size: int) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(int(warm)), str(size)],
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--processes", type=int, default=200)
    parser.add_argument("--parallel", type=int, default=8)
    parser.add_argument("--size", type=int, default=14016)
    parser.add_argument("--warm", action="store_true")
    args = parser.parse_args()
    import torch

    with ThreadPoolExecutor(args.parallel) as ex:
        runs = list(ex.map(one, [args.warm] * args.processes, [args.size] * args.processes))
    bad = [r for r in runs if r["differing"]]
    for r in bad:
        print(json.dumps(r))
    print(json.dumps({
        "torch": torch.__version__, "cpu_capability": torch.backends.cpu.get_cpu_capability(),
        "size": args.size, "warm": args.warm, "processes": len(runs), "first_call_differs": len(bad),
        "max_ulp_first": max(r["ulp_first"] for r in runs),
        "max_ulp_later": max(r["ulp_later"] for r in runs),
    }))


if __name__ == "__main__":
    main()
