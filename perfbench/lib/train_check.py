"""Whether the program's first training steps are the reference's.

Set-up drove the program through the run's first calls, each as the window
calls it (a whole epoch of chained graph replays), and kept the state
before them, after the first call and after the last. The
reference (``reference/train.py``) takes the same weights, rows and
generator seeds and follows the same steps. A leaf's gap is |norm(program)
- norm(reference)| over the larger of the reference leaf's norm and the
median leaf's. Three numbers are compared:

* ``loss_gap``: the relative gap of the first step's total loss.
* ``grad_gap``: the median leaf's gap of Adam's first moment after the
  first call, the gradients as the optimizer got them: 0.09 (g1 + 5e-4 p0)
  + 0.1 (g2 + 5e-4 p1) over an epoch of two steps, whose state after one
  step stays inside the graph.
* ``change_gap``: the worst leaf's gap of the change over the calls
  (parameters, and the BatchNorm running statistics); parameters whose
  reference gradient is under a thousandth of the median leaf's move by
  round-off alone under Adam and are left out.

The first step's loss and the median leaf stand where the worst step and the
worst leaf would read the noise of the later steps and of small leaves on
sound runs: Adam's first update moves an element whose gradient is near zero
by about the learning rate whatever its sign, so float32 round-off in it
reaches the later losses; and the early BatchNorm biases' and weights'
gradients are sums over millions of voxels that cancel, so their float32
round-off reaches 1e-3 of their norm (PERF.md). ``gaps`` reads all six.
"""

from __future__ import annotations

import statistics

import torch

from ..reference import ssd3d as ref
from ..reference import train as ref_train

ROUNDOFF_SHARE = 1e-3
# the numbers compared, by the reading each is
COMPARED = {"loss_gap": "loss_step1", "grad_gap": "grad_median", "change_gap": "change_worst"}


def break_state(new, before, faults, cfg: dict):
    """The faults the tests and calibration plant in a train step's result:
    ``unchanged`` hands back the old state, ``double`` moves one leaf twice
    (the backbone family's ``DOUBLE_LEAF``)."""
    if "unchanged" in faults:
        return before
    if "double" in faults:
        leaf = ref.family(cfg).DOUBLE_LEAF
        params = dict(new.params)
        params[leaf] = 2 * new.params[leaf] - before.params[leaf]
        return new.replace(params=params)
    return new


def leaf_gaps(prog: dict, refs: dict, names) -> list:
    """Each leaf's |norm(prog) - norm(ref)| / max(norm(ref), median norm(ref))."""
    norms = {n: float(torch.linalg.vector_norm(refs[n].double())) for n in names}
    median = float(torch.tensor(sorted(norms.values())).median())
    return [abs(float(torch.linalg.vector_norm(prog[n].double())) - norms[n])
            / max(norms[n], median, 1e-30) for n in names]


def reference_steps(cfg: dict, train: dict, state_dict: dict, data: dict, first: dict, seed: int,
                    device) -> dict:
    """The reference's steps on the program's rows: its losses, first
    gradient, and the states it left after the first call and after the
    last, as ``first`` keeps the program's (for the control, the reference
    in the program's place)."""
    trainer = ref_train.Trainer(cfg, state_dict, train["augment"], device)
    gen = torch.Generator(device=device)
    losses, grads, epoch = [], None, None
    kept = {"state0": snapshot(trainer)}
    for i, (rows, e) in enumerate(zip(first["rows"], first["epochs"])):
        if e != epoch:
            gen.manual_seed(seed + e)
            epoch = e
        batch = {k: v[rows] for k, v in data.items()}
        out = trainer.step(batch, gen)
        losses.append(out["total"])
        grads = out["grads"] if grads is None else grads
        if i + 1 == first["calls"][0]:
            kept["state1"] = snapshot(trainer)
    kept["last"] = snapshot(trainer)
    return {"losses": losses, "grads": grads, "first": {**kept, "losses": losses,
            "calls": first["calls"]}}


def snapshot(trainer) -> dict:
    return {"params": dict(trainer.params), "stats": dict(trainer.stats), "mu": dict(trainer.mu)}


def gaps(first: dict, refs: dict) -> dict:
    """The numbers from the program's kept states and the reference's run."""
    losses = [abs(p - r) / abs(r) for p, r in zip(first["losses"], refs["losses"])]
    p0, p1, last = first["state0"], first["state1"], first["last"]
    names = list(p0["params"])
    grad = leaf_gaps(p1["mu"], refs["first"]["state1"]["mu"], names)
    norms = {n: float(torch.linalg.vector_norm(refs["grads"][n].double())) for n in names}
    median = float(torch.tensor(sorted(norms.values())).median())
    moving = [n for n in names if norms[n] >= ROUNDOFF_SHARE * median]
    state0 = {**p0["params"], **p0["stats"]}
    prog_now = {**last["params"], **last["stats"]}
    ref_last = refs["first"]["last"]
    ref_now = {**ref_last["params"], **ref_last["stats"]}
    prog_change = {n: prog_now[n] - state0[n] for n in moving + list(p0["stats"])}
    ref_change = {n: ref_now[n] - state0[n] for n in prog_change}
    change = leaf_gaps(prog_change, ref_change, list(prog_change))
    return {"loss_step1": losses[0], "loss_worst": max(losses),
            "grad_worst": max(grad), "grad_median": statistics.median(grad),
            "change_worst": max(change), "change_median": statistics.median(change)}


def check(cell, cfg: dict, state_dict: dict, data: dict, first: dict, device) -> list:
    """The three numbers beside their limits. With ``cell.control == "tf32"``
    the reference computed with TF32 on takes the program's place."""
    args = (cfg, cell.config["train"], state_dict, data, first, cell.seed, device)
    with ref.float32_exact():
        refs = reference_steps(*args)
        if cell.control == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            first = reference_steps(*args)["first"]
    readings = gaps(first, refs)
    limits = cell.workload["limits"]
    return readings, [(name, readings[COMPARED[name]], limits[name]) for name in COMPARED]
