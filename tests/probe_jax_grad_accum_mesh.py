"""Probe: does the JAX package's ``grad_accum`` step give its unsharded result on every mesh?

Runs the JAX package's ``make_train_step(grad_accum=2)`` on one batch of 16
(the weights and batch of ``tests/test_torch_port_train_step.py``, 16^3,
width 0.25, float32) unsharded and with the batch sharded over data meshes
of 2, 4 and 8 CPU devices, and prints each run's total loss and gradient
norm, then a JSON line of them. ``tests/test_torch_port_parallel.py`` holds
the port's 2-rank ``grad_accum`` step against the mesh on which the JAX
program equals its unsharded one:

    JAX_PLATFORMS=cpu python tests/probe_jax_grad_accum_mesh.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (the 8-device CPU platform, before JAX starts)
import jax  # noqa: E402
from test_torch_port_train_step import Pair, _batch  # noqa: E402

from mslesions3d_tpu.parallel import make_mesh, shard_batch  # noqa: E402
from mslesions3d_tpu.train import steps as jax_steps  # noqa: E402


def main() -> None:
    pair = Pair()
    step = jax_steps.make_train_step(pair.jcfg, pair.jmodel, pair.priors, donate=False,
                                     grad_accum=2)
    batch = _batch(batch=16, seed=5)
    out = {}
    for n in (1, 2, 4, 8):
        _, m = step(pair.jstate, batch if n == 1 else shard_batch(batch, make_mesh(n)),
                    jax.random.PRNGKey(0))
        out[n] = {"total_loss": float(m["total_loss"]), "grad_norm": float(m["grad_norm"])}
        print(f"{n} device(s): total_loss {out[n]['total_loss']:.6f}, grad_norm "
              f"{out[n]['grad_norm']:.6f}", flush=True)
    print(json.dumps({"jax": jax.__version__, "by_devices": out}))


if __name__ == "__main__":
    main()
