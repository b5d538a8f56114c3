"""One rank of a 2-rank gloo group on the CPU, for tests/test_torch_port_parallel.py.

    python tests/torch_parallel_worker.py <task> <rank> <world> <port> <dir>

The rank joins the group through ``parallel.initialize_multihost``: the
``steps`` task with explicit arguments, the ``trainer`` task from
torchrun's environment variables (set by the test). It runs the task on
the inputs the test saved in ``<dir>`` and saves what it computed to
``<dir>/<task>_<rank>.pt``. This module imports no JAX: the test holds the
results against the JAX package, and imports ``batch_norm`` to run it on
one rank.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from mslesions3d_tpu_torch.data.augment import AugmentConfig  # noqa: E402
from mslesions3d_tpu_torch.models.layers import BatchNorm3d  # noqa: E402
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors  # noqa: E402
from mslesions3d_tpu_torch.parallel import (  # noqa: E402
    data_parallel,
    initialize_multihost,
    make_mesh,
    process_batch_slice,
    shard_batch,
    shard_global_batch,
)
from mslesions3d_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_sharded_gathered_train_step,
    make_train_step,
)


def run_variant(v: dict, mesh):
    """One train step of a variant (the test's ``variants``) on this rank's rows."""
    cfg = SSD3DConfig.create(**v["kw"])
    state = create_train_state(cfg, device="cpu", state_dict=v["source"])
    opts = dict(v["opts"])
    augment = AugmentConfig(**opts.pop("augment", {}))
    step = make_train_step(cfg, SSD3D(cfg), model_priors(cfg), augment=augment, mesh=mesh,
                           **opts)
    local = shard_batch(v["batch"], mesh, opts.get("grad_accum", 1))
    new, m = step(state, local, torch.Generator().manual_seed(v["seed"]))
    return new, m


def step_outputs(new, m) -> dict:
    out = {k: m[k] for k in ("total_loss", "conf_loss", "loc_loss", "grad_norm", "n_positives")}
    out.update(params=new.params, batch_stats=new.batch_stats)
    if "detections" in m:
        out["detections"] = m["detections"]
    return out


def batch_norm(bn: dict, rows: slice, mesh) -> dict:
    """BatchNorm3d's train forward (both variants) on ``rows`` of the test's
    input, and the gradients of a weighted sum of its output."""
    out = {}
    for fast in (False, True):
        layer = BatchNorm3d(bn["x"].shape[1], fast_variance=fast).train()
        layer.load_state_dict(bn["state"])
        x = bn["x"][rows].clone().requires_grad_()
        with data_parallel(mesh):
            y = layer(x)
            dx, dw, db = torch.autograd.grad((y * bn["w"][rows]).sum(),
                                             [x, layer.weight, layer.bias])
        out[fast] = {"y": y.detach(), "dx": dx, "dw": dw, "db": db,
                     "running_mean": layer.running_mean, "running_var": layer.running_var}
    return out


def task_steps(mesh, root: Path) -> dict:
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    results = {name: step_outputs(*run_variant(v, mesh))
               for name, v in inputs["variants"].items()}
    n = inputs["bn"]["x"].shape[0] // mesh.size
    results["batch_norm"] = batch_norm(inputs["bn"], slice(mesh.rank * n, (mesh.rank + 1) * n),
                                       mesh)
    # the sharded device cache: this rank's shard and its local indices
    g = inputs["gathered"]
    cfg = SSD3DConfig.create(**g["kw"])
    state = create_train_state(cfg, device="cpu", state_dict=g["source"])
    n_local = g["n_local"]
    shard = {k: torch.from_numpy(v[mesh.rank * n_local:(mesh.rank + 1) * n_local])
             for k, v in g["data"].items()}
    step = make_sharded_gathered_train_step(cfg, SSD3D(cfg), model_priors(cfg), mesh)
    idx = torch.from_numpy(g["local_idx"][mesh.rank])
    results["sharded_gathered"] = step_outputs(*step(state, shard, idx))
    # the multi-host helpers: this process's rows of the plain variant's batch
    plain = inputs["variants"]["plain"]
    rows = shard_global_batch(plain["batch"], mesh)
    cfg = SSD3DConfig.create(**plain["kw"])
    step = make_train_step(cfg, SSD3D(cfg), model_priors(cfg), mesh=mesh)
    _, m = step(create_train_state(cfg, device="cpu", state_dict=plain["source"]), rows)
    results["multihost"] = {"total_loss": m["total_loss"],
                            "slice": process_batch_slice(plain["batch"]["image"].shape[0])}
    try:
        process_batch_slice(3)
    except ValueError as e:
        results["multihost"]["ragged"] = str(e)
    return results


def task_trainer(mesh, root: Path) -> dict:
    from mslesions3d_tpu_torch.cli import train as cli
    from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
    from mslesions3d_tpu_torch.train import Trainer, TrainerConfig

    inputs = torch.load(root / "inputs.pt", weights_only=False)
    results = {}
    for name, extra in inputs["fits"].items():
        dm = SyntheticDataModule(inputs["data"], n_classes=1, batch_size=8, max_objects=4)
        dm.setup("fit")
        tcfg = TrainerConfig(logdir=str(root / "logs"), experiment_name=name, device="cpu",
                             data_parallel=True, **inputs["trainer"], **extra)
        state, result = Trainer(tcfg).fit(SSD3DConfig.create(**inputs["kw"]), dm,
                                          augment=AugmentConfig(**inputs["augment"]))
        results[name] = {"state": state, "result": result}
    result = cli.main([*inputs["cli"], "-ld", str(root / "logs"), "--data_parallel", "1",
                       "--device", "cpu"])
    results["cli"] = {"result": result}
    # a global batch of 3 over 2 ranks: refused before any data is loaded
    dm = SyntheticDataModule(inputs["data"], n_classes=1, batch_size=3, max_objects=4)
    tcfg = TrainerConfig(logdir=str(root / "logs"), experiment_name="ragged", device="cpu",
                         data_parallel=True, **inputs["trainer"])
    try:
        Trainer(tcfg).fit(SSD3DConfig.create(**inputs["kw"]), dm)
    except ValueError as e:
        results["ragged"] = str(e)
    return results


def main(task: str, rank: int, world: int, port: int, root: str) -> None:
    root = Path(root)
    if task == "steps":
        initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=120)
    else:  # torchrun's environment, set by the test
        assert int(os.environ["RANK"]) == rank and int(os.environ["WORLD_SIZE"]) == world
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (rank, world, "gloo")
    results = {"steps": task_steps, "trainer": task_trainer}[task](mesh, root)
    torch.save(results, root / f"{task}_{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    # one thread a rank, and torch's first CPU log taken small: a fresh
    # process's first multi-threaded log can be wrong in one block (ROADMAP §3)
    torch.set_num_threads(1)
    torch.log(torch.ones(8))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
