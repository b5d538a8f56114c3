"""One rank of a gloo group on the CPU, for tests/test_torch_port_{parallel,spatial,tensor_parallel}.py.

    python tests/torch_parallel_worker.py <task> <rank> <world> <port> <dir>

The rank joins the group through ``parallel.initialize_multihost``: the
``steps`` and ``spatial`` tasks with explicit arguments, the ``trainer`` and
``spatial_trainer`` tasks from torchrun's environment variables (set by the
test). It runs the task on the inputs the test saved in ``<dir>`` and saves
what it computed to ``<dir>/<task>_<rank>.pt``. The data-parallel tasks run
in a world of 2, the spatial ones in a world of 4 (a 2 x 2 data x spatial
mesh, and a 1 x 4 one), the ``tensor`` task in a world of 2 (a 1 x 1 x 2
data x spatial x model mesh) or 4 (1 x 1 x 4 and 1 x 2 x 2). This
module imports no JAX: the test holds the results against the JAX package,
and imports ``batch_norm``, ``run_variant``, ``spatial_forward``,
``tensor_forward`` and ``tensor_step`` to run them without a mesh.
"""

import contextlib
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from mslesions3d_tpu_torch.data.augment import AugmentConfig  # noqa: E402
from mslesions3d_tpu_torch.models.layers import BatchNorm3d  # noqa: E402
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors  # noqa: E402
from mslesions3d_tpu_torch.models import layers, mobilenet  # noqa: E402
from mslesions3d_tpu_torch.parallel import (  # noqa: E402
    data_parallel,
    exchange_rows,
    gather_depth,
    halo,
    initialize_multihost,
    local_row_runs,
    make_mesh,
    make_mesh_2d,
    make_mesh_3d,
    make_spatially_sharded_forward,
    make_tensor_parallel_forward,
    process_batch_slice,
    shard_batch,
    shard_global_batch,
    shard_tree,
    tensor_sharding,
    unshard_tree,
)
from mslesions3d_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_eval_step,
    make_sharded_gathered_train_step,
    make_train_step,
)


def run_variant(v: dict, mesh):
    """One train step of a variant (the test's ``variants``) on this rank's
    rows under a mesh (``shard_batch``), on the whole batch without one."""
    cfg = SSD3DConfig.create(**v["kw"])
    state = create_train_state(cfg, device="cpu", state_dict=v["source"])
    opts = dict(v["opts"])
    augment = AugmentConfig(**opts.pop("augment", {}))
    step = make_train_step(cfg, SSD3D(cfg), model_priors(cfg), augment=augment, mesh=mesh,
                           **opts)
    batch = v["batch"]
    if mesh is not None:
        batch = shard_batch(batch, mesh, opts.get("grad_accum", 1))
    new, m = step(state, batch, torch.Generator().manual_seed(v["seed"]))
    return new, m


def step_outputs(new, m) -> dict:
    out = {k: m[k] for k in ("total_loss", "conf_loss", "loc_loss", "grad_norm", "n_positives")}
    out.update(params=new.params, batch_stats=new.batch_stats)
    for key in ("detections", "grads"):
        if key in m:
            out[key] = m[key]
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
    # with grad_accum=2 the ranks exchange rows after the gather
    step = make_sharded_gathered_train_step(cfg, SSD3D(cfg), model_priors(cfg), mesh,
                                            grad_accum=2, return_grads=True)
    state = create_train_state(cfg, device="cpu", state_dict=g["source"])
    results["sharded_gathered_ga2"] = step_outputs(*step(state, shard, idx))
    # the exchange itself, both ways: rows labelled by their global index
    block = {"row": torch.arange(mesh.rank * 6, (mesh.rank + 1) * 6),
             "flag": torch.arange(mesh.rank * 6, (mesh.rank + 1) * 6) % 3 == 0}
    wanted = [local_row_runs(12, mesh, 3, rank=r) for r in range(mesh.size)]
    results["exchange"] = {via: exchange_rows(block, mesh, wanted, all_to_all=via)
                           for via in (True, False)}
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


@contextlib.contextmanager
def recorded_kernels():
    """The input shapes of every K2 and K3 call of the model (their plain
    versions on CPU tensors)."""
    calls = {"k2": [], "k3": []}
    dw, tail = layers.fused_depthwise_bn_relu_cuda, mobilenet.fused_tail_cuda

    def k2(x, *args, **kwargs):
        calls["k2"].append(tuple(x.shape))
        return dw(x, *args, **kwargs)

    def k3(x, *args, **kwargs):
        calls["k3"].append(tuple(x.shape))
        return tail(x, *args, **kwargs)

    layers.fused_depthwise_bn_relu_cuda, mobilenet.fused_tail_cuda = k2, k3
    try:
        yield calls
    finally:
        layers.fused_depthwise_bn_relu_cuda, mobilenet.fused_tail_cuda = dw, tail


def spatial_forward(f: dict, mesh):
    """(locs, scores, K2 and K3 input shapes) of a forward case (the test's
    ``forwards``) on the whole batch; under a data x spatial mesh through
    ``make_spatially_sharded_forward``."""
    cfg = SSD3DConfig.create(**f["kw"])
    model = SSD3D(cfg)
    model.load_state_dict(f["source"])
    with recorded_kernels() as calls:
        if mesh is None:
            with torch.no_grad():
                locs, scores = model.eval()(torch.from_numpy(f["x"]))
        else:
            locs, scores = make_spatially_sharded_forward(model, mesh)(f["x"])
    return {"locs": locs, "scores": scores, **calls}


def eval_outputs(v: dict, mesh) -> dict:
    """The eval step of a variant on this rank's rows of its batch (all of
    them without a mesh)."""
    cfg = SSD3DConfig.create(**v["kw"])
    state = create_train_state(cfg, device="cpu", state_dict=v["source"])
    batch = v["batch"] if mesh is None else shard_batch(v["batch"], mesh)
    return make_eval_step(cfg, SSD3D(cfg), model_priors(cfg), mesh=mesh)(state, batch)


def halo_case(h: dict, mesh) -> dict:
    """``halo`` and ``gather_depth`` over the spatial group on this rank's
    slab of the test's volume: the haloed slab, the gathered volume and the
    slab's gradient of a weighted sum of each."""
    n, s = mesh.n_spatial, mesh.spatial.rank
    part = h["x"].shape[2] // n
    out = {}
    for lo, hi in ((1, 1), (1, 0)):
        x = h["x"][:, :, s * part:(s + 1) * part].clone().requires_grad_()
        y = halo(x, mesh.spatial, lo, hi)
        w = h["w"][:, :, s * part - lo + 1:(s + 1) * part + hi + 1]
        (g,) = torch.autograd.grad((y * w).sum(), [x])
        out[(lo, hi)] = {"y": y.detach(), "grad": g}
    x = h["x"][:, :, s * part:(s + 1) * part].clone().requires_grad_()
    y = gather_depth(x, mesh.spatial)
    (g,) = torch.autograd.grad((y * h["w"][:, :, 1:-1]).sum(), [x])
    out["gather"] = {"y": y.detach(), "grad": g}
    return out


def task_spatial(world, root: Path) -> dict:
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    results = {}
    mesh = make_mesh_2d(2, 2, device="cpu")
    results["mesh"] = (mesh.data.rank, mesh.spatial.rank, mesh.describe())
    results["forward"] = {name: spatial_forward(f, mesh) for name, f in inputs["forwards"].items()}
    results["steps"] = {name: step_outputs(*run_variant(v, mesh))
                        for name, v in inputs["variants"].items()}
    results["eval"] = eval_outputs(inputs["eval"], mesh)
    only = make_mesh_2d(1, 4, device="cpu")
    results["spatial_only"] = spatial_forward(inputs["spatial_only"], only)
    results["halo"] = halo_case(inputs["halo"], only)
    return results


def task_spatial_trainer(world, root: Path) -> dict:
    from mslesions3d_tpu_torch.cli import train as cli
    from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
    from mslesions3d_tpu_torch.train import Trainer, TrainerConfig

    inputs = torch.load(root / "inputs.pt", weights_only=False)
    results = {}

    def fit(name, batch_size=8, config=(), **extra):
        dm = SyntheticDataModule(inputs["data"], n_classes=1, batch_size=batch_size,
                                 max_objects=4)
        dm.setup("fit")
        tcfg = TrainerConfig(logdir=str(root / "logs"), experiment_name=name, device="cpu",
                             **dict(inputs["trainer"], **extra))
        return Trainer(tcfg).fit(SSD3DConfig.create(**dict(inputs["kw"], **dict(config))), dm,
                                 augment=AugmentConfig(**inputs["augment"]))

    for name, extra in inputs["fits"].items():
        state, result = fit(name, **extra)
        results[name] = {"state": state, "result": result}
    results["cli"] = {"result": cli.main([*inputs["cli"], "-ld", str(root / "logs"),
                                          "--spatial_shards", "2", "--data_parallel", "1",
                                          "--device", "cpu"])}
    # the JAX package's checks, raised before any data is loaded
    errors = {}
    for name, extra, kw in (("shards", dict(spatial_shards=3), {}),
                            ("depth", dict(spatial_shards=4),
                             dict(config=dict(input_size=(18, 16, 16)))),
                            ("world", dict(spatial_shards=2, data_parallel=False), {}),
                            ("capped", dict(spatial_shards=2, data_parallel=True),
                             dict(batch_size=3))):
        try:
            fit(f"error_{name}", **kw, **extra)
        except ValueError as e:
            errors[name] = str(e)
    results["errors"] = errors
    return results


def tensor_forward(f: dict, mesh) -> dict:
    """(locs, scores, K2 and K3 input shapes) of a forward case on the whole
    batch; under a data x spatial x model mesh through
    ``make_tensor_parallel_forward`` (this rank's slices of ``source``)."""
    cfg = SSD3DConfig.create(**f["kw"])
    model = SSD3D(cfg)
    with recorded_kernels() as calls:
        if mesh is None:
            model.load_state_dict(f["source"])
            with torch.no_grad():
                locs, scores = model.eval()(torch.from_numpy(f["x"]))
        else:
            locs, scores = make_tensor_parallel_forward(model, mesh)(f["source"], f["x"])
    return {"locs": locs, "scores": scores, **calls}


def tensor_step(v: dict, mesh) -> dict:
    """One train step of a variant, and the eval step on its batch, with
    ``return_grads``: on the whole state and batch without a mesh; under a
    data x spatial x model mesh on this rank's slices of the state and rows
    of the batch. The params, BN statistics and gradients come back whole
    (joined over the model group); ``local_grads`` are this rank's own."""
    cfg = SSD3DConfig.create(**v["kw"])
    model, priors = SSD3D(cfg), model_priors(cfg)
    state = create_train_state(cfg, device="cpu", state_dict=v["source"])
    opts = dict(v["opts"])
    augment = AugmentConfig(**opts.pop("augment", {}))
    step = make_train_step(cfg, model, priors, augment=augment, mesh=mesh, return_grads=True,
                           **opts)
    evaluate = make_eval_step(cfg, model, priors, mesh=mesh)
    batch = v["batch"]
    if mesh is not None:
        specs = tensor_sharding(state, mesh)
        state = shard_tree(state, mesh)
        batch = shard_batch(batch, mesh, opts.get("grad_accum", 1))
    new, m = step(state, batch, torch.Generator().manual_seed(v["seed"]))
    ev = evaluate(state, batch)
    out = step_outputs(new, m)
    out["eval"] = {k: ev[k] for k in ("total_loss", "conf_loss", "loc_loss", "detections")}
    if mesh is not None:
        out["local_grads"] = m["grads"]
        out.update(params=unshard_tree(new.params, mesh, specs.params),
                   batch_stats=unshard_tree(new.batch_stats, mesh, specs.batch_stats),
                   grads=unshard_tree(m["grads"], mesh, specs.params))
    return out


def task_tensor(world, root: Path) -> dict:
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    results = {}
    for shape in inputs["meshes"][world.size]:
        mesh = make_mesh_3d(*shape, device="cpu")
        results[shape] = {
            "mesh": (mesh.data.rank, mesh.spatial.rank, mesh.model.rank, mesh.describe()),
            "forward": {name: tensor_forward(f, mesh) for name, f in inputs["forwards"].items()},
            "steps": {name: tensor_step(v, mesh) for name, v in inputs["variants"].items()
                      if shape in v.get("meshes", [shape])},
        }
    return results


def main(task: str, rank: int, world: int, port: int, root: str) -> None:
    root = Path(root)
    if task in ("steps", "spatial", "tensor"):
        initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu",
                             timeout_s=120 if task == "steps" else 300)
    else:  # torchrun's environment, set by the test
        assert int(os.environ["RANK"]) == rank and int(os.environ["WORLD_SIZE"]) == world
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (rank, world, "gloo")
    results = {"steps": task_steps, "trainer": task_trainer, "spatial": task_spatial,
               "spatial_trainer": task_spatial_trainer, "tensor": task_tensor}[task](mesh, root)
    torch.save(results, root / f"{task}_{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    # one thread a rank, and torch's first CPU log taken small: a fresh
    # process's first multi-threaded log can be wrong in one block (ROADMAP §3)
    torch.set_num_threads(1)
    torch.log(torch.ones(8))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
