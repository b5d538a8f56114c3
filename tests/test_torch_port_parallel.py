"""The port's data parallelism on the CPU: 2-rank gloo groups against one rank and JAX.

Each group is two processes of ``tests/torch_parallel_worker.py`` (a script
of their own rather than ``torch.multiprocessing`` children, which would
import this module and JAX with it) on a free port, each group with its own
timeout (a hung rendezvous fails the test rather
than stalling the suite); every rank takes one thread and the small first
``torch.log`` (ROADMAP §3). The ranks join through
``parallel.initialize_multihost``: the step group with explicit arguments,
the trainer group from torchrun's environment variables.

Train steps at 16^3, width 0.25, float32, on the weights and batches of
``tests/test_torch_port_train_step.py``. Each variant's 2-rank step (every
rank on its rows, ``parallel.shard_batch``) is held on both ranks against
the port's 1-rank step on the global batch: losses, n_positives and
grad_norm within 1e-5 relative, BN statistics within 1e-5, params by
``assert_params_close`` (Adam's first step moves a near-zero gradient's
element by about lr either way), detections' counts and labels equal and
boxes and scores within 1e-5. Where the draws are the JAX package's too
(no random draw, or flips and rot90 at probability 1), the 2-rank step is
also held against JAX's ``make_train_step`` on the 8-device CPU mesh
(``shard_batch(batch, make_mesh(8))``, as ``tests/test_train.py`` does) at
the same bounds (``grad_accum`` on a 2-device mesh: see ``JAX_DEVICES``).
Every JAX program here runs on several devices and compiles fresh: one
taken from the persistent compile cache can corrupt the heap on the forced
8-device CPU backend (the JAX package's bug D, ``utils/cache.py``).
Variants: plain; ``with_detections``; augmentation drawn
at random (flips, rot90, intensity) and at probability 1 (the JAX
comparison); ``grad_accum=2`` (batch 16: rank r holds the r-th half of each
micro-batch); patch training (16^3 crops of 24^3 volumes, the global
batch's draws); the ConvNet without dropout (JAX) and with dropout 0.5 and
``grad_accum=2`` (the global mask, each rank its rows). The sharded gathered
step (two shards of 8 volumes, 4 local indices a rank) against JAX's
``make_sharded_gathered_train_step`` on a 2-device mesh with the same local
indices and against the port's 1-rank step on the gathered global batch,
and at ``grad_accum=2`` (the ranks exchange rows after the gather: each
takes its share of every micro-batch) against JAX's 2-device program and the
port's 1-rank step at ``grad_accum=2``; the row exchange itself through
``all_to_all`` and through the gathered batch. ``BatchNorm3d``'s own
train branch under the mesh against one rank.
The multi-host helpers: ``shard_global_batch`` rows give the 1-rank loss,
``process_batch_slice`` and ``dcn_friendly_mesh`` equal JAX's.

``Trainer.fit(data_parallel=True)`` at W = 2 (16^3, width 0.25, flips drawn
at random, 2 epochs of 2 steps): with the sharded cache its per-step losses
equal the port's 1-rank gathered step on the global batches of the JAX
package's sharded index stream (also at ``grad_accum=2``, the cache kept),
and streaming equals the 1-rank streaming
fit, within 1e-5 relative; both ranks end with bit-equal states; only rank
0 writes (one ``metrics.jsonl`` line per logged event, rank 1 reports no
checkpoint). ``cli.train --data_parallel 1`` trains at W = 2. A global
batch that does not divide over the ranks is refused before training.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_port_convnet import _jax_state as convnet_jax_state
from torch_parallel_worker import batch_norm
from test_torch_port_train_step import (
    KW,
    _batch,
    _close_rel,
    _jax_state,
    _np,
    _source_state_dict,
    assert_params_close,
)

from mslesions3d_tpu.data.augment import AugmentConfig as JaxAugment
from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.parallel import dcn_friendly_mesh as jax_dcn_friendly_mesh
from mslesions3d_tpu.parallel import make_mesh as jax_make_mesh
from mslesions3d_tpu.parallel import process_batch_slice as jax_process_batch_slice
from mslesions3d_tpu.parallel import shard_batch as jax_shard_batch
from mslesions3d_tpu.train import steps as jax_steps
from mslesions3d_tpu.utils.cache import quarantine_from_persistent_cache
from mslesions3d_tpu_torch import parallel
from mslesions3d_tpu_torch.data.augment import AugmentConfig
from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
from mslesions3d_tpu_torch.data.generate import generate_dataset
from mslesions3d_tpu_torch.models.layers import BatchNorm3d
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    create_train_state,
    make_gathered_train_step,
    make_train_step,
)
from mslesions3d_tpu_torch.weights import from_jax_batch_stats, from_jax_params, from_jax_variables

torch.log(torch.ones(8))  # ROADMAP §3: the first CPU log of a process, taken small

WORKER = Path(__file__).parent / "torch_parallel_worker.py"
GROUP_TIMEOUT_S = 240
RTOL = 1e-5
AUG_RANDOM = dict(flip_axes=(0, 1, 2), rot90_planes=((1, 2),), shift_intensity=0.1,
                  scale_intensity=0.1)
AUG_FIXED = dict(flip_axes=(0, 1, 2), flip_prob=1.0, rot90_planes=((1, 2),), rot90_prob=1.0)
# JAX's grad_accum=2 program on 4 or 8 CPU devices (micro-batches of 8 rows)
# gives a gradient norm 4.8% from its own 1- and 2-device programs (the
# losses agree; tests/probe_jax_grad_accum_mesh.py prints them): the 2-device
# mesh is the one on which JAX's sharded program equals its unsharded one here
JAX_DEVICES = {"grad_accum": 2}
CONVNET_KW = dict(KW, base_network_config="convnet_maxpool_double",
                  aspect_ratios={4: [1.0], 6: [1.0]})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_group(task: str, root: Path, env_init: bool = False, world: int = 2) -> list:
    """Starts the ``world`` ranks of ``task``; ``finish_group`` waits for them."""
    port, procs = _free_port(), []
    for rank in range(world):
        env = dict(os.environ)
        if env_init:
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), task, str(rank), str(world), str(port), str(root)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
    return procs


def finish_group(task: str, root: Path, procs: list, timeout_s: float = GROUP_TIMEOUT_S) -> list:
    """Every rank's results; a rank that fails or outlives the timeout fails the test."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{task} rank {rank} failed:\n{out}"
    return [torch.load(root / f"{task}_{rank}.pt", weights_only=False)
            for rank in range(len(procs))]


# ------------------------------------------------------------------ steps
def _variants() -> dict:
    source = _source_state_dict(SSD3DConfig.create(**KW))
    _, _, conv_params = convnet_jax_state(dict(CONVNET_KW, convnet_dropout=0.0), seed=2)
    conv_source = {k: v.float() if v.is_floating_point() else v for k, v in from_jax_variables(
        conv_params, {}, SSD3DConfig.create(**dict(CONVNET_KW, convnet_dropout=0.0))).items()}
    plain = dict(kw=KW, source=source, batch=_batch(seed=0), seed=1, opts={})
    return {
        "plain": plain,
        "detections": dict(plain, opts=dict(with_detections=True)),
        "augment": dict(plain, batch=_batch(seed=1), opts=dict(augment=AUG_RANDOM)),
        "augment_fixed": dict(plain, batch=_batch(seed=1), opts=dict(augment=AUG_FIXED)),
        "grad_accum": dict(plain, batch=_batch(batch=16, seed=5), opts=dict(grad_accum=2)),
        "patches": dict(plain, batch=_batch(seed=2, d=24), opts=dict(patch_training=True)),
        "convnet": dict(kw=dict(CONVNET_KW, convnet_dropout=0.0), source=conv_source,
                        batch=_batch(seed=3), seed=1, opts={}),
        "convnet_dropout": dict(kw=dict(CONVNET_KW, convnet_dropout=0.5), source=conv_source,
                                batch=_batch(batch=16, seed=3), seed=7,
                                opts=dict(grad_accum=2)),
    }


def _gathered_inputs() -> dict:
    data = {k: v for k, v in _batch(batch=16, seed=11).items() if k != "batch_mask"}
    local_idx = np.array([[1, 6, 3, 0], [7, 2, 5, 4]], np.int64)
    return dict(kw=KW, source=_source_state_dict(SSD3DConfig.create(**KW)), data=data,
                n_local=8, local_idx=local_idx)


def _bn_inputs() -> dict:
    gen = torch.Generator().manual_seed(5)
    state = BatchNorm3d(6).state_dict()
    state.update(weight=torch.rand(6, generator=gen) + 0.5, bias=torch.randn(6, generator=gen),
                 running_mean=torch.randn(6, generator=gen),
                 running_var=torch.rand(6, generator=gen) + 0.5)
    return {"x": torch.randn((8, 6, 3, 4, 5), generator=gen) * 2 + 1, "state": state,
            "w": torch.randn((8, 6, 3, 4, 5), generator=gen)}


def _one_rank(v: dict):
    """The port's 1-rank step of a variant on its global batch."""
    cfg = SSD3DConfig.create(**v["kw"])
    opts = dict(v["opts"])
    augment = AugmentConfig(**opts.pop("augment", {}))
    step = make_train_step(cfg, SSD3D(cfg), model_priors(cfg), augment=augment, **opts)
    state = create_train_state(cfg, device="cpu", state_dict=v["source"])
    return step(state, v["batch"], torch.Generator().manual_seed(v["seed"]))


def _jax_sharded(v: dict, n_devices: int = 8):
    """JAX's step of a variant on an n-device CPU mesh."""
    jcfg = JaxConfig.create(**v["kw"])
    opts = dict(v["opts"])
    augment = JaxAugment(**opts.pop("augment", {}))
    opts["with_detections"] = True
    jstep = jax_steps.make_train_step(jcfg, JaxSSD3D(jcfg), model_priors(SSD3DConfig.create(
        **v["kw"])), augment=augment, donate=False, **opts)
    if v["kw"] is KW:
        jstate = _jax_state(jcfg, v["source"])
    else:  # the ConvNet: JAX's own init, the source's origin
        _, jstate, _ = convnet_jax_state(v["kw"], seed=2)
    jnew, jm = quarantine_from_persistent_cache(jstep)(
        jstate, jax_shard_batch(v["batch"], jax_make_mesh(n_devices)), jax.random.PRNGKey(0))
    return jnew, jm


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_steps")
    variants, gathered = _variants(), _gathered_inputs()
    torch.save({"variants": variants, "gathered": gathered, "bn": _bn_inputs()},
               root / "inputs.pt")
    procs = launch_group("steps", root)
    # the references run while the ranks do
    ref = {name: _one_rank(v) for name, v in variants.items()}
    jax_ref = {name: _jax_sharded(variants[name], JAX_DEVICES.get(name, 8))
               for name in ("plain", "augment_fixed", "grad_accum", "convnet")}
    return {"ranks": finish_group("steps", root, procs), "ref": ref, "jax": jax_ref,
            "variants": variants, "gathered": gathered}


def _assert_step_close(ours: dict, new, m, stats_ref=None):
    for key in ("total_loss", "conf_loss", "loc_loss", "grad_norm", "n_positives"):
        _close_rel(ours[key], m[key], RTOL)
    assert_params_close(ours["params"], new.params)
    for name, ref in (stats_ref or new.batch_stats).items():
        np.testing.assert_allclose(_np(ours["batch_stats"][name]), _np(ref), rtol=RTOL,
                                   atol=RTOL, err_msg=name)


def _assert_detections_close(det: dict, ref: dict):
    np.testing.assert_array_equal(_np(det["count"]), _np(ref["count"]))
    np.testing.assert_array_equal(_np(det["labels"]), _np(ref["labels"]))
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(_np(det[key]), _np(ref[key]), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("name", ["plain", "detections", "augment", "augment_fixed",
                                  "grad_accum", "patches", "convnet", "convnet_dropout"])
def test_two_rank_step_equals_one_rank(steps, name):
    new, m = steps["ref"][name]
    for rank, results in enumerate(steps["ranks"]):
        _assert_step_close(results[name], new, m)
    a, b = (r[name] for r in steps["ranks"])
    for tree in ("params", "batch_stats"):  # the ranks' states are equal
        for key, value in a[tree].items():
            assert torch.equal(value, b[tree][key]), (tree, key)
    if name == "detections":
        det = {k: torch.cat([r[name]["detections"][k] for r in steps["ranks"]])
               for k in m["detections"]}
        _assert_detections_close(det, m["detections"])
        assert int(det["count"].sum()) > 0


@pytest.mark.parametrize("name", ["plain", "detections", "augment_fixed", "grad_accum",
                                  "convnet"])
def test_two_rank_step_equals_jax_data_parallel(steps, name):
    jnew, jm = steps["jax"]["plain" if name == "detections" else name]
    cfg = SSD3DConfig.create(**steps["variants"][name]["kw"])
    jparams = from_jax_params(jax.device_get(jnew.params), cfg)
    jstats = (from_jax_batch_stats(jnew.params, jax.device_get(jnew.batch_stats))
              if jnew.batch_stats else {})
    for results in steps["ranks"]:
        ours = results[name]
        for key in ("total_loss", "conf_loss", "loc_loss", "grad_norm", "n_positives"):
            _close_rel(ours[key], jm[key], RTOL)
        assert_params_close(ours["params"], jparams)
        for key, ref in jstats.items():
            np.testing.assert_allclose(_np(ours["batch_stats"][key]), _np(ref), rtol=RTOL,
                                       atol=RTOL, err_msg=key)
    if name == "detections":
        det = {k: torch.cat([r[name]["detections"][k] for r in steps["ranks"]])
               for k in jm["detections"]}
        _assert_detections_close(det, {k: np.asarray(v) for k, v in jm["detections"].items()})


def test_batch_norm_train_forward_takes_global_statistics(steps):
    """``BatchNorm3d``'s own train branch (both variants) under a 2-rank mesh:
    each rank's output and input gradient are its rows of the 1-rank ones,
    the ranks' weight and bias gradients sum to the 1-rank ones, and the
    running statistics move by the global batch's on both ranks; within
    1e-5."""
    ref = batch_norm(_bn_inputs(), slice(0, 8), None)
    for fast in (False, True):
        for key in ("y", "dx"):
            ours = torch.cat([r["batch_norm"][fast][key] for r in steps["ranks"]])
            torch.testing.assert_close(ours, ref[fast][key], rtol=RTOL, atol=RTOL)
        for key in ("dw", "db"):
            ours = sum(r["batch_norm"][fast][key] for r in steps["ranks"])
            torch.testing.assert_close(ours, ref[fast][key], rtol=RTOL, atol=RTOL)
        for r in steps["ranks"]:
            for key in ("running_mean", "running_var"):
                torch.testing.assert_close(r["batch_norm"][fast][key], ref[fast][key],
                                           rtol=RTOL, atol=RTOL)


def test_sharded_gathered_step_equals_jax(steps):
    g = steps["gathered"]
    rows = (np.arange(2)[:, None] * g["n_local"] + g["local_idx"]).ravel()
    cfg = SSD3DConfig.create(**KW)
    state = create_train_state(cfg, device="cpu", state_dict=g["source"])
    data = {k: torch.from_numpy(v) for k, v in g["data"].items()}
    new, m = make_gathered_train_step(cfg, SSD3D(cfg), model_priors(cfg))(
        state, data, torch.from_numpy(rows))
    jcfg = JaxConfig.create(**KW)
    mesh = jax_make_mesh(2)
    sharding = NamedSharding(mesh, P("data"))
    jstep = jax_steps.make_sharded_gathered_train_step(jcfg, JaxSSD3D(jcfg), model_priors(cfg),
                                                       mesh, donate=False)
    jnew, jm = quarantine_from_persistent_cache(jstep)(
        _jax_state(jcfg, g["source"]),
        {k: jax.device_put(v, sharding) for k, v in g["data"].items()},
        jax.device_put(g["local_idx"].ravel().astype(np.int32), sharding),
        jax.random.PRNGKey(0))
    jparams = from_jax_params(jax.device_get(jnew.params), cfg)
    for results in steps["ranks"]:
        ours = results["sharded_gathered"]
        _assert_step_close(ours, new, m)
        for key in ("total_loss", "grad_norm"):
            _close_rel(ours[key], jm[key], RTOL)
        assert_params_close(ours["params"], jparams)


def test_sharded_gathered_step_grad_accum_equals_jax_and_one_rank(steps):
    """grad_accum=2 over 2 ranks: block r of the global batch is gathered
    from shard r, and micro-batch i (global rows [4 i, 4 i + 4)) lies in
    block i, so the ranks exchange rows; the step then equals the port's
    1-rank step on the gathered global batch and JAX's 2-device program."""
    g = steps["gathered"]
    rows = (np.arange(2)[:, None] * g["n_local"] + g["local_idx"]).ravel()
    cfg = SSD3DConfig.create(**KW)
    state = create_train_state(cfg, device="cpu", state_dict=g["source"])
    data = {k: torch.from_numpy(v) for k, v in g["data"].items()}
    new, m = make_gathered_train_step(cfg, SSD3D(cfg), model_priors(cfg), grad_accum=2,
                                      return_grads=True)(state, data, torch.from_numpy(rows))
    jcfg = JaxConfig.create(**KW)
    mesh = jax_make_mesh(2)
    sharding = NamedSharding(mesh, P("data"))
    jstep = jax_steps.make_sharded_gathered_train_step(
        jcfg, JaxSSD3D(jcfg), model_priors(cfg), mesh, donate=False, grad_accum=2)
    jnew, jm = quarantine_from_persistent_cache(jstep)(
        _jax_state(jcfg, g["source"]),
        {k: jax.device_put(v, sharding) for k, v in g["data"].items()},
        jax.device_put(g["local_idx"].ravel().astype(np.int32), sharding),
        jax.random.PRNGKey(0))
    jparams = from_jax_params(jax.device_get(jnew.params), cfg)
    for results in steps["ranks"]:
        ours = results["sharded_gathered_ga2"]
        _assert_step_close(ours, new, m)
        for key in ("total_loss", "conf_loss", "loc_loss", "grad_norm", "n_positives"):
            _close_rel(ours[key], jm[key], RTOL)
        assert_params_close(ours["params"], jparams)
        for name, ref in m["grads"].items():
            np.testing.assert_allclose(_np(ours["grads"][name]), _np(ref), rtol=1e-3, atol=1e-4,
                                       err_msg=name)


@pytest.mark.parametrize("via", [True, False], ids=["all_to_all", "all_gather"])
def test_exchange_rows_hands_each_rank_its_runs(steps, via):
    """12 rows in blocks of 6, 3 micro-batches of 4: rank r gets rows
    [4 i + 2 r, 4 i + 2 r + 2) of each, booleans kept."""
    for rank, results in enumerate(steps["ranks"]):
        got = results["exchange"][via]
        expected = np.concatenate([np.arange(4 * i + 2 * rank, 4 * i + 2 * rank + 2)
                                   for i in range(3)])
        np.testing.assert_array_equal(got["row"].numpy(), expected)
        assert got["flag"].dtype == torch.bool
        np.testing.assert_array_equal(got["flag"].numpy(), expected % 3 == 0)


def test_multihost_rows_give_the_single_process_loss(steps):
    _, m = steps["ref"]["plain"]
    for rank, results in enumerate(steps["ranks"]):
        assert results["multihost"]["slice"] == slice(4 * rank, 4 * rank + 4)
        _close_rel(results["multihost"]["total_loss"], m["total_loss"], RTOL)
        assert "not divisible by process count 2" in results["multihost"]["ragged"]


@pytest.mark.parametrize("data_per_slice", [None, 1, 2, 4, 8])
def test_dcn_friendly_mesh_equals_jax(data_per_slice):
    ref = jax_dcn_friendly_mesh(data_per_slice)
    ours = parallel.dcn_friendly_mesh(data_per_slice, world_size=8, local_world_size=8)
    np.testing.assert_array_equal(ours.ranks, np.vectorize(lambda d: d.id)(ref.devices))
    assert ours.shape == dict(ref.shape)


def test_dcn_friendly_mesh_and_batch_slice_raise_as_jax():
    with pytest.raises(ValueError) as ref:
        jax_dcn_friendly_mesh(3)
    with pytest.raises(ValueError) as ours:
        parallel.dcn_friendly_mesh(3, world_size=8, local_world_size=8)
    assert str(ours.value) == str(ref.value)
    # a single process: every row, as JAX's
    assert parallel.process_batch_slice(8) == jax_process_batch_slice(8) == slice(0, 8)
    assert parallel.initialize_multihost(device="cpu") is False


def test_local_rows_interleave_micro_batches():
    class Mesh:
        size, rank, device = 2, 1, torch.device("cpu")

    assert parallel.local_row_runs(8, Mesh) == [slice(4, 8)]
    assert parallel.local_row_runs(16, Mesh, grad_accum=2) == [slice(4, 8), slice(12, 16)]
    rows = np.arange(16)[:, None]
    np.testing.assert_array_equal(parallel.shard_batch({"x": rows, "ids": "kept"}, Mesh, 2)["x"],
                                  rows[[4, 5, 6, 7, 12, 13, 14, 15]])
    # the multi-host rows are the same rule's, as tensors on the mesh's device
    multihost = parallel.shard_global_batch({"x": rows, "ids": "kept"}, Mesh, grad_accum=2)
    assert multihost["ids"] == "kept" and multihost["x"].device == Mesh.device
    np.testing.assert_array_equal(multihost["x"].numpy(), rows[[4, 5, 6, 7, 12, 13, 14, 15]])
    with pytest.raises(ValueError, match="micro-batch of 3 rows.*2 ranks"):
        parallel.local_row_runs(6, Mesh, grad_accum=2)
    with pytest.raises(ValueError, match="global batch 7 is not divisible by the mesh's 2"):
        parallel.local_row_runs(7, Mesh)


# ------------------------------------------------------------------ trainer
TRAINER = dict(max_epochs=2, max_steps=-1, early_stopping=False, compute_metric_every_n_epochs=1,
               seed=970205, log_every_n_steps=1, grad_hist_every_n_steps=0)
TRAINER_KW = dict(KW, batch_size=8, min_score=0.2)
TRAINER_AUG = dict(flip_axes=(0, 1, 2))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_trainer")
    data = root / "data"
    generate_dataset(data, num_images=20, n_classes=1, image_size=(16, 16, 16),
                     object_size=(4, 8), num_objects=(1, 3), seed=4, num_processes=1)
    cli_args = ["-d", str(data), "-b", "8", "-wm", "0.25", "-mi", "2", "-en", "cli",
                "--max_objects", "4", "-a", "flip"]
    torch.save({"data": str(data), "kw": TRAINER_KW, "trainer": TRAINER,
                "augment": TRAINER_AUG, "cli": cli_args,
                "fits": {"cache": {}, "stream": dict(device_data_cache=False),
                         "cache_ga2": dict(grad_accum=2)}},
               root / "inputs.pt")
    procs = launch_group("trainer", root, env_init=True)
    dm = SyntheticDataModule(data, n_classes=1, batch_size=8, max_objects=4)
    dm.setup("fit")
    _, stream_ref = Trainer(TrainerConfig(
        logdir=str(root / "ref_logs"), experiment_name="stream", device="cpu",
        device_data_cache=False, **TRAINER)).fit(SSD3DConfig.create(**TRAINER_KW), dm,
                                                  augment=AugmentConfig(**TRAINER_AUG))
    return {"ranks": finish_group("trainer", root, procs), "root": root, "dm": dm,
            "stream_ref": stream_ref}


def _losses(result) -> list:
    return [v for e in result["timings"]["epochs"] for v in e["train_losses"]]


def _index_stream_losses(trained, grad_accum: int) -> list:
    """The 1-rank gathered step's losses on the global batches of the JAX
    package's sharded index stream (train/loop.py:406-420)."""
    dm = trained["dm"]
    cfg = SSD3DConfig.create(**TRAINER_KW)
    n_train, world, b_local = len(dm.trainsubs), 2, 4
    n_local = -(-n_train // world)
    host = dm.materialize([dm.trainsubs[i % n_train] for i in range(world * n_local)])
    data = {k: torch.from_numpy(v) for k, v in host.items() if isinstance(v, np.ndarray)}
    step = make_gathered_train_step(cfg, SSD3D(cfg), model_priors(cfg),
                                    AugmentConfig(**TRAINER_AUG), grad_accum=grad_accum)
    state = create_train_state(cfg, seed=TRAINER["seed"], device="cpu")
    expected = []
    for epoch in range(TRAINER["max_epochs"]):
        rg = np.random.default_rng(TRAINER["seed"] + epoch)
        perms = [rg.permutation(n_local) for _ in range(world)]
        gen = torch.Generator().manual_seed(TRAINER["seed"] + epoch)
        for s in range(n_local // b_local):
            idx = np.concatenate([r * n_local + p[s * b_local:(s + 1) * b_local]
                                  for r, p in enumerate(perms)])
            state, m = step(state, data, torch.from_numpy(idx), gen)
            expected.append(float(m["total_loss"]))
    assert len(expected) == 4
    return expected


def test_trainer_sharded_cache_follows_the_jax_index_stream(trained):
    """The sharded cache's step stream equals the 1-rank gathered step on the
    global batches of the JAX package's stream (train/loop.py:406-420)."""
    expected = _index_stream_losses(trained, 1)
    for results in trained["ranks"]:
        np.testing.assert_allclose(_losses(results["cache"]["result"]), expected, rtol=RTOL)


def test_trainer_sharded_cache_keeps_its_shards_with_grad_accum(trained):
    """``grad_accum=2`` over 2 ranks keeps the sharded cache: the fit's losses
    follow the JAX package's sharded index stream at grad_accum=2 (streaming
    would draw other batches)."""
    expected = _index_stream_losses(trained, 2)
    for results in trained["ranks"]:
        np.testing.assert_allclose(_losses(results["cache_ga2"]["result"]), expected,
                                   rtol=RTOL)


@pytest.mark.parametrize("fit", ["cache", "stream"])
def test_trainer_ranks_end_equal_and_rank_0_writes(trained, fit):
    a, b = (r[fit] for r in trained["ranks"])
    for tree in ("params", "batch_stats", "ema_params"):
        for key, value in (getattr(a["state"], tree) or {}).items():
            assert torch.equal(value, getattr(b["state"], tree)[key]), (tree, key)
    for key, value in a["state"].opt_state.mu.items():
        assert torch.equal(value, b["state"].opt_state.mu[key])
    assert int(a["state"].step) == int(b["state"].step) == 4
    # the losses are global on every rank; the detection metrics are rank 0's
    assert ([h["avg_val_loss"] for h in a["result"]["history"]]
            == [h["avg_val_loss"] for h in b["result"]["history"]])
    assert "mAP/validation_IoU_0.1" not in b["result"]["history"][0]
    assert a["result"]["best_checkpoint"] is not None and b["result"]["best_checkpoint"] is None
    # one line per logged event: 4 steps and 2 epochs, written once
    lines = (trained["root"] / "logs" / fit / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 6
    ckpts = sorted(p.name for p in Path(a["result"]["checkpoint_dir"]).iterdir())
    assert ckpts[-1] == "last" and len(ckpts) == 3
    assert "mAP/validation_IoU_0.1" in a["result"]["history"][0]
    assert "mAP/training_IoU_0.1" in a["result"]["history"][0]


def test_trainer_streaming_equals_one_rank(trained):
    ref = trained["stream_ref"]
    for rank, results in enumerate(trained["ranks"]):
        ours = results["stream"]["result"]
        np.testing.assert_allclose(_losses(ours), _losses(ref), rtol=RTOL)
        for h, r in zip(ours["history"], ref["history"]):
            np.testing.assert_allclose(h["avg_val_loss"], r["avg_val_loss"], rtol=RTOL)
            # rank 0's metrics over every rank's gathered detections
            for key in [k for k in r if k.startswith(("mAP/", "recall/")) and rank == 0]:
                np.testing.assert_allclose(h[key], r[key], rtol=RTOL, atol=1e-7, err_msg=key)


def test_cli_train_data_parallel(trained):
    a, b = (r["cli"]["result"] for r in trained["ranks"])
    assert len(_losses(a)) == 2 and np.isfinite(_losses(a)).all()
    assert _losses(a) == _losses(b)
    assert (trained["root"] / "logs" / "cli" / "checkpoints" / "last").is_dir()


def test_trainer_refuses_a_batch_that_does_not_divide(trained):
    for results in trained["ranks"]:
        assert results["ragged"] == "global batch 3 is not divisible by the mesh's 2 ranks"
    assert not (trained["root"] / "logs" / "ragged" / "metrics.jsonl").exists()

