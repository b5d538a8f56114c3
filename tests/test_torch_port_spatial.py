"""The port's spatial sharding on the CPU: 4-rank gloo groups against one rank and JAX.

Each group is four processes of ``tests/torch_parallel_worker.py`` (launched
as the data-parallel tests launch theirs, one thread a rank). The ``spatial``
group forms a 2 x 2 data x spatial mesh (``parallel.make_mesh_2d``: rank =
d n_spatial + s) and then a 1 x 4 one in the same world; the
``spatial_trainer`` group joins from torchrun's environment variables.

On the 2 x 2 mesh, every result is held against the port's step or forward
on one rank (the same weights, batch and generator) and, where the draws are
the JAX package's too, against JAX's programs on the same mesh shape of its
8-device CPU mesh (``make_mesh_2d(2, 2)``, its ``make_spatially_sharded_forward``
and its ``make_train_step(constraint_mesh=...)``), with the JAX tests'
tolerances (tests/test_spatial_sharding.py):

* the eval forward at 32^3, batch 2: width 0.5 (JAX's test config), and at
  width 1.0 on the default path, with ``use_pallas`` (K2's plain version on
  each rank's haloed slab of layer 3: 2 planes + 2), ``use_pallas_tail``
  (K3's plain version on the whole input, past the cut) and both; locs and
  scores within 1e-4 of JAX's and within 1e-5 of the port's unsharded
  forward with the same flags;
* the train step at 16^3, width 0.25, the JAX test's config, weights (JAX's
  init from seed 0, carried by ``from_jax_variables``) and batches: batch 2
  and 8, flips at probability 1 at
  n_spatial = 2, ``grad_accum=2`` (micro-batches of 4, split over the data
  ranks), ``remat`` at batch 8 (the blocks past the cut recomputed in the
  backward under the split of their forward) and the ConvNet without
  dropout at 32^3 against JAX (loss within
  rtol 1e-5, gradients within 1e-3, the ConvNet's within 5e-3); every
  variant, and flips, rot90 in (0, 1) / (0, 2) and the affine drawn at
  random, ``grad_accum=2`` at batch 2 (micro-batches of 1: every row on
  every data rank) and the ConvNet with dropout 0.5, against the port's
  1-rank step (losses within rtol 1e-5, every gradient leaf within 1e-3,
  every leaf's norm and the gradient norm within 1% (plus 1e-4 for a leaf),
  so no leaf is scaled by a shard count; the BN statistics within 1e-5; the
  four ranks' states bit-equal);
* the eval step at batch 4: losses and each data rank's detections (K1's
  plain version on the gathered heads) against the 1-rank step's rows.

On the 1 x 4 mesh: the spatial-only forward at 64^3, width 0.25, batch 1
against JAX's 1 x 4 program and the unsharded one; ``halo`` and
``gather_depth`` against the zero-padded volume and their gradients.

``Trainer(spatial_shards=2, data_parallel=True)`` on the 2 x 2 mesh (16^3,
width 0.25, flips drawn at random, 2 epochs of 2 steps): its step losses
within rtol 1e-5 and its validation losses within rtol 2e-4 (the JAX
trainer test's) of the 1-rank streaming fit, the four ranks' states equal;
``cli.train --spatial_shards 2 --data_parallel 1`` trains; the JAX
package's checks (shards that do not divide the world, a depth that does
not divide the shards) raise its messages, and a world that cannot hold the
mesh or a batch that does not divide over the data axis (where the JAX
package caps the axis) raises naming the world to launch. The layout of ``shard_batch_spatial``
equals JAX's device shards on the 2 x 2 mesh.

Every JAX program here runs on several devices and compiles fresh (the JAX
package's bug D, ``utils/cache.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_convnet import _jax_state as convnet_jax_state
from test_torch_port_forward import randomized_variables
from test_torch_port_parallel import finish_group, launch_group
from test_torch_port_train_step import _batch, _close_rel, _np
from torch_parallel_worker import eval_outputs, run_variant, spatial_forward

from mslesions3d_tpu.data.augment import AugmentConfig as JaxAugment
from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.parallel import spatial as jax_spatial
from mslesions3d_tpu.train import steps as jax_steps
from mslesions3d_tpu.train.state import create_train_state as jax_create_train_state
from mslesions3d_tpu.utils.cache import quarantine_from_persistent_cache
from mslesions3d_tpu_torch import parallel
from mslesions3d_tpu_torch.data.augment import AugmentConfig
from mslesions3d_tpu_torch.data.datasets import SyntheticDataModule
from mslesions3d_tpu_torch.data.generate import generate_dataset
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig, model_priors
from mslesions3d_tpu_torch.train import Trainer, TrainerConfig
from mslesions3d_tpu_torch.weights import from_jax_batch_stats, from_jax_params, from_jax_variables

torch.log(torch.ones(8))  # ROADMAP §3: the first CPU log of a process, taken small

RTOL = 1e-5
# the JAX test's train-step config (tests/test_spatial_sharding.py)
KW = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=1e-3,
          threshold=(0.1, 0.2))
FORWARD_TOL = 1e-4  # the JAX test's, against JAX
GRAD_TOL = 1e-3  # the JAX test's, and every leaf against the 1-rank step
CONVNET_GRAD_ATOL = 5e-3  # the JAX ConvNet test's
NORM_RTOL, NORM_ATOL = 1e-2, 1e-4
VAL_RTOL = 2e-4  # the JAX trainer test's
# four single-threaded ranks beside the suite's other workers
GROUP_TIMEOUT_S = 600
FORWARD_KW = dict(n_classes=2, input_channels=1, input_size=(32, 32, 32))
CONVNET_KW = dict(n_classes=2, input_channels=1, input_size=(32, 32, 32),
                  base_network_config="convnet_maxpool_double",
                  aspect_ratios={6: [1.0], 9: [1.0]}, lr=1e-3, threshold=(0.1, 0.2))
FLIP = dict(flip_axes=(0, 1, 2), flip_prob=1.0)
MIXED = dict(flip_axes=(0, 1, 2), rot90_planes=((0, 1), (0, 2)), rot90_prob=0.7,
             affine_prob=0.7)
WIDTH_1 = {"off": {}, "use_pallas": dict(use_pallas=True),
           "use_pallas_tail": dict(use_pallas_tail=True),
           "both": dict(use_pallas=True, use_pallas_tail=True)}
# the variants held against JAX's 2 x 2 program (deterministic draws)
JAX_VARIANTS = ("batch2", "batch8", "flip", "grad_accum", "remat", "convnet")


def _forward_case(width, flags, size=(32, 32, 32), batch=2, seed=0):
    config = dict(FORWARD_KW, input_size=size, width_mult=width)
    _, params, stats = randomized_variables(config, seed=seed)
    cfg = SSD3DConfig.create(**config, **flags)
    x = np.random.default_rng(seed + 1).normal(size=(batch, *size, 1)).astype(np.float32)
    return {"kw": dict(config, **flags), "source": from_jax_variables(params, stats, cfg),
            "x": x, "variables": {"params": params, "batch_stats": stats}}


def _forwards() -> dict:
    cases = {"w05": _forward_case(0.5, {})}
    w1 = _forward_case(1.0, {})
    for name, flags in WIDTH_1.items():
        cases[name] = dict(w1, kw=dict(w1["kw"], **flags))
    return cases


def _jax_batch(batch: int, boxes: int = 3) -> dict:
    """The JAX test's batch: normal volumes, the same box in every row."""
    rng = np.random.default_rng(7)
    return {"image": rng.normal(0, 1, (batch, 16, 16, 16, 1)).astype(np.float32),
            "boxes": np.tile(np.array([0.2, 0.2, 0.2, 0.6, 0.6, 0.6], np.float32),
                             (batch, boxes, 1)),
            "labels": np.ones((batch, boxes), np.int32),
            "box_mask": np.ones((batch, boxes), bool), "batch_mask": np.ones(batch, bool)}


def _jax_init(kw: dict):
    """JAX's train state from seed 0 (the JAX test's) and its weights as the
    port's state dict."""
    jcfg = JaxConfig.create(**kw)
    jstate = jax_create_train_state(JaxSSD3D(jcfg), jcfg, jax.random.PRNGKey(0))
    source = from_jax_variables(jax.device_get(jstate.params),
                                jax.device_get(jstate.batch_stats), SSD3DConfig.create(**kw))
    return jstate, source


def _variants() -> dict:
    _, source = _jax_init(KW)
    _, _, conv_params = convnet_jax_state(dict(CONVNET_KW, convnet_dropout=0.0), seed=2)
    conv_source = {k: v.float() if v.is_floating_point() else v for k, v in from_jax_variables(
        conv_params, {}, SSD3DConfig.create(**dict(CONVNET_KW, convnet_dropout=0.0))).items()}
    plain = dict(kw=KW, source=source, batch=_jax_batch(2), seed=1,
                 opts=dict(return_grads=True))
    convnet = dict(kw=dict(CONVNET_KW, convnet_dropout=0.0), source=conv_source,
                   batch=_batch(batch=2, seed=3, d=32), seed=1, opts=dict(return_grads=True))
    return {
        "batch2": plain,
        "batch8": dict(plain, batch=_jax_batch(8)),
        "flip": dict(plain, batch=_jax_batch(4, boxes=1),
                     opts=dict(return_grads=True, augment=FLIP)),
        "mixed_augment": dict(plain, batch=_batch(batch=4, seed=2), seed=5,
                              opts=dict(return_grads=True, augment=MIXED)),
        "grad_accum": dict(plain, batch=_batch(batch=8, seed=5),
                           opts=dict(return_grads=True, grad_accum=2)),
        "grad_accum_whole_rows": dict(plain, kw=dict(KW, min_score=0.2),
                                      batch=_batch(batch=2, seed=6),
                                      opts=dict(return_grads=True, grad_accum=2,
                                                with_detections=True)),
        "detections": dict(plain, kw=dict(KW, min_score=0.2), batch=_batch(batch=4, seed=7),
                           opts=dict(return_grads=True, with_detections=True)),
        "remat": dict(plain, kw=dict(KW, remat=True), batch=_jax_batch(8)),
        "convnet": convnet,
        "convnet_dropout": dict(convnet, kw=dict(CONVNET_KW, convnet_dropout=0.5), seed=7),
    }


def _halo_inputs() -> dict:
    gen = torch.Generator().manual_seed(9)
    return {"x": torch.randn((2, 3, 8, 4, 5), generator=gen),
            "w": torch.randn((2, 3, 10, 4, 5), generator=gen)}


def _jax_step(name: str, v: dict, mesh):
    """JAX's train step of a variant on a data x spatial mesh."""
    jcfg = JaxConfig.create(**v["kw"])
    opts = {k: o for k, o in v["opts"].items() if k != "augment"}
    augment = JaxAugment(**v["opts"].get("augment", {}))
    if name == "convnet":  # JAX's own init, the source's origin
        _, jstate, _ = convnet_jax_state(v["kw"], seed=2)
    else:
        jstate, _ = _jax_init(v["kw"])
    step = jax_steps.make_train_step(jcfg, JaxSSD3D(jcfg), model_priors(SSD3DConfig.create(
        **v["kw"])), augment=augment, donate=False, constraint_mesh=mesh, **opts)
    return quarantine_from_persistent_cache(step)(
        jstate, jax_spatial.shard_batch_spatial(v["batch"], mesh), jax.random.PRNGKey(0))


def _jax_forward(case: dict, mesh):
    model = JaxSSD3D(JaxConfig.create(**case["kw"]))
    run = quarantine_from_persistent_cache(jax_spatial.make_spatially_sharded_forward(model,
                                                                                      mesh))
    return [np.asarray(t) for t in run(case["variables"], jnp.asarray(case["x"]))]


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    forwards, variants = _forwards(), _variants()
    only = _forward_case(0.25, {}, size=(64, 64, 64), batch=1, seed=2)
    evaluate = dict(variants["detections"], batch=_batch(batch=4, seed=8))
    strip = lambda case: {k: v for k, v in case.items() if k != "variables"}  # noqa: E731
    torch.save({"forwards": {k: strip(f) for k, f in forwards.items()}, "variants": variants,
                "eval": evaluate, "spatial_only": strip(only), "halo": _halo_inputs()},
               root / "inputs.pt")
    procs = launch_group("spatial", root, world=4)
    # the references run while the ranks do
    ref = {
        "forward": {k: spatial_forward(strip(f), None) for k, f in forwards.items()},
        "steps": {k: run_variant(v, None) for k, v in variants.items()},
        "eval": eval_outputs(evaluate, None),
        "spatial_only": spatial_forward(strip(only), None),
    }
    mesh22, mesh14 = jax_spatial.make_mesh_2d(2, 2), jax_spatial.make_mesh_2d(1, 4)
    jax_ref = {
        "forward": {k: _jax_forward(forwards[k], mesh22) for k in ("w05", "off")},
        "steps": {k: _jax_step(k, variants[k], mesh22) for k in JAX_VARIANTS},
        "spatial_only": _jax_forward(only, mesh14),
    }
    return {"ranks": finish_group("spatial", root, procs, GROUP_TIMEOUT_S), "ref": ref,
            "jax": jax_ref,
            "variants": variants}


def _assert_grads_close(ours: dict, ref: dict, atol: float = GRAD_TOL):
    """Every leaf within ``atol`` and its norm within 1% (+ 1e-4): a leaf
    scaled by a shard count fails the norm even where the values are small."""
    for name, g in ref.items():
        a, b = _np(ours[name]), _np(g)
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=atol, err_msg=name)
        na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
        assert abs(na - nb) <= NORM_RTOL * nb + NORM_ATOL, (name, na, nb)


def test_mesh_places_each_rank(spatial):
    for rank, results in enumerate(spatial["ranks"]):
        d, s, text = results["mesh"]
        assert (d, s) == divmod(rank, 2)
        assert text.startswith("data x spatial mesh 2 x 2: world size 4, backend gloo")


@pytest.mark.parametrize("name", ["w05", *WIDTH_1])
def test_sharded_forward_equals_unsharded_and_jax(spatial, name):
    ref = spatial["ref"]["forward"][name]
    jax_ref = spatial["jax"]["forward"]["w05" if name == "w05" else "off"]
    for results in spatial["ranks"]:
        ours = results["forward"][name]
        for key, j in zip(("locs", "scores"), jax_ref):
            np.testing.assert_allclose(_np(ours[key]), _np(ref[key]), rtol=RTOL, atol=RTOL)
            np.testing.assert_allclose(_np(ours[key]), j, rtol=FORWARD_TOL, atol=FORWARD_TOL)
    assert float(np.std(_np(ref["locs"]))) > 0.01


@pytest.mark.parametrize("name", ["use_pallas", "both"])
def test_k2_runs_on_the_haloed_slab(spatial, name):
    """Layer 3 (128 channels, 4^3 at 32^3) is before the cut: each rank
    sends K2 its 2 planes and the 2 halo planes, one row; with
    ``use_pallas`` alone K2 also takes layers 5 and 7, past the cut, whole."""
    unsharded = spatial["ref"]["forward"][name]["k2"]
    assert unsharded[0] == (2, 128, 4, 4, 4)
    for results in spatial["ranks"]:
        calls = results["forward"][name]["k2"]
        assert calls[0] == (1, 128, 2 + 2, 4, 4)
        assert calls[1:] == [(1, *shape[1:]) for shape in unsharded[1:]]
        assert len(calls) == (3 if name == "use_pallas" else 1)


@pytest.mark.parametrize("name", ["use_pallas_tail", "both"])
def test_k3_runs_whole_past_the_cut(spatial, name):
    for results in spatial["ranks"]:
        assert results["forward"][name]["k3"] == [(1, 128, 4, 4, 4)]
    assert spatial["ref"]["forward"][name]["k3"] == [(2, 128, 4, 4, 4)]


@pytest.mark.parametrize("name", ["batch2", "batch8", "flip", "mixed_augment", "grad_accum",
                                  "grad_accum_whole_rows", "detections", "remat", "convnet",
                                  "convnet_dropout"])
def test_sharded_step_equals_one_rank(spatial, name):
    new, m = spatial["ref"]["steps"][name]
    for results in spatial["ranks"]:
        ours = results["steps"][name]
        for key in ("total_loss", "conf_loss", "loc_loss", "n_positives"):
            _close_rel(ours[key], m[key], RTOL)
        _close_rel(ours["grad_norm"], m["grad_norm"], NORM_RTOL)
        _assert_grads_close(ours["grads"], m["grads"])
        for key, ref in new.batch_stats.items():
            np.testing.assert_allclose(_np(ours["batch_stats"][key]), _np(ref), rtol=RTOL,
                                       atol=RTOL, err_msg=key)
    first = spatial["ranks"][0]["steps"][name]
    for results in spatial["ranks"][1:]:
        for tree in ("params", "batch_stats"):
            for key, value in first[tree].items():
                assert torch.equal(value, results["steps"][name][tree][key]), (tree, key)
    if "detections" in m:  # each data rank's rows (gathered or not), whole heads
        per = spatial["variants"][name]["batch"]["image"].shape[0] // 2
        for rank, results in enumerate(spatial["ranks"]):
            d = rank // 2
            det = results["steps"][name]["detections"]
            for key, ref in m["detections"].items():
                np.testing.assert_allclose(_np(det[key]), _np(ref[per * d:per * (d + 1)]),
                                           rtol=RTOL, atol=RTOL, err_msg=key)
        assert int(m["detections"]["count"].sum()) > 0


@pytest.mark.parametrize("name", JAX_VARIANTS)
def test_sharded_step_equals_jax(spatial, name):
    jnew, jm = spatial["jax"]["steps"][name]
    cfg = SSD3DConfig.create(**spatial["variants"][name]["kw"])
    jgrads = from_jax_params(jax.device_get(jm["grads"]), cfg)
    jstats = (from_jax_batch_stats(jnew.params, jax.device_get(jnew.batch_stats))
              if jnew.batch_stats else {})
    atol = CONVNET_GRAD_ATOL if name == "convnet" else GRAD_TOL
    for results in spatial["ranks"]:
        ours = results["steps"][name]
        _close_rel(ours["total_loss"], jm["total_loss"], RTOL)
        for key, g in jgrads.items():
            np.testing.assert_allclose(_np(ours["grads"][key]), _np(g), rtol=GRAD_TOL, atol=atol,
                                       err_msg=key)
        for key, ref in jstats.items():
            np.testing.assert_allclose(_np(ours["batch_stats"][key]), _np(ref), rtol=RTOL,
                                       atol=RTOL, err_msg=key)


def test_sharded_eval_step_equals_one_rank(spatial):
    ref = spatial["ref"]["eval"]
    for rank, results in enumerate(spatial["ranks"]):
        ours, d = results["eval"], rank // 2
        for key in ("total_loss", "conf_loss", "loc_loss", "n_valid"):
            _close_rel(ours[key], ref[key], RTOL)
        det = ours["detections"]
        np.testing.assert_array_equal(_np(det["count"]), _np(ref["detections"]["count"][2 * d:
                                                                                       2 * d + 2]))
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_allclose(_np(det[key]), _np(ref["detections"][key][2 * d:2 * d + 2]),
                                       rtol=RTOL, atol=RTOL, err_msg=key)
    assert int(ref["detections"]["count"].sum()) > 0


def test_spatial_only_forward_equals_unsharded_and_jax(spatial):
    ref = spatial["ref"]["spatial_only"]
    for results in spatial["ranks"]:
        ours = results["spatial_only"]
        for key, j in zip(("locs", "scores"), spatial["jax"]["spatial_only"]):
            np.testing.assert_allclose(_np(ours[key]), _np(ref[key]), rtol=RTOL, atol=RTOL)
            np.testing.assert_allclose(_np(ours[key]), j, rtol=FORWARD_TOL, atol=FORWARD_TOL)


@pytest.mark.parametrize("case", [(1, 1), (1, 0), "gather"], ids=["halo_1_1", "halo_1_0",
                                                                  "gather"])
def test_halo_and_gather_equal_the_padded_volume(spatial, case):
    """Rank s of 4 holds planes [2 s, 2 s + 2) of 8: its haloed slab is the
    zero-padded volume's planes around them, and its gradient that of the
    four ranks' weighted sums; the gather's gradient sums the four ranks'."""
    h = _halo_inputs()
    x = h["x"].clone().requires_grad_()
    padded = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    lo, hi = (1, 1) if case == "gather" else case
    slabs = [slice(2 * s - lo + 1, 2 * s + 2 + hi + 1) for s in range(4)]
    if case == "gather":
        total = 4 * (x * h["w"][:, :, 1:-1]).sum()
    else:
        total = sum((padded[:, :, sl] * h["w"][:, :, sl]).sum() for sl in slabs)
    (grad,) = torch.autograd.grad(total, [x])
    for s, results in enumerate(spatial["ranks"]):
        ours = results["halo"][case]
        expected = h["x"] if case == "gather" else padded.detach()[:, :, slabs[s]]
        torch.testing.assert_close(ours["y"], expected, rtol=0, atol=0)
        torch.testing.assert_close(ours["grad"], grad[:, :, 2 * s:2 * s + 2], rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------------------ layout
class _View:
    def __init__(self, rank, size):
        self.rank, self.size = rank, size


@pytest.mark.parametrize("rank", range(4))
def test_batch_layout_equals_jax(rank):
    """Rank (d, s) of the 2 x 2 mesh holds what JAX's device (d, s) holds:
    rows d of a batch, depth slab s of a volume."""
    d, s = divmod(rank, 2)
    mesh = parallel.SpatialMesh(world=_View(rank, 4), data=_View(d, 2), spatial=_View(s, 2))
    batch = _batch(batch=4, seed=0)
    jmesh = jax_spatial.make_mesh_2d(2, 2)
    jbatch = jax_spatial.shard_batch_spatial(batch, jmesh)
    ours = parallel.shard_batch_spatial(batch, mesh)
    device = jmesh.devices[d, s]
    for key, value in jbatch.items():
        shard = next(sh.data for sh in value.addressable_shards if sh.device == device)
        np.testing.assert_array_equal(ours[key], np.asarray(shard), err_msg=key)
    # the steps' rows, whole volumes: the data rank's share of every
    # micro-batch, or its block where a micro-batch does not divide over the
    # data ranks (the step gathers the batch then)
    shares = parallel.shard_batch(batch, mesh, grad_accum=2)
    np.testing.assert_array_equal(shares["labels"], batch["labels"][[d, 2 + d]])
    block = parallel.shard_batch(batch, mesh, grad_accum=4)
    np.testing.assert_array_equal(block["labels"], batch["labels"][2 * d:2 * d + 2])
    np.testing.assert_array_equal(block["image"], batch["image"][2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="volume depth 16 is not divisible by spatial_shards=3"):
        parallel.depth_slab(batch["image"], parallel.SpatialMesh(
            world=_View(0, 3), data=_View(0, 1), spatial=_View(0, 3)))


def test_data_mesh_split_keeps_the_rows():
    """A data mesh always splits the rows: the layers' split says so, and
    asking it for whole rows is an error rather than a silent split."""
    mesh = parallel.DataMesh(None, 0, 2, torch.device("cpu"), "gloo")
    assert mesh.rows is mesh and mesh.split().rows is mesh
    with pytest.raises(ValueError, match="a data mesh splits the batch rows"):
        mesh.split(rows=False)


# ------------------------------------------------------------------ trainer
TRAINER = dict(max_epochs=2, max_steps=-1, early_stopping=False, compute_metric_every_n_epochs=1,
               seed=970205, log_every_n_steps=1, grad_hist_every_n_steps=0)
TRAINER_KW = dict(KW, batch_size=8, min_score=0.2)
TRAINER_AUG = dict(flip_axes=(0, 1, 2))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_trainer")
    data = root / "data"
    generate_dataset(data, num_images=20, n_classes=1, image_size=(16, 16, 16),
                     object_size=(4, 8), num_objects=(1, 3), seed=4, num_processes=1)
    cli_args = ["-d", str(data), "-b", "8", "-wm", "0.25", "-mi", "2", "-en", "cli",
                "--max_objects", "4", "-a", "flip"]
    torch.save({"data": str(data), "kw": TRAINER_KW, "trainer": TRAINER,
                "augment": TRAINER_AUG, "cli": cli_args,
                "fits": {"spatial": dict(spatial_shards=2, data_parallel=True)}},
               root / "inputs.pt")
    procs = launch_group("spatial_trainer", root, env_init=True, world=4)
    dm = SyntheticDataModule(data, n_classes=1, batch_size=8, max_objects=4)
    dm.setup("fit")
    _, ref = Trainer(TrainerConfig(
        logdir=str(root / "ref_logs"), experiment_name="stream", device="cpu",
        device_data_cache=False, **TRAINER)).fit(SSD3DConfig.create(**TRAINER_KW), dm,
                                                  augment=AugmentConfig(**TRAINER_AUG))
    return {"ranks": finish_group("spatial_trainer", root, procs, GROUP_TIMEOUT_S), "root": root,
            "ref": ref}


def _losses(result) -> list:
    return [v for e in result["timings"]["epochs"] for v in e["train_losses"]]


def test_trainer_spatial_shards_equals_one_rank(trained):
    ref = trained["ref"]
    for rank, results in enumerate(trained["ranks"]):
        ours = results["spatial"]["result"]
        np.testing.assert_allclose(_losses(ours), _losses(ref), rtol=RTOL)
        assert len(_losses(ours)) == 4
        for h, r in zip(ours["history"], ref["history"], strict=True):
            np.testing.assert_allclose(h["avg_val_loss"], r["avg_val_loss"], rtol=VAL_RTOL)
        assert (ours["best_checkpoint"] is not None) == (rank == 0)
    assert "mAP/validation_IoU_0.1" in trained["ranks"][0]["spatial"]["result"]["history"][0]
    first = trained["ranks"][0]["spatial"]["state"]
    for results in trained["ranks"][1:]:
        for key, value in first.params.items():
            assert torch.equal(value, results["spatial"]["state"].params[key]), key


def test_cli_train_spatial_shards(trained):
    losses = [_losses(r["cli"]["result"]) for r in trained["ranks"]]
    assert len(losses[0]) == 2 and np.isfinite(losses[0]).all()
    assert all(other == losses[0] for other in losses[1:])
    assert (trained["root"] / "logs" / "cli" / "checkpoints" / "last").is_dir()


@pytest.mark.parametrize("case,message", [
    ("shards", "spatial_shards=3 does not divide the 4 ranks of the world"),
    ("depth", "volume depth 18 is not divisible by spatial_shards=4"),
    ("world", "a data x spatial mesh of 1 x 2 needs a world of 2 ranks, and this one has 4: "
              "launch 2"),
    ("capped", "batch 3 is not divisible by the data axis's 2 ranks (a world of 4 / "
               "spatial_shards=2): launch 2 ranks"),
])
def test_trainer_spatial_checks_raise(trained, case, message):
    for results in trained["ranks"]:
        assert message in results["errors"][case]
    assert not (trained["root"] / "logs" / f"error_{case}" / "metrics.jsonl").exists()
