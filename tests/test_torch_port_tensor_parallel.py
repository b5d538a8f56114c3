"""The port's tensor parallelism on the CPU: gloo groups against one rank and JAX.

Two groups of ``tests/torch_parallel_worker.py`` ranks (launched as the
data-parallel tests launch theirs, one thread a rank): a world of 2 forms a
1 x 1 x 2 data x spatial x model mesh (``parallel.make_mesh_3d``: rank =
(d n_spatial + s) n_model + m), a world of 4 forms 1 x 1 x 4 and 1 x 2 x 2
meshes in turn. (The data axis's rows are those of the data and spatial
meshes, whose steps ``tests/test_torch_port_{parallel,spatial}.py`` hold.)
On every mesh:

* the forward (``make_tensor_parallel_forward``) at the JAX test's size
  (tests/test_tensor_parallel.py: 24^3, width 0.25, batch 2, JAX's init from
  seed 0 carried by ``from_jax_variables``) against JAX's tensor-parallel
  forward on the same mesh shape of its 8-device CPU mesh and against the
  port's unsharded forward, both at rtol / atol 1e-5 (the JAX test's);
* the forward at width 1.0, 32^3, batch 2 on the default path, with
  ``use_pallas`` (K2's plain version on each rank's channel slice of layer
  3: 128 / n_model channels, a haloed slab of 2 + 2 planes where the depth
  is split too), ``use_pallas_tail`` (K3's plain version on every channel,
  the tail's weights joined over the model group) and both, against the
  unsharded forward with the same flags at 1e-5;
* the train step (``return_grads``) and the eval step on this rank's slices
  of the state (``parallel.shard_tree``) and rows of the batch, against the
  port's unsharded steps: losses within rtol 1e-5, the gradient norm within
  1%, every gradient leaf (joined over the model group) within 1e-3 and
  its norm within 1% (+ 1e-4), the BN statistics within 1e-5, the params by
  ``assert_params_close``, the eval step's losses within 1e-5 and its
  detections (each data rank's rows). The variants: 32^3, width 0.25,
  batch 4, flips at probability 1, with ``use_l2_rescale``; the same with
  ``boxes_per_location`` 3 (the heads' K = 6 and 18 take the Cin rule at
  n_model 4: partial sums, all-reduced); at width 0.2539, where a
  pointwise conv with BN takes the Cin rule, a depthwise conv and its BN
  are whole and the heads split the outputs of a whole input
  (``RAGGED_WIDTH``); ``remat`` on the 1 x 2 x 2 mesh (the blocks
  recomputed in the backward, their halos and channel gathers again under
  the split of their forward); the ConvNet at 16^3 with dropout
  0.5 (the global mask, each rank its slice of the channels). The deepest
  BNs of a 32^3 model see 1^3 a sample, so the gradient variants run at
  batch 4: at batch 2 a BN over two values has a zero true input gradient
  and both programs' float32 gradients upstream of it are rounding noise
  (10% of a leaf apart on the same mesh-less step run twice in another
  order), which is why the JAX-size variant is held by its losses only;
* a replicated leaf's local gradient is the same on every model rank;
* the JAX test's train step on a 1 x 2 x 2 mesh: its loss against JAX's
  3-D program at rtol 1e-4 (JAX's gradients on that mesh are corrupt, its
  bug B, so the port's are held against its own unsharded step above).

Without processes: the sharding rules (``parallel.tensor_sharding``) against
JAX's ``tensor_sharding_tree`` leaf by leaf at n_model 2, 4 and 8, and the
forward's placement cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from test_torch_port_parallel import finish_group, launch_group
from test_torch_port_train_step import _batch, _close_rel, _np, assert_params_close
from torch_parallel_worker import tensor_forward, tensor_step

from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.parallel import tensor as jax_tensor
from mslesions3d_tpu.train import steps as jax_steps
from mslesions3d_tpu.train.state import create_train_state as jax_create_train_state
from mslesions3d_tpu.utils.cache import quarantine_from_persistent_cache
from mslesions3d_tpu_torch import parallel
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.train import create_train_state
from mslesions3d_tpu_torch.weights import from_jax_batch_stats, from_jax_params, from_jax_variables

torch.log(torch.ones(8))  # ROADMAP §3: the first CPU log of a process, taken small

RTOL = 1e-5
FORWARD_TOL = 1e-5  # the JAX test's
JAX_LOSS_RTOL = 1e-4  # the JAX test's 3-D step
GRAD_TOL = 1e-3
NORM_RTOL, NORM_ATOL = 1e-2, 1e-4
GROUP_TIMEOUT_S = 600
MESHES = {2: [(1, 1, 2)], 4: [(1, 1, 4), (1, 2, 2)]}
ALL_MESHES = [shape for shapes in MESHES.values() for shape in shapes]
MESH_IDS = ["x".join(map(str, shape)) for shape in ALL_MESHES]
# the JAX test's config (tests/test_tensor_parallel.py::_build)
JAX_KW = dict(n_classes=2, input_channels=1, input_size=(24, 24, 24), width_mult=0.25, lr=1e-3,
              threshold=(0.1, 0.2))
STEP_KW = dict(JAX_KW, input_size=(32, 32, 32), use_l2_rescale=True)
CONVNET_KW = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16),
                  base_network_config="convnet_maxpool_double",
                  aspect_ratios={6: [1.0], 9: [1.0]}, lr=1e-3, threshold=(0.1, 0.2),
                  convnet_dropout=0.5)
FLAGS = {"off": {}, "use_pallas": dict(use_pallas=True),
         "use_pallas_tail": dict(use_pallas_tail=True),
         "both": dict(use_pallas=True, use_pallas_tail=True)}
FLIP = dict(flip_axes=(0, 1, 2), flip_prob=1.0)
GRAD_VARIANTS = ("batch4", "bpl3", "ragged", "remat", "convnet_dropout")
# the variants that run on one mesh only (the one with both a spatial and a
# model axis): the JAX-size step, held against JAX's 3-D program there, and
# remat, whose recompute gathers again under both splits
ONE_MESH = {"jax": (1, 2, 2), "remat": (1, 2, 2)}
STEP_CASES = [(shape, name) for shape in ALL_MESHES for name in ("jax", *GRAD_VARIANTS)
              if ONE_MESH.get(name, shape) == shape]
# width 0.2539: layers of 8, 16, 32, 32, 64, 64, 129 and 129 channels, so at
# n_model 2 and 4 layer 6's pointwise conv (64 -> 129) takes the Cin rule (a
# partial sum before a whole BN), layer 7 is whole (a depthwise conv of 129
# groups on the summed input), and the heads on layer 7 split their outputs
# of a whole input
RAGGED_WIDTH = 0.2539


def _jax_build():
    """The JAX test's model, variables and images."""
    jcfg = JaxConfig.create(**JAX_KW)
    model = JaxSSD3D(jcfg)
    images = np.random.default_rng(0).normal(0, 1, (2, 24, 24, 24, 1)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(images), train=False)
    return model, jax.device_get(variables), images


def _jax_batch(images) -> dict:
    """The JAX test's batch: one box in every row."""
    return {"image": images,
            "boxes": np.tile(np.asarray([[0.2, 0.2, 0.2, 0.6, 0.6, 0.6]], np.float32), (2, 1, 1)),
            "labels": np.ones((2, 1), np.int32), "box_mask": np.ones((2, 1), bool),
            "batch_mask": np.ones((2,), bool)}


def _forwards(variables, images) -> dict:
    cfg = SSD3DConfig.create(**JAX_KW)
    cases = {"jax": {"kw": JAX_KW, "x": images, "source": from_jax_variables(
        variables["params"], variables["batch_stats"], cfg)}}
    w1 = dict(JAX_KW, input_size=(32, 32, 32), width_mult=1.0)
    source = SSD3D(SSD3DConfig.create(**w1), generator=torch.Generator().manual_seed(3))
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 32, 1)).astype(np.float32)
    for name, flags in FLAGS.items():
        cases[f"w1_{name}"] = {"kw": dict(w1, **flags), "x": x,
                               "source": source.state_dict()}
    return cases


def _jax_state_source(kw: dict):
    jcfg = JaxConfig.create(**kw)
    jstate = jax_create_train_state(JaxSSD3D(jcfg), jcfg, jax.random.PRNGKey(0))
    source = from_jax_variables(jax.device_get(jstate.params),
                                jax.device_get(jstate.batch_stats), SSD3DConfig.create(**kw))
    return jstate, source


def _variants(images) -> dict:
    _, jax_source = _jax_state_source(JAX_KW)

    def port_source(kw, seed):
        return SSD3D(SSD3DConfig.create(**kw), generator=torch.Generator().manual_seed(seed)
                     ).state_dict()

    batch4 = dict(kw=STEP_KW, source=port_source(STEP_KW, 1), batch=_batch(batch=4, seed=2, d=32),
                  seed=1, opts=dict(augment=FLIP))
    bpl3 = dict(kw=dict(STEP_KW, boxes_per_location=3, min_score=0.2))
    ragged = dict(STEP_KW, width_mult=RAGGED_WIDTH)
    return {
        "jax": dict(kw=JAX_KW, source=jax_source, batch=_jax_batch(images), seed=1, opts={},
                    meshes=[ONE_MESH["jax"]]),
        "batch4": batch4,
        "bpl3": dict(batch4, **bpl3, source=port_source(bpl3["kw"], 2)),
        "ragged": dict(batch4, kw=ragged, source=port_source(ragged, 4)),
        "remat": dict(batch4, kw=dict(STEP_KW, remat=True), meshes=[ONE_MESH["remat"]]),
        "convnet_dropout": dict(kw=CONVNET_KW, source={
            k: v.float() if v.is_floating_point() else v
            for k, v in port_source(CONVNET_KW, 3).items()},
            batch=_batch(batch=2, seed=3, d=16), seed=7, opts={}),
    }


def _jax_forward(model, variables, images, shape):
    mesh = jax_tensor.make_mesh_3d(*shape)
    run = quarantine_from_persistent_cache(jax_tensor.make_tensor_parallel_forward(model, mesh))
    return [np.asarray(t) for t in run(variables, jnp.asarray(images))]


def _jax_3d_step(batch, shape=(1, 2, 2)):
    """The JAX test's train step on a data x spatial x model mesh."""
    jcfg = JaxConfig.create(**JAX_KW)
    model = JaxSSD3D(jcfg)
    mesh = jax_tensor.make_mesh_3d(*shape)
    step = jax_steps.make_train_step(jcfg, model, model_priors(SSD3DConfig.create(**JAX_KW)),
                                     donate=False, return_grads=True, constraint_mesh=mesh)
    state = jax_create_train_state(model, jcfg, jax.random.PRNGKey(0))
    state = jax.device_put(state, jax_tensor.tensor_sharding_tree(state, mesh))
    sharded = {k: jax.device_put(v, NamedSharding(mesh, P("data", "spatial") if k == "image"
                                                  else P("data")))
               for k, v in batch.items()}
    _, metrics = quarantine_from_persistent_cache(step)(state, sharded, jax.random.PRNGKey(1))
    return float(metrics["total_loss"])


@pytest.fixture(scope="module")
def tensor(tmp_path_factory):
    model, variables, images = _jax_build()
    forwards, variants = _forwards(variables, images), _variants(images)
    groups = {}
    for world in MESHES:
        root = tmp_path_factory.mktemp(f"tensor{world}")
        torch.save({"forwards": forwards, "variants": variants, "meshes": MESHES}, root / "inputs.pt")
        groups[world] = (root, launch_group("tensor", root, world=world))
    # the references run while the ranks do
    ref = {"forward": {k: tensor_forward(f, None) for k, f in forwards.items()},
           "steps": {k: tensor_step(v, None) for k, v in variants.items()}}
    jax_ref = {"forward": {shape: _jax_forward(model, variables, images, shape)
                           for shape in ALL_MESHES},
               "step_loss": _jax_3d_step(_jax_batch(images))}
    ranks = {}
    for world, (root, procs) in groups.items():
        for rank, results in enumerate(finish_group("tensor", root, procs, GROUP_TIMEOUT_S)):
            for shape, res in results.items():
                ranks.setdefault(shape, {})[rank] = res
    return {"ranks": ranks, "ref": ref, "jax": jax_ref, "variants": variants}


def _ranks(tensor, shape) -> list:
    by_rank = tensor["ranks"][shape]
    return [by_rank[r] for r in sorted(by_rank)]


@pytest.mark.parametrize("shape", ALL_MESHES, ids=MESH_IDS)
def test_mesh_places_each_rank(tensor, shape):
    n_data, n_spatial, n_model = shape
    for rank, results in enumerate(_ranks(tensor, shape)):
        d, s, m, text = results["mesh"]
        assert (d * n_spatial + s) * n_model + m == rank
        assert text.startswith(f"data x spatial x model mesh {n_data} x {n_spatial} x {n_model}: "
                               f"world size {n_data * n_spatial * n_model}, backend gloo")


@pytest.mark.parametrize("shape", ALL_MESHES, ids=MESH_IDS)
def test_forward_equals_jax_and_unsharded(tensor, shape):
    ref = tensor["ref"]["forward"]["jax"]
    jax_ref = tensor["jax"]["forward"][shape]
    for results in _ranks(tensor, shape):
        ours = results["forward"]["jax"]
        for key, j in zip(("locs", "scores"), jax_ref):
            np.testing.assert_allclose(_np(ours[key]), j, rtol=FORWARD_TOL, atol=FORWARD_TOL)
            np.testing.assert_allclose(_np(ours[key]), _np(ref[key]), rtol=FORWARD_TOL,
                                       atol=FORWARD_TOL)
    assert float(np.std(_np(ref["locs"]))) > 0.01


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("shape", ALL_MESHES, ids=MESH_IDS)
def test_flagged_forward_equals_unsharded(tensor, shape, flags):
    """Width 1.0 at 32^3: layer 3 is (2, 128, 4, 4, 4). K2 takes each rank's
    128 / n_model channels of it (and with ``use_pallas`` alone layers 5 and
    7, whole in depth past the cut); K3 takes all 128 channels."""
    name = f"w1_{flags}"
    ref = tensor["ref"]["forward"][name]
    n_data, n_spatial, n_model = shape
    rows = 2 // n_data
    for results in _ranks(tensor, shape):
        ours = results["forward"][name]
        for key in ("locs", "scores"):
            np.testing.assert_allclose(_np(ours[key]), _np(ref[key]), rtol=FORWARD_TOL,
                                       atol=FORWARD_TOL)
        if "use_pallas" in FLAGS[flags]:
            planes = 4 if n_spatial == 1 else 4 // n_spatial + 2
            assert ours["k2"][0] == (rows, 128 // n_model, planes, 4, 4)
            assert [s[1] for s in ours["k2"]] == [s[1] // n_model for s in ref["k2"]]
        if "use_pallas_tail" in FLAGS[flags]:
            assert ref["k3"] == [(2, 128, 4, 4, 4)]
            assert ours["k3"] == [(rows, 128, 4, 4, 4)]
        else:
            assert ours["k3"] == []


def _assert_grads_close(ours: dict, ref: dict):
    """Every leaf within GRAD_TOL and its norm within 1% (+ 1e-4)."""
    for name, g in ref.items():
        a, b = _np(ours[name]), _np(g)
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)
        na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
        assert abs(na - nb) <= NORM_RTOL * nb + NORM_ATOL, (name, na, nb)


@pytest.mark.parametrize("shape,name", STEP_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{n}" for s, n in STEP_CASES])
def test_step_equals_unsharded(tensor, shape, name):
    ref = tensor["ref"]["steps"][name]
    n_data = shape[0]
    for rank, results in enumerate(_ranks(tensor, shape)):
        ours = results["steps"][name]
        for key in ("total_loss", "conf_loss", "loc_loss", "n_positives"):
            _close_rel(ours[key], ref[key], RTOL)
        for key in ("total_loss", "conf_loss", "loc_loss"):
            _close_rel(ours["eval"][key], ref["eval"][key], RTOL)
        per = tensor["variants"][name]["batch"]["image"].shape[0] // n_data
        d = rank // (shape[1] * shape[2])
        for key, value in ref["eval"]["detections"].items():
            np.testing.assert_allclose(_np(ours["eval"]["detections"][key]),
                                       _np(value[per * d:per * (d + 1)]), rtol=RTOL, atol=RTOL,
                                       err_msg=key)
        if name == "jax":  # batch 2: the gradients are rounding noise (module docstring)
            continue
        _close_rel(ours["grad_norm"], ref["grad_norm"], NORM_RTOL)
        _assert_grads_close(ours["grads"], ref["grads"])
        for key, value in ref["batch_stats"].items():
            np.testing.assert_allclose(_np(ours["batch_stats"][key]), _np(value), rtol=RTOL,
                                       atol=RTOL, err_msg=key)
        assert_params_close(ours["params"], ref["params"])
    if name == "bpl3":
        assert int(ref["eval"]["detections"]["count"].sum()) > 0


@pytest.mark.parametrize("shape", ALL_MESHES, ids=MESH_IDS)
def test_replicated_grads_equal_on_every_model_rank(tensor, shape):
    """A leaf that no rule shards (the heads' biases under the Cin rule, the
    ConvNet's PReLU) has the same gradient on every model rank of a (d, s)."""
    n_model = shape[2]
    ranks = _ranks(tensor, shape)
    checked = 0
    for name in (n for s, n in STEP_CASES if s == shape and n != "jax"):
        specs = parallel.tensor_sharding(tensor["ref"]["steps"][name]["grads"], n_model)
        for first in range(0, len(ranks), n_model):
            group = [ranks[first + m]["steps"][name]["local_grads"] for m in range(n_model)]
            for key, spec in specs.items():
                if spec is None:
                    checked += 1
                    for other in group[1:]:
                        torch.testing.assert_close(other[key], group[0][key], rtol=0, atol=0)
                else:
                    assert group[0][key].shape[spec] * n_model == \
                        tensor["ref"]["steps"][name]["grads"][key].shape[spec]
    assert checked > 0


def test_3d_step_loss_equals_jax(tensor):
    ours = [r["steps"]["jax"]["total_loss"] for r in _ranks(tensor, (1, 2, 2))]
    for loss in ours:
        _close_rel(loss, tensor["jax"]["step_loss"], JAX_LOSS_RTOL)


# ------------------------------------------------------------------ the rules
def _jax_specs(kw: dict, n_model: int) -> dict:
    """JAX's ``tensor_sharding_tree`` of the model's variables at n_model,
    as {port name: the port tensor's sharded dim, or None}."""
    jcfg = JaxConfig.create(**kw)
    size = kw["input_size"]
    shapes = jax.eval_shape(lambda: JaxSSD3D(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *size, 1)), train=False))
    mesh = Mesh(np.asarray(jax.devices()[:n_model]).reshape(1, 1, n_model),
                ("data", "spatial", "model"))
    tree = jax_tensor.tensor_sharding_tree(shapes, mesh)

    def code(leaf, sharding):
        """1: the leaf's last axis sharded (Cout, or a vector), 2: a
        kernel's Cin, 0: replicated; as a leaf of its shape."""
        axes = [i for i, a in enumerate(tuple(sharding.spec)) if a == "model"]
        c = 0 if not axes else (2 if len(leaf.shape) == 5 and axes[0] == 3 else 1)
        return np.full(leaf.shape, c, np.float32)

    codes = jax.tree_util.tree_map(code, shapes, tree)
    cfg = SSD3DConfig.create(**kw)
    port = {**from_jax_params(codes["params"], cfg),
            **from_jax_batch_stats(codes["params"], codes.get("batch_stats", {}))}
    out = {}
    for name, t in port.items():
        c = int(t.reshape(-1)[0])
        out[name] = None if c == 0 else (1 if c == 2 or name == "rescale_factors" else 0)
    return out


RULE_CONFIGS = {
    # bpl 3: the heads' K = 6 and 18 shard Cout at n_model 2 and Cin at 4 and 8
    "bpl3": dict(JAX_KW, boxes_per_location=3),
    # width 0.1875: a stem of 6 channels and blocks of 12, 24, 48, ...: some
    # leaves divide by n_model and some do not (replicated)
    "ragged": dict(JAX_KW, width_mult=0.1875),
    "convnet": dict(CONVNET_KW, input_size=(24, 24, 24)),
}


@pytest.mark.parametrize("n_model", [2, 4, 8])
@pytest.mark.parametrize("config", list(RULE_CONFIGS))
def test_sharding_rules_match_jax(config, n_model):
    kw = RULE_CONFIGS[config]
    expected = _jax_specs(kw, n_model)
    cfg = SSD3DConfig.create(**kw)
    ours = parallel.tensor_sharding(SSD3D(cfg).state_dict(), n_model)
    for name, spec in ours.items():
        if name.endswith("num_batches_tracked"):
            assert spec is None
        else:
            assert spec == expected[name], (name, spec, expected[name])
    assert ours.keys() - expected.keys() <= {k for k in ours if k.endswith("num_batches_tracked")}
    # the rules take a whole TrainState: the moments and the EMA as the params
    state = create_train_state(dataclasses.replace(cfg, ema_decay=0.9), device="cpu")
    specs = parallel.tensor_sharding(state, n_model)
    for tree in (specs.opt_state.mu, specs.opt_state.nu, specs.ema_params, specs.params):
        assert tree == {k: ours[k] for k in state.params}
    assert specs.batch_stats == {k: ours[k] for k in state.batch_stats}
    assert specs.step is None and specs.opt_state.count is None
    if config == "bpl3":
        cin = {2: None, 4: 1, 8: 1}[n_model]
        for j in range(3):
            for head in ("loc_convs", "cl_convs"):
                assert ours[f"pred_convs.{head}.{j}.weight"] == (0 if cin is None else cin)
    if config == "ragged" and n_model > 2:
        assert ours["base.features.0.0.weight"] is None  # 6 output channels, 1 input
    if config == "convnet":
        assert ours["base.features.0.adn.A.weight"] is None


def test_placement_is_cached_per_state_dict():
    """``place_variables`` slices a state dict once and serves the same
    slices until another dict comes; the slices are this model index's."""
    class View:
        def __init__(self, rank, size):
            self.rank, self.size, self.device = rank, size, torch.device("cpu")

    mesh = parallel.TensorMesh(world=View(1, 2), data=View(0, 1), spatial=View(0, 1),
                               model=View(1, 2), stats=View(0, 1))
    cfg = SSD3DConfig.create(**JAX_KW)
    model = SSD3D(cfg)
    run = parallel.make_tensor_parallel_forward(model, mesh)
    sd = model.state_dict()
    first = run.place_variables(sd)
    assert run.place_variables(sd) is first
    key = "base.features.2.conv2.weight"
    torch.testing.assert_close(first[key], sd[key][sd[key].shape[0] // 2:], rtol=0, atol=0)
    other = {k: v.clone() for k, v in sd.items()}
    assert run.place_variables(other) is not first
    assert first["pred_convs.cl_convs.0.weight"].shape[0] == 2  # K = 4 shards Cout at 2
