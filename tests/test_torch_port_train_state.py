"""Training-mode BatchNorm, the init schemes, the optimizer and the train
state of the port, against the JAX package where it has a counterpart.

* BN in training mode, the stem's (flax ``nn.BatchNorm``, fast variance)
  and the blocks' (the JAX package's ``BatchNorm3d``): output, running
  statistics and gradients within 1e-5 in float32 (a bf16 output within
  one bf16 ulp).
* The optimizer fed identical gradients for 100 steps across T_max, for
  each scheduler: params and moments within 1e-6 of each leaf's largest
  value, ``rescale_factors`` moving under L2 decay with a zero gradient,
  the bias group at 2x lr.
* Init schemes "torch", "flax" and "kaiming_relu" (their bounds and
  biases, from an explicit generator), float32 masters, device rules, and
  the options this slice leaves out (``remat`` in training,
  ``patch_training``).
* The "torch" scheme's draws against JAX's, leaf by leaf, on the 4k
  recipe's model (``cli/recipe.py``: width 1.0, 2 classes, bpl 3, 64^3)
  from seeds 0, 1 and 2 in both frameworks: every leaf's shape (mapped by
  ``weights.from_jax_variables``), its support (max |w| within the bound
  1 / sqrt(fan_in), and reaching it where the leaf is large), its mean and
  standard deviation within 5 standard errors of U(-bound, bound)'s for the
  leaf's size, and of each other's; the BN scale, bias and statistics and
  ``rescale_factors`` equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.models.layers import BatchNorm3d as JaxBatchNorm3d
from mslesions3d_tpu.train.state import create_train_state as jax_create_train_state
from mslesions3d_tpu.train.state import make_optimizer as jax_make_optimizer
from mslesions3d_tpu_torch.models.layers import TRUNCATED_NORMAL_STD, BatchNorm3d
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.serving import Detector
from mslesions3d_tpu_torch.train import state as train_state
from mslesions3d_tpu_torch.train.state import AdamL2, create_train_state, eval_view
from mslesions3d_tpu_torch.train.steps import make_eval_step, make_train_step
from mslesions3d_tpu_torch.weights import from_jax_variables

SMALL = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=1e-3,
             threshold=(0.1, 0.2))


# ---------------------------------------------------------------- BatchNorm
def _bn_case(c, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0.3, 1.5, (3, 4, 5, 6, c))).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32)}
    s = {"mean": rng.uniform(-0.5, 0.5, c).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    r = rng.normal(size=x.shape).astype(np.float32)  # a cotangent for the gradients
    return jnp.asarray(x, dtype), p, s, r


def _port_bn(stem, x, p, s, r):
    c = p["scale"].shape[0]
    bn = BatchNorm3d(c, fast_variance=stem).train()
    bn.weight.data.copy_(torch.from_numpy(p["scale"]))
    bn.bias.data.copy_(torch.from_numpy(p["bias"]))
    bn.running_mean.copy_(torch.from_numpy(s["mean"]))
    bn.running_var.copy_(torch.from_numpy(s["var"]))
    xt = torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
    xt = xt.permute(0, 4, 1, 2, 3).requires_grad_()
    y = bn(xt)
    gx, gw, gb = torch.autograd.grad((y.float() * torch.from_numpy(r).permute(0, 4, 1, 2, 3)).sum(),
                                     (xt, bn.weight, bn.bias))
    return (y.detach().permute(0, 2, 3, 4, 1).float().numpy(), bn.running_mean.numpy(),
            bn.running_var.numpy(), gx.permute(0, 2, 3, 4, 1).float().numpy(), gw.numpy(),
            gb.numpy())


def _jax_bn(stem, x, p, s, r):
    c = p["scale"].shape[0]
    if stem:
        module = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                               dtype=jnp.float32)
        apply = lambda v, xx: module.apply(v, xx, mutable=["batch_stats"])  # noqa: E731
    else:
        module = JaxBatchNorm3d(c)
        apply = lambda v, xx: module.apply(v, xx, train=True, mutable=["batch_stats"])  # noqa

    def f(xx, params):
        y, mutated = apply({"params": params, "batch_stats": s}, xx)
        return jnp.sum(y.astype(jnp.float32) * r), (y, mutated["batch_stats"])

    (_, (y, stats)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(x, p)
    return (np.asarray(y, np.float32), np.asarray(stats["mean"]), np.asarray(stats["var"]),
            np.asarray(gx, np.float32), np.asarray(gp["scale"]), np.asarray(gp["bias"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stem", [True, False], ids=["stem", "block"])
def test_train_mode_batchnorm_matches_jax(stem, dtype):
    case = _bn_case(8, getattr(jnp, dtype), seed=1 + stem)
    ours, ref = _port_bn(stem, *case), _jax_bn(stem, *case)
    y_tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(ours[0], ref[0], rtol=y_tol, atol=y_tol)
    for a, b in zip(ours[1:3], ref[1:3]):  # running mean, running var
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert np.abs(ours[2] - case[2]["var"]).max() > 1e-3  # the statistics moved
    if dtype == "float32":
        for a, b in zip(ours[3:], ref[3:]):  # d/dx, d/dscale, d/dbias
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


def test_running_variance_is_biased():
    """0.9 * old + 0.1 * the biased batch variance: torch's own BN would use the
    unbiased one."""
    x = torch.randn((2, 3, 2, 2, 2), generator=torch.Generator().manual_seed(0))
    bn = BatchNorm3d(3).train()
    bn(x)
    biased = x.var(dim=(0, 2, 3, 4), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased, rtol=1e-6, atol=1e-7)


def test_eval_after_train_uses_running_statistics():
    model = SSD3D(SSD3DConfig.create(**SMALL))
    x = torch.randn((2, 16, 16, 16, 1), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        before = model.eval()(x)
        model.train()(x)
        moved = model.eval()(x)
    assert not torch.equal(before[0], moved[0])  # the BN statistics moved
    with torch.no_grad():
        torch.testing.assert_close(model(x)[0], moved[0], rtol=0, atol=0)


# ---------------------------------------------------------------- optimizer
SHAPES = {"conv.weight": (4, 2, 3, 3, 3), "bn.weight": (4,), "bn.bias": (4,),
          "head.weight": (6, 4, 3, 3, 3), "head.bias": (6,), "rescale_factors": (1, 4, 1, 1, 1)}
JAX_PATH = {"conv.weight": ("conv", "kernel"), "bn.weight": ("bn", "scale"),
            "bn.bias": ("bn", "bias"), "head.weight": ("head", "kernel"),
            "head.bias": ("head", "bias"), "rescale_factors": ("rescale_factors",)}


def _to_jax_tree(flat: dict) -> dict:
    tree: dict = {}
    for name, arr in flat.items():
        *parents, leaf = JAX_PATH[name]
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def _from_jax_tree(tree, masked_ok=False) -> dict:
    out = {}
    for name, path in JAX_PATH.items():
        node = tree
        for key in path:
            node = node[key]
        if not isinstance(node, (jax.Array, np.ndarray)):
            assert masked_ok
            continue
        out[name] = np.asarray(node)
    return out


def _jax_moments(opt_state) -> tuple[dict, dict, int]:
    mu, nu, counts = {}, {}, set()
    for group in ("bias", "weight"):
        adam = opt_state.inner_states[group].inner_state[1]
        mu.update(_from_jax_tree(adam.mu, masked_ok=True))
        nu.update(_from_jax_tree(adam.nu, masked_ok=True))
        counts.add(int(adam.count))
    assert len(counts) == 1
    return mu, nu, counts.pop()


@pytest.mark.parametrize("scheduler", ["CosineAnnealingLR", "cosine_annealed", "none"])
def test_optimizer_matches_optax_over_100_steps(scheduler):
    rng = np.random.default_rng(3)
    params = {n: rng.normal(0, 0.5, s).astype(np.float32) for n, s in SHAPES.items()}
    params["rescale_factors"][:] = 20.0
    tx, _ = jax_make_optimizer(1e-2, scheduler, t_max=40)
    jparams = _to_jax_tree(params)
    jstate = tx.init(jparams)
    jupdate = jax.jit(lambda g, st, p: tx.update(g, st, p))

    ours = AdamL2(1e-2, scheduler, t_max=40)
    tparams = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    tstate = ours.init(tparams)
    for _ in range(100):  # across T_max = 40 twice: the schedule oscillates
        grads = {n: (rng.normal(0, 1, s) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
                 for n, s in SHAPES.items()}
        grads["rescale_factors"][:] = 0.0  # unused while use_l2_rescale is off
        updates, jstate = jupdate(_to_jax_tree(grads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        tparams, tstate = ours.update({n: torch.from_numpy(g) for n, g in grads.items()},
                                      tstate, tparams)
    ref_params = _from_jax_tree(jparams)
    ref_mu, ref_nu, ref_count = _jax_moments(jstate)
    assert int(tstate.count) == ref_count == 100
    for name in SHAPES:
        for ours_t, ref in ((tparams, ref_params), (tstate.mu, ref_mu), (tstate.nu, ref_nu)):
            r = ref[name]
            np.testing.assert_allclose(ours_t[name].numpy(), r, rtol=1e-6,
                                       atol=1e-6 * np.abs(r).max(), err_msg=name)
    # rescale_factors moved under L2 decay alone, in both
    assert np.abs(ref_params["rescale_factors"] - 20.0).min() > 1e-3


def test_bias_group_takes_twice_the_lr():
    params = {"a.weight": torch.ones(4), "a.bias": torch.ones(4)}
    tx = AdamL2(1e-2, "none", weight_decay=0.0)
    new, _ = tx.update({n: torch.ones(4) for n in params}, tx.init(params), params)
    step_w = (1 - new["a.weight"]).abs().mean()
    step_b = (1 - new["a.bias"]).abs().mean()
    torch.testing.assert_close(step_b / step_w, torch.tensor(2.0), rtol=1e-5, atol=0)
    assert train_state.is_bias("base.features.0.1.bias") and not train_state.is_bias("x.weight")


@pytest.mark.parametrize("scheduler", ["CosineAnnealingLR", "cosine_annealed", "none"])
def test_schedules_match_jax(scheduler):
    _, ref = jax_make_optimizer(1e-3, scheduler, t_max=40)
    _, ours = train_state.make_optimizer(1e-3, scheduler, t_max=40)
    counts = torch.arange(200, dtype=torch.int32)
    # float32 cos of arguments up to 5 pi differs between XLA and torch by an
    # ulp or two (~5e-7 of the rate), and near the trough 1 + cos cancels, so
    # the absolute bound is 1e-6 of the base rate
    np.testing.assert_allclose(ours(counts).numpy(), [float(ref(c)) for c in range(200)],
                               rtol=1e-6, atol=1e-6 * 1e-3)
    with pytest.raises(ValueError, match="Unknown scheduler"):
        train_state.make_optimizer(1e-3, "linear")


# ---------------------------------------------------------------- init and state
def _convs(model):
    return [m for m in model.modules() if isinstance(m, torch.nn.Conv3d)]


@pytest.mark.parametrize("scheme", ["torch", "flax", "kaiming_relu"])
def test_init_schemes(scheme):
    cfg = SSD3DConfig.create(**SMALL, init_scheme=scheme)
    model = SSD3D(cfg, generator=torch.Generator().manual_seed(0))
    for conv in _convs(model):
        w = conv.weight.detach()
        fan_in = w.shape[1] * 27 if w.shape[2] == 3 else w.shape[1]
        if scheme == "torch":  # U(+-1/sqrt(fan_in)) weights and biases
            bound = (1.0 / fan_in) ** 0.5
            assert w.abs().max() <= bound * (1 + 1e-6)
            if w.numel() >= 2000:
                assert abs(float(w.std()) / (bound / 3 ** 0.5) - 1) < 0.1
            if conv.bias is not None:
                assert conv.bias.abs().max() <= bound * (1 + 1e-6) and conv.bias.any()
            continue
        if scheme == "flax":
            std = (1.0 / fan_in) ** 0.5 / TRUNCATED_NORMAL_STD
            assert w.abs().max() <= 2 * std * (1 + 1e-6)
            expected_std = (1.0 / fan_in) ** 0.5
        else:
            assert w.abs().max() <= (6.0 / fan_in) ** 0.5 * (1 + 1e-6)
            expected_std = (2.0 / fan_in) ** 0.5
        if w.numel() >= 2000:
            assert abs(float(w.std()) / expected_std - 1) < 0.1
        if conv.bias is not None:
            assert not conv.bias.any()
    again = SSD3D(cfg, generator=torch.Generator().manual_seed(0))
    other = SSD3D(cfg, generator=torch.Generator().manual_seed(1))
    key = "base.features.2.conv2.weight"
    assert torch.equal(model.state_dict()[key], again.state_dict()[key])
    assert not torch.equal(model.state_dict()[key], other.state_dict()[key])
    with pytest.raises(ValueError, match="init_scheme"):
        SSD3D(SSD3DConfig.create(**SMALL, init_scheme="xavier"))


# the 4k recipe's model (cli/recipe.py: -bpl 3, -th 0.1 0.2, -lr 0.003)
RECIPE_MODEL = dict(n_classes=2, input_channels=1, input_size=(64, 64, 64), width_mult=1.0,
                    boxes_per_location=3, threshold=(0.1, 0.2), lr=0.003)
SIGMAS = 5.0


@pytest.fixture(scope="module")
def recipe_draws():
    """{seed: (JAX's initial params and statistics as the port's state dict,
    the port's initial state dict)} for the recipe's model, "torch" scheme."""
    jcfg, cfg = JaxConfig.create(**RECIPE_MODEL), SSD3DConfig.create(**RECIPE_MODEL)
    assert jcfg.init_scheme == cfg.init_scheme == "torch"
    out = {}
    for seed in (0, 1, 2):
        jstate = jax_create_train_state(JaxSSD3D(jcfg), jcfg, jax.random.PRNGKey(seed))
        theirs = from_jax_variables(jax.device_get(jstate.params),
                                    jax.device_get(jstate.batch_stats), cfg)
        ours = create_train_state(cfg, seed=seed, device="cpu").state_dict()
        out[seed] = (theirs, ours)
    return out


def _uniform_bound(name: str, shape) -> float:
    """1 / sqrt(fan_in) of a conv weight or bias (fan_in = C_in / groups x
    the kernel's volume: its weight's shape[1:])."""
    weight = RECIPE_SHAPES[name.replace(".bias", ".weight")]
    return 1.0 / math.prod(weight[1:]) ** 0.5


RECIPE_SHAPES = {n: tuple(p.shape) for n, p in SSD3D(
    SSD3DConfig.create(**RECIPE_MODEL)).state_dict().items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_init_draws_match_jax(recipe_draws, seed):
    theirs, ours = recipe_draws[seed]
    assert ours.keys() == theirs.keys() == RECIPE_SHAPES.keys()
    for name, t in ours.items():
        j = theirs[name]
        assert tuple(t.shape) == tuple(j.shape) == RECIPE_SHAPES[name], name
        if name.endswith("num_batches_tracked"):
            continue
        conv_weight = t.dim() == 5 and name != "rescale_factors"
        conv_bias = name.startswith("pred_convs.") and name.endswith(".bias")
        if not (conv_weight or conv_bias):
            # BN scale 1, bias 0, running mean 0, var 1; rescale_factors 20
            torch.testing.assert_close(t.float(), j.float(), rtol=0, atol=0, msg=name)
            continue
        bound = _uniform_bound(name, t.shape)
        n = t.numel()
        for values in (t.double(), j.double()):
            assert float(values.abs().max()) <= bound * (1 + 1e-6), name
            if n >= 1000:  # a uniform sample of n reaches within 40 / n of its bound
                assert float(values.abs().max()) >= bound * (1 - 40.0 / n), name
            # U(-b, b): mean 0 (standard error b / sqrt(3 n)), std b / sqrt(3)
            # (relative standard error sqrt(0.2 / n))
            assert abs(float(values.mean())) <= SIGMAS * bound / math.sqrt(3 * n), name
            assert abs(float(values.std()) / (bound / math.sqrt(3)) - 1) <= \
                SIGMAS * math.sqrt(0.2 / n) + 1.0 / n, name
        # and the two against each other
        assert abs(float(t.double().mean() - j.double().mean())) <= \
            SIGMAS * bound * math.sqrt(2.0 / (3 * n)), name
        assert abs(float(t.double().std() / j.double().std()) - 1) <= \
            SIGMAS * math.sqrt(0.4 / n) + 2.0 / n, name


def test_train_state_masters_are_float32_draws():
    cfg = SSD3DConfig.create(**SMALL, dtype="bfloat16", ema_decay=0.9)
    state = create_train_state(cfg, seed=4, device="cpu")
    f32 = SSD3D(SSD3DConfig.create(**SMALL), generator=torch.Generator().manual_seed(4))
    served = SSD3D(cfg, generator=torch.Generator().manual_seed(4))
    for name, p in f32.named_parameters():
        assert state.params[name].dtype == torch.float32
        torch.testing.assert_close(state.params[name], p.detach(), rtol=0, atol=0)
        torch.testing.assert_close(state.params[name].to(served.get_parameter(name).dtype),
                                   served.get_parameter(name).detach(), rtol=0, atol=0)
    assert set(state.batch_stats) == {n for n, _ in f32.named_buffers()
                                      if not n.endswith("num_batches_tracked")}
    assert state.ema_params.keys() == state.params.keys()
    assert eval_view(state).params is state.ema_params
    assert int(state.step) == int(state.opt_state.count) == int(state.nonfinite_streak) == 0
    # the state loads strictly into the served model
    det = Detector(cfg, {k: v.clone() for k, v in state.state_dict().items()}, device="cpu")
    assert det.model.base.features[0][0].weight.dtype == torch.bfloat16


def test_train_state_carries_a_state_dict():
    cfg = SSD3DConfig.create(**SMALL)
    source = SSD3D(cfg, generator=torch.Generator().manual_seed(9)).state_dict()
    state = create_train_state(cfg, seed=0, device="cpu", state_dict=source)
    for name, p in state.params.items():
        torch.testing.assert_close(p, source[name], rtol=0, atol=0)
    assert state.ema_params is None and eval_view(state) is state


def test_train_state_wants_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(SSD3DConfig.create(**SMALL))


def test_options_left_out_raise():
    """The options this test once refused now run: ``remat`` in training
    gives the plain forward's outputs (tests/test_torch_port_remat.py holds
    its gradients), and the patch train and eval steps crop full volumes
    (tests/test_torch_port_patches.py holds them against JAX)."""
    cfg = SSD3DConfig.create(**SMALL, remat=True)
    model, plain = SSD3D(cfg), SSD3D(SSD3DConfig.create(**SMALL))
    x = torch.randn((2, 16, 16, 16, 1), generator=torch.Generator().manual_seed(0))
    for a, b in zip(model.train()(x), plain.train()(x)):
        assert torch.equal(a, b) and a.requires_grad
    priors = model_priors(cfg)
    state = create_train_state(cfg, device="cpu")
    full = {"image": np.random.default_rng(0).normal(size=(2, 20, 24, 18, 1)).astype(np.float32),
            "boxes": np.array([[[0.2, 0.2, 0.2, 0.6, 0.5, 0.6]]] * 2, np.float32),
            "labels": np.ones((2, 1), np.int32), "box_mask": np.ones((2, 1), bool)}
    new, m = make_train_step(cfg, model, priors, patch_training=True)(
        state, full, torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["total_loss"])) and int(new.step) == 1
    ev = make_eval_step(cfg, model, priors, patch_training=True)(new, full)
    assert np.isfinite(float(ev["total_loss"])) and ev["gt_box_mask"].all()
