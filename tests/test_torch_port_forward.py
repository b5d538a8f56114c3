"""The PyTorch port's SSD3D forward against the JAX package's, same weights.

JAX variables are made from a seed, their BN scale/bias and running stats are
randomised so eval-mode normalisation is not the identity, and they are
carried to the port by ``from_jax_variables``. float32 at 32^3.
Tolerance rtol 1e-4, atol 1e-5: float32 convolutions sum in a different
order in XLA and in torch's CPU kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.models.layers import BatchNorm3d as JaxBatchNorm3d
from mslesions3d_tpu_torch.models.layers import BatchNorm3d
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig
from mslesions3d_tpu_torch.weights import from_jax_variables

INPUT = (32, 32, 32)
RTOL, ATOL = 1e-4, 1e-5


def randomized_variables(config, seed=0):
    """JAX init from a seed, with BN params and stats drawn by numpy."""
    model = JaxSSD3D(JaxConfig.create(**config))
    variables = jax.device_get(
        model.init(jax.random.PRNGKey(seed), jnp.zeros((1, *INPUT, 1)), train=False)
    )
    rng = np.random.default_rng(seed)

    def visit(tree, stats):
        n = 0
        for key, sub in tree.items():
            if isinstance(sub, dict) and {"scale", "bias"} <= set(sub) and "kernel" not in sub:
                sub["scale"] = rng.uniform(0.5, 1.5, sub["scale"].shape).astype(np.float32)
                sub["bias"] = rng.uniform(-0.2, 0.2, sub["bias"].shape).astype(np.float32)
                stats[key]["mean"] = rng.uniform(-0.5, 0.5, sub["scale"].shape).astype(np.float32)
                stats[key]["var"] = rng.uniform(0.5, 2.0, sub["scale"].shape).astype(np.float32)
                n += 1
            elif isinstance(sub, dict) and key in stats:
                n += visit(sub, stats[key])
        return n

    params = jax.tree_util.tree_map(np.array, variables["params"])
    batch_stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    # every BN of the 8-layer tower: 1 in the stem, 2 in each of 7 blocks
    assert visit(params["backbone"], batch_stats["backbone"]) == 15
    return model, params, batch_stats


def port_model(config, params, batch_stats):
    cfg = SSD3DConfig.create(**config)
    model = SSD3D(cfg)
    model.load_state_dict(from_jax_variables(params, batch_stats, cfg))
    return model.eval()


@pytest.fixture(scope="module", params=[1.0, 0.25], ids=["width1.0", "width0.25"])
def pair(request):
    config = dict(n_classes=2, input_channels=1, input_size=INPUT, width_mult=request.param)
    jax_model, params, batch_stats = randomized_variables(config)
    x = np.random.default_rng(3).normal(size=(2, *INPUT, 1)).astype(np.float32)
    variables = {"params": params, "batch_stats": batch_stats}
    ref_locs, ref_scores = jax_model.apply(variables, jnp.asarray(x), train=False)
    ref_l3 = jax_model.apply(variables, jnp.asarray(x), train=False,
                             method=lambda m, xx, train: m.backbone(xx, train=train))[3]
    return {
        "port": port_model(config, params, batch_stats), "x": x,
        "locs": np.asarray(ref_locs), "scores": np.asarray(ref_scores), "l3": np.asarray(ref_l3),
    }


def test_forward_matches_jax(pair):
    with torch.no_grad():
        locs, scores = pair["port"](torch.from_numpy(pair["x"]))
    assert tuple(locs.shape) == pair["locs"].shape == (2, 146, 6)
    assert tuple(scores.shape) == pair["scores"].shape == (2, 146, 2)
    # not vacuous: the outputs carry input-dependent signal, not just biases
    assert float(np.std(pair["locs"])) > 0.01
    assert float(np.abs(pair["locs"][0] - pair["locs"][1]).max()) > 1e-3
    np.testing.assert_allclose(locs.numpy(), pair["locs"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(scores.numpy(), pair["scores"], rtol=RTOL, atol=ATOL)


def test_layer3_feature_map_matches_jax(pair):
    """Layer 3 follows three stride-2 convs: where a padding bug shows."""
    with torch.no_grad():
        x = torch.from_numpy(pair["x"]).permute(0, 4, 1, 2, 3)
        l3 = pair["port"].base(x)[3].permute(0, 2, 3, 4, 1)
    assert tuple(l3.shape) == pair["l3"].shape
    assert float(np.abs(pair["l3"]).max()) > 0.1
    np.testing.assert_allclose(l3.numpy(), pair["l3"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_and_folded_match_jax(dtype):
    """Eval BN in float32 then cast back, and its folded affine. Both sides
    run the same float32 formula; XLA's and torch's rsqrt may differ by an
    ulp, so float32 agrees to 1e-6, and a bf16 output may then round to the
    neighbouring bf16 value: one bf16 ulp, 2^-7."""
    rng = np.random.default_rng(7)
    c = 16
    stats = {name: rng.uniform(lo, hi, c).astype(np.float32)
             for name, lo, hi in (("scale", 0.5, 1.5), ("bias", -0.2, 0.2),
                                  ("mean", -0.5, 0.5), ("var", 0.5, 2.0))}
    variables = {"params": {"scale": stats["scale"], "bias": stats["bias"]},
                 "batch_stats": {"mean": stats["mean"], "var": stats["var"]}}
    x = rng.normal(size=(2, 3, 4, 5, c)).astype(np.float32)
    jbn = JaxBatchNorm3d(c)
    ref = jbn.apply(variables, jnp.asarray(x, dtype))
    ref_gamma, ref_beta = jbn.apply(variables, method=JaxBatchNorm3d.folded)

    bn = BatchNorm3d(c).eval()
    bn.load_state_dict({
        "weight": torch.from_numpy(stats["scale"]), "bias": torch.from_numpy(stats["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"]),
        "num_batches_tracked": torch.zeros((), dtype=torch.long),
    })
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        ours = bn(xt).permute(0, 2, 3, 4, 1)
        gamma, beta = bn.folded()
    assert ours.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(ref_gamma), rtol=1e-6)
    np.testing.assert_allclose(beta.numpy(), np.asarray(ref_beta), rtol=1e-6, atol=1e-7)


def test_state_dict_schema_is_complete(pair):
    """from_jax_variables fills every key of the port's state_dict, in its shape."""
    ours = pair["port"].state_dict()
    assert "base.features.0.0.weight" in ours and "pred_convs.cl_convs.2.bias" in ours
    assert ours["rescale_factors"].shape[0] == 1 and ours["rescale_factors"].dim() == 5
