"""The port's SSD3D with ``use_pallas`` / ``use_pallas_tail`` against the JAX model.

The same randomised JAX variables (``randomized_variables``) are carried to
the port with ``from_jax_variables``; the JAX model runs its Pallas kernels
in interpret mode, the port its kernels' plain versions (CPU tensors).
float32 at 32^3, tolerance rtol 1e-4, atol 1e-5 as for the unfused forward:
the sums are taken in other orders in XLA and in torch's CPU kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu_torch.kernels.depthwise import fused_depthwise_bn_relu_cuda
from mslesions3d_tpu_torch.kernels.nms import greedy_nms_cuda
from mslesions3d_tpu_torch.kernels.tail import fused_tail_cuda
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig
from mslesions3d_tpu_torch.weights import from_jax_variables
from test_torch_port_forward import INPUT, randomized_variables

RTOL, ATOL = 1e-4, 1e-5
FLAGS = {
    "use_pallas": dict(use_pallas=True),
    "use_pallas_tail": dict(use_pallas_tail=True),
    "both": dict(use_pallas=True, use_pallas_tail=True),
}


def jax_and_port(width_mult, flags, seed=0):
    """JAX outputs and the port's outputs on the same weights and inputs."""
    config = dict(n_classes=2, input_channels=1, input_size=INPUT, width_mult=width_mult)
    _, params, batch_stats = randomized_variables(config, seed=seed)
    x = np.random.default_rng(3).normal(size=(2, *INPUT, 1)).astype(np.float32)
    jax_model = JaxSSD3D(JaxConfig.create(**config, **flags))
    ref = jax_model.apply({"params": params, "batch_stats": batch_stats}, jnp.asarray(x),
                          train=False)
    cfg = SSD3DConfig.create(**config, **flags)
    port = SSD3D(cfg)
    port.load_state_dict(from_jax_variables(params, batch_stats, cfg))
    with torch.no_grad():
        ours = port.eval()(torch.from_numpy(x))
    return port, [np.asarray(r) for r in ref], [o.numpy() for o in ours]


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
def test_flagged_forward_matches_jax(flags):
    port, ref, ours = jax_and_port(1.0, FLAGS[flags])
    assert port.base.fuse_tail == ("tail" in flags or flags == "both")
    assert float(np.std(ref[0])) > 0.01
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_narrow_tail_takes_the_layer_path_in_both():
    """width 0.25: the tail's widths are not multiples of 128, so neither
    package fuses it, and both give the unfused outputs."""
    port, ref, ours = jax_and_port(0.25, dict(use_pallas_tail=True))
    assert not port.base.fuse_tail
    _, ref_off, _ = jax_and_port(0.25, {})
    for a, b, c in zip(ours, ref, ref_off):
        np.testing.assert_array_equal(b, c)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_unaligned_tail_input_raises_in_both():
    """width 0.5: the tail's widths are multiples of 128 but its input (64
    channels) is not, and both packages raise the same ValueError."""
    config = dict(n_classes=2, input_channels=1, input_size=INPUT, width_mult=0.5,
                  use_pallas_tail=True)
    x = jnp.zeros((1, *INPUT, 1))
    with pytest.raises(ValueError, match="lane-aligned tail input channels; got 64"):
        JaxSSD3D(JaxConfig.create(**config)).init(jax.random.PRNGKey(0), x, train=False)
    port = SSD3D(SSD3DConfig.create(**config)).eval()
    assert port.base.fuse_tail
    with pytest.raises(ValueError, match="lane-aligned tail input channels; got 64"), \
            torch.no_grad():
        port(torch.zeros((1, *INPUT, 1)))


def test_jax_variables_with_flags_load_into_the_port():
    """The JAX variable tree is the same with the flags on, so
    from_jax_variables fills the flagged port's state_dict strictly."""
    config = dict(n_classes=2, input_channels=1, input_size=INPUT, **FLAGS["both"])
    variables = jax.device_get(JaxSSD3D(JaxConfig.create(**config)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, *INPUT, 1)), train=False))
    cfg = SSD3DConfig.create(**config)
    port = SSD3D(cfg)
    state = from_jax_variables(variables["params"], variables["batch_stats"], cfg)
    port.load_state_dict(state, strict=True)
    assert set(state) == set(SSD3D(SSD3DConfig.create(input_size=INPUT)).state_dict())


def test_launch_counters_stay_on_cpu():
    counters = (fused_depthwise_bn_relu_cuda, fused_tail_cuda, greedy_nms_cuda)
    before = [c.launches for c in counters]
    from mslesions3d_tpu_torch.serving import Detector

    det = Detector(SSD3DConfig.create(input_size=INPUT, **FLAGS["both"]), device="cpu")
    out = det.predict(np.zeros((1, *INPUT, 1), np.float32))
    assert out["boxes"].shape == (1, 100, 6)
    assert [c.launches for c in counters] == before
