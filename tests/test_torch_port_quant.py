"""The port's int8 post-training quantization (``quant.py``) and Q1's plain
version against the JAX package's ``quant.py``.

The model and variables are the JAX test's (``tests/test_quant.py``: 32^3,
width 0.25, 2 classes, BN statistics perturbed), carried to the port with
``from_jax_variables``.

- ``fold_ssd3d``: the port rounds the BN rsqrt once from float64; XLA's
  float32 rsqrt lies within an ulp of that on the CPU (off by one on ~15% of
  inputs), so a folded weight (rsqrt, scale, weight: three roundings) lies
  within 3 float32 ulps (relative 3 x 2^-23) of JAX's; against a float64
  fold the port is within 2. A folded bias, bias - mean * gamma, can cancel,
  so its error is measured against the larger of its two terms.
- ``folded_forward`` agrees with JAX's within rtol 1e-4, atol 1e-5 (the bound
  of ``test_quant.py``) and with the port's own ``SSD3D`` forward.
- ``calibrate`` agrees with JAX's within 1e-5 relative.
- ``quantize`` on the same activation scales: int8 weights equal JAX's, but
  for elements whose w / sw lies within 1e-6 of a half step (counted: none).
- Q1's plain integer conv equals XLA's int32 ``conv_general_dilated``
  exactly for dense 3^3 at stride 1 and 2, depthwise 3^3 at stride 1 and 2,
  and pointwise; the epilogue lies within 1 float32 ulp of JAX's ``_qconv``.
- ``quantized_forward`` on the same quantized model (JAX's, carried across)
  agrees with JAX's within 1e-3 relative (Frobenius); the requantized int8
  codes of every conv input, given the same float32 input, are counted.
- The PTQ bounds of ``test_quant.py`` hold in the port; the ConvNet and
  ``use_l2_rescale`` raise; int8 bundles round-trip bit for bit on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu import quant as jq
from mslesions3d_tpu_torch import quant
from mslesions3d_tpu_torch.kernels.qconv import (pack_weights, qconv_cuda, qconv_s32,
                                                  unpack_weights)
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig
from mslesions3d_tpu_torch.serving import (ServingDetector, export_detector,
                                           export_sliding_window_detector, save_bundle)
from mslesions3d_tpu_torch.sliding_window import make_sliding_window_detector
from mslesions3d_tpu_torch.weights import from_jax_variables
from test_quant import _model_and_variables

EPS = 2.0 ** -23  # a float32 ulp at 1
QKEYS = ("wq", "sx", "scale", "b")


@pytest.fixture(scope="module")
def pair():
    jcfg, _, variables, x = _model_and_variables()
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(32, 32, 32),
                             width_mult=0.25)
    state_dict = from_jax_variables(variables["params"], variables["batch_stats"], cfg)
    jfolded = jq.fold_ssd3d(jcfg, variables)
    return {
        "jcfg": jcfg, "cfg": cfg, "variables": variables, "state_dict": state_dict,
        "x": np.asarray(x), "jfolded": jfolded, "folded": quant.fold_ssd3d(cfg, state_dict),
        "jscales": jq.calibrate(jfolded, np.asarray(x)),
    }


def _specs(folded):
    return list(folded["layers"]) + [s for k in folded["feature_layers"]
                                     for s in folded["heads"][k]]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_fold_weights_within_three_ulps_of_jax(pair):
    ours, ref = _specs(pair["folded"]), _specs(pair["jfolded"])
    assert len(ours) == len(ref) == 15 + 6
    worst = 0.0
    for a, b in zip(ours, ref):
        assert (a["strides"], a["groups"], a["emit"]) == (tuple(b["strides"]), b["groups"],
                                                          b["emit"])
        w, wj = _np(a["w"]), _np(b["w"])
        assert w.shape == wj.shape and w.dtype == np.float32
        worst = max(worst, float(np.max(np.abs(w - wj) / np.maximum(np.abs(wj), 1e-30))))
    assert worst <= 3 * EPS, worst / EPS


def test_fold_within_two_ulps_of_a_float64_fold(pair):
    """The port's own arithmetic: each folded weight within 2 ulps (relative)
    of the fold computed in float64 from the same float32 state."""
    sd = {k: v.double() for k, v in pair["state_dict"].items()}
    prefix = "base.features.1"
    gamma = sd[f"{prefix}.bn1.weight"] / torch.sqrt(
        (pair["state_dict"][f"{prefix}.bn1.running_var"] + quant.BN_EPS).double())
    want = sd[f"{prefix}.conv1.weight"].permute(2, 3, 4, 1, 0) * gamma
    got = pair["folded"]["layers"][1]["w"].double()
    assert float(((got - want).abs() / want.abs().clamp_min(1e-30)).max()) <= 2 * EPS


def test_fold_biases_within_three_ulps_of_their_terms(pair):
    """b' = bias - mean * gamma: JAX's and the port's within 3 ulps of
    max(|bias|, |mean * gamma|), the magnitude the subtraction rounds at."""
    sd = {k: v.numpy() for k, v in pair["state_dict"].items()}
    bns = ["base.features.0.1"] + [f"base.features.{i}.{bn}" for i in range(1, 8)
                                   for bn in ("bn1", "bn2")]
    for bn, a, b in zip(bns, pair["folded"]["layers"], pair["jfolded"]["layers"], strict=True):
        gamma = sd[f"{bn}.weight"] / np.sqrt(sd[f"{bn}.running_var"] + np.float32(1e-5))
        terms = np.maximum(np.abs(sd[f"{bn}.bias"]), np.abs(sd[f"{bn}.running_mean"] * gamma))
        assert np.max(np.abs(_np(a["b"]) - _np(b["b"])) / terms) <= 3 * EPS, bn


def test_folded_forward_matches_jax_and_the_model(pair):
    x = pair["x"]
    jl, js = jax.jit(lambda v: jq.folded_forward(pair["jfolded"], v))(jnp.asarray(x))
    with torch.no_grad():
        locs, scores = quant.folded_forward(pair["folded"], torch.from_numpy(x))
        model = SSD3D(pair["cfg"])
        model.load_state_dict(pair["state_dict"])
        ml, ms = model.eval()(torch.from_numpy(x))
    for ours, ref in ((locs, jl), (scores, js), (locs, ml), (scores, ms)):
        np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-4, atol=1e-5)
    assert float(np.std(_np(jl))) > 0.01


def test_calibrate_matches_jax(pair):
    ours = quant.calibrate(pair["folded"], pair["x"])
    assert ours.dtype == np.float64 and ours.shape == pair["jscales"].shape == (15 + 3,)
    np.testing.assert_allclose(ours, pair["jscales"], rtol=1e-5)


def test_quantize_weights_equal_jax(pair):
    ours = quant.quantize(pair["folded"], pair["jscales"])
    ref = jq.quantize(pair["jfolded"], pair["jscales"])
    near_half = 0
    for a, b, f in zip(_specs(ours), _specs(ref), _specs(pair["jfolded"])):
        w = _np(f["w"]).astype(np.float64)
        sw = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(0), 1e-12) / 127.0
        frac = np.abs(np.abs(w / sw) % 1.0 - 0.5)
        tie = frac < 1e-6
        near_half += int(tie.sum())
        assert a["wq"].dtype == torch.int8
        np.testing.assert_array_equal(_np(a["wq"])[~tie], _np(b["wq"])[~tie])
        np.testing.assert_allclose(_np(a["scale"]), _np(b["scale"]), rtol=4 * EPS)
        assert float(a["sx"]) == float(b["sx"])
    assert near_half == 0


def test_quantize_checks_the_scale_count(pair):
    with pytest.raises(ValueError, match="activation scales"):
        quant.quantize(pair["folded"], np.ones(3))


CONVS = {  # name: (input shape, weight shape, strides, groups)
    "dense_s1": ((2, 6, 6, 6, 4), (3, 3, 3, 4, 8), (1, 1, 1), 1),
    "dense_s2": ((2, 7, 6, 5, 4), (3, 3, 3, 4, 8), (2, 2, 2), 1),
    "stem_1_2_2": ((2, 6, 8, 8, 1), (3, 3, 3, 1, 8), (1, 2, 2), 1),
    "depthwise_s1": ((2, 6, 5, 7, 8), (3, 3, 3, 1, 8), (1, 1, 1), 8),
    "depthwise_s2": ((2, 7, 6, 5, 8), (3, 3, 3, 1, 8), (2, 2, 2), 8),
    "pointwise": ((2, 5, 6, 7, 12), (1, 1, 1, 12, 16), (1, 1, 1), 1),
    "pointwise_odd": ((2, 4, 4, 4, 6), (1, 1, 1, 6, 5), (1, 1, 1), 1),
}


def _conv_inputs(name):
    shape, wshape, strides, groups = CONVS[name]
    rng = np.random.default_rng(sorted(CONVS).index(name))
    q = rng.integers(-127, 128, shape).astype(np.int8)
    wq = rng.integers(-127, 128, wshape).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, wshape[-1]).astype(np.float32)
    b = rng.normal(size=wshape[-1]).astype(np.float32)
    return q, wq, scale, b, strides, groups


@pytest.mark.parametrize("name", list(CONVS))
def test_qconv_s32_equals_xla_int32_conv(name):
    q, wq, _, _, strides, groups = _conv_inputs(name)
    k = wq.shape[0]
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(q), jnp.asarray(wq), strides, ((k // 2, k // 2),) * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32)
    ours = qconv_s32(torch.from_numpy(q), torch.from_numpy(wq), strides, groups)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("name", list(CONVS))
def test_qconv_epilogue_within_one_ulp_of_jax(name, relu):
    """Inputs on the int8 grid with sx = 1 (``test_quant.py``'s exactness
    check): JAX's ``_qconv`` requantizes them to themselves."""
    q, wq, scale, b, strides, groups = _conv_inputs(name)
    k = wq.shape[0]
    spec = dict(wq=jnp.asarray(wq), sx=jnp.float32(1.0), scale=jnp.asarray(scale),
                b=jnp.asarray(b), strides=strides, padding=((k // 2, k // 2),) * 3,
                groups=groups)
    ref = np.asarray(jq._qconv(jnp.asarray(q.astype(np.float32)), spec))
    if relu:
        ref = np.maximum(ref, 0)
    ours = qconv_cuda(*(torch.from_numpy(a) for a in (q, wq, scale, b)), strides, groups,
                      relu).numpy()
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    assert np.all(np.abs(ours - ref) <= ulp)


@pytest.mark.parametrize("name", list(CONVS))
def test_packed_weights_give_the_same_conv_and_need_no_repack(name):
    """``pack_weights`` stores wq as Q1 reads it: its DHWIO view gives the
    same conv, and is the layout the launch reads without a copy."""
    q, wq, scale, b, strides, groups = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                        for a in _conv_inputs(name))
    view = unpack_weights(pack_weights(wq, groups), groups)
    assert torch.equal(view, wq)
    assert pack_weights(view, groups).data_ptr() == view.data_ptr()
    assert torch.equal(qconv_cuda(q, view, scale, b, strides, groups),
                       qconv_cuda(q, wq, scale, b, strides, groups))


def test_quantized_module_stores_packed_weights(pair):
    qmodule = quant.QuantizedSSD3D(quant.quantize(pair["folded"], pair["jscales"]))
    specs = qmodule.qmodel()
    for spec in [*specs["layers"], *(s for h in specs["heads"].values() for s in h)]:
        assert pack_weights(spec["wq"], spec["groups"]).data_ptr() == spec["wq"].data_ptr()


def test_qconv_raises_off_the_card_and_cpu():
    q, wq, scale, b, strides, groups = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                        for a in _conv_inputs("dense_s1"))
    with pytest.raises(ValueError, match="one CUDA device"):
        qconv_cuda(q.to("meta"), wq.to("meta"), scale.to("meta"), b.to("meta"))
    wide = torch.zeros((3, 3, 3, 8192, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow int32"):
        qconv_cuda(torch.zeros((1, 3, 3, 3, 8192), dtype=torch.int8), wide, scale[:2], b[:2])


def _carry(spec):
    out = {k: v for k, v in spec.items() if k not in QKEYS}
    out.update({k: torch.from_numpy(np.array(spec[k])) for k in QKEYS})
    return out


@pytest.fixture(scope="module")
def carried(pair):
    """JAX's quantized model, and the same model carried to the port."""
    ref = jq.quantize(pair["jfolded"], pair["jscales"])
    ours = dict(layers=[_carry(s) for s in ref["layers"]],
                heads={k: tuple(_carry(s) for s in v) for k, v in ref["heads"].items()},
                feature_layers=ref["feature_layers"], config=pair["cfg"])
    return ref, ours


def test_quantized_forward_matches_jax(pair, carried):
    ref_q, ours_q = carried
    x = pair["x"]
    jl, js = jax.jit(lambda v: jq.quantized_forward(ref_q, v))(jnp.asarray(x))
    with torch.no_grad():
        locs, scores = quant.quantized_forward(ours_q, torch.from_numpy(x))

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(locs.numpy(), jl) < 1e-3 and rel(scores.numpy(), js) < 1e-3


def test_requantized_codes_match_jax(pair, carried):
    """Each conv's input, as JAX's quantized forward computes it, requantized
    by both: the share of int8 codes that differ (printed) stays below 1e-5
    (both divide in float32 and round half to even)."""
    ref_q, ours_q = carried
    x = jnp.asarray(pair["x"])
    differ = total = 0
    for spec, ours in zip(ref_q["layers"], ours_q["layers"]):
        want = np.asarray(jnp.clip(jnp.round(x / spec["sx"]), -127, 127).astype(jnp.int8))
        got = quant.requantize(torch.from_numpy(np.asarray(x)), ours["sx"]).numpy()
        differ += int((got != want).sum())
        total += want.size
        x = jax.nn.relu(jq._qconv(x, spec))
    print(f"requantized codes that differ: {differ} of {total}")
    assert differ <= 1e-5 * total


def test_quantized_forward_close_to_float(pair):
    """The PTQ bounds of ``test_quant.py``: <= 5% relative error against the
    folded float32 model, >= 98% argmax agreement."""
    qm = quant.quantize(pair["folded"], quant.calibrate(pair["folded"], pair["x"]))
    x = torch.from_numpy(pair["x"])
    with torch.no_grad():
        lf, sf = quant.folded_forward(pair["folded"], x)
        lq, sq = quant.quantized_forward(qm, x)

    def rel(a, b):
        a, b = a.double(), b.double()
        return float(torch.linalg.norm(a - b) / (torch.linalg.norm(b) + 1e-12))

    assert rel(lq, lf) < 0.05 and rel(sq, sf) < 0.05
    assert float((sq.argmax(-1) == sf.argmax(-1)).double().mean()) > 0.98
    for spec in qm["layers"]:
        assert spec["wq"].dtype == torch.int8 and int(spec["wq"].abs().max()) == 127
        assert spec["scale"].shape == (spec["wq"].shape[-1],)


def test_quantize_rejects_unsupported():
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(32, 32, 32),
                             base_network_config="convnet_maxpool_double",
                             aspect_ratios={6: [1.0], 9: [1.0]})
    with pytest.raises(ValueError, match="InstanceNorm"):
        quant.fold_ssd3d(cfg, {})
    cfg2 = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(32, 32, 32),
                              width_mult=0.25, use_l2_rescale=True)
    with pytest.raises(ValueError, match="l2_rescale"):
        quant.fold_ssd3d(cfg2, SSD3D(cfg2).state_dict())


def test_quantize_ssd3d_wants_a_card_unless_asked_for_the_cpu(pair):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test checks the behaviour without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quant.quantize_ssd3d(pair["cfg"], pair["state_dict"], pair["x"])


def test_int8_bundle_roundtrip(pair, tmp_path):
    """The int8 bundle serves exactly what the live int8 detector says."""
    cfg, sd, x = pair["cfg"], pair["state_dict"], pair["x"]
    exports, manifest = export_detector(cfg, sd, (2,), dtype="float32", quantize="int8",
                                        calib_images=x, platforms=["cpu"])
    assert manifest["quantize"] == "int8"
    assert set(manifest["custom_ops"]) == {"msl::greedy_nms", "msl::qconv_codes",
                                           "msl::qconv_heads"}
    served = ServingDetector(save_bundle(tmp_path / "q.mslx", exports, manifest),
                             device="cpu").predict(x)
    live = quant.make_quantized_detection_fn(cfg, sd, x, device="cpu")
    with torch.inference_mode():
        want = {k: v.numpy() for k, v in live(torch.from_numpy(x)).items()}
    for k in want:
        np.testing.assert_array_equal(served[k], want[k])
    assert want["count"].min() > 0


def test_int8_sliding_window_bundle_roundtrip(pair, tmp_path):
    cfg, sd, x = pair["cfg"], pair["state_dict"], pair["x"]
    vol_shape = (40, 32, 40)
    exports, manifest = export_sliding_window_detector(
        cfg, sd, vol_shape, (1,), dtype="float32", quantize="int8", calib_images=x,
        platforms=["cpu"])
    assert manifest["quantize"] == "int8" and manifest["kind"] == "sliding_window"
    served = ServingDetector(save_bundle(tmp_path / "q_full.mslx", exports, manifest),
                             device="cpu")
    vol = np.random.default_rng(3).normal(0, 1, (1, *vol_shape, 1)).astype(np.float32)
    got = served.predict(vol)
    qmodel = quant.QuantizedSSD3D(quant.quantize_ssd3d(cfg, sd, x, device="cpu"))
    run = make_sliding_window_detector(cfg, vol_shape,
                                       patch_forward=lambda _state, p: qmodel(p))
    live = run(type("Placement", (), {"device": torch.device("cpu")}), vol[0])
    for k in live:
        np.testing.assert_array_equal(got[k], live[k].numpy())
    assert int(live["count"][0]) > 0
