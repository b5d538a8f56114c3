"""Post-training int8 quantization of SSD3D for inference.

Counterpart of ``mslesions3d_tpu/quant.py``, the same classic symmetric
PTQ in four steps:

1. **Fold**: each BatchNorm folds into the conv before it (W' = W * gamma,
   b' = beta, gamma = scale / sqrt(var + eps)), so the backbone becomes a
   chain of conv + bias + ReLU and the heads biased convs
   (:func:`fold_ssd3d`, :func:`folded_forward`).
2. **Calibrate**: one float32 pass of the folded model over a few volumes
   records the absmax of every conv input (:func:`calibrate`).
3. **Quantize**: per-output-channel symmetric int8 weights (sw[oc] =
   absmax(W[..., oc]) / 127, computed in float64), per-tensor int8
   activations from the calibration maxima; biases stay float32
   (:func:`quantize`).
4. **Run**: every conv runs through Q1 (``kernels/qconv.py``: int8 x int8
   -> int32, then ``acc * (sx * sw) + b`` and the ReLU in float32), whose
   epilogue writes the int8 codes (clip(round(y / sx)) for the next conv's
   sx) its consumers read: the stem quantizes the image as it loads, an
   emitted layer also writes its heads' codes, and a feature layer's loc
   and cls heads run as one conv writing float32 (:func:`run_program`).
   :func:`quantized_forward_chain` is the same forward as JAX writes it
   (float32 convs, a requantize before each), equal bit for bit. Decode,
   NMS and top-k stay float32 (``ops.nms.detect_objects``, K1 on the card).

Scope: the MobileNet backbone family. The ConvNet uses InstanceNorm
(per-sample statistics, not foldable) and ``use_l2_rescale`` is not
supported; both raise, with the JAX package's messages.

Tensors are the JAX package's layouts: activations (B, D, H, W, C), conv
weights (k, k, k, C_in / groups, C_out). The folded and quantized programs
are dicts of tensors with the JAX package's keys, so the tests carry a
quantized model from one package to the other.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .kernels.qconv import (pack_weights, qconv_codes_cuda, qconv_cuda, qconv_heads_cuda,
                            requantize, unpack_weights)
from .models.mobilenet import mobilenet_layer_plan
from .models.ssd3d import SSD3DConfig

BN_EPS = 1e-5
_QKEYS = ("wq", "sx", "scale", "b")


def _dhwio(weight: torch.Tensor) -> torch.Tensor:
    """A torch conv weight (O, I/g, k, k, k) as (k, k, k, I/g, O) float32."""
    return weight.float().permute(2, 3, 4, 1, 0).contiguous()


def _fold_bn(kernel: torch.Tensor, state: dict, prefix: str):
    """Fold conv (no bias) + BN into (W', b'): W' = W * gamma_oc, b' = beta.

    The rsqrt is rounded once from float64 (torch's float32 rsqrt and XLA's
    each lie within an ulp of it, so apart by up to two).
    """
    rsqrt = torch.rsqrt((state[f"{prefix}.running_var"].float() + BN_EPS).double()).float()
    gamma = state[f"{prefix}.weight"].float() * rsqrt
    beta = state[f"{prefix}.bias"].float() - state[f"{prefix}.running_mean"].float() * gamma
    return kernel * gamma, beta


def fold_ssd3d(config: SSD3DConfig, state_dict: dict, device="cpu") -> dict:
    """Fold a trained SSD3D's ``state_dict`` into a flat conv + bias + ReLU program.

    Returns {"layers": [conv specs], "heads": {layer: (loc, cls)},
    "feature_layers": (...), "config": config}. Each conv spec is a dict
    {w (float32, DHWIO), b (float32, per output channel), strides, padding,
    groups, emit (feature-map index or None)}, its tensors on ``device``.
    """
    if "mobilenet" not in config.base_network_config:
        raise ValueError(
            "int8 quantization supports the mobilenet backbone family; "
            f"{config.base_network_config!r} uses InstanceNorm (per-sample "
            "statistics, not foldable into weights)"
        )
    if config.use_l2_rescale:
        raise ValueError("int8 quantization does not support use_l2_rescale")

    state = {k: v.detach().to(device) for k, v in state_dict.items()}
    plan = mobilenet_layer_plan(config.base_network_config, config.width_mult, config.cube,
                                truncate_after=max(config.feature_layers))
    wanted = set(config.feature_layers)
    layers = []
    for i, spec in enumerate(plan):
        prefix = f"base.features.{i}"
        strides = tuple(spec["strides"])
        if spec["kind"] == "conv_bn":
            kernel = _dhwio(state[f"{prefix}.0.weight"])
            w, b = _fold_bn(kernel, state, f"{prefix}.1")
            k = kernel.shape[0]
            layers.append(dict(w=w, b=b, strides=strides, groups=1, padding=((k // 2,) * 2,) * 3,
                               emit=i if i in wanted else None))
        else:  # dw_block: depthwise conv + BN + ReLU, then pointwise conv + BN + ReLU
            dw_w, dw_b = _fold_bn(_dhwio(state[f"{prefix}.conv1.weight"]), state, f"{prefix}.bn1")
            layers.append(dict(w=dw_w, b=dw_b, strides=strides, groups=dw_w.shape[-1],
                               padding=((1, 1),) * 3, emit=None))
            pw_w, pw_b = _fold_bn(_dhwio(state[f"{prefix}.conv2.weight"]), state, f"{prefix}.bn2")
            layers.append(dict(w=pw_w, b=pw_b, strides=(1, 1, 1), groups=1,
                               padding=((0, 0),) * 3, emit=i if i in wanted else None))
    heads = {}
    for j, k in enumerate(sorted(wanted)):
        heads[k] = tuple(
            dict(w=_dhwio(state[f"pred_convs.{name}.{j}.weight"]),
                 b=state[f"pred_convs.{name}.{j}.bias"].float(),
                 strides=(1, 1, 1), groups=1, padding=((1, 1),) * 3, emit=None)
            for name in ("loc_convs", "cl_convs")
        )
    return dict(layers=layers, heads=heads, feature_layers=tuple(sorted(wanted)), config=config)


def _conv(x: torch.Tensor, spec: dict) -> torch.Tensor:
    w = spec["w"]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), stride=spec["strides"],
                 padding=w.shape[0] // 2, groups=spec["groups"])
    return y.permute(0, 2, 3, 4, 1) + spec["b"]


def _reshape_heads(loc: torch.Tensor, cls: torch.Tensor, n_classes: int):
    batch = loc.shape[0]
    return loc.reshape(batch, -1, 6), cls.reshape(batch, -1, n_classes)


def folded_forward(folded: dict, images: torch.Tensor, record=None):
    """float32 forward of the folded program; mirrors ``SSD3D`` in eval mode.

    ``record``: optional list; every conv input's absmax is appended (a
    0-d tensor), in the JAX package's order: the backbone's convs, then one
    shared head-input scale per feature layer. ``calibrate`` uses it.
    """
    cfg = folded["config"]
    x = images.float()
    features = {}
    for spec in folded["layers"]:
        if record is not None:
            record.append(x.abs().max())
        x = torch.relu(_conv(x, spec))
        if spec["emit"] is not None:
            features[spec["emit"]] = x
    locs, scores = [], []
    for k in folded["feature_layers"]:
        f = features[k]
        if record is not None:
            record.append(f.abs().max())
        loc_spec, cls_spec = folded["heads"][k]
        lo, cl = _reshape_heads(_conv(f, loc_spec), _conv(f, cls_spec), cfg.n_classes)
        locs.append(lo)
        scores.append(cl)
    return torch.cat(locs, 1), torch.cat(scores, 1)


def calibrate(folded: dict, images) -> np.ndarray:
    """Per-conv-input absmax over calibration images, in one pass.

    images: (N, D, H, W, C), a handful of representative volumes; they go
    to the folded program's device. The convs run in IEEE float32 (cuDNN's
    TF32 off). Returns the activation scales (float64), aligned with
    :func:`folded_forward`'s record order.
    """
    device = folded["layers"][0]["w"].device
    images = torch.as_tensor(np.asarray(images), dtype=torch.float32).to(device)
    rec = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            folded_forward(folded, images, record=rec)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    m = torch.stack(rec).cpu().numpy().astype(np.float64)
    return np.maximum(m, 1e-6) / 127.0


def quantize(folded: dict, act_scales) -> dict:
    """int8-quantize a folded program with calibration activation scales.

    Weights per output channel, from float64: sw = max|W[..., oc]| / 127,
    wq = clip(rint(W / sw), -127, 127). Each spec gets wq (int8), sx
    (float32 0-d), scale = float32(sx * sw) (the fused output rescale) and
    b (float32); its tensors are on the CPU.
    """
    scales = list(np.asarray(act_scales, np.float64))
    want = len(folded["layers"]) + len(folded["feature_layers"])
    if len(scales) != want:
        raise ValueError(f"expected {want} activation scales, got {len(scales)}")

    def qweights(spec, sx):
        w = spec["w"].detach().cpu().numpy().astype(np.float64)
        sw = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(0), 1e-12) / 127.0
        wq = np.clip(np.rint(w / sw), -127, 127).astype(np.int8)
        out = {k: v for k, v in spec.items() if k != "w"}
        out.update(
            wq=torch.from_numpy(wq), sx=torch.tensor(sx, dtype=torch.float32),
            scale=torch.from_numpy((sx * sw).astype(np.float32)),
            b=spec["b"].detach().cpu().float(),
        )
        return out

    qlayers = [qweights(spec, scales[i]) for i, spec in enumerate(folded["layers"])]
    qheads = {}
    for j, k in enumerate(folded["feature_layers"]):
        sx = scales[len(folded["layers"]) + j]
        qheads[k] = tuple(qweights(s, sx) for s in folded["heads"][k])
    return dict(layers=qlayers, heads=qheads, feature_layers=folded["feature_layers"],
                config=folded["config"])


def _qconv(x: torch.Tensor, spec: dict, relu: bool) -> torch.Tensor:
    """Symmetric int8 conv through Q1 in float32: requantize, int32 accumulation, fused rescale."""
    return qconv_cuda(requantize(x, spec["sx"]), spec["wq"], spec["scale"], spec["b"],
                      spec["strides"], spec["groups"], relu)


def quantized_forward_chain(qmodel: dict, images: torch.Tensor):
    """The int8 forward as a chain of float32 convs: each conv's float32
    output requantized (plain torch) for the next, every conv through
    :func:`kernels.qconv.qconv_cuda`. JAX's ``quantized_forward`` step for
    step; :func:`quantized_forward` gives the same outputs bit for bit."""
    cfg = qmodel["config"]
    x = images.float()
    features = {}
    for spec in qmodel["layers"]:
        x = _qconv(x, spec, relu=True)
        if spec["emit"] is not None:
            features[spec["emit"]] = x
    locs, scores = [], []
    for k in qmodel["feature_layers"]:
        f = features[k]
        loc_spec, cls_spec = qmodel["heads"][k]
        lo, cl = _reshape_heads(_qconv(f, loc_spec, relu=False), _qconv(f, cls_spec, relu=False),
                                cfg.n_classes)
        locs.append(lo)
        scores.append(cl)
    return torch.cat(locs, 1), torch.cat(scores, 1)


def fuse_heads(loc: dict, cls: dict) -> dict:
    """A feature layer's loc and cls head specs as one conv: the weights,
    scales and biases concatenated along Cout (loc first), the shared
    activation scale, and ``split`` = loc's Cout."""
    if not torch.equal(torch.as_tensor(loc["sx"]), torch.as_tensor(cls["sx"])):
        raise ValueError("the loc and cls heads of a feature layer must share one activation "
                         "scale (quantize gives them the feature map's)")
    meta = {k: v for k, v in loc.items() if k not in _QKEYS}
    return dict(meta, wq=torch.cat([torch.as_tensor(loc["wq"]), torch.as_tensor(cls["wq"])], -1),
                scale=torch.cat([torch.as_tensor(loc["scale"]), torch.as_tensor(cls["scale"])]),
                b=torch.cat([torch.as_tensor(loc["b"]), torch.as_tensor(cls["b"])]),
                sx=torch.as_tensor(loc["sx"], dtype=torch.float32),
                split=int(loc["wq"].shape[-1]))


def fused_program(qmodel: dict) -> dict:
    """The operands of the fused int8 forward (:func:`run_program`) from a
    quantized program: each backbone conv's spec with ``sx_out``, the scales
    of the codes its epilogue writes (the next conv's input scale, then, at
    an emitted layer, its heads'), and per feature layer :func:`fuse_heads`."""
    layers = qmodel["layers"]
    heads = {k: fuse_heads(*qmodel["heads"][k]) for k in qmodel["feature_layers"]}
    out = []
    for i, spec in enumerate(layers):
        scales = [layers[i + 1]["sx"]] if i + 1 < len(layers) else []
        if spec["emit"] is not None:
            scales.append(heads[spec["emit"]]["sx"])
        if not scales:
            raise ValueError(f"layer {i} feeds no conv: neither a next layer nor a head")
        sx_out = torch.stack([torch.as_tensor(s, dtype=torch.float32) for s in scales])
        out.append({**spec, "sx_out": sx_out.reshape(-1)})
    return dict(layers=out, heads=heads, feature_layers=qmodel["feature_layers"],
                config=qmodel["config"])


def run_program(program: dict, images: torch.Tensor):
    """The fused int8 forward over :func:`fused_program`'s operands: the
    stem quantizes the float32 / bf16 image as it loads, every backbone
    conv writes the int8 codes its consumers read (``qconv_codes_cuda``:
    the next conv's, and at an emitted layer the heads'), and each feature
    layer's loc and cls heads run as one conv (``qconv_heads_cuda``). One
    Q1 launch a backbone conv and a feature layer, and no requantize pass."""
    cfg = program["config"]
    x = images if images.dtype in (torch.float32, torch.bfloat16) else images.float()
    features = {}
    layers = program["layers"]
    for i, spec in enumerate(layers):
        codes = qconv_codes_cuda(x, spec["wq"], spec["scale"], spec["b"], spec["sx_out"],
                                 spec["strides"], spec["groups"], relu=True,
                                 sx_in=spec["sx"] if i == 0 else None)
        x = codes[0]
        if spec["emit"] is not None:
            features[spec["emit"]] = codes[-1]
    locs, scores = [], []
    for k in program["feature_layers"]:
        head = program["heads"][k]
        lo, cl = qconv_heads_cuda(features[k], head["wq"], head["scale"], head["b"],
                                  head["split"])
        lo, cl = _reshape_heads(lo, cl, cfg.n_classes)
        locs.append(lo)
        scores.append(cl)
    return torch.cat(locs, 1), torch.cat(scores, 1)


def quantized_forward(qmodel: dict, images: torch.Tensor):
    """int8 forward: every conv s8 x s8 -> s32 through Q1, the ReLU and the
    next convs' requantize fused into each conv's epilogue
    (:func:`run_program`); equal bit for bit to :func:`quantized_forward_chain`."""
    return run_program(fused_program(qmodel), images)


def quantize_ssd3d(config: SSD3DConfig, state_dict: dict, calib_images, device="cuda") -> dict:
    """Fold, calibrate on ``device`` (the card by default) and quantize in one call."""
    from .serving import require_device

    folded = fold_ssd3d(config, state_dict, require_device(device, "quantize_ssd3d"))
    return quantize(folded, calibrate(folded, calib_images))


_LAYER_KEYS = _QKEYS + ("sx_out",)


class QuantizedSSD3D(nn.Module):
    """A quantized program as a module: images (B, D, H, W, C) -> (locs, scores).

    Its buffers are :func:`fused_program`'s operands: each backbone conv's
    int8 weights, ``sx``, ``scale``, ``b`` and ``sx_out``, and each feature
    layer's loc and cls heads as one conv. ``.to(device)`` moves them and
    ``torch.export`` bakes them into a program. The weights are stored as
    Q1 reads them (``kernels.qconv.pack_weights``), so that no call repacks
    them. :meth:`qmodel` gives the quantized program back, its head specs
    views of the fused heads' buffers.
    """

    def __init__(self, qmodel: dict):
        super().__init__()
        program = fused_program(qmodel)
        self.config = qmodel["config"]
        self.feature_layers = tuple(qmodel["feature_layers"])
        self._layers = [self._keep(f"layer{i}", spec, _LAYER_KEYS)
                        for i, spec in enumerate(program["layers"])]
        self._heads = {k: self._keep(f"head{k}", program["heads"][k], _QKEYS)
                       for k in self.feature_layers}

    def _keep(self, name: str, spec: dict, keys: tuple) -> tuple:
        for key in keys:
            value = torch.as_tensor(spec[key])
            if key == "wq":
                value = pack_weights(value, spec["groups"])
            self.register_buffer(f"{name}_{key}", value)
        return name, keys, {k: v for k, v in spec.items() if k not in keys}

    def _spec(self, entry: tuple) -> dict:
        name, keys, meta = entry
        spec = {**meta, **{key: getattr(self, f"{name}_{key}") for key in keys}}
        spec["wq"] = unpack_weights(spec["wq"], meta["groups"])
        return spec

    def program(self) -> dict:
        """:func:`fused_program`'s operands, its tensors the module's buffers."""
        return dict(layers=[self._spec(e) for e in self._layers],
                    heads={k: self._spec(e) for k, e in self._heads.items()},
                    feature_layers=self.feature_layers, config=self.config)

    def qmodel(self) -> dict:
        """The quantized program, its tensors the module's buffers."""
        program = self.program()
        heads = {}
        for k, (name, _, meta) in self._heads.items():
            fused, n = program["heads"][k], meta["split"]
            wk = getattr(self, f"{name}_wq")
            base = {key: v for key, v in meta.items() if key != "split"}
            heads[k] = tuple({**base, "wq": unpack_weights(w), "sx": fused["sx"], "scale": sc,
                              "b": b}
                             for w, sc, b in ((wk[:n], fused["scale"][:n], fused["b"][:n]),
                                              (wk[n:], fused["scale"][n:], fused["b"][n:])))
        layers = [{key: v for key, v in spec.items() if key != "sx_out"}
                  for spec in program["layers"]]
        return dict(layers=layers, heads=heads, feature_layers=self.feature_layers,
                    config=self.config)

    def forward(self, images: torch.Tensor):
        return run_program(self.program(), images)


def make_quantized_detection_fn(config: SSD3DConfig, state_dict: dict, calib_images, *,
                                min_score=None, top_k=None, device="cuda") -> nn.Module:
    """End-to-end int8 detector, quantized and run on ``device``: images ->
    {boxes, labels, scores, count}, a ``serving.DetectionProgram`` around
    :class:`QuantizedSSD3D`, as ``serving.export_detector`` builds for
    ``quantize="int8"``."""
    from .serving import DetectionProgram

    qm = quantize_ssd3d(config, state_dict, calib_images, device=device)
    return DetectionProgram.for_config(QuantizedSSD3D(qm), config, min_score=min_score,
                                       top_k=top_k).to(device)
