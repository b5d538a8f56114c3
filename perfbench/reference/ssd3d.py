"""SSD3D written out in plain PyTorch: the benchmark's reference forward.

A MobileNet-v1 tower of 3^3 convs (a stem, then depthwise-separable blocks)
truncated after its last feature layer, and a 3^3 loc and class head on
each feature layer (Medical-Image-Analysis-Laboratory/MSLesions3D,
lesions3d/ssd3d.py and mobilenet.py). It reads a ``state_dict`` in that
repository's schema, computes in float32 whatever dtype the weights are
stored in, and imports nothing of the program under test.

Images are (B, D, H, W, C); locs come out (B, P, 6) and class logits
(B, P, n_classes) in prior order (feature layer, then voxel in D, H, W
order, then box). BatchNorm in eval mode uses the running statistics; in
training mode the batch's mean and biased variance (the stem's as
E[x^2] - E[x]^2, clamped at 0), and it hands back the moved running
statistics (0.9 old + 0.1 batch).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

STEM_CHANNELS = 32
GROUPS = ((64, 1, 2), (128, 2, 2), (256, 2, 2), (512, 6, 2), (1024, 2, 1))
BN_EPS = 1e-5
BN_KEEP = 0.9


class float32_exact:
    """TF32 off for cuDNN and cuBLAS inside the block: the reference computes
    in IEEE float32."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def tower_plan(cfg: dict) -> list:
    """[(kind, in channels, out channels, stride)] of the truncated tower."""
    width = float(cfg.get("width_mult", 1.0))
    cube = len(set(cfg["input_size"])) == 1
    last = max(int(k) for k in cfg["aspect_ratios"])
    stem = int(STEM_CHANNELS * width)
    plan = [("stem", int(cfg["input_channels"]), stem, (2, 2, 2) if cube else (1, 2, 2))]
    cin = stem
    for channels, repeats, stride in GROUPS:
        for i in range(repeats):
            if len(plan) - 1 == last:
                return plan
            cout = int(channels * width)
            plan.append(("block", cin, cout, (stride,) * 3 if i == 0 else (1, 1, 1)))
            cin = cout
    return plan


def feature_layers(cfg: dict) -> list:
    return sorted(int(k) for k in cfg["aspect_ratios"])


def boxes_per_map(cfg: dict, layer: int) -> int:
    return len(cfg["aspect_ratios"][str(layer)]) + int(cfg["boxes_per_location"]) - 1


def param_specs(cfg: dict) -> list:
    """[(name, shape, kind, fan_in)] of the state dict, in the schema's order.
    Kinds: conv_w, conv_b, bn_w, bn_b, bn_mean, bn_var, bn_count, rescale."""
    specs = []

    def bn(prefix, c):
        specs.extend([(f"{prefix}.weight", (c,), "bn_w", 0), (f"{prefix}.bias", (c,), "bn_b", 0),
                      (f"{prefix}.running_mean", (c,), "bn_mean", 0),
                      (f"{prefix}.running_var", (c,), "bn_var", 0),
                      (f"{prefix}.num_batches_tracked", (), "bn_count", 0)])

    plan = tower_plan(cfg)
    for i, (kind, cin, cout, _) in enumerate(plan):
        p = f"base.features.{i}"
        if kind == "stem":
            specs.append((f"{p}.0.weight", (cout, cin, 3, 3, 3), "conv_w", cin * 27))
            bn(f"{p}.1", cout)
        else:
            specs.append((f"{p}.conv1.weight", (cin, 1, 3, 3, 3), "conv_w", 27))
            bn(f"{p}.bn1", cin)
            specs.append((f"{p}.conv2.weight", (cout, cin, 1, 1, 1), "conv_w", cin))
            bn(f"{p}.bn2", cout)
    channels = {i: cout for i, (_, _, cout, _) in enumerate(plan)}
    for head, per_box in (("loc_convs", 6), ("cl_convs", int(cfg["n_classes"]))):
        for j, layer in enumerate(feature_layers(cfg)):
            c, out = channels[layer], boxes_per_map(cfg, layer) * per_box
            specs.append((f"pred_convs.{head}.{j}.weight", (out, c, 3, 3, 3), "conv_w", c * 27))
            specs.append((f"pred_convs.{head}.{j}.bias", (out,), "conv_b", c * 27))
    specs.append(("rescale_factors", (1, channels[min(feature_layers(cfg))], 1, 1, 1),
                  "rescale", 0))
    return specs


def _bn(x, sd, prefix, train, fast, moved):
    w, b = sd[f"{prefix}.weight"].float(), sd[f"{prefix}.bias"].float()
    shape = (1, -1, 1, 1, 1)
    if not train:
        mean, var = sd[f"{prefix}.running_mean"].float(), sd[f"{prefix}.running_var"].float()
        return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS) * w.view(shape) \
            + b.view(shape)
    dims = (0, 2, 3, 4)
    mean = x.mean(dims)
    if fast:
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    else:
        var = ((x - mean.view(shape)) ** 2).mean(dims)
    if moved is not None:
        with torch.no_grad():
            moved[f"{prefix}.running_mean"] = (BN_KEEP * sd[f"{prefix}.running_mean"].float()
                                               + (1 - BN_KEEP) * mean)
            moved[f"{prefix}.running_var"] = (BN_KEEP * sd[f"{prefix}.running_var"].float()
                                              + (1 - BN_KEEP) * var)
    return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS) * w.view(shape) \
        + b.view(shape)


def forward(sd: dict, cfg: dict, images: torch.Tensor, train: bool = False,
            moved: dict | None = None, dtype: torch.dtype = torch.float32):
    """(locs (B, P, 6), logits (B, P, n_classes)) in float32. With ``train``
    BatchNorm takes the batch statistics and, given ``moved``, writes the
    moved running statistics into it. ``dtype`` other than float32 runs the
    convs and keeps every activation in it (BatchNorm in float32, its output
    rounded back), as a program served in that dtype does."""
    x = images.to(dtype).permute(0, 4, 1, 2, 3)
    wanted = set(feature_layers(cfg))
    features = {}
    for i, (kind, cin, _, stride) in enumerate(tower_plan(cfg)):
        p = f"base.features.{i}"
        if kind == "stem":
            x = F.conv3d(x, sd[f"{p}.0.weight"].to(dtype), None, stride, 1)
            x = torch.relu(_bn(x.float(), sd, f"{p}.1", train, True, moved).to(dtype))
        else:
            x = F.conv3d(x, sd[f"{p}.conv1.weight"].to(dtype), None, stride, 1, 1, cin)
            x = torch.relu(_bn(x.float(), sd, f"{p}.bn1", train, False, moved).to(dtype))
            x = F.conv3d(x, sd[f"{p}.conv2.weight"].to(dtype))
            x = torch.relu(_bn(x.float(), sd, f"{p}.bn2", train, False, moved).to(dtype))
        if i in wanted:
            features[i] = x
    b = images.shape[0]
    locs, logits = [], []
    for j, layer in enumerate(feature_layers(cfg)):
        f = features[layer]
        for head, per_box, out in (("loc_convs", 6, locs),
                                   ("cl_convs", int(cfg["n_classes"]), logits)):
            y = F.conv3d(f, sd[f"pred_convs.{head}.{j}.weight"].to(dtype),
                         sd[f"pred_convs.{head}.{j}.bias"].to(dtype), 1, 1)
            out.append(y.float().permute(0, 2, 3, 4, 1).reshape(b, -1, per_box))
    return torch.cat(locs, 1), torch.cat(logits, 1)
