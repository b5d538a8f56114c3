"""The MobileNet family of SSD3D's backbone, in plain PyTorch: a MobileNet-v1
tower of 3^3 convs (a stem, then depthwise-separable blocks) truncated after
its last feature layer (Medical-Image-Analysis-Laboratory/MSLesions3D,
lesions3d/ssd3d.py ``MobileNetBase`` and mobilenet.py). A family module of
``reference/ssd3d.py``: its tower's plan, its state-dict entries, the kinds
it adds, its forward and the leaf the ``double`` fault moves.

BatchNorm in eval mode uses the running statistics; in training mode the
batch's mean and biased variance (the stem's as E[x^2] - E[x]^2, clamped at
0), and it hands back the moved running statistics (0.9 old + 0.1 batch).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

STEM_CHANNELS = 32
GROUPS = ((64, 1, 2), (128, 2, 2), (256, 2, 2), (512, 6, 2), (1024, 2, 1))
BN_EPS = 1e-5
BN_KEEP = 0.9
# kind -> (value under "init", value under "served", role): a value is a
# constant or a (low, high) uniform draw; the role is "trained", "statistic"
# or "counter"
KINDS = {
    "bn_w": (1.0, (0.8, 1.2), "trained"),
    "bn_b": (0.0, (-0.1, 0.1), "trained"),
    "bn_mean": (0.0, (-0.1, 0.1), "statistic"),
    "bn_var": (1.0, (0.8, 1.25), "statistic"),
    "bn_count": (0, 0, "counter"),
}
DOUBLE_LEAF = "base.features.3.conv2.weight"


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


def tower_specs(cfg: dict) -> list:
    """[(name, shape, kind, fan_in)] of the tower's state-dict entries, in the
    schema's order."""
    specs = []

    def bn(prefix, c):
        specs.extend([(f"{prefix}.weight", (c,), "bn_w", 0), (f"{prefix}.bias", (c,), "bn_b", 0),
                      (f"{prefix}.running_mean", (c,), "bn_mean", 0),
                      (f"{prefix}.running_var", (c,), "bn_var", 0),
                      (f"{prefix}.num_batches_tracked", (), "bn_count", 0)])

    for i, (kind, cin, cout, _) in enumerate(tower_plan(cfg)):
        p = f"base.features.{i}"
        if kind == "stem":
            specs.append((f"{p}.0.weight", (cout, cin, 3, 3, 3), "conv_w", cin * 27))
            bn(f"{p}.1", cout)
        else:
            specs.append((f"{p}.conv1.weight", (cin, 1, 3, 3, 3), "conv_w", 27))
            bn(f"{p}.bn1", cin)
            specs.append((f"{p}.conv2.weight", (cout, cin, 1, 1, 1), "conv_w", cin))
            bn(f"{p}.bn2", cout)
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


def forward(sd: dict, cfg: dict, x: torch.Tensor, train: bool, moved: dict | None,
            dtype: torch.dtype, generator: torch.Generator | None) -> dict:
    """{feature layer: map (B, C, D, H, W)} of ``x`` (B, C, D, H, W) in
    ``dtype``: the convs run in it, BatchNorm in float32 with its output
    rounded back. The tower draws nothing: ``generator`` is not used."""
    wanted = {int(k) for k in cfg["aspect_ratios"]}
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
    return features
