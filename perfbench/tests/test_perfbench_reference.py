"""The plain reference against the program, on the CPU at a tiny size:
the state dict's schema, the priors, the eval forward, decode + NMS + top-k,
and the benchmark's synthetic data and weights."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.ops.nms import detect_objects
from perfbench.lib import data, weights
from perfbench.reference import boxes as bx
from perfbench.reference import ssd3d as ref

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ["ssd3d_mobilenet_96_bf16", "ssd3d_mobilenet_recipe64_f32"]


def model_json(name: str, **changes) -> dict:
    body = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    return {**body["model"], **changes}


@pytest.mark.parametrize("name", CONFIGS)
def test_schema_and_priors(name):
    cfg = model_json(name)
    config = SSD3DConfig.from_json_dict(cfg)
    sd = SSD3D(config).state_dict()
    specs = ref.param_specs(cfg)
    assert sorted(n for n, *_ in specs) == sorted(sd)
    assert all(tuple(sd[n].shape) == tuple(shape) for n, shape, *_ in specs)
    priors = bx.priors(cfg, ref.tower_plan(cfg))
    np.testing.assert_array_equal(priors.numpy(), model_priors(config))


@pytest.mark.parametrize("scheme", ["served", "init"])
def test_eval_forward_and_detections(scheme):
    cfg = model_json("ssd3d_mobilenet_96_bf16", input_size=[32, 32, 32], dtype="float32",
                     width_mult=0.5)
    config = SSD3DConfig.from_json_dict(cfg)
    sd = weights.make_state_dict(cfg, 11, "cpu", scheme)
    model = SSD3D(config)
    model.load_state_dict(sd)
    model.eval()
    x = data.make_volumes(3, (32, 32, 32), (1, 5), (4, 8), 12, "cpu")["image"]
    with torch.no_grad():
        locs, logits = model(x)
        ref_locs, ref_logits = ref.forward(sd, cfg, x)
    torch.testing.assert_close(ref_locs, locs, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ref_logits, logits, rtol=1e-4, atol=1e-5)
    priors = bx.priors(cfg, ref.tower_plan(cfg))
    det = detect_objects(locs, logits, priors, n_classes=2, min_score=0.5, max_overlap=0.5,
                         top_k=20)
    for v in range(3):
        mine = bx.detect(locs[v], logits[v], priors, min_score=0.5, max_overlap=0.5, top_k=20)
        n = int(det["count"][v])
        assert len(mine) == n
        if n:
            torch.testing.assert_close(torch.stack([b for b, _, _ in mine]), det["boxes"][v, :n])
            torch.testing.assert_close(torch.tensor([s for _, _, s in mine]),
                                       det["scores"][v, :n])


def test_volumes_from_the_seed():
    a = data.make_volumes(4, (24, 24, 24), (1, 5), (6, 14), 5, "cpu")
    b = data.make_volumes(4, (24, 24, 24), (1, 5), (6, 14), 5, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    img = a["image"][..., 0]
    assert torch.allclose(img.mean((1, 2, 3)), torch.zeros(4), atol=1e-5)
    counts = a["box_mask"].sum(1)
    assert bool(((counts >= 2) & (counts <= 5)).all())
    boxes = a["boxes"][a["box_mask"]]
    assert bool((boxes[:, 3:] > boxes[:, :3]).all()) and bool((boxes <= 1).all())


def test_weights_from_the_seed_in_the_served_type():
    cfg = model_json("ssd3d_mobilenet_96_bf16")
    sd = weights.make_state_dict(cfg, 3, "cpu", "served", torch.bfloat16)
    again = weights.make_state_dict(cfg, 3, "cpu", "served", torch.bfloat16)
    other = weights.make_state_dict(cfg, 4, "cpu", "served", torch.bfloat16)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["base.features.0.0.weight"], other["base.features.0.0.weight"])
    assert sd["base.features.0.0.weight"].dtype == torch.bfloat16
    assert sd["base.features.0.1.running_var"].dtype == torch.float32
