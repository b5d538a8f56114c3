"""The ConvNet family of the plain reference (``reference/convnet.py``) against
the program, on the CPU: the state dict's schema and the priors of each of
the three ``CONVNET_CONFIGS``, the eval forward, one training step with
dropout on, and whole runs of both traffic modules switched to the ConvNet
by ``overrides`` alone: a family is all the harness needs."""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch.data.augment import AugmentConfig
from mslesions3d_tpu_torch.models import layers as port_layers
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.train import create_train_state
from mslesions3d_tpu_torch.train.steps import make_train_step
from perfbench import run
from perfbench.lib import data, harness, weights
from perfbench.reference import boxes as bx
from perfbench.reference import convnet
from perfbench.reference import ssd3d as ref
from perfbench.reference import train as ref_train

ROOT = Path(__file__).resolve().parents[2]
RECIPE = json.loads((ROOT / "perfbench" / "configs" / "ssd3d_mobilenet_recipe64_f32.json")
                    .read_text())
FEATURE_LAYERS = {"convnet_strides": (5, 7), "convnet_maxpool_simple": (5, 7),
                  "convnet_maxpool_double": (6, 9)}


def convnet_cfg(name: str, **changes) -> dict:
    ratios = {str(layer): [1.0] for layer in FEATURE_LAYERS[name]}
    return {**RECIPE["model"], "base_network_config": name, "aspect_ratios": ratios, **changes}


def test_the_family_is_found_by_name():
    assert ref.family(convnet_cfg("convnet_strides")) is convnet
    assert ref.family_name({"base_network_config": "mobilenet"}) == "mobilenet"
    with pytest.raises(FileNotFoundError):
        ref.family({"base_network_config": "resnet_50"})


@pytest.mark.parametrize("name", sorted(convnet.CONVNET_CONFIGS))
def test_schema_and_priors(name):
    cfg = convnet_cfg(name)
    config = SSD3DConfig.from_json_dict(cfg)
    sd = SSD3D(config).state_dict()
    specs = ref.param_specs(cfg)
    assert sorted(n for n, *_ in specs) == sorted(sd)
    assert all(tuple(sd[n].shape) == tuple(shape) for n, shape, *_ in specs)
    priors = bx.priors(cfg, ref.tower_plan(cfg))
    np.testing.assert_array_equal(priors.numpy(), model_priors(config))


@pytest.mark.parametrize("scheme", ["served", "init"])
@pytest.mark.parametrize("name", sorted(convnet.CONVNET_CONFIGS))
def test_eval_forward(name, scheme):
    cfg = convnet_cfg(name, input_size=[32, 32, 32])
    sd = weights.make_state_dict(cfg, 13, "cpu", scheme)
    model = SSD3D(SSD3DConfig.from_json_dict(cfg))
    model.load_state_dict(sd)
    model.eval()
    x = data.make_volumes(2, (32, 32, 32), (1, 5), (4, 8), 14, "cpu")["image"]
    with torch.no_grad():
        locs, logits = model(x)
        ref_locs, ref_logits = ref.forward(sd, cfg, x)
    torch.testing.assert_close(ref_locs, locs, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ref_logits, logits, rtol=1e-4, atol=1e-5)


def test_slopes_drawn_under_served_and_at_the_init_under_init():
    cfg = convnet_cfg("convnet_maxpool_double")
    served = weights.make_state_dict(cfg, 3, "cpu", "served")
    init = weights.make_state_dict(cfg, 3, "cpu", "init")
    slopes = torch.cat([v for k, v in served.items() if k.endswith(".adn.A.weight")])
    assert len(slopes) == 7 and len(set(slopes.tolist())) == 7
    assert bool(((slopes >= 0.15) & (slopes <= 0.25)).all())
    assert all(float(v) == pytest.approx(0.2) for k, v in init.items()
               if k.endswith(".adn.A.weight"))


def test_train_step_with_dropout(monkeypatch):
    """One step of the port's ``make_train_step`` and of the reference's
    ``Trainer`` from generators of one seed, the recipe's augmentation and
    dropout 0.1 on: the same dropout masks, the same loss and gradients.

    Tolerances: both sides compute in float32 and sum in different orders
    (the convs' backward, the loss's sums), which puts the loss ~2e-7 apart
    and each gradient under 1e-5 of the median leaf's norm apart (measured:
    at most 7.1e-6). The tower's conv biases, cancelled by the InstanceNorm
    after them, have gradients of round-off alone, so each leaf's gap is
    taken against the larger of its norm and the median leaf's, as
    ``lib/train_check.py`` takes it. The bounds, 1e-5 and 1e-4, sit ten
    times above."""
    cfg = convnet_cfg("convnet_maxpool_double", input_size=[32, 32, 32])
    config = SSD3DConfig.from_json_dict(cfg)
    sd = weights.make_state_dict(cfg, 5, "cpu", "init")
    batch = data.make_volumes(2, (32, 32, 32), (1, 5), (4, 8), 6, "cpu")
    masks = {"port": [], "ref": []}
    port_mask, ref_mask = port_layers._global_mask, convnet.dropout_mask

    def recorded_port(shape, split, generator, device, channels):
        u = port_mask(shape, split, generator, device, channels)
        masks["port"].append(u < 1.0 - config.convnet_dropout)
        return u

    def recorded_ref(shape, keep, generator, device):
        masks["ref"].append(ref_mask(shape, keep, generator, device))
        return masks["ref"][-1]

    monkeypatch.setattr(port_layers, "_global_mask", recorded_port)
    monkeypatch.setattr(convnet, "dropout_mask", recorded_ref)
    augment = AugmentConfig.from_names(RECIPE["train"]["augment_names"])
    step = make_train_step(config, SSD3D(config), model_priors(config), augment,
                           hard_negative_mining=True, return_grads=True)
    state = create_train_state(config, device="cpu", state_dict=sd)
    gen = torch.Generator().manual_seed(9)
    _, metrics = step(state, {k: v.numpy() for k, v in batch.items()}, gen)
    trainer = ref_train.Trainer(cfg, sd, RECIPE["train"]["augment"], "cpu")
    ref_gen = torch.Generator().manual_seed(9)
    out = trainer.step(batch, ref_gen)

    assert len(masks["port"]) == len(masks["ref"]) == 7  # one a conv block
    assert all(torch.equal(a, b) for a, b in zip(masks["port"], masks["ref"]))
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert float(metrics["total_loss"]) == pytest.approx(out["total"], rel=1e-5)
    grads = out["grads"]
    assert set(grads) == set(metrics["grads"])
    median = statistics.median(float(g.norm()) for g in grads.values())
    for name, g in grads.items():
        gap = float((metrics["grads"][name] - g).norm()) / max(float(g.norm()), median)
        assert gap < 1e-4, (name, gap)


# The cells switched to the ConvNet by ``overrides`` alone, at the tiny sizes
# of test_perfbench_runs.py, under the cells' own limits but one. The
# training cell's change_gap (0.06) was set for the MobileNet at its size;
# this tiny ConvNet read 0.0001-0.0133 on 12 sound seeds and 0.0646 on a
# 13th, where one element of the 18 of ``pred_convs.loc_convs.0.bias``
# moved 0.0171 against the reference's 0.0214 over the 4 steps: the L1 loss's
# gradient is a sum of signs, and after the first update, which moves every
# element by the learning rate, a sign can flip. Faults read 1 (unchanged)
# and 1.02-1.09 (double) there, and half the batch fails loss_gap (2e-4 and
# up against sound runs' 7e-8 at most). A ConvNet cell sets its own limits.
CONVNET = {"base_network_config": "convnet_maxpool_double",
           "aspect_ratios": {"6": [1.0], "9": [1.0]}, "input_size": [32, 32, 32]}
TINY_CONVNET_LIMITS = {"change_gap": 0.3}
SERVE = "serve96_batch32_fused"
TRAIN = "train64_b64_epoch"


def tiny_convnet(name: str, seed: int, faults=()) -> harness.Cell:
    if name == TRAIN:
        overrides = {"params": {"batch": 8}, "model": CONVNET}
    else:
        overrides = {"params": {"batch": 4, "pool": 8, "batch_sizes": [1, 4], "warmup_calls": 1,
                                "ref_block": 4, "flags": []},
                     "model": CONVNET}
    seconds = 0.3 if name == TRAIN else 1.0
    cell = harness.make_cell(name, seed, seconds, False, device="cpu", faults=faults,
                             overrides=overrides)
    if name == TRAIN:
        cell.config["inputs"] = {**cell.config["inputs"], "num_images": 20}
        cell.workload["limits"] = {**cell.workload["limits"], **TINY_CONVNET_LIMITS}
    return cell


def result(cell: harness.Cell) -> dict:
    torch.set_num_threads(4)
    return run.execute(cell, require_chips=False)


@pytest.mark.parametrize("name", [SERVE, TRAIN])
def test_convnet_sound_run_is_correct(name):
    cell = tiny_convnet(name, 2**31 + 41)
    assert ref.family(cell.config["model"]) is convnet
    r = result(cell)
    assert r["correct"], r["checks"]
    assert not harness.forbidden_modules()


@pytest.mark.parametrize("fault", ["stale", "altered", "half", "nosuppress"])
def test_convnet_serving_fault_is_not_correct(fault):
    r = result(tiny_convnet(SERVE, 2**31 + 43, faults=(fault,)))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "double"])
def test_convnet_training_fault_is_not_correct(fault):
    cell = tiny_convnet(TRAIN, 2**31 + 47, faults=(fault,))
    assert ref.family(cell.config["model"]).DOUBLE_LEAF == "base.features.3.conv.weight"
    r = result(cell)
    assert not r["correct"], r["checks"]
