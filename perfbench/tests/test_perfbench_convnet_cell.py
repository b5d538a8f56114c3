"""The ConvNet training cell ``train64_convnet_b64_epoch`` on the CPU, shrunk
by ``overrides`` alone (16^3, batch 4, a device cache of 16 of 20 volumes),
under the cell's own limits: a sound run reads correct, and a call that
hands back its old state, half the batch left out and a leaf moved twice
read not correct. And the cell's work count (``metrics/_counts_convnet.py``)
against torch's own FLOP counter on the plain reference's forward, for all
three ConvNet configurations.

At this size 14 sound seeds read ``loss_gap`` 0-2.0e-07, ``grad_gap``
1.1e-07-3.4e-04 and ``change_gap`` 5.7e-05-0.022; the faults read
``change_gap`` 0.084-0.381 (half), 1.004-1.012 (double) and 1 (unchanged),
and half the batch ``loss_gap`` 0.016-0.081.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import run
from perfbench.lib import harness, weights
from perfbench.metrics import _counts_convnet as counts
from perfbench.reference import convnet
from perfbench.reference import ssd3d as ref

ROOT = Path(__file__).resolve().parents[2]
CELL = "train64_convnet_b64_epoch"
TINY = {"params": {"batch": 4}, "model": {"input_size": [16, 16, 16]}}
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "ssd3d_convnet_recipe64_f32.json")
                    .read_text())
FEATURE_LAYERS = {"convnet_strides": (5, 7), "convnet_maxpool_simple": (5, 7),
                  "convnet_maxpool_double": (6, 9)}


def tiny(seed: int, faults=()) -> harness.Cell:
    cell = harness.make_cell(CELL, seed, 0.3, False, device="cpu", faults=faults,
                             overrides=TINY)
    cell.config["inputs"] = {**cell.config["inputs"], "num_images": 20}
    return cell


def result(cell: harness.Cell) -> dict:
    torch.set_num_threads(4)
    return run.execute(cell, require_chips=False)


def test_the_cell_is_the_recipe_on_the_convnet():
    cell = harness.make_cell(CELL, 1, 1.0, False)
    recipe = json.loads((ROOT / "perfbench" / "configs" / "ssd3d_mobilenet_recipe64_f32.json")
                        .read_text())
    changed = {k for k in recipe["model"] if recipe["model"][k] != cell.model[k]}
    assert changed == {"base_network_config", "aspect_ratios"}
    assert cell.model["convnet_dropout"] == 0.1 and cell.config["reduced"] == []
    assert {k: cell.config[k] for k in ("train", "inputs")} == \
        {k: recipe[k] for k in ("train", "inputs")}
    assert ref.family(cell.model) is convnet
    assert cell.workload["traffic"] == "train_epochs" and cell.params["batch"] == 64


def test_sound_run_is_correct():
    r = result(tiny(2**31 + 61))
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_volumes_per_s", "setup_s"}
    assert not harness.forbidden_modules()


@pytest.mark.parametrize("fault", ["unchanged", "half", "double"])
def test_fault_is_not_correct(fault):
    r = result(tiny(2**31 + 67, faults=(fault,)))
    assert not r["correct"], r["checks"]


def test_forward_at_64_with_three_boxes():
    tower, heads = counts.forward_flops(CONFIG["model"])
    # the tower: 64^3 (1 -> 32, 32 -> 32), 32^3 (32 -> 64, 64 -> 64), 16^3
    # (64 -> 128, 128 -> 128), 8^3 (128 -> 256), 27 taps each; the heads:
    # 3 boxes x (6 + 2) x 27 on 16^3 x 128 and 8^3 x 256
    assert tower == 32_161_923_072
    assert heads == 849_346_560
    assert tower + heads == pytest.approx(33.01e9, rel=1e-3)


@pytest.mark.parametrize("name", sorted(FEATURE_LAYERS))
def test_count_equals_torch_flop_counter(name):
    """torch's FLOP counter on the reference's forward (its convs at 2 FLOP
    a multiply-add) at 32^3: the tower alone (the family's forward) and the
    whole, whose difference is the heads."""
    cfg = {**CONFIG["model"], "base_network_config": name, "input_size": [32, 32, 32],
           "aspect_ratios": {str(layer): [1.0] for layer in FEATURE_LAYERS[name]}}
    sd = weights.make_state_dict(cfg, 1, "cpu", "init")
    images = torch.zeros(1, 32, 32, 32, 1)
    with FlopCounterMode(display=False) as whole:
        ref.forward(sd, cfg, images)
    with FlopCounterMode(display=False) as alone:
        convnet.forward(sd, cfg, images.permute(0, 4, 1, 2, 3), False, None, torch.float32, None)
    tower, heads = counts.forward_flops(cfg)
    assert tower == pytest.approx(alone.get_total_flops(), rel=1e-3)
    assert heads == pytest.approx(whole.get_total_flops() - alone.get_total_flops(), rel=1e-3)
