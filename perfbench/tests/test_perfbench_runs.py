"""Whole runs of each cell on the CPU at a tiny size, past the harness's look
for a card: sound runs come out correct under the cells' limits, and runs
with the timed path broken underneath, or the control in the program's
place, come out not correct. Card tests (``gpu``) run the controls at the
cells' own sizes and skip without a card.
"""

from __future__ import annotations

import pytest
import torch

from perfbench import run
from perfbench.lib import harness

SERVE = "serve96_batch32_fused"
TRAIN = "train64_b64_epoch"
TINY_SERVE = {"params": {"batch": 4, "pool": 8, "batch_sizes": [1, 4], "warmup_calls": 1,
                         "ref_block": 4},
              "model": {"input_size": [32, 32, 32]}}
TINY_TRAIN = {"params": {"batch": 8}, "model": {"input_size": [32, 32, 32], "width_mult": 0.25}}


def tiny(name: str, seed: int, seconds: float, faults=(), control=None) -> harness.Cell:
    overrides = TINY_TRAIN if name == TRAIN else TINY_SERVE
    cell = harness.make_cell(name, seed, seconds, False, device="cpu", faults=faults,
                             overrides=overrides, control=control)
    if name == TRAIN:
        cell.config["inputs"] = {**cell.config["inputs"], "num_images": 20}
    return cell


def result(cell: harness.Cell) -> dict:
    torch.set_num_threads(4)
    return run.execute(cell, require_chips=False)


def test_serving_sound_run_is_correct():
    r = result(tiny(SERVE, 2**31 + 17, 1.0))
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"volumes_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["stale", "altered", "half", "nosuppress"])
def test_serving_fault_is_not_correct(fault):
    r = result(tiny(SERVE, 2**31 + 18, 1.0, faults=(fault,)))
    assert not r["correct"], r["checks"]


def test_no_suppression_is_undone_after_the_run():
    from mslesions3d_tpu_torch.ops import nms as port_nms

    k1 = port_nms.greedy_nms_cuda
    result(tiny(SERVE, 2**31 + 18, 0.2, faults=("nosuppress",)))
    assert port_nms.greedy_nms_cuda is k1


def test_serving_int8_control_is_not_correct():
    r = result(tiny(SERVE, 2**31 + 19, 1.0, control="int8"))
    assert not r["correct"], r["checks"]


def test_training_sound_run_is_correct():
    r = result(tiny(TRAIN, 2**31 + 23, 0.5))
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_volumes_per_s", "setup_s"}


def test_epoch_checks_the_window_call_shape():
    """Set-up drives the checked steps as whole epochs: two calls of two steps."""
    cell = tiny(TRAIN, 2**31 + 23, 0.5)
    run_ = harness.traffic(cell).Run(cell)
    run_.setup()
    assert run_.first["calls"] == [2, 4]
    assert len(run_.first["losses"]) == len(run_.first["rows"]) == 4
    assert run_.first["epochs"] == [0, 0, 1, 1]


@pytest.mark.parametrize("fault", ["unchanged", "half", "double"])
def test_training_fault_is_not_correct(fault):
    r = result(tiny(TRAIN, 2**31 + 29, 0.5, faults=(fault,)))
    assert not r["correct"], r["checks"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_int8_control_at_the_cell_size(seed):
    _need_card()
    r = run.execute(harness.make_cell(SERVE, seed, 2.0, False, control="int8"))
    assert not r["correct"], r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_no_suppression_at_the_cell_size(seed):
    _need_card()
    r = run.execute(harness.make_cell(SERVE, seed, 2.0, False, faults=("nosuppress",)))
    assert not r["correct"], r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_tf32_control_at_the_cell_size(seed):
    _need_card()
    r = run.execute(harness.make_cell(TRAIN, seed, 0.01, False, control="tf32"))
    assert not r["correct"], r["checks"]
