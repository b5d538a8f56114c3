"""The phase markers inside the epoch's CUDA graph, on the card.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_step_markers.py

* Under deterministic cuDNN, TF32 off, a MobileNet epoch (16^3, width 0.25,
  batch 2, 3 rows) whose capture marks its phases equals, bit for bit, one
  captured with no marks (``train.graphs.marking`` swapped for a null
  context), and a call of either makes the same host launches under the
  profiler: the events are nodes of the graph, not launches. The marks are
  the step's phases, with each weight-gradient launch of the depthwise
  convs and the stem (``msl.train.dw_wgrad``) between the forward's end and
  the backward's.
* A ConvNet epoch (32^3, batch 8): while a profiler records, each call
  samples the previous call's last replay once it has ended, and the
  step's forward, backward and update add up to the marked replay's device
  time within 5% (the rest is the row gather before the step and the copy
  of the new state into the graph's after it); the blocks' conv and norm-act
  time lies inside the forward.
* With no profiler recording, the calls after the capture make no
  synchronising call: no ``torch.cuda.synchronize``, no event or stream
  wait, no event query or elapsed time, and nothing torch's sync debug mode
  reports.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.parallel.mesh import tree_tensors
from mslesions3d_tpu_torch.train import create_train_state, make_gathered_train_epoch
from mslesions3d_tpu_torch.train import graphs
from perfbench.lib.trace import LAUNCH_CALLS

pytestmark = pytest.mark.gpu

SMALL = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=1e-3,
             threshold=(0.1, 0.2), min_score=0.3)
CONVNET = dict(SMALL, input_size=(32, 32, 32), width_mult=1.0,
               base_network_config="convnet_maxpool_double", convnet_dropout=0.1,
               aspect_ratios={6: [1.0], 9: [1.0]})
STEP = ("msl.step.forward", "msl.step.backward", "msl.step.update")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def deterministic():
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _dataset(n, d, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (n, d, d, d, 1)).astype(np.float32)
    boxes = np.zeros((n, 2, 6), np.float32)
    for b in range(n):
        lo = rng.uniform(0.05, 0.5, 3)
        boxes[b, 0] = np.concatenate([lo, lo + rng.uniform(0.25, 0.45, 3)]).clip(0, 1)
        vox = (boxes[b, 0] * d).astype(int)
        images[b, vox[0]:vox[3], vox[1]:vox[4], vox[2]:vox[5], 0] += 3.0
    host = {"image": images, "boxes": boxes, "labels": np.ones((n, 2), np.int32),
            "box_mask": np.array([[True, False]] * n)}
    return {k: torch.from_numpy(v).cuda() for k, v in host.items()}


def _epoch(cfg_kwargs):
    cfg = SSD3DConfig.create(**cfg_kwargs)
    epoch = make_gathered_train_epoch(cfg, SSD3D(cfg), model_priors(cfg),
                                      hard_negative_mining=True)
    return epoch, create_train_state(cfg, seed=3, device="cuda")


def _launches(prof) -> int:
    return sum(1 for e in prof.events() if e.name in LAUNCH_CALLS)


def test_markers_change_no_number_and_add_no_launch(monkeypatch, deterministic):
    _need_card()
    data = _dataset(6, 16)
    idx = torch.tensor([[0, 3], [5, 1], [2, 4]], device="cuda")
    out, launches, marks = {}, {}, {}
    for marked in (True, False):
        if not marked:
            monkeypatch.setattr(graphs, "marking", lambda marks: contextlib.nullcontext())
        epoch, state = _epoch(SMALL)
        gen = torch.Generator(device="cuda").manual_seed(7)
        state, _ = epoch(state, data, idx, gen)  # the capture
        out[marked] = epoch(state, data, idx, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            epoch(out[marked][0], data, idx, gen)
            torch.cuda.synchronize()
        launches[marked] = _launches(prof)
        marks[marked] = [name for name, *_ in epoch.graphed.captured.marks]
    # each weight-gradient launch of the depthwise convs and the stem is
    # marked inside the backward
    dw = [i for i, name in enumerate(marks[True]) if name == "msl.train.dw_wgrad"]
    assert dw and marks[False] == []
    assert [m for m in marks[True] if m != "msl.train.dw_wgrad"] == [*STEP, "msl.epoch.replay"]
    assert marks[True][dw[0] - 1] == STEP[0] and marks[True][dw[-1] + 1] == STEP[1]
    (a, ma), (b, mb) = out[True], out[False]
    for key in ma:
        assert torch.equal(ma[key], mb[key]), key
    assert all(torch.equal(x, y) for x, y in zip(tree_tensors(a), tree_tensors(b)))
    assert launches[True] == launches[False]


def test_convnet_phases_add_up_to_the_replay():
    _need_card()
    epoch, state = _epoch(CONVNET)
    data = _dataset(16, 32)
    idx = torch.arange(16, device="cuda").view(2, 8)
    gen = torch.Generator(device="cuda").manual_seed(5)
    state, _ = epoch(state, data, idx, gen)  # the capture; replays without a profiler
    torch.cuda.synchronize()
    graphed = epoch.graphed
    assert graphed.sampled == 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            state, _ = epoch(state, data, idx[:1], gen)
            torch.cuda.synchronize()
    assert graphed.sampled == 3
    ms = graphed.phase_ms()
    assert set(ms) == {*STEP, "msl.convnet.conv", "msl.convnet.norm_act", "msl.epoch.replay"}
    phases = sum(ms[name] for name in STEP)
    assert phases == pytest.approx(ms["msl.epoch.replay"], rel=0.05), ms
    assert ms["msl.convnet.conv"] + ms["msl.convnet.norm_act"] < ms["msl.step.forward"]
    assert min(ms.values()) > 0


class _Counted:
    def __init__(self):
        self.calls = []

    def wrap(self, name, fn):
        def counted(*args, **kwargs):
            self.calls.append(name)
            return fn(*args, **kwargs)
        return counted


def test_no_synchronising_call_without_a_profiler(monkeypatch):
    _need_card()
    epoch, state = _epoch(CONVNET)
    data = _dataset(16, 32)
    idx = torch.arange(16, device="cuda").view(2, 8)
    gen = torch.Generator(device="cuda").manual_seed(5)
    state, _ = epoch(state, data, idx, gen)  # the capture
    torch.cuda.synchronize()
    counted = _Counted()
    monkeypatch.setattr(torch.cuda, "synchronize",
                        counted.wrap("synchronize", torch.cuda.synchronize))
    for cls in (torch.cuda.Event, torch.cuda.Stream):
        for method in ("synchronize", "query", "elapsed_time", "wait_event", "wait_stream"):
            if hasattr(cls, method):
                monkeypatch.setattr(cls, method, counted.wrap(method, getattr(cls, method)))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, _ = epoch(state, data, idx, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert counted.calls == []
    assert epoch.graphed.sampled == 0
