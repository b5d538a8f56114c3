"""The train step's phase markers and the ConvNet block's, on the CPU.

* ``utils.profiling.phases`` is one shared null object while no profiler
  records and no capture marks: an eager step then records no event and
  opens no range, and computes what a profiled step computes, bit for bit;
* under a profiler the eager step opens ``msl.step.forward``,
  ``msl.step.backward`` and ``msl.step.update`` one after another inside
  ``msl.epoch`` (forward and backward once a micro-batch), and each ConvNet
  block ``msl.convnet.conv`` then ``msl.convnet.norm_act`` inside the
  forward; none of them is a user annotation;
* under ``marking`` (a CUDA graph's capture; here with stand-in events)
  each boundary is one event, the end of a phase and the start of the next,
  and the phases land in the list as they end; the list is let go after the
  block, also when it raises;
* ``GraphedEpoch`` adds a replay's elapsed times to its counters only where
  a replay ran and its last event is done, and ``phase_ms`` gives the ms a
  sampled step;
* the benchmark's readers of the markers (``perfbench/metrics``) read
  ``phase_ms`` of the cell's program, and nothing from a program without
  it; ``mfu.train_convnet`` counts 3 x 33.01 GFLOP a volume.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.train import create_train_state, make_gathered_train_epoch
from mslesions3d_tpu_torch.train.graphs import GraphedEpoch, _Capture
from mslesions3d_tpu_torch.utils import profiling
from mslesions3d_tpu_torch.utils.profiling import marking, phases
from perfbench.lib import harness

SMALL = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=1e-3,
             threshold=(0.1, 0.2))
CONVNET = dict(base_network_config="convnet_maxpool_double", convnet_dropout=0.1,
               aspect_ratios={6: [1.0], 9: [1.0]})
STEP = ("msl.step.forward", "msl.step.backward", "msl.step.update")
BLOCK = ("msl.convnet.conv", "msl.convnet.norm_act")


def _data(n=4):
    rng = np.random.default_rng(0)
    return {"image": torch.from_numpy(rng.normal(size=(n, 16, 16, 16, 1)).astype(np.float32)),
            "boxes": torch.tensor([[[0.2, 0.2, 0.2, 0.6, 0.6, 0.6]]] * n),
            "labels": torch.ones((n, 1), dtype=torch.int32),
            "box_mask": torch.ones((n, 1), dtype=torch.bool)}


def _epoch(extra=None, **options):
    cfg = SSD3DConfig.create(**SMALL, **(extra or {}))
    epoch = make_gathered_train_epoch(cfg, SSD3D(cfg), model_priors(cfg), **options)
    return epoch, create_train_state(cfg, seed=1, device="cpu")


def _msl(prof) -> list:
    return sorted((e for e in prof.events() if e.name.startswith("msl.")),
                  key=lambda e: (e.time_range.start, -e.time_range.end))


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_phases_are_the_shared_null_object_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert phases("msl.a") is phases("msl.b")
    with phases("msl.a") as phase:
        phase.next("msl.b")


@pytest.mark.parametrize("extra, options, micro", [
    (None, {}, 1), (None, {"grad_accum": 2}, 2), (CONVNET, {}, 1), (CONVNET, {"grad_accum": 2}, 2),
], ids=["mobilenet", "mobilenet_grad_accum", "convnet", "convnet_grad_accum"])
def test_eager_spans_nest_as_stated(extra, options, micro):
    epoch, state = _epoch(extra, **options)
    idx = torch.tensor([[0, 1], [2, 3]])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        epoch(state, _data(), idx, torch.Generator().manual_seed(2))
    events = _msl(prof)
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation for e in events)
    (whole,) = [e for e in events if e.name == "msl.epoch"]
    steps = [e for e in events if e.name in STEP]
    per_step = [*STEP[:2]] * micro + [STEP[2]]
    assert [e.name for e in steps] == per_step * len(idx)
    assert all(_inside(e, whole) for e in steps)
    for a, b in zip(steps, steps[1:]):  # one after another
        assert a.time_range.end <= b.time_range.start
    blocks = [e for e in events if e.name in BLOCK]
    if extra is None:
        assert blocks == []
        return
    assert [e.name for e in blocks] == [*BLOCK] * 7 * micro * len(idx)  # 7 conv blocks a forward
    forwards = [e for e in steps if e.name == "msl.step.forward"]
    assert all(any(_inside(b, f) for f in forwards) for b in blocks)
    for conv, norm_act in zip(blocks[::2], blocks[1::2]):
        assert conv.time_range.end <= norm_act.time_range.start


def test_without_a_profiler_the_step_records_nothing(monkeypatch):
    """No event, no range, no phase object: the markers' classes and torch's
    event and range raise if touched. The step computes what it computes
    under a profiler, bit for bit."""
    epoch, state = _epoch(CONVNET)
    idx = torch.tensor([[0, 1], [2, 3]])
    with profile(activities=[ProfilerActivity.CPU]):
        traced = epoch(state, _data(), idx, torch.Generator().manual_seed(2))

    def touched(*args, **kwargs):
        raise AssertionError("a marker ran with no profiler recording")

    monkeypatch.setattr(profiling, "_Phases", touched)
    monkeypatch.setattr(profiling, "_recorded_event", touched)
    monkeypatch.setattr(torch.cuda, "Event", touched)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", touched)
    plain = epoch(state, _data(), idx, torch.Generator().manual_seed(2))
    for key, value in traced[1].items():
        assert torch.equal(value, plain[1][key]), key
    for name, p in traced[0].params.items():
        assert torch.equal(p, plain[0].params[name]), name


class _FakeEvent:
    """A stand-in for a timing event: its time is its order of recording."""

    recorded = 0

    def __init__(self, done=True):
        _FakeEvent.recorded += 1
        self.at, self.done = float(_FakeEvent.recorded), done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.at - self.at


def test_marking_records_one_event_a_boundary(monkeypatch):
    monkeypatch.setattr(profiling, "_recorded_event", _FakeEvent)
    marks = []
    with marking(marks), phases("msl.whole"):
        with phases("msl.a") as phase:
            phase.next("msl.b")
            phase.next("msl.c")
        with phases("msl.d"):
            pass
    assert [m[0] for m in marks] == ["msl.a", "msl.b", "msl.c", "msl.d", "msl.whole"]
    (a, b, c, d, whole) = marks
    assert a[2] is b[1] and b[2] is c[1]  # a boundary is one event
    assert [round(m[1].elapsed_time(m[2])) for m in marks] == [1, 1, 1, 1, 7]
    assert phases("msl.e") is phases("msl.f")  # let go after the block
    with pytest.raises(RuntimeError):
        with marking([]):
            raise RuntimeError("a capture that fails")
    assert phases("msl.e") is phases("msl.f")


def _capture(marks, replayed=True):
    return _Capture(key=(), generator=None, graph=None, state=None, idx=None, metrics=None,
                    marks=marks, replayed=replayed)


def test_graphed_epoch_samples_only_ended_replays():
    graphed = GraphedEpoch(step=None)
    e = [_FakeEvent() for _ in range(4)]
    marks = [("msl.step.forward", e[0], e[1]), ("msl.step.backward", e[1], e[2]),
             ("msl.epoch.replay", e[0], e[3])]
    assert graphed.phase_ms() == {}
    graphed._sample(_capture(marks, replayed=False))  # no replay yet
    assert graphed.sampled == 0
    graphed._sample(_capture(marks[:2] + [("msl.epoch.replay", e[0], _FakeEvent(done=False))]))
    assert graphed.sampled == 0  # the replay has not ended
    graphed._sample(_capture(marks))
    graphed._sample(_capture(marks))
    assert graphed.sampled == 2
    assert graphed.marked_ms == {"msl.step.forward": 2.0, "msl.step.backward": 2.0,
                                 "msl.epoch.replay": 6.0}
    assert graphed.phase_ms() == {"msl.step.forward": 1.0, "msl.step.backward": 1.0,
                                  "msl.epoch.replay": 3.0}


MARKED = {"train.forward_ms.convnet": "msl.step.forward",
          "train.backward_ms.convnet": "msl.step.backward",
          "train.update_ms.convnet": "msl.step.update",
          "convnet.norm_act_ms.train": "msl.convnet.norm_act",
          "train.dw_wgrad_ms.train": "msl.train.dw_wgrad"}


def _read(metric, ctx):
    path = harness.reader_path(metric)
    return harness.load_module(path, "test_reader_" + path.stem.replace(".", "_")).read(ctx)


@pytest.mark.parametrize("metric", list(MARKED))
def test_marker_readers(metric):
    ms = {name: 10.0 + i for i, name in enumerate(MARKED.values())}
    graphed = SimpleNamespace(phase_ms=lambda: ms)
    fn = SimpleNamespace(graphed=graphed)
    trace = SimpleNamespace(window_s=10.0)
    assert _read(metric, SimpleNamespace(trace=trace, run=SimpleNamespace(fn=fn))) == \
        ms[MARKED[metric]]
    # no trace; a program without the accessor (the markers' parent); no sample yet
    assert _read(metric, SimpleNamespace(trace=None, run=SimpleNamespace(fn=fn))) is None
    parent = SimpleNamespace(fn=SimpleNamespace(graphed=SimpleNamespace(captures=1)))
    assert _read(metric, SimpleNamespace(trace=trace, run=parent)) is None
    empty = SimpleNamespace(fn=SimpleNamespace(graphed=SimpleNamespace(phase_ms=dict)))
    assert _read(metric, SimpleNamespace(trace=trace, run=empty)) is None


def test_mfu_of_the_convnet_cell():
    cell = harness.make_cell("train64_convnet_b64_epoch", 1, 1.0, True)
    ctx = SimpleNamespace(trace=SimpleNamespace(window_s=10.0), run=SimpleNamespace(cfg=cell.model),
                          out={"attempted": 640})
    # 3 x 33.011 GFLOP x 640 volumes over 10 s x 67 TFLOP/s
    assert _read("mfu.train_convnet", ctx) == pytest.approx(9.4601, rel=1e-4)
    assert _read("mfu.train_convnet", SimpleNamespace(trace=None, run=ctx.run, out=ctx.out)) is None
