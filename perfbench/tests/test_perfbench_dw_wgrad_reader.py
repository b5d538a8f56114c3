"""The reader of ``train.dw_wgrad_ms.train``: the device ms a sampled step
that ``GraphedEpoch.phase_ms()`` gives the marker ``msl.train.dw_wgrad``
(summed over the weight-gradient kernel's launches), and nothing from a
run without a trace, a program without the accessor, a program that has
sampled no step, or one whose step opens no such marker (a program without
the kernel: its other phases are there, this one is not)."""

from __future__ import annotations

from types import SimpleNamespace

from perfbench.lib import harness

METRIC = "train.dw_wgrad_ms.train"
TRACE = SimpleNamespace(window_s=10.0)


def _read(ctx):
    path = harness.reader_path(METRIC)
    assert path.name == "train.dw_wgrad_ms.py"
    return harness.load_module(path, "test_reader_dw_wgrad").read(ctx)


def _ctx(phase_ms=None, trace=TRACE, graphed=None):
    graphed = graphed or SimpleNamespace(phase_ms=lambda: phase_ms)
    return SimpleNamespace(trace=trace, run=SimpleNamespace(fn=SimpleNamespace(graphed=graphed)))


def test_reads_the_marker():
    ms = {"msl.step.forward": 12.0, "msl.step.backward": 30.0, "msl.train.dw_wgrad": 0.42}
    assert _read(_ctx(ms)) == 0.42


def test_reads_nothing_where_there_is_nothing_to_read():
    ms = {"msl.step.forward": 12.0, "msl.step.backward": 30.0}
    assert _read(_ctx(ms)) is None  # a step without the marker (the parent's program)
    assert _read(_ctx({**ms, "msl.train.dw_wgrad": 0.4}, trace=None)) is None  # no trace
    assert _read(_ctx(graphed=SimpleNamespace(captures=1))) is None  # no accessor
    assert _read(_ctx({})) is None  # no step sampled yet
    assert _read(SimpleNamespace(trace=TRACE, run=SimpleNamespace())) is None  # no program


def test_the_manifest_names_it_for_the_recipe_cell():
    entry = next(m for m in harness.benchmark()["per_layer"] if m["name"] == METRIC)
    assert entry["workloads"] == ["train64_b64_epoch"]
    assert entry["moves"] == "train_volumes_per_s" and entry["source"] == "program_counter"
