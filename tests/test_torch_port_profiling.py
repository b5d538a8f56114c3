"""The port's ``utils/profiling.py`` and ``utils/cache.py`` on the CPU, against
the JAX package's ``utils/profiling.py`` and ``utils/cache.py``.

* ``time_fn`` calls the function as the JAX one does (a first call, the
  warm-up, the timed calls) and returns a positive ms a call;
* ``StepTimer`` gives the JAX one's summary, key for key, on the same clock;
* ``trace`` writes a ``torch.profiler`` trace into its directory;
* ``device_busy_ms`` takes the union of the kernels' intervals, and the
  device-clock helpers raise where the profiler sees no kernel (here, with
  no card) rather than report zero;
* the build cache (the JAX package's persistent compile cache, keyed by the
  runtime; here ``kernels.build.build_library``): a library's name hashes the
  compiler's ``--version``, so another version builds anew.
"""

import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.autograd import DeviceType

from mslesions3d_tpu.utils import profiling as jax_profiling
from mslesions3d_tpu_torch.kernels import build as kernels_build
from mslesions3d_tpu_torch.native import native
from mslesions3d_tpu_torch.utils import cache, profiling


class Counted:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def test_time_fn_calls_as_jax():
    ours = Counted(lambda x: x * 2.0)
    theirs = Counted(jax.jit(lambda x: x * 2.0))
    ms = profiling.time_fn(ours, (torch.ones(64),), iters=7, warmup=2)
    jax_ms = jax_profiling.time_fn(theirs, (jnp.ones(64),), iters=7, warmup=2)
    assert ours.calls == theirs.calls == 1 + 2 + 7
    assert ms > 0 and jax_ms > 0
    assert profiling.block({"a": [torch.ones(2)], "b": (1, "x")})["a"][0].sum() == 2


def test_step_timer_equals_jax(monkeypatch):
    clock = iter([0.0, 0.5, 0.75, 2.0, 2.1, 2.2] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    ours, theirs = profiling.StepTimer(window=4), jax_profiling.StepTimer(window=4)
    assert ours.summary() == theirs.summary() == {}
    for timer in (ours, theirs):
        for _ in range(6):
            timer.tick()
    assert ours.summary() == pytest.approx(theirs.summary())
    assert set(ours.summary()) == {"step_time_mean_s", "step_time_p50_s", "step_time_max_s"}
    assert ours.times == pytest.approx([0.25, 1.25, 0.1, 0.1])  # the window keeps the last 4


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(tmp_path / "tb"):
        torch.ones(128).cumsum(0)
    files = list((tmp_path / "tb").rglob("*.json*"))
    assert files and files[0].stat().st_size > 0


def _event(start, end):
    return SimpleNamespace(device_type=DeviceType.CUDA, time_range=SimpleNamespace(
        start=start, end=end))


def test_device_busy_ms_is_the_union():
    prof = SimpleNamespace(events=lambda: [
        _event(0, 1000), _event(500, 1500), _event(3000, 3500),
        SimpleNamespace(device_type=DeviceType.CPU, time_range=SimpleNamespace(start=0,
                                                                                end=9000))])
    busy, span = profiling.device_busy_ms(prof)
    assert (busy, span) == (2.0, 3.5)  # [0, 1.5] and [3, 3.5] ms of [0, 3.5]
    with pytest.raises(RuntimeError, match="saw no kernel"):
        profiling.device_busy_ms(SimpleNamespace(events=lambda: []))


def test_device_clock_raises_without_a_kernel(monkeypatch):
    """A trace of CPU work holds no kernel: traced again with twice the
    calls, up to ``tries`` traces, then an error."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    said, calls = [], Counted(lambda: torch.ones(8) + 1)
    with pytest.raises(RuntimeError, match="saw no kernel on the card in 3 traces"):
        profiling.device_ms(calls, iters=2, log=said.append, tries=3)
    assert said == [f"the profiler kept 0 kernel records of {n} calls; tracing once more "
                    f"with {2 * n} calls" for n in (2, 4)]
    assert calls.calls == (1 + 2) + (1 + 4) + (1 + 8)  # a warm call before each trace
    assert profiling.kernel_name(
        "void (anonymous namespace)::fused_tail_cluster<8>(float const*, int)") == \
        "fused_tail_cluster<8>"


def test_build_cache_keys_the_compiler_version(tmp_path, monkeypatch):
    """Another ``g++ --version`` is another library: an upgraded toolkit
    builds anew rather than load the old one (the JAX cache's lesson)."""
    assert "kernels/build.py" in cache.__doc__
    first, _ = kernels_build.build_library(native.SOURCE, "g++", native.GXX_FLAGS, tmp_path,
                                           native.LIBS)
    again, _ = kernels_build.build_library(native.SOURCE, "g++", native.GXX_FLAGS, tmp_path,
                                           native.LIBS)
    assert again == first
    version = kernels_build.compiler_version("g++")
    monkeypatch.setattr(kernels_build, "compiler_version", lambda c: version + " upgraded")
    upgraded, _ = kernels_build.build_library(native.SOURCE, "g++", native.GXX_FLAGS, tmp_path,
                                              native.LIBS)
    assert upgraded != first and upgraded.is_file() and first.is_file()
