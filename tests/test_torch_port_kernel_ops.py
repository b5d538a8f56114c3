"""The seam from a CUDA kernel to the op the port calls (``kernels/build.py``).

Every ``msl::`` op is a ``torch.library.Library`` definition made through
``define_op``. Its schema is what exported bundles were saved against, so
it is pinned here. Calling the ops must not import ``torch._dynamo``, which
a ``torch.library.custom_op`` does at its first call. ``launch`` checks a
kernel's return code; a stub library built with g++ stands in for a kernel
here, where there is no card.
"""

import contextlib
import ctypes
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest
import torch

from mslesions3d_tpu_torch.kernels import build as kernels_build
from mslesions3d_tpu_torch.kernels.build import alignment, build_library, launch, load_library
# each import defines its module's ops
from mslesions3d_tpu_torch.kernels import depthwise, dw_wgrad, nms, qconv, tail  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

# the schemas that exported bundles were saved against
SCHEMAS = {
    "greedy_nms": "msl::greedy_nms(Tensor boxes, Tensor valid, float max_overlap, str walk, "
                  "SymInt stages) -> Tensor",
    "fused_depthwise_bn_relu": "msl::fused_depthwise_bn_relu(Tensor x, Tensor weights, "
                               "Tensor gamma, Tensor beta, SymInt[] tile) -> Tensor",
    "fused_tail": "msl::fused_tail(Tensor x, Tensor[] weights, SymInt[] strides, "
                  "SymInt[] emit) -> Tensor[]",
    "depthwise_wgrad": "msl::depthwise_wgrad(Tensor x, Tensor gz, Tensor(a!) grad_w, "
                       "int[] stride, int[] padding, int[] tile) -> ()",
    "qconv": "msl::qconv(Tensor q, Tensor wq, Tensor scale, Tensor bias, SymInt[] stride, "
             "SymInt groups, bool relu) -> Tensor",
    "qconv_codes": "msl::qconv_codes(Tensor x, Tensor wq, Tensor scale, Tensor bias, "
                   "SymInt[] stride, SymInt groups, bool relu, Tensor sx_out, "
                   "Tensor? sx_in) -> Tensor",
    "qconv_heads": "msl::qconv_heads(Tensor q, Tensor wq, Tensor scale, Tensor bias, "
                   "SymInt split) -> (Tensor, Tensor)",
}


@pytest.mark.parametrize("op", sorted(SCHEMAS))
def test_op_schema_is_the_one_bundles_were_saved_against(op):
    assert str(getattr(torch.ops.msl, op).default._schema) == SCHEMAS[op]


# Each op once on CPU tensors, in a fresh process.
CALL_EVERY_OP = textwrap.dedent("""
    import sys

    import torch

    import mslesions3d_tpu_torch.quant
    import mslesions3d_tpu_torch.serving
    import mslesions3d_tpu_torch.train
    from mslesions3d_tpu_torch.kernels import depthwise, dw_wgrad, nms, qconv, tail

    g = torch.Generator().manual_seed(0)
    lo = torch.rand(2, 8, 3, generator=g)
    boxes = torch.cat([lo, lo + 0.3], -1)
    keep = torch.ops.msl.greedy_nms(boxes, torch.ones(2, 8, dtype=torch.bool), 0.5, "", -1)
    x = torch.randn(1, 4, 3, 3, 3, generator=g).to(memory_format=torch.channels_last_3d)
    y = torch.ops.msl.fused_depthwise_bn_relu(x, torch.randn(3, 3, 3, 4, generator=g),
                                              torch.ones(4), torch.zeros(4), [])
    layer = [torch.randn(3, 3, 3, 4, generator=g), torch.ones(4), torch.zeros(4),
             torch.randn(4, 6, generator=g), torch.ones(6), torch.zeros(6)]
    maps = torch.ops.msl.fused_tail(x, layer, [2], [0])
    grad_w = torch.zeros(4, 1, 3, 3, 3)
    torch.ops.msl.depthwise_wgrad(x, y, grad_w, [1, 1, 1], [1, 1, 1], [])
    q = torch.randint(-127, 128, (1, 3, 3, 3, 4), dtype=torch.int8, generator=g)
    wq = torch.randint(-127, 128, (3, 3, 3, 4, 6), dtype=torch.int8, generator=g)
    scale, bias = torch.full((6,), 1e-3), torch.zeros(6)
    f = torch.ops.msl.qconv(q, wq, scale, bias, [1, 1, 1], 1, True)
    codes = torch.ops.msl.qconv_codes(q, wq, scale, bias, [2, 2, 2], 1, True,
                                      torch.tensor([0.01]), None)
    loc, cls = torch.ops.msl.qconv_heads(q, wq, scale, bias, 2)
    assert keep.shape == (2, 8) and y.shape == x.shape and maps[0].shape == (1, 6, 2, 2, 2)
    assert bool(grad_w.abs().sum() > 0) and f.shape == (1, 3, 3, 3, 6)
    assert codes.shape == (1, 1, 2, 2, 2, 6) and (loc.shape[-1], cls.shape[-1]) == (2, 4)
    print("torch._dynamo" in sys.modules)
""")


def test_every_op_on_cpu_leaves_dynamo_unimported():
    """A custom_op imports torch._dynamo at its first call (seconds of
    set-up); a Library definition does not."""
    proc = subprocess.run([sys.executable, "-c", CALL_EVERY_OP], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False"], proc.stdout


def test_greedy_nms_output_never_aliases_its_input():
    """With nothing suppressed the plain NMS returns ``valid`` itself; the
    op returns a copy."""
    boxes = torch.tensor([[[0, 0, 0, 1, 1, 1], [2, 2, 2, 3, 3, 3]]], dtype=torch.float32)
    valid = torch.ones(1, 2, dtype=torch.bool)
    keep = torch.ops.msl.greedy_nms(boxes, valid, 0.5, "", -1)
    assert torch.equal(keep, valid) and keep.data_ptr() != valid.data_ptr()


STUB = """
extern "C" const char* msl_cuda_error_string(int err) {
    return err == 3 ? "stub error 3" : "other";
}
extern "C" int msl_stub(int code, long long value, long long* seen, void* stream) {
    seen[0] = value;
    seen[1] = (long long)stream;
    return code;
}
"""


@pytest.fixture
def stub_library(tmp_path, monkeypatch):
    """``load_library("stub")`` on a g++-built stand-in for a kernel, with a
    CUDA device context and stream that need no card."""
    src = tmp_path / "stub.cc"
    src.write_text(STUB)
    path, _ = build_library(src, "g++", ("-O1", "-shared", "-fPIC"), tmp_path / "out")
    monkeypatch.setattr(kernels_build, "build", lambda name: (path, ""))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(
        cuda_stream=4096))
    load_library.cache_clear()
    yield load_library("stub", msl_stub=((ctypes.c_int, ctypes.c_longlong,
                                          ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p),
                                         ctypes.c_int))
    load_library.cache_clear()


@pytest.mark.parametrize("code", [0, 3, 7])
def test_launch_passes_the_stream_last_and_checks_the_code(stub_library, code):
    seen = (ctypes.c_longlong * 2)()
    call = (lambda: launch("stub_cuda", stub_library, "msl_stub", torch.device("cuda", 0), code,
                           2 ** 40, seen))
    if code == 0:
        call()
    else:
        reason = "stub error 3" if code == 3 else "other"
        with pytest.raises(RuntimeError, match=f"^stub_cuda: launch failed: {reason}$"):
            call()
    assert list(seen) == [2 ** 40, 4096]


@pytest.mark.parametrize("offset, want", [(0, 16), (1, 1), (2, 2), (4, 4), (8, 8), (12, 4)])
def test_alignment_is_the_largest_power_of_two_up_to_16(offset, want):
    base = torch.empty(64, dtype=torch.uint8)
    base = base[(-base.data_ptr()) % 16:]  # now on 16 bytes
    assert alignment(base[offset:]) == want
    assert alignment(base, base[offset:]) == want
    assert alignment(base[offset:], torch.empty(0)) == want  # an empty tensor's null pointer
