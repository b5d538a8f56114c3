"""Build the port's native sources into shared libraries at first use, and
turn a CUDA kernel's entry point into the ``msl::`` op the port calls.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by nvcc
for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so`` at the root
of the checkout, then loaded with ctypes; ``native/nifti_loader.cc`` (the
host NIfTI loader) is compiled by g++ the same way into ``build/native/``
(:func:`build_library`). The hash covers the source, the flags and the
compiler's ``--version``, so an edited source or an upgraded toolkit builds
anew instead of loading a stale library. nvcc is found under ``$CUDA_HOME``
or ``/usr/local/cuda``.

The seam from a kernel to its op, for every ``kernels/*.py``: the module
declares its entry points' ctypes signatures to :func:`load_library`, calls
them through :func:`launch` (the device's current stream, the return code
checked), and defines its op with :func:`define_op`. Nothing here builds or
loads at import; :func:`define_op` registers at the caller's import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
BUILD_DIR = BUILD_ROOT / "kernels"

# -fmad=false: no FMA contraction, so float32 arithmetic rounds as the
# plain torch versions do. -Xptxas -v reports registers, shared memory and
# spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> Path:
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    nvcc = home / "bin" / "nvcc"
    if not nvcc.is_file():
        raise RuntimeError(f"nvcc not found at {nvcc}; set CUDA_HOME to the CUDA toolkit")
    return nvcc


@functools.cache
def compiler_version(compiler: str) -> str:
    """What ``<compiler> --version`` prints (part of every library's hash)."""
    proc = subprocess.run([compiler, "--version"], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} --version failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout


def build_library(src: Path, compiler: str, flags, out_dir: Path,
                  libs=()) -> tuple[Path, str]:
    """Compile ``src`` with ``compiler`` and ``flags`` (linking ``libs``) into
    ``out_dir/lib<stem>-<hash>.so`` if it is not there yet; returns (library
    path, the compiler's log). The hash covers the source, the flags, the
    libraries and the compiler's version. The library is written under a
    temporary name and renamed, so a concurrent build never loads a partial
    file. A failed build raises with the compiler's output."""
    src = Path(src)
    key = src.read_bytes() + " ".join((*flags, *libs)).encode() + compiler_version(
        compiler).encode()
    lib = Path(out_dir) / f"lib{src.stem}-{hashlib.sha256(key).hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.is_file():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src), *libs],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed on {src}:\n{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, log.read_text() if log.is_file() else ""


@functools.cache
def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` if needed; returns (library path, nvcc's log)."""
    return build_library(CSRC_DIR / f"{name}.cu", str(find_nvcc()), NVCC_FLAGS, BUILD_DIR)


@functools.cache
def load_library(name: str, **entry_points: tuple) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached.

    ``entry_points`` maps each entry point's name to its (argtypes, restype),
    as tuples; ``msl_cuda_error_string``, which every source exports, is
    declared here.
    """
    lib = ctypes.CDLL(str(build(name)[0]))
    for entry, (argtypes, restype) in {
            **entry_points, "msl_cuda_error_string": ((ctypes.c_int,), ctypes.c_char_p)}.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def launch(what: str, lib: ctypes.CDLL, entry: str, device: torch.device, *args) -> None:
    """Call ``lib``'s ``entry`` with ``args`` and the current stream of
    ``device`` last, on that device, without synchronising. A non-zero
    return code raises, naming ``what`` and the CUDA error."""
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: launch failed: {lib.msl_cuda_error_string(err).decode()}")


def alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 that every tensor's data pointer is a multiple of."""
    return min(16, *(t.data_ptr() & -t.data_ptr() if t.data_ptr() else 16 for t in tensors))


# Every op is defined through torch.library.Library, not torch.library.custom_op:
# a custom_op's kernel runs under torch._disable_dynamo, whose first call
# imports torch._dynamo (~5 s of set-up on an H100 host), which neither
# serving nor training would otherwise import. A trace names the op all the same.
_MSL = torch.library.Library("msl", "FRAGMENT")


def define_op(schema: str, cpu, cuda, fake) -> None:
    """Define the op ``msl::<schema>``: ``cpu`` runs it on CPU tensors (the
    kernel's plain version), ``cuda`` on CUDA tensors (the launch) and
    ``fake`` gives its outputs' shapes to ``torch.export``. Neither ``cpu``
    nor ``cuda`` returns one of its inputs: an op's output never aliases its
    input."""
    name = schema[:schema.index("(")]
    _MSL.define(schema, tags=(torch.Tag.pt2_compliant_tag,))
    _MSL.impl(name, cpu, "CPU")
    _MSL.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"msl::{name}", fake, lib=_MSL)
