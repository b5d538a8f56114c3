"""Build the port's native sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by nvcc
for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so`` at the root
of the checkout, then loaded with ctypes; ``native/nifti_loader.cc`` (the
host NIfTI loader) is compiled by g++ the same way into ``build/native/``
(:func:`build_library`). The hash covers the source, the flags and the
compiler's ``--version``, so an edited source or an upgraded toolkit builds
anew instead of loading a stale library. nvcc is found under ``$CUDA_HOME``
or ``/usr/local/cuda``. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

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
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)[0]))
