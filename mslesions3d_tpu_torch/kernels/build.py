"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by nvcc
for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so`` at the root
of the checkout, then loaded with ctypes. The hash covers the source and the
flags, so an edited source builds anew. nvcc is found under ``$CUDA_HOME`` or
``/usr/local/cuda``. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

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
def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` if needed; returns (library path, nvcc's log)."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log = lib.with_suffix(".log")
    if not lib.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [str(find_nvcc()), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib, log.read_text() if log.is_file() else ""


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)[0]))
