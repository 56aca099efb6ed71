"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/*.cu` file exposes a plain C interface and is compiled on first
use with `nvcc` for `sm_90a` into its own shared library, which is loaded
with `ctypes` (no PyTorch headers, so a build takes seconds). Libraries
land in `build/torch_kernels/` at the root of the checkout, named by a hash
of their source and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME): the CUDA kernels are built from "
        "source on the machine with the GPU"
    )


def build(name: str, extra_flags: Sequence[str] = ()) -> Path:
    """Compile `csrc/<name>.cu` into a shared library (if not built yet) and
    return its path."""
    src = CSRC / f"{name}.cu"
    flags = [*_ARCH, *_BASE_FLAGS, *extra_flags]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(name: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build if needed, then load `csrc/<name>.cu`'s library once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, extra_flags)))
            _libs[name] = lib
        return lib


def check(error_string, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its cudaGetLastError);
    `error_string` is the library's own cudaGetErrorString binding."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: {error_string(err).decode()}")
