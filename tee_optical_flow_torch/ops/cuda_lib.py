"""Build, load and call the port's CUDA kernels (``csrc/tvl1.cu``).

The source is compiled at first use with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/kernels/`` at the root of the checkout (a
directory git ignores), named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.

Parity flags: ``--fmad=false`` keeps every multiply and add separately
rounded, as the plain PyTorch versions and the JAX reference compute them
(a fused multiply-add would break one-step parity), and no
``--use_fast_math``, so ``sqrtf`` and division stay IEEE-exact. The TV-L1
dual update keeps its division form on purpose (ops/tvl1_pallas.py:121-123
in the JAX package): ulp differences grow over the ~7500 iterated steps.

Nothing here runs at import: the CPU tests import every module of the
port on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tvl1.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "tvl1_median5x5": (_P, _P, _I, _I, _I, _P, _F, _P),
    "tvl1_primal": (_P,) * 11 + (_I, _I, _I, _F, _F, _P, _F, _P, _P),
    "tvl1_err_reduce": (_P, _I, _P, _P, _F, _I, _P),
    "tvl1_dual": (_P,) * 6 + (_I, _I, _I, _F, _P, _P),
    "tvl1_num_blocks": (_I, _I),
}

_lib: Optional[ctypes.CDLL] = None
# filled by the first load: the build's wall time (0 when reused) and
# nvcc's resource report (-Xptxas -v: registers, spills per kernel)
build_info = {"seconds": None, "ptxas": "", "path": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _build() -> Path:
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libtvl1_{key}.so"
    if out.exists():
        build_info["seconds"] = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    build_info["seconds"] = time.perf_counter() - t0
    build_info["ptxas"] = proc.stderr
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        path = _build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.tvl1_error_string.argtypes = [ctypes.c_int]
        lib.tvl1_error_string.restype = ctypes.c_char_p
        build_info["path"] = str(path)
        _lib = lib
    return _lib


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device pointer of a tensor for ctypes (None -> NULL)."""
    return None if t is None else t.data_ptr()


@contextlib.contextmanager
def launch_context(device: torch.device):
    """Make ``device`` current and yield its current stream's handle, on
    which every kernel launches (no synchronisation)."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        msg = load_library().tvl1_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
