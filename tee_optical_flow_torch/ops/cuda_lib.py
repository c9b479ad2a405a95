"""Build, load and call the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc -c`` per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``: ``csrc/tvl1.cu`` (K1, the block loop with K2 and the median),
``csrc/deepflow.cu`` (K3), ``csrc/labelling.cu`` (the masks' labelling),
``csrc/relpos_attention.cu`` (ViT-Det's attention) and
``csrc/layer_norm.cu`` (ViT-Det's residual add, norm and cast). The
library lands in ``build/kernels/`` at the root of the checkout (a
directory git ignores), named by a hash of the sources and the flags, so
an edited source is rebuilt and unchanged ones are reused. A variant with
``-D`` overrides of a source's compile-time settings
(``load_library(defines)``) is built beside it under its own name; only
measurements and tests ask for one.

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
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# the C functions' argument types; each returns an int, the launch's
# cudaGetLastError (decoded by tvl1_error_string), but tee_device_launches,
# which returns the library's launch count as a long long
_SIGNATURES = {
    "tee_device_launches": (_I,),
    "tvl1_median5x5": (_P, _P, _I, _I, _I, _P),
    "tvl1_outer_loop": (_P,) * 14 + (_I,) * 7 + (_F,) * 4 + (_P,),
    "tvl1_num_tiles": (_I, _I),
    "tvl1_block_loop": (_P,) * 14 + (_I,) * 7 + (_F,) * 4 + (_P,),
    "tvl1_block_sweeps": (_I,),
    "tvl1_block_tiles": (_I, _I),
    "deepflow_resident": (_I, _I, _P),
    "deepflow_solve": (_P,) * 16 + (_I,) * 5 + (_F,) * 6 + (_P,),
    "labelling_group": (_P,) * 4 + (_I,) * 6 + (_P,),
    "rel_pos_attention": (_P,) * 5 + (_I,) * 6 + (_L,) * 4 + (_F,)
    + (_I,) * 3 + (_P,),
    "residual_norm": (_P,) * 6 + (_I,) * 5 + (_F,) + (_P,),
}

# the loaded libraries, by their nvcc flags
_libs: Dict[Tuple[str, ...], ctypes.CDLL] = {}
# filled by the first load of the default library: the build's wall time
# (0 when reused), nvcc's resource report (-Xptxas -v: registers, spills
# per kernel) and the library's path
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


def _build(flags: Tuple[str, ...]) -> Tuple[Path, float, str]:
    """The library built with ``flags``: its path, the build's seconds (0
    when reused) and nvcc's resource report."""
    sources = sorted(CSRC.glob("*.cu"))
    key = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        key.update(src.name.encode() + src.read_bytes())
    out = BUILD_DIR / f"libtee_kernels_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0, ""
    # a directory of this process's own: a concurrent build never sees
    # half a file, and the finished library is moved in atomically
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [tmp / f"{src.stem}.o" for src in sources]
    procs = [subprocess.Popen(
        [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(obj),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[1] for proc in procs]
    failed = [f"nvcc failed on {src}:\n{log}" for src, proc, log
              in zip(sources, procs, logs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run(
            [_nvcc(), *flags, "-shared", "-o", str(tmp / out.name),
             *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"nvcc failed to link {out.name}:\n{link.stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp / out.name, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return out, time.perf_counter() - t0, "".join(logs)


def load_library(defines: Optional[Dict[str, int]] = None) -> ctypes.CDLL:
    """The kernel library, built on first call; with ``defines`` (name ->
    value, passed to nvcc as -D), a variant of it."""
    flags = NVCC_FLAGS + tuple(f"-D{k}={v}"
                               for k, v in sorted((defines or {}).items()))
    if flags not in _libs:
        path, seconds, ptxas = _build(flags)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.tee_device_launches.restype = ctypes.c_longlong
        lib.tvl1_error_string.argtypes = [ctypes.c_int]
        lib.tvl1_error_string.restype = ctypes.c_char_p
        if not defines:
            build_info.update(seconds=seconds, ptxas=ptxas, path=str(path))
        _libs[flags] = lib
    return _libs[flags]


def device_launch_count(lib: Optional[ctypes.CDLL] = None,
                        reset: bool = False) -> int:
    """The device launches that the C entries of ``lib`` (the kernel
    library by default) issued successfully since the count was last
    reset; ``reset`` starts it again from 0. Each C entry counts a launch
    once the launch call returned cudaSuccess, so the count holds whatever
    a profiler's trace loses."""
    return int((lib or load_library()).tee_device_launches(int(reset)))


def check_inputs(name: str, tensors) -> None:
    """Raise ValueError unless every tensor is a contiguous float32
    (B, H, W) tensor of the first one's shape and device: what the
    kernels' flat indexing assumes."""
    ref = tensors[0]
    if ref.ndim != 3:
        raise ValueError(f"{name}: expected (B, H, W) tensors, got "
                         f"{tuple(ref.shape)}")
    for t in tensors:
        if t.device != ref.device or t.dtype != torch.float32 \
                or t.shape != ref.shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: every input must be a contiguous float32 "
                f"{tuple(ref.shape)} tensor on {ref.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


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
