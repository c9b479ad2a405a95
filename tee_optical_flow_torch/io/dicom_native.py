"""ctypes bindings for the port's native dicomlite parser
(``csrc/dicomlite.cpp``, its own copy of the JAX package's decoder).

The accelerated host-side decode path (the role GDCM's C++ plays for the
reference). ``native_read`` returns (metadata dict, raw pixel array) or
None when the library is unavailable or the transfer syntax needs the
pure-Python/cv2 path in io/dicom.py.

The library is built at first use with ``g++ -O3 -fPIC -std=c++17
-shared`` into ``build/dicomlite/`` at the root of the checkout (a
directory git ignores), named by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one reused. Each process
builds in a temporary directory of its own and moves the finished library
in with ``os.replace``: processes that build at once never see half a
file. Where it cannot be built (no g++), reads take the pure-Python
parser, with a warning. A library without the JPEG-Lossless symbol keeps
its uncompressed and RLE paths; JPEG-Lossless frames then raise
DICOMReadError in io/dicom.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import struct
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dicomlite.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dicomlite"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None
_lib_failed = False
# filled by the first load: the build's wall time (0 when reused) and the
# library's path
build_info = {"seconds": None, "path": None}


class _DicomInfo(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int32), ("cols", ctypes.c_int32),
        ("frames", ctypes.c_int32), ("samples", ctypes.c_int32),
        ("bits", ctypes.c_int32), ("planar", ctypes.c_int32),
        ("pixel_spacing", ctypes.c_double), ("frame_rate", ctypes.c_double),
        ("heart_rate", ctypes.c_double),
        ("patient_id", ctypes.c_char * 64),
        ("photometric", ctypes.c_char * 20),
        ("transfer_syntax", ctypes.c_char * 64),
        ("n_rwaves", ctypes.c_int32),
        ("rwave_times", ctypes.c_double * 256),
        ("pixel_data_offset", ctypes.c_int64),
        ("pixel_data_size", ctypes.c_int64),
        ("encapsulated", ctypes.c_int32),
    ]


_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
# the library's C functions: argument types and return type
_SIGNATURES = {
    "dicom_parse": ([ctypes.c_char_p, ctypes.POINTER(_DicomInfo)],
                    ctypes.c_int),
    "dicom_read_pixels": ([ctypes.c_char_p, _U8P, ctypes.c_int64],
                          ctypes.c_int64),
    "dicom_rle_decode": ([ctypes.c_char_p, ctypes.c_int64, _U8P,
                          ctypes.c_int64, _I32P], ctypes.c_int64),
}
_JPEGLL = "dicom_jpegll_decode"
_JPEGLL_SIGNATURE = ([ctypes.c_char_p, ctypes.c_int64,
                      ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64, _I32P],
                     ctypes.c_int64)


def _build() -> Tuple[Path, float]:
    """The library built from SOURCE: its path and the build's seconds (0
    when reused)."""
    key = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f"libdicomlite_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f"{out.stem}.", dir=BUILD_DIR))
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp / out.name), str(SOURCE)],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp / out.name, out)
        return out, time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _open(path) -> ctypes.CDLL:
    """The library at ``path`` with its functions' types declared. One
    without the JPEG-Lossless decoder keeps its other paths."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    if hasattr(lib, _JPEGLL):
        fn = getattr(lib, _JPEGLL)
        fn.argtypes, fn.restype = _JPEGLL_SIGNATURE
    else:
        logger.warning("%s lacks %s: JPEG-Lossless decode is disabled, the "
                       "uncompressed and RLE paths are kept", path, _JPEGLL)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        path, seconds = _build()
        _lib = _open(path)
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        logger.warning("native dicomlite unavailable (%s); using the "
                       "pure-Python parser", exc)
        _lib_failed = True
        return None
    build_info.update(seconds=seconds, path=str(path))
    return _lib


def native_available() -> bool:
    return _load() is not None


_RLE_UID = "1.2.840.10008.1.2.5"
_JPEGLL_UID = "1.2.840.10008.1.2.4.70"


def jpegll_decode_frame(payload: bytes) -> Optional[np.ndarray]:
    """Decode one JPEG-Lossless (process 14) frame payload with the C++
    decoder (csrc/dicomlite.cpp dicom_jpegll_decode). Returns (H, W) or
    (H, W, S) uint8/uint16, or None if the native library or its decoder
    is unavailable or the stream is not a decodable lossless JPEG."""
    lib = _load()
    if lib is None or not hasattr(lib, _JPEGLL):
        return None
    # retry-on-capacity keeps the ABI simple (one frame is a few MB)
    cap = max(len(payload) * 4, 1 << 20)
    for _ in range(4):
        out = np.empty(cap, np.uint16)
        info = (ctypes.c_int32 * 4)()
        got = lib.dicom_jpegll_decode(
            payload, len(payload),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size,
            info)
        if got == -4:  # DICOM_E_CAPACITY
            cap *= 8
            continue
        if got <= 0:
            return None
        rows, cols, ncomp, precision = (int(info[i]) for i in range(4))
        arr = out[:got].reshape(rows, cols, ncomp)
        if ncomp == 1:
            arr = arr[..., 0]
        return arr.astype(np.uint8) if precision <= 8 else arr.copy()
    return None


def _encapsulated_payloads(path: str, info: "_DicomInfo"):
    """Yield the frame payloads of an encapsulated pixel-data stream
    (Python walks a few 8-byte item headers; decode stays in C++).
    Yields None once on malformed streams."""
    with open(path, "rb") as f:
        f.seek(int(info.pixel_data_offset))
        data = f.read(int(info.pixel_data_size))
    pos = 0
    first = True
    while pos + 8 <= len(data):
        group, elem, ilen = struct.unpack_from("<HHI", data, pos)
        pos += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            break
        if (group, elem) != (0xFFFE, 0xE000):
            yield None
            return
        payload = data[pos:pos + ilen]
        pos += ilen
        if first:
            first = False
            continue  # basic offset table (possibly empty)
        yield payload


def _decode_rle_stream(path: str, info: "_DicomInfo",
                       lib) -> Optional[np.ndarray]:
    rows, cols = int(info.rows), int(info.cols)
    samples = max(int(info.samples), 1)
    frame_bytes = rows * cols * samples
    frames = []
    segcounts = (ctypes.c_int32 * 16)()
    for payload in _encapsulated_payloads(path, info):
        if payload is None:
            return None
        out = np.empty(frame_bytes, np.uint8)
        got = lib.dicom_rle_decode(
            payload, len(payload),
            out.ctypes.data_as(_U8P), out.size, segcounts)
        if got != frame_bytes:
            return None
        if samples > 1:
            frames.append(out.reshape(samples, rows, cols).transpose(1, 2, 0))
        else:
            frames.append(out.reshape(rows, cols))
    if not frames:
        return None
    return np.stack(frames)


def _decode_jpegll_stream(path: str,
                          info: "_DicomInfo") -> Optional[np.ndarray]:
    from .dicom import group_jpeg_fragments

    rows, cols = int(info.rows), int(info.cols)
    samples = max(int(info.samples), 1)
    payloads = []
    for payload in _encapsulated_payloads(path, info):
        if payload is None:
            return None
        payloads.append(bytes(payload))
    frames = []
    for payload in group_jpeg_fragments(payloads, max(int(info.frames), 1)):
        arr = jpegll_decode_frame(payload)
        if arr is None:
            return None
        shape = (rows, cols) if samples == 1 else (rows, cols, samples)
        if arr.shape != shape:
            return None
        frames.append(arr)
    if not frames:
        return None
    return np.stack(frames)


def native_read(path: str) -> Optional[Tuple[dict, np.ndarray]]:
    """Parse + decode with the native library. Returns None on any
    condition the Python path should handle instead."""
    lib = _load()
    if lib is None:
        return None
    info = _DicomInfo()
    rc = lib.dicom_parse(path.encode(), ctypes.byref(info))
    if rc != 0 or info.pixel_data_size <= 0:
        return None
    if info.bits not in (8, 16) or info.rows <= 0 or info.cols <= 0:
        return None
    if info.encapsulated:
        # RLE rides the native packbits decoder and JPEG-Lossless the
        # native process-14 decoder; other encapsulated syntaxes
        # (baseline/extended JPEG) take the cv2 path of io/dicom
        ts = info.transfer_syntax.decode(errors="replace").strip("\x00 ")
        if ts == _RLE_UID and info.bits == 8:
            arr = _decode_rle_stream(path, info, lib)
        elif ts == _JPEGLL_UID:
            arr = _decode_jpegll_stream(path, info)
        else:
            return None
        if arr is None:
            return None
        return _build_meta(info), np.ascontiguousarray(arr)

    buf = np.empty(int(info.pixel_data_size), np.uint8)
    got = lib.dicom_read_pixels(path.encode(), buf.ctypes.data_as(_U8P),
                                buf.size)
    if got <= 0:
        return None

    dtype = np.uint16 if info.bits == 16 else np.uint8
    arr = buf.view(dtype)
    frames = max(int(info.frames), 1)
    expected = frames * info.rows * info.cols * info.samples
    if arr.size < expected:
        return None
    arr = arr[:expected]
    if info.samples > 1:
        if info.planar == 1:
            arr = arr.reshape(frames, info.samples, info.rows, info.cols)
            arr = arr.transpose(0, 2, 3, 1)
        else:
            arr = arr.reshape(frames, info.rows, info.cols, info.samples)
    else:
        arr = arr.reshape(frames, info.rows, info.cols)

    return _build_meta(info), np.ascontiguousarray(arr)


def _build_meta(info: "_DicomInfo") -> dict:
    return {
        "pixel_spacing": (info.pixel_spacing if info.pixel_spacing >= 0
                          else None),
        "frame_rate": info.frame_rate if info.frame_rate >= 0 else None,
        "R_times": (np.asarray(info.rwave_times[:info.n_rwaves])
                    if info.n_rwaves > 0 else None),
        "R_wave_data_present": info.n_rwaves > 0,
        "patient_id": info.patient_id.decode(errors="replace"),
        "heart_rate": info.heart_rate if info.heart_rate >= 0 else None,
        "photometric": info.photometric.decode(errors="replace"),
        "transfer_syntax": info.transfer_syntax.decode(errors="replace"),
    }
