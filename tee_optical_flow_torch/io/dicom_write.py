"""Minimal DICOM writer: synthesize valid multi-frame part-10 files.

The port's copy of the JAX package's writer (io/dicom_write.py), without
its JPEG-Lossless encoder: it regenerates DICOM fixtures from the
parser-side knowledge in io/dicom.py so the decode leg of the pipeline
can be tested and driven end to end. Supports the two transfer syntaxes
the ultrasound path actually sees:

  * explicit VR little endian with native (uncompressed) pixel data;
  * RLE lossless (1.2.840.10008.1.2.5): per-frame encapsulated items,
    one packbits segment per color sample, with the 64-byte RLE header.
    The encoder emits replicate runs for constant rows (black sector
    background) and literal runs elsewhere — valid packbits, biased for
    speed over ratio (speckle barely compresses anyway).

Used by the port's tests and chip_smoke.py.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np

from .dicom import EXPLICIT_VR_LE, RLE_LOSSLESS

_LONG_LEN_VRS = (b"OB", b"OW", b"SQ", b"UN", b"UT")


def encode_element(group: int, elem: int, vr: bytes, payload: bytes) -> bytes:
    """One explicit-VR-LE data element (even-length padded)."""
    head = struct.pack("<HH", group, elem) + vr
    if vr in _LONG_LEN_VRS:
        if len(payload) % 2:
            payload += b"\x00"
        return head + b"\x00\x00" + struct.pack("<I", len(payload)) + payload
    if len(payload) % 2:
        payload += b" " if vr in (b"UI", b"LO", b"CS", b"IS", b"DS") else b"\x00"
    return head + struct.pack("<H", len(payload)) + payload


def _packbits_segment(seg: np.ndarray, cols: int) -> bytes:
    """Packbits-encode one (rows*cols,) uint8 segment, row at a time:
    constant rows become replicate runs, others literal runs."""
    out = bytearray()
    rows = seg.reshape(-1, cols)
    for row in rows:
        if (row == row[0]).all():
            n = cols
            while n > 0:
                take = min(n, 128)
                if take == 1:
                    out += bytes([0, row[0]])
                else:
                    out += bytes([257 - take, row[0]])
                n -= take
        else:
            for start in range(0, cols, 128):
                chunk = row[start:start + 128]
                out += bytes([len(chunk) - 1]) + chunk.tobytes()
    return bytes(out)


def _rle_frame(frame: np.ndarray) -> bytes:
    """(H, W) or (H, W, S) uint8 -> one RLE-encapsulated frame payload."""
    if frame.ndim == 2:
        frame = frame[..., None]
    h, w, s = frame.shape
    segments = [_packbits_segment(np.ascontiguousarray(frame[..., i]).ravel(), w)
                for i in range(s)]
    header = struct.pack("<I", s)
    offsets = []
    pos = 64
    for seg in segments:
        offsets.append(pos)
        pos += len(seg) + (len(seg) % 2)
    offsets += [0] * (15 - len(offsets))
    header += struct.pack("<15I", *offsets)
    body = b"".join(seg + (b"\x00" if len(seg) % 2 else b"") for seg in segments)
    return header + body


def write_dicom_clip(path: str, frames: np.ndarray, *,
                     frame_rate: float = 30, pixel_spacing: float = 0.05,
                     rwave_times: Optional[Sequence[float]] = (10.0, 800.0),
                     patient_id: str = "TEST01", heart_rate: int = 72,
                     transfer_syntax: str = "native") -> None:
    """Write a (N, H, W, 3) or (N, H, W) uint8 clip as a part-10 DICOM.

    ``transfer_syntax``: 'native' (explicit VR LE, uncompressed) or
    'rle' (RLE lossless encapsulation).
    """
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim == 3:
        n, h, w = frames.shape
        samples = 1
    else:
        n, h, w, samples = frames.shape
    if transfer_syntax not in ("native", "rle"):
        raise ValueError(f"unsupported transfer_syntax {transfer_syntax!r}")
    ts = RLE_LOSSLESS if transfer_syntax == "rle" else EXPLICIT_VR_LE
    meta = encode_element(0x0002, 0x0010, b"UI", ts.encode())

    # ultrasound-regions sequence: one defined-length item w/ PhysicalDeltaX
    item_body = encode_element(0x0018, 0x602C, b"FD",
                               struct.pack("<d", pixel_spacing))
    item = struct.pack("<HHI", 0xFFFE, 0xE000, len(item_body)) + item_body
    seq = encode_element(0x0018, 0x6011, b"SQ", item)

    elements = [
        encode_element(0x0010, 0x0020, b"LO", patient_id.encode()),
        encode_element(0x0018, 0x0040, b"IS", str(int(frame_rate)).encode()),
        encode_element(0x0018, 0x1088, b"IS", str(int(heart_rate)).encode()),
        seq,
    ]
    if rwave_times is not None:
        elements.append(encode_element(
            0x0018, 0x6060, b"UL",
            b"".join(struct.pack("<I", int(r)) for r in rwave_times)))
    elements += [
        encode_element(0x0028, 0x0002, b"US", struct.pack("<H", samples)),
        encode_element(0x0028, 0x0004, b"CS",
                       b"RGB" if samples == 3 else b"MONOCHROME2"),
        encode_element(0x0028, 0x0008, b"IS", str(n).encode()),
        encode_element(0x0028, 0x0010, b"US", struct.pack("<H", h)),
        encode_element(0x0028, 0x0011, b"US", struct.pack("<H", w)),
        encode_element(0x0028, 0x0100, b"US", struct.pack("<H", 8)),
    ]

    if transfer_syntax == "rle":
        # encapsulated: undefined-length PixelData, empty offset table,
        # one item per frame, sequence delimiter
        items = [struct.pack("<HHI", 0xFFFE, 0xE000, 0)]
        for i in range(n):
            payload = _rle_frame(frames[i])
            if len(payload) % 2:
                payload += b"\x00"
            items.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(payload))
                         + payload)
        items.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
        pixel = (struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00"
                 + struct.pack("<I", 0xFFFFFFFF) + b"".join(items))
    else:
        pixel = encode_element(0x7FE0, 0x0010, b"OB", frames.tobytes())
    elements.append(pixel)

    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + b"".join(elements))
