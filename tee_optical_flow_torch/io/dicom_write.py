"""Minimal DICOM writer: synthesize valid multi-frame part-10 files.

The port's copy of the JAX package's writer (io/dicom_write.py): it
regenerates DICOM fixtures from the parser-side knowledge in io/dicom.py
so the decode leg of the pipeline can be tested and driven end to end.
Supports the transfer syntaxes the ultrasound path sees:

  * explicit VR little endian with native (uncompressed) pixel data;
  * RLE lossless (1.2.840.10008.1.2.5): per-frame encapsulated items,
    one packbits segment per color sample, with the 64-byte RLE header.
    The encoder emits replicate runs for constant rows (black sector
    background) and literal runs elsewhere — valid packbits, biased for
    speed over ratio (speckle barely compresses anyway);
  * JPEG Lossless (1.2.840.10008.1.2.4.70, process 14, selection value
    1): one SOF3 stream per frame item.

Used by the port's tests.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np

from .dicom import EXPLICIT_VR_LE, JPEG_LOSSLESS, RLE_LOSSLESS

_LONG_LEN_VRS = (b"OB", b"OW", b"SQ", b"UN", b"UT")

# --------------------------------------------------------------------------
# JPEG Lossless (process 14, selection value 1) encoder — ITU-T T.81
# Annex H (the JAX package's encoder). Deliberately independent of the C++
# decoder in csrc/dicomlite.cpp (dicom_jpegll_decode) so the round-trip
# tests exercise two implementations of the spec against each other.
# --------------------------------------------------------------------------

# canonical DC Huffman table for difference categories 0..16:
# BITS = 3 codes of length 2, then one code per length 3..16
_JLL_BITS = bytes([0, 3] + [1] * 14)
_JLL_VALS = bytes(range(17))


def _jll_codes():
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        n = _JLL_BITS[length - 1]
        for _ in range(n):
            codes[_JLL_VALS[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, nbits: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            byte = (self.acc >> self.nbits) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)  # byte stuffing
        self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            byte = ((self.acc << (8 - self.nbits)) |
                    ((1 << (8 - self.nbits)) - 1)) & 0xFF  # pad with 1s
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)
            self.acc = 0
            self.nbits = 0


def _jll_marker(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def jpegll_encode_frame(frame: np.ndarray, precision: int = 8,
                        restart_interval: int = 0) -> bytes:
    """Encode one (H, W) or (H, W, S) integer frame as a JPEG-Lossless
    process-14 SV1 stream (interleaved components, point transform 0).

    ``restart_interval`` > 0 emits a DRI segment and an RSTn marker every
    that many MCUs (prediction resets to the default value per T.81
    H.2.3) — used by tests to exercise the decoder's restart path,
    including restarts that fall mid-row."""
    if frame.ndim == 2:
        frame = frame[..., None]
    h, w, s = frame.shape
    frame = frame.astype(np.int64)

    sof = struct.pack(">BHHB", precision, h, w, s)
    for ci in range(s):
        sof += struct.pack(">BBB", ci + 1, 0x11, 0)
    dht = b"\x00" + _JLL_BITS + _JLL_VALS
    sos = struct.pack(">B", s)
    for ci in range(s):
        sos += struct.pack(">BB", ci + 1, 0x00)
    sos += struct.pack(">BBB", 1, 0, 0)  # Ss=1 (SV1), Se=0, Ah<<4|Al=0

    codes = _jll_codes()
    bw = _BitWriter()
    default_px = 1 << (precision - 1)

    if restart_interval == 0:
        # vectorized SV1 prediction: Ra everywhere, Rb in the first
        # column, the default at (0, 0); diffs modulo 2^16
        px = np.empty_like(frame)
        px[:, 1:, :] = frame[:, :-1, :]
        px[1:, 0, :] = frame[:-1, 0, :]
        px[0, 0, :] = default_px
        diffs = (frame - px) & 0xFFFF
        d = np.where(diffs > 32768, diffs - 65536, diffs).reshape(-1)
        # vectorized entropy coding (a per-sample Python loop costs
        # minutes per real clip). Per sample:
        # Huffman(SSSS) then SSSS extra bits (none for SSSS=16), MSB
        # first; assembled via per-bit-index scatter + packbits.
        code_t = np.array([codes[i][0] for i in range(17)], np.int64)
        clen_t = np.array([codes[i][1] for i in range(17)], np.int64)
        pow2 = np.int64(1) << np.arange(17, dtype=np.int64)
        a = np.abs(d)
        ssss = np.searchsorted(pow2, a, side="right").astype(np.int64)
        nextra = np.where(ssss == 16, 0, ssss)
        extra = np.where(d >= 0, d, d + pow2[ssss] - 1) & (pow2[ssss] - 1)
        extra = np.where(ssss == 16, 0, extra)
        val = (code_t[ssss] << nextra) | extra
        n = clen_t[ssss] + nextra
        ends = np.cumsum(n)
        offs = ends - n
        total = int(ends[-1]) if n.size else 0
        bits = np.ones((total + 7) & ~7, np.uint8)  # pad bits are 1s
        for j in range(int(n.max()) if n.size else 0):
            sel = n > j
            bits[offs[sel] + j] = ((val[sel] >> (n[sel] - 1 - j)) & 1
                                   ).astype(np.uint8)
        by = np.packbits(bits)
        ff = np.flatnonzero(by == 0xFF)
        if ff.size:
            by = np.insert(by, ff + 1, np.uint8(0))  # byte stuffing
        bw.out += by.tobytes()
    else:
        mcu = 0
        rst = 0
        reset_pending = False
        row_since_reset = 0
        for y in range(h):
            row_since_reset += 1
            for x in range(w):
                if mcu == restart_interval:
                    bw.flush()
                    bw.out += bytes([0xFF, 0xD0 + rst])
                    rst = (rst + 1) % 8
                    mcu = 0
                    row_since_reset = 0
                    reset_pending = True
                for ci in range(s):
                    if reset_pending or (y == 0 and x == 0):
                        px = default_px
                    elif row_since_reset == 0 or y == 0:
                        px = frame[y, x - 1, ci]      # Ra
                    elif x == 0:
                        px = frame[y - 1, x, ci]      # Rb
                    else:
                        px = frame[y, x - 1, ci]      # SV1: Ra
                    d = int(frame[y, x, ci] - px) & 0xFFFF
                    if d > 32768:
                        d -= 65536
                    ssss = 16 if d == 32768 else abs(d).bit_length()
                    code, length = codes[ssss]
                    bw.put(code, length)
                    if 0 < ssss < 16:
                        v = d if d >= 0 else d + (1 << ssss) - 1
                        bw.put(v & ((1 << ssss) - 1), ssss)
                reset_pending = False
                mcu += 1
    bw.flush()
    head = b"\xff\xd8" + _jll_marker(0xFFC4, dht)
    if restart_interval:
        head += _jll_marker(0xFFDD, struct.pack(">H", restart_interval))
    return (head + _jll_marker(0xFFC3, sof) + _jll_marker(0xFFDA, sos) +
            bytes(bw.out) + b"\xff\xd9")


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

    ``transfer_syntax``: 'native' (explicit VR LE, uncompressed),
    'rle' (RLE lossless encapsulation), or 'jpeg_lossless'
    (JPEG Lossless process 14 SV1, 1.2.840.10008.1.2.4.70).
    """
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim == 3:
        n, h, w = frames.shape
        samples = 1
    else:
        n, h, w, samples = frames.shape
    ts = {"native": EXPLICIT_VR_LE, "rle": RLE_LOSSLESS,
          "jpeg_lossless": JPEG_LOSSLESS}.get(transfer_syntax)
    if ts is None:
        raise ValueError(f"unsupported transfer_syntax {transfer_syntax!r}")
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

    if transfer_syntax in ("rle", "jpeg_lossless"):
        # encapsulated: undefined-length PixelData, empty offset table,
        # one item per frame, sequence delimiter
        encode_frame = (_rle_frame if transfer_syntax == "rle"
                        else jpegll_encode_frame)
        items = [struct.pack("<HHI", 0xFFFE, 0xE000, 0)]
        for i in range(n):
            payload = encode_frame(frames[i])
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
