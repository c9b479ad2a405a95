"""Self-contained DICOM reader (no pydicom/GDCM dependency).

The port's copy of the JAX package's pure-Python parser (io/dicom.py),
host-side. It reads:

  * part-10 files (128-byte preamble + 'DICM') and bare datasets;
  * explicit and implicit VR little endian, deflated explicit VR;
    sequences (defined and undefined length), needed for
    SequenceOfUltrasoundRegions;
  * native (uncompressed) multi-frame pixel data, 8/16-bit, mono or RGB;
  * encapsulated JPEG-Lossless (process 14) frames through the port's
    native decoder (io/dicom_native.py), other JPEG frames through
    cv2.imdecode where cv2 imports;
  * RLE-encapsulated frames (DICOM packbits);
  * YBR_FULL / YBR_FULL_422 -> RGB color conversion;
  * the metadata fallback chain the reference uses: PhysicalDeltaX from
    the ultrasound-regions sequence, RWaveTimeVector, and
    CineRate -> FrameTime -> FrameTimeVector frame-rate fallbacks
    (calculate_optical_flow.py:315-367).

``read_dicom_clip`` tries the native C++ parser first (io/dicom_native.py,
the GDCM role) and takes this parser for what it does not decode.
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..exceptions import DICOMReadError

logger = logging.getLogger(__name__)

# transfer syntaxes
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
DEFLATED_LE = "1.2.840.10008.1.2.1.99"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
JPEG_LOSSLESS = "1.2.840.10008.1.2.4.70"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"

_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}
_STR_VRS = {b"AE", b"AS", b"CS", b"DA", b"DT", b"LO", b"LT", b"PN", b"SH",
            b"ST", b"TM", b"UI", b"UC", b"UR", b"UT"}

# tag -> (name, implicit VR) for the tags this pipeline consumes
_TAGS = {
    (0x0002, 0x0010): ("TransferSyntaxUID", b"UI"),
    (0x0008, 0x0008): ("ImageType", b"CS"),
    (0x0010, 0x0020): ("PatientID", b"LO"),
    (0x0018, 0x0040): ("CineRate", b"IS"),
    (0x0018, 0x1063): ("FrameTime", b"DS"),
    (0x0018, 0x1065): ("FrameTimeVector", b"DS"),
    (0x0018, 0x1088): ("HeartRate", b"IS"),
    (0x0018, 0x6011): ("SequenceOfUltrasoundRegions", b"SQ"),
    (0x0018, 0x602C): ("PhysicalDeltaX", b"FD"),
    (0x0018, 0x602E): ("PhysicalDeltaY", b"FD"),
    (0x0018, 0x6060): ("RWaveTimeVector", b"UL"),
    (0x0028, 0x0002): ("SamplesPerPixel", b"US"),
    (0x0028, 0x0004): ("PhotometricInterpretation", b"CS"),
    (0x0028, 0x0006): ("PlanarConfiguration", b"US"),
    (0x0028, 0x0008): ("NumberOfFrames", b"IS"),
    (0x0028, 0x0010): ("Rows", b"US"),
    (0x0028, 0x0011): ("Columns", b"US"),
    (0x0028, 0x0100): ("BitsAllocated", b"US"),
    (0x0028, 0x0103): ("PixelRepresentation", b"US"),
    (0x7FE0, 0x0010): ("PixelData", b"OB"),
}
_NAME_TO_TAG = {name: tag for tag, (name, _) in _TAGS.items()}


class DicomDataset:
    """Minimal attribute-style dataset (ds.PatientID, ds[group, elem])."""

    def __init__(self):
        self._elements: Dict[Tuple[int, int], Any] = {}

    def __contains__(self, tag) -> bool:
        return self._normalize(tag) in self._elements

    def __getitem__(self, tag):
        return self._elements[self._normalize(tag)]

    def get(self, tag, default=None):
        return self._elements.get(self._normalize(tag), default)

    def set(self, tag: Tuple[int, int], value: Any):
        self._elements[tag] = value

    @staticmethod
    def _normalize(tag):
        if isinstance(tag, tuple):
            return (int(tag[0]), int(tag[1]))
        if isinstance(tag, str):
            return _NAME_TO_TAG[tag]
        raise KeyError(tag)

    def __getattr__(self, name):
        tag = _NAME_TO_TAG.get(name)
        if tag is None:
            raise AttributeError(name)
        if tag not in self._elements:
            raise AttributeError(name)
        return self._elements[tag]

    @property
    def pixel_array(self) -> np.ndarray:
        return decode_pixel_data(self)


def _decode_value(vr: bytes, raw: bytes):
    if vr in _STR_VRS:
        text = raw.decode("ascii", errors="replace").rstrip("\x00 ").strip()
        if "\\" in text:
            return text.split("\\")
        return text
    if vr == b"IS":
        parts = raw.decode("ascii", errors="replace").strip("\x00 ").split("\\")
        vals = [int(float(p)) for p in parts if p.strip()]
        return vals[0] if len(vals) == 1 else vals
    if vr == b"DS":
        parts = raw.decode("ascii", errors="replace").strip("\x00 ").split("\\")
        vals = [float(p) for p in parts if p.strip()]
        return vals[0] if len(vals) == 1 else vals
    if vr == b"US":
        vals = list(struct.unpack(f"<{len(raw) // 2}H", raw))
        return vals[0] if len(vals) == 1 else vals
    if vr == b"SS":
        vals = list(struct.unpack(f"<{len(raw) // 2}h", raw))
        return vals[0] if len(vals) == 1 else vals
    if vr == b"UL":
        vals = list(struct.unpack(f"<{len(raw) // 4}I", raw))
        return vals[0] if len(vals) == 1 else vals
    if vr == b"SL":
        vals = list(struct.unpack(f"<{len(raw) // 4}i", raw))
        return vals[0] if len(vals) == 1 else vals
    if vr == b"FL":
        vals = list(struct.unpack(f"<{len(raw) // 4}f", raw))
        return vals[0] if len(vals) == 1 else vals
    if vr == b"FD":
        vals = list(struct.unpack(f"<{len(raw) // 8}d", raw))
        return vals[0] if len(vals) == 1 else vals
    return raw  # OB/OW/UN: raw bytes


class _Parser:
    def __init__(self, data: bytes, explicit: bool):
        self.data = data
        self.pos = 0
        self.explicit = explicit

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def _u16(self) -> int:
        v = struct.unpack_from("<H", self.data, self.pos)[0]
        self.pos += 2
        return v

    def _u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def read_element(self):
        group = self._u16()
        elem = self._u16()
        tag = (group, elem)

        if tag == (0xFFFE, 0xE00D) or tag == (0xFFFE, 0xE0DD):
            self._u32()  # item/sequence delimiter length (0)
            return tag, None, None

        if self.explicit and group != 0xFFFE:
            vr = self.data[self.pos:self.pos + 2]
            self.pos += 2
            if vr in _LONG_VRS:
                self.pos += 2  # reserved
                length = self._u32()
            else:
                length = self._u16()
        else:
            vr = _TAGS.get(tag, ("", b"UN"))[1]
            length = self._u32()

        if vr == b"SQ" or (tag in _TAGS and _TAGS[tag][1] == b"SQ"):
            return tag, b"SQ", self._read_sequence(length)

        if length == 0xFFFFFFFF:
            if tag == (0x7FE0, 0x0010):
                return tag, b"OB", self._read_encapsulated_frames()
            return tag, b"SQ", self._read_sequence(length)

        raw = self.data[self.pos:self.pos + length]
        self.pos += length
        return tag, vr, raw

    def _read_sequence(self, length: int) -> List[DicomDataset]:
        items: List[DicomDataset] = []
        end = None if length == 0xFFFFFFFF else self.pos + length
        while not self.eof():
            if end is not None and self.pos >= end:
                break
            group = self._u16()
            elem = self._u16()
            ilen = self._u32()
            if (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimiter
                break
            if (group, elem) != (0xFFFE, 0xE000):
                raise DICOMReadError(f"Malformed sequence item tag {group:04x},{elem:04x}")
            if ilen == 0xFFFFFFFF:
                item = self._read_item_undefined()
            else:
                sub = _Parser(self.data[self.pos:self.pos + ilen], self.explicit)
                item = _parse_dataset(sub)
                self.pos += ilen
            items.append(item)
        return items

    def _read_item_undefined(self) -> DicomDataset:
        item = DicomDataset()
        while not self.eof():
            tag, vr, value = self.read_element()
            if tag == (0xFFFE, 0xE00D):
                break
            if vr == b"SQ":
                item.set(tag, value)
            elif vr is not None:
                item.set(tag, _decode_value(vr, value))
        return item

    def _read_encapsulated_frames(self) -> List[bytes]:
        """Encapsulated pixel data: basic offset table item + frame items."""
        frames: List[bytes] = []
        first = True
        while not self.eof():
            group = self._u16()
            elem = self._u16()
            ilen = self._u32()
            if (group, elem) == (0xFFFE, 0xE0DD):
                break
            if (group, elem) != (0xFFFE, 0xE000):
                raise DICOMReadError("Malformed encapsulated pixel data")
            payload = self.data[self.pos:self.pos + ilen]
            self.pos += ilen
            if first:
                first = False
                continue  # basic offset table (possibly empty)
            frames.append(payload)
        return frames


def _parse_dataset(parser: _Parser, dataset: Optional[DicomDataset] = None) -> DicomDataset:
    ds = dataset or DicomDataset()
    while not parser.eof():
        tag, vr, value = parser.read_element()
        if vr is None:
            continue
        if vr == b"SQ":
            ds.set(tag, value)
        elif tag == (0x7FE0, 0x0010):
            ds.set(tag, value)  # raw bytes or encapsulated frame list
        else:
            ds.set(tag, _decode_value(vr, value))
    return ds


def dcmread(path: str) -> DicomDataset:
    """Read a DICOM file into a DicomDataset."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise DICOMReadError(f"{path}: too small to be DICOM")

    pos = 0
    if len(data) > 132 and data[128:132] == b"DICM":
        pos = 132

    transfer_syntax = EXPLICIT_VR_LE
    meta = DicomDataset()
    if pos == 132:
        # file meta group (0002) is always explicit VR LE
        p = _Parser(data, explicit=True)
        p.pos = pos
        while not p.eof():
            peek_group = struct.unpack_from("<H", p.data, p.pos)[0]
            if peek_group != 0x0002:
                break
            tag, vr, value = p.read_element()
            if vr not in (b"SQ", None):
                meta.set(tag, _decode_value(vr, value))
        pos = p.pos
        ts = meta.get((0x0002, 0x0010))
        if ts:
            transfer_syntax = ts

    if transfer_syntax == EXPLICIT_VR_BE:
        raise DICOMReadError("Big-endian transfer syntax not supported")
    explicit = transfer_syntax != IMPLICIT_VR_LE
    body = data[pos:]
    if transfer_syntax == DEFLATED_LE:
        import zlib
        body = zlib.decompress(body, -15)
        explicit = True

    parser = _Parser(body, explicit=explicit)
    ds = _parse_dataset(parser)
    ds.set((0x0002, 0x0010), transfer_syntax)
    return ds


# ---------------------------------------------------------------------------
# pixel decoding
# ---------------------------------------------------------------------------

def _rle_decode_frame(payload: bytes, rows: int, cols: int,
                      samples: int, bits: int) -> np.ndarray:
    """DICOM RLE (packbits per segment)."""
    nseg = struct.unpack_from("<I", payload, 0)[0]
    offsets = list(struct.unpack_from("<15I", payload, 4))[:nseg]
    offsets.append(len(payload))
    segments = []
    for i in range(nseg):
        seg = bytearray()
        p = offsets[i]
        end = offsets[i + 1]
        while p < end and len(seg) < rows * cols:
            n = payload[p]
            p += 1
            if n < 128:
                seg += payload[p:p + n + 1]
                p += n + 1
            elif n > 128:
                seg += bytes([payload[p]]) * (257 - n)
                p += 1
        segments.append(bytes(seg[:rows * cols]))
    bytes_per_sample = bits // 8
    out = np.zeros((rows * cols, samples), dtype=np.uint16 if bits == 16 else np.uint8)
    for s in range(samples):
        if bits == 16:
            hi = np.frombuffer(segments[s * 2], np.uint8).astype(np.uint16)
            lo = np.frombuffer(segments[s * 2 + 1], np.uint8).astype(np.uint16)
            out[:, s] = (hi << 8) | lo
        else:
            out[:, s] = np.frombuffer(segments[s], np.uint8)
    arr = out.reshape(rows, cols, samples)
    return arr[..., 0] if samples == 1 else arr


def group_jpeg_fragments(payloads: List[bytes], nframes: int) -> List[bytes]:
    """DICOM encapsulation legally splits one JPEG frame across multiple
    pixel-data fragments. When the fragment count already equals the
    frame count, pass through; otherwise merge consecutive fragments
    until one ends with the JPEG EOI marker (FFD9, ignoring the even-
    length pad byte), the frame boundary."""
    if len(payloads) == nframes:
        return list(payloads)
    frames: List[bytes] = []
    acc = bytearray()
    for payload in payloads:
        acc += payload
        tail = bytes(acc[-3:])
        if tail.endswith(b"\xff\xd9") or tail[:2] == b"\xff\xd9":
            frames.append(bytes(acc))
            acc = bytearray()
    if acc:  # trailing data without EOI: keep as-is, decoder will reject
        frames.append(bytes(acc))
    return frames


def _decode_jpeg_frame(payload: bytes, ts: str) -> np.ndarray:
    """One JPEG frame: JPEG-Lossless through the native decoder (cv2
    cannot parse SOF3 streams, and a clip must fail loudly rather than
    mis-decode), the other syntaxes through cv2.imdecode."""
    if ts == JPEG_LOSSLESS:
        from .dicom_native import jpegll_decode_frame

        img = jpegll_decode_frame(bytes(payload))
        if img is None:
            raise DICOMReadError(
                "JPEG-Lossless (1.2.840.10008.1.2.4.70) frame could not be "
                "decoded: the native dicomlite library (g++ build of "
                "tee_optical_flow_torch/csrc/dicomlite.cpp) is unavailable "
                "or the stream is not a valid process-14 scan")
        return img
    try:
        import cv2
    except ImportError as exc:
        raise DICOMReadError(
            f"transfer syntax {ts} needs cv2 for JPEG decode") from exc
    img = cv2.imdecode(np.frombuffer(payload, np.uint8),
                       cv2.IMREAD_UNCHANGED)
    if img is None:
        raise DICOMReadError("cv2 failed to decode encapsulated frame")
    if img.ndim == 3:
        img = img[..., ::-1]  # BGR -> RGB
    return img


def decode_pixel_data(ds: DicomDataset) -> np.ndarray:
    raw = ds.get((0x7FE0, 0x0010))
    if raw is None:
        raise DICOMReadError("No PixelData element")
    rows = int(ds.get((0x0028, 0x0010)))
    cols = int(ds.get((0x0028, 0x0011)))
    samples = int(ds.get((0x0028, 0x0002), 1))
    bits = int(ds.get((0x0028, 0x0100), 8))
    nframes = int(ds.get((0x0028, 0x0008), 1) or 1)
    ts = ds.get((0x0002, 0x0010), EXPLICIT_VR_LE)
    planar = int(ds.get((0x0028, 0x0006), 0) or 0)

    if isinstance(raw, list):  # encapsulated frames
        if ts == RLE_LOSSLESS:
            frames = [_rle_decode_frame(payload, rows, cols, samples, bits)
                      for payload in raw]
        else:  # JPEG family: frames may span fragments
            frames = [_decode_jpeg_frame(payload, ts) for payload
                      in group_jpeg_fragments(raw, nframes)]
        arr = np.stack(frames) if len(frames) > 1 else frames[0][None]
        if nframes == 1:
            arr = arr[0]
        return arr

    dtype = np.uint16 if bits == 16 else np.uint8
    arr = np.frombuffer(raw, dtype=dtype)
    expected = rows * cols * samples * nframes
    arr = arr[:expected]
    if samples > 1:
        if planar == 1:
            arr = arr.reshape(nframes, samples, rows, cols).transpose(0, 2, 3, 1)
        else:
            arr = arr.reshape(nframes, rows, cols, samples)
    else:
        arr = arr.reshape(nframes, rows, cols)
    if nframes == 1:
        arr = arr[0]
    return arr


def ybr_to_rgb(arr: np.ndarray) -> np.ndarray:
    """YBR_FULL -> RGB (ITU-R 601 full range), uint8 in/out."""
    y = arr[..., 0].astype(np.float32)
    cb = arr[..., 1].astype(np.float32) - 128.0
    cr = arr[..., 2].astype(np.float32) - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def should_convert_to_rgb(ds: DicomDataset) -> bool:
    photometric = str(ds.get((0x0028, 0x0004), "") or "")
    return photometric.startswith("YBR")


def read_dicom_clip(path: str) -> Tuple[DicomDataset, np.ndarray]:
    """Read file -> (dataset, RGB uint8 clip (N, H, W, 3)).

    Mirrors the reference's read + color-space + gray2rgb normalization
    (calculate_optical_flow.py:292-312, :522-540): grayscale multi-frame
    clips are replicated to RGB so the rest of the pipeline sees one
    layout.

    Tries the native C++ parser first (io/dicom_native.py, the GDCM role)
    and falls back to the pure-Python parser for what the native path
    does not decode (baseline JPEG, deflate) or where its library cannot
    be built. The native path's dataset holds the tags extract_metadata
    reads.
    """
    from .dicom_native import native_read

    try:
        native = native_read(path)
    except Exception as exc:  # any native failure: the Python parser reads
        logger.warning("native read of %s failed (%s); using the "
                       "pure-Python parser", path, exc)
        native = None
    if native is not None:
        meta, arr = native
        ds = DicomDataset()
        ds.set((0x0010, 0x0020), meta["patient_id"])
        if meta["heart_rate"] is not None:
            ds.set((0x0018, 0x1088), meta["heart_rate"])
        if meta["frame_rate"] is not None:
            ds.set((0x0018, 0x0040), meta["frame_rate"])
        if meta["pixel_spacing"] is not None:
            region = DicomDataset()
            region.set((0x0018, 0x602C), meta["pixel_spacing"])
            ds.set((0x0018, 0x6011), [region])
        if meta["R_wave_data_present"]:
            ds.set((0x0018, 0x6060), meta["R_times"].tolist())
        ds.set((0x0028, 0x0004), meta["photometric"])
        ds.set((0x0002, 0x0010), meta["transfer_syntax"])
        if meta["photometric"].startswith("YBR") and arr.ndim == 4 \
                and arr.shape[-1] == 3:
            arr = ybr_to_rgb(arr)
        if arr.ndim == 3:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        return ds, np.ascontiguousarray(arr)

    ds = dcmread(path)
    arr = ds.pixel_array
    if should_convert_to_rgb(ds) and arr.ndim >= 3 and arr.shape[-1] == 3 \
            and not isinstance(ds.get((0x7FE0, 0x0010)), list):
        arr = ybr_to_rgb(arr)  # raw YBR only; cv2-decoded JPEG is already RGB
    if arr.ndim == 3 and arr.shape[-1] != 3:
        arr = np.repeat(arr[..., None], 3, axis=-1)  # gray clip -> RGB
    elif arr.ndim == 2:
        arr = np.repeat(arr[None, ..., None], 3, axis=-1)
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        arr = arr[None]
    return ds, np.ascontiguousarray(arr)


def extract_metadata(ds: DicomDataset, verbose: bool = False) -> Dict[str, Any]:
    """The reference's metadata dict with its exact fallback chain
    (calculate_optical_flow.py:315-367)."""
    metadata = {"pixel_spacing": None, "frame_rate": None,
                "R_times": None, "R_wave_data_present": False}

    try:
        regions = ds[(0x0018, 0x6011)]
        metadata["pixel_spacing"] = regions[0][(0x0018, 0x602C)]
    except (KeyError, AttributeError, IndexError, TypeError) as e:
        if verbose:
            logger.warning("No pixel spacing metadata: %s", e)

    try:
        rwaves = ds.RWaveTimeVector
        if not isinstance(rwaves, float) and rwaves is not None:
            metadata["R_times"] = np.atleast_1d(np.asarray(rwaves, dtype=np.float64))
            metadata["R_wave_data_present"] = True
    except (AttributeError, KeyError, TypeError):
        pass

    try:
        metadata["frame_rate"] = float(ds.CineRate)
    except (AttributeError, KeyError, TypeError):
        try:
            metadata["frame_rate"] = float(np.round(1000 / float(ds.FrameTime)))
        except (AttributeError, KeyError, ValueError, ZeroDivisionError, TypeError):
            try:
                ftv = ds.FrameTimeVector
                metadata["frame_rate"] = float(np.round(1000 / float(ftv[1])))
            except (AttributeError, KeyError, IndexError, ValueError,
                    ZeroDivisionError, TypeError) as e:
                if verbose:
                    logger.warning("No frame rate information: %s", e)
    return metadata
