"""The port's DICOM decode against the JAX package's, on the CPU: the
native reader (``io/dicom_native`` over the port's own
``csrc/dicomlite.cpp``, built with g++ into ``build/dicomlite/``), the
JPEG branches of the pure-Python reader, and the JPEG-Lossless encoder of
the writer.

It mirrors tests/test_dicom_pipeline.py's decode tests on the port (RLE
and JPEG-Lossless round trips through both parsers, 16-bit frames,
restart markers, fragmented frames, fill bytes, the refusal without the
native decoder), covers what that file does not (every JPEG-Lossless
predictor, from an encoder written here; a library without the
JPEG-Lossless symbol; a library that cannot be built; six builds at
once), and holds ``read_dicom_clip``'s arrays and ``extract_metadata``'s
dict bit-equal to the JAX package's on the same files. Everything here is
integer decode and float64 metadata, so every comparison is exact.
"""

import logging
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX reference runs on the CPU)

from tee_optical_flow_torch.exceptions import DICOMReadError
from tee_optical_flow_torch.io import dicom as t_dicom
from tee_optical_flow_torch.io import dicom_native as t_native
from tee_optical_flow_torch.io import dicom_write as t_write
from tee_optical_flow_tpu.io import dicom as j_dicom
from tee_optical_flow_tpu.io import dicom_write as j_write

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synthetic_clip(rng, n=3, h=48, w=48):
    """tests/test_dicom_pipeline.py's clip: a bright blob drifting right
    on dark speckle, RGB, with zero rows (RLE replicate runs, small
    JPEG-Lossless categories)."""
    clip = (rng.uniform(size=(n, h, w)) * 40).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        blob = np.exp(-((yy - h // 2) ** 2 + (xx - w // 4 - i) ** 2)
                      / (2 * 8.0 ** 2))
        clip[i] = np.clip(clip[i] + blob * 215, 0, 255).astype(np.uint8)
    clip[:, :10] = 0
    return np.repeat(clip[..., None], 3, axis=-1)


def _assert_same_as_jax(path):
    """The port's read_dicom_clip and extract_metadata against the JAX
    package's on ``path``, bit for bit; returns the port's array."""
    j_ds, j_arr = j_dicom.read_dicom_clip(path)
    t_ds, t_arr = t_dicom.read_dicom_clip(path)
    assert t_arr.dtype == j_arr.dtype and t_arr.shape == j_arr.shape
    np.testing.assert_array_equal(t_arr, j_arr)
    j_meta = j_dicom.extract_metadata(j_ds)
    t_meta = t_dicom.extract_metadata(t_ds)
    assert sorted(j_meta) == sorted(t_meta)
    for key in j_meta:
        assert type(t_meta[key]) is type(j_meta[key]), key
        np.testing.assert_array_equal(t_meta[key], j_meta[key])
    return t_arr


def _encapsulated(path, ts, payloads, rows, cols, bits, samples=1):
    """A part-10 file whose pixel data are the encapsulated ``payloads``
    (one item each), with the metadata write_dicom_clip writes."""
    items = [struct.pack("<HHI", 0xFFFE, 0xE000, 0)]
    for p in payloads:
        p = p + (b"\x00" if len(p) % 2 else b"")
        items.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(p)) + p)
    items.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    pixel = (struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00"
             + struct.pack("<I", 0xFFFFFFFF) + b"".join(items))
    _write(path, ts, rows, cols, len(payloads), bits, samples, pixel)


def _write(path, ts, rows, cols, n, bits, samples, pixel):
    el = t_write.encode_element
    body = b"".join([
        el(0x0010, 0x0020, b"LO", b"P16"),
        el(0x0018, 0x0040, b"IS", b"25"),
        el(0x0018, 0x6060, b"UL", struct.pack("<2I", 15, 700)),
        el(0x0028, 0x0002, b"US", struct.pack("<H", samples)),
        el(0x0028, 0x0004, b"CS",
           b"RGB" if samples == 3 else b"MONOCHROME2"),
        el(0x0028, 0x0008, b"IS", str(n).encode()),
        el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        el(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
        pixel])
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM"
                + el(0x0002, 0x0010, b"UI", ts.encode()) + body)


def _write_16bit(path, frames, syntax):
    """(N, H, W) uint16 frames as a 16-bit monochrome file, uncompressed
    or JPEG-Lossless at precision 16."""
    n, h, w = frames.shape
    if syntax == "native":
        pixel = t_write.encode_element(0x7FE0, 0x0010, b"OW",
                                       frames.astype("<u2").tobytes())
        _write(path, t_dicom.EXPLICIT_VR_LE, h, w, n, 16, 1, pixel)
    else:
        _encapsulated(path, t_dicom.JPEG_LOSSLESS,
                      [t_write.jpegll_encode_frame(f, precision=16)
                       for f in frames], h, w, 16)


def test_native_library_is_built_from_the_ports_source():
    assert t_native.native_available()
    path = t_native.build_info["path"]
    assert os.path.dirname(path) == str(t_native.BUILD_DIR)
    assert t_native.BUILD_DIR == type(t_native.BUILD_DIR)(
        ROOT, "build", "dicomlite")
    assert t_native.SOURCE.parent.name == "csrc"
    assert t_native.SOURCE.parent.parent.name == "tee_optical_flow_torch"
    assert hasattr(t_native._load(), "dicom_jpegll_decode")


def test_concurrent_builds_agree(tmp_path):
    """Six processes build into one empty directory at once (the test
    workers do): each gets the same library, whole, and no temporary
    directory is left behind."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    code = ("import sys; from pathlib import Path; "
            "import tee_optical_flow_torch.io.dicom_native as d; "
            "d.BUILD_DIR = Path(sys.argv[1]); "
            "import ctypes; p, _ = d._build(); "
            "assert hasattr(ctypes.CDLL(str(p)), 'dicom_parse'); print(p)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(paths.pop())]


@pytest.mark.parametrize("syntax", ["native", "rle", "jpeg_lossless"])
def test_round_trip_both_parsers(rng, tmp_path, syntax):
    """The port's writer, read back by the native path and the pure-Python
    parser of the port (tests/test_dicom_pipeline.py's RLE and JPEG-LL
    round trips), and byte-equal to the JAX package's writer; the
    JPEG-Lossless encoder and the C++ decoder are independent
    implementations of T.81 Annex H."""
    frames = _synthetic_clip(rng)
    path, j_path = str(tmp_path / "t.dcm"), str(tmp_path / "j.dcm")
    t_write.write_dicom_clip(path, frames, transfer_syntax=syntax)
    j_write.write_dicom_clip(j_path, frames, transfer_syntax=syntax)
    assert open(path, "rb").read() == open(j_path, "rb").read()
    np.testing.assert_array_equal(t_dicom.dcmread(path).pixel_array, frames)
    meta, arr = t_native.native_read(path)
    np.testing.assert_array_equal(arr, frames)
    ts = {"native": t_dicom.EXPLICIT_VR_LE, "rle": t_dicom.RLE_LOSSLESS,
          "jpeg_lossless": t_dicom.JPEG_LOSSLESS}[syntax]
    assert meta["transfer_syntax"].strip("\x00 ") == ts
    np.testing.assert_array_equal(_assert_same_as_jax(path), frames)


@pytest.mark.parametrize("syntax", ["native", "jpeg_lossless"])
def test_16bit_files_match_jax(rng, tmp_path, syntax):
    frames = rng.integers(0, 1 << 16, size=(2, 17, 23), dtype=np.uint16)
    path = str(tmp_path / "p16.dcm")
    _write_16bit(path, frames, syntax)
    arr = _assert_same_as_jax(path)
    assert arr.dtype == np.uint16
    np.testing.assert_array_equal(arr[..., 0], frames)
    np.testing.assert_array_equal(t_dicom.dcmread(path).pixel_array, frames)


def test_jpegll_frame_16bit(rng):
    """tests/test_dicom_pipeline.py: precision 16, diffs over the whole
    modulo-2^16 range, the SSSS=16 no-extra-bits case."""
    f16 = rng.integers(0, 1 << 16, size=(17, 23), dtype=np.uint16)
    f16[0, :4] = (0, 32768, 0, 65535)  # +-32768 differences: SSSS 16
    dec = t_native.jpegll_decode_frame(
        t_write.jpegll_encode_frame(f16, precision=16))
    assert dec.dtype == np.uint16
    np.testing.assert_array_equal(dec, f16)


def _encode_predictor(frame, predictor, precision):
    """A JPEG-Lossless stream of ``frame`` (H, W) under selection value
    ``predictor`` (T.81 Table H.1), one pixel at a time: the first row
    predicts from the left, the first column from above, (0, 0) from
    2^(P-1)."""
    codes = t_write._jll_codes()
    bw = t_write._BitWriter()
    f = frame.astype(np.int64)
    h, w = f.shape
    for y in range(h):
        for x in range(w):
            if y == 0 and x == 0:
                px = 1 << (precision - 1)
            elif y == 0:
                px = f[y, x - 1]
            elif x == 0:
                px = f[y - 1, x]
            else:
                ra, rb, rc = f[y, x - 1], f[y - 1, x], f[y - 1, x - 1]
                px = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                      5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                      7: (ra + rb) >> 1}[predictor]
            d = int(f[y, x] - px) & 0xFFFF
            d = d - 65536 if d > 32768 else d
            ssss = 16 if d == 32768 else abs(d).bit_length()
            bw.put(*codes[ssss])
            if 0 < ssss < 16:
                bw.put((d if d >= 0 else d + (1 << ssss) - 1)
                       & ((1 << ssss) - 1), ssss)
    bw.flush()
    sof = struct.pack(">BHHB", precision, h, w, 1) + bytes([1, 0x11, 0])
    sos = bytes([1, 1, 0x00, predictor, 0, 0])
    mk = t_write._jll_marker
    return (b"\xff\xd8" + mk(0xFFC4, b"\x00" + t_write._JLL_BITS
                             + t_write._JLL_VALS)
            + mk(0xFFC3, sof) + mk(0xFFDA, sos) + bytes(bw.out)
            + b"\xff\xd9")


@pytest.mark.parametrize("precision", [8, 16])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_jpegll_every_predictor(rng, predictor, precision):
    frame = rng.integers(0, 1 << precision, size=(9, 11)).astype(
        np.uint16 if precision == 16 else np.uint8)
    dec = t_native.jpegll_decode_frame(
        _encode_predictor(frame, predictor, precision))
    assert dec.dtype == frame.dtype
    np.testing.assert_array_equal(dec, frame)


def _split_items(path, out_path):
    """Rewrite ``path``'s encapsulated stream with every frame item split
    in two fragments at an even point."""
    raw = open(path, "rb").read()
    pix = raw.index(struct.pack("<HH", 0x7FE0, 0x0010))
    head, stream = raw[:pix], raw[pix:]
    items, pos = [], 12  # tag + OB + reserved + undefined length
    while pos + 8 <= len(stream):
        g, e, ln = struct.unpack_from("<HHI", stream, pos)
        pos += 8
        if (g, e) == (0xFFFE, 0xE0DD):
            break
        items.append(stream[pos:pos + ln])
        pos += ln
    out = stream[:12] + struct.pack("<HHI", 0xFFFE, 0xE000, len(items[0]))
    out += items[0]
    for payload in items[1:]:
        cut = (len(payload) // 2) & ~1
        for part in (payload[:cut], payload[cut:]):
            part = part + (b"\x00" if len(part) % 2 else b"")
            out += struct.pack("<HHI", 0xFFFE, 0xE000, len(part)) + part
    out += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    with open(out_path, "wb") as f:
        f.write(head + out)


def test_restart_markers_and_fragmented_frames(rng, tmp_path):
    """A restart interval that is not a row multiple (prediction resets
    mid-row, T.81 H.2.3), and frames split across two fragments, read
    by both parsers and equal to the JAX package's read."""
    frame = rng.integers(0, 256, size=(19, 29), dtype=np.uint8)
    enc = t_write.jpegll_encode_frame(frame, restart_interval=23)
    assert enc == j_write.jpegll_encode_frame(frame, restart_interval=23)
    np.testing.assert_array_equal(t_native.jpegll_decode_frame(enc), frame)

    clip = _synthetic_clip(rng, n=2)
    path = str(tmp_path / "frag.dcm")
    t_write.write_dicom_clip(path, clip, transfer_syntax="jpeg_lossless")
    frag = str(tmp_path / "frag2.dcm")
    _split_items(path, frag)
    np.testing.assert_array_equal(_assert_same_as_jax(frag), clip)
    np.testing.assert_array_equal(t_dicom.dcmread(frag).pixel_array, clip)


def test_fill_bytes_before_markers(rng):
    """T.81 B.1.1.2: 0xFF fill bytes may precede any marker (headers,
    restarts, EOI); the decoder skips them."""
    frame = rng.integers(0, 256, size=(19, 29), dtype=np.uint8)
    enc = t_write.jpegll_encode_frame(frame, restart_interval=23)
    out = bytearray()
    for i, byte in enumerate(enc):
        if (byte == 0xFF and i + 1 < len(enc)
                and (0xD0 <= enc[i + 1] <= 0xD7
                     or enc[i + 1] in (0xD9, 0xC4, 0xDA))):
            out += b"\xff\xff"
        out.append(byte)
    assert len(out) > len(enc)
    np.testing.assert_array_equal(t_native.jpegll_decode_frame(bytes(out)),
                                  frame)


def _no_native(monkeypatch):
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_lib_failed", True)


def test_jpegll_without_native_raises(rng, tmp_path, monkeypatch):
    """Without the native decoder a JPEG-Lossless clip raises
    DICOMReadError (never a cv2 mis-decode); uncompressed and RLE clips
    take the pure-Python parser, with the same arrays and metadata as the
    JAX package's read."""
    frames = _synthetic_clip(rng, n=2)
    paths = {}
    for syntax in ("native", "rle", "jpeg_lossless"):
        paths[syntax] = str(tmp_path / f"{syntax}.dcm")
        t_write.write_dicom_clip(paths[syntax], frames,
                                 transfer_syntax=syntax)
    _no_native(monkeypatch)
    assert not t_native.native_available()
    with pytest.raises(DICOMReadError, match="JPEG-Lossless"):
        t_dicom.read_dicom_clip(paths["jpeg_lossless"])
    for syntax in ("native", "rle"):
        np.testing.assert_array_equal(_assert_same_as_jax(paths[syntax]),
                                      frames)


def test_library_without_jpegll_keeps_its_other_paths(rng, tmp_path,
                                                      monkeypatch, caplog):
    """A library that lacks dicom_jpegll_decode (built here from the
    source with the symbol renamed) is kept, with a warning: its
    uncompressed and RLE reads still run natively, and a JPEG-Lossless
    clip raises DICOMReadError."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = tmp_path / "stub.cpp"
    src.write_text(t_native.SOURCE.read_text().replace(
        "dicom_jpegll_decode", "dicom_jpegll_decode_absent"))
    stub_path = tmp_path / "libstub.so"
    subprocess.run(["g++", *t_native.CXX_FLAGS, "-o", str(stub_path),
                    str(src)], check=True, capture_output=True, timeout=300)
    with caplog.at_level(logging.WARNING, logger=t_native.__name__):
        stub = t_native._open(stub_path)
    assert not hasattr(stub, "dicom_jpegll_decode")
    assert "dicom_jpegll_decode" in caplog.text
    monkeypatch.setattr(t_native, "_lib", stub)
    frames = _synthetic_clip(rng, n=2)
    for syntax in ("native", "rle", "jpeg_lossless"):
        path = str(tmp_path / f"{syntax}.dcm")
        t_write.write_dicom_clip(path, frames, transfer_syntax=syntax)
        if syntax == "jpeg_lossless":
            assert t_native.jpegll_decode_frame(b"\xff\xd8") is None
            assert t_native.native_read(path) is None
            with pytest.raises(DICOMReadError, match="JPEG-Lossless"):
                t_dicom.read_dicom_clip(path)
        else:
            _, arr = t_native.native_read(path)
            np.testing.assert_array_equal(arr, frames)
            np.testing.assert_array_equal(_assert_same_as_jax(path), frames)


def test_unbuildable_library_warns_and_reads_in_python(rng, tmp_path,
                                                       monkeypatch, caplog):
    """Where the library cannot be built (no g++ here), reads take the
    pure-Python parser with the JAX package's arrays, and the failure is
    logged as a warning."""
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_lib_failed", False)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(t_native.shutil, "which", lambda name: None)
    frames = _synthetic_clip(rng, n=2)
    path = str(tmp_path / "rle.dcm")
    t_write.write_dicom_clip(path, frames, transfer_syntax="rle")
    with caplog.at_level(logging.WARNING, logger=t_native.__name__):
        assert not t_native.native_available()
    assert any(r.levelno == logging.WARNING and "g++" in r.getMessage()
               for r in caplog.records)
    np.testing.assert_array_equal(_assert_same_as_jax(path), frames)


def test_baseline_jpeg_through_cv2_matches_jax(rng, tmp_path):
    """Baseline JPEG frames (1.2.840.10008.1.2.4.50) decode through
    cv2.imdecode where cv2 imports, in both packages alike; a grey clip
    comes back as RGB."""
    cv2 = pytest.importorskip("cv2")
    frames = _synthetic_clip(rng, n=2)[..., 0]
    payloads = [cv2.imencode(".jpg", f)[1].tobytes() for f in frames]
    path = str(tmp_path / "jpeg.dcm")
    _encapsulated(path, t_dicom.JPEG_BASELINE, payloads, *frames.shape[1:],
                  8)
    arr = _assert_same_as_jax(path)
    assert arr.shape == frames.shape + (3,)
    assert np.abs(arr[..., 0].astype(int) - frames).max() < 16  # lossy


def test_baseline_jpeg_without_cv2_raises(rng, tmp_path, monkeypatch):
    frames = _synthetic_clip(rng, n=1)[..., 0]
    path = str(tmp_path / "jpeg.dcm")
    _encapsulated(path, t_dicom.JPEG_BASELINE, [b"\xff\xd8\xff\xd9"],
                  *frames.shape[1:], 8)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(DICOMReadError, match="cv2"):
        t_dicom.read_dicom_clip(path)


def test_group_jpeg_fragments_matches_jax():
    frags = [b"\xff\xd8ab", b"cd\xff\xd9", b"\xff\xd8e\xff\xd9\x00",
             b"\xff\xd8tail"]
    for n in (4, 2, 3):
        assert t_dicom.group_jpeg_fragments(frags, n) == \
            j_dicom.group_jpeg_fragments(frags, n)
