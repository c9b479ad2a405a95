"""Inputs made from the seed: synthetic echo clips and the DICOM files
that hold them.

The clip follows the pattern of the repository's smoke run
(``chip_smoke.echo_clip`` over ``synthetic.make_echo_pair``): a speckled
myocardial ring about a dark cavity inside a fan-shaped sector,
contracting about the ring centre (0.55 H, 0.5 W) with a cardiac period in
frames. It is made here on the device in a few large calls (speckle from a
``torch.Generator``, a separable blur, one bicubic resampling of every
frame), so that a run's set-up stays short. Each clip of a pool takes one
motion (an amplitude and a phase) of a fixed set, in an order drawn from
the seed, and a speckle of its own: every seed gives the same set of
motions, so the work of the epsilon stop varies from clip to clip as in a
cohort but hardly from seed to seed.

``write_dicom`` is a frozen copy of the uncompressed branch of the
program's ``io/dicom_write.write_dicom_clip`` (explicit VR little endian,
the ultrasound-region pixel spacing, cine rate and R-wave times).
"""

from __future__ import annotations

import math
import struct
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
_LONG_LEN_VRS = (b"OB", b"OW", b"SQ", b"UN", b"UT")


def seed_rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one named use of ``seed`` (any whole number,
    negative or above 64 bits too)."""
    words = [ord(c) for c in stream]
    return np.random.default_rng([abs(int(seed)) % 2 ** 64,
                                  int(seed < 0), *words])


def torch_generator(seed: int, stream: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and a
    named use."""
    word = int(seed_rng(seed, stream).integers(0, 2 ** 63 - 1))
    return torch.Generator(device=device).manual_seed(word)


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian of a (B, H, W) tensor, reflected borders."""
    radius = int(math.ceil(4 * sigma))
    t = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=x.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = (k / k.sum()).to(x.dtype)
    y = F.pad(x[:, None], (radius, radius, 0, 0), mode="reflect")
    y = F.conv2d(y, k.reshape(1, 1, 1, -1))
    y = F.pad(y, (0, 0, radius, radius), mode="reflect")
    return F.conv2d(y, k.reshape(1, 1, -1, 1))[:, 0]


def sector_geometry(h: int, w: int, device):
    """Boolean (H, W) masks of the fan ('sector'), the myocardial ring
    ('wall') and the cavity, and the elliptical radius about the ring
    centre."""
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    ang = torch.atan2(xx - w / 2.0, yy + 20.0)
    rad = torch.hypot(xx - w / 2.0, yy + 20.0)
    sector = (ang.abs() < math.radians(38)) & (rad < 0.95 * h)
    r_ell = torch.hypot((yy - 0.55 * h) / (0.28 * h),
                        (xx - 0.5 * w) / (0.22 * w))
    return {"sector": sector, "wall": (r_ell >= 0.75) & (r_ell < 1.35)
            & sector, "cavity": (r_ell < 0.75) & sector, "r_ell": r_ell}


def echo_clips(seed: int, count: int, frames: int, h: int, w: int, *,
               amplitudes: Sequence[float], period: float, device
               ) -> torch.Tensor:
    """(count, frames, h, w) uint8 clips on ``device``: clip j takes the
    motion ``perm[j]`` of a fixed set, amplitude ``amplitudes[m %
    len(amplitudes)]`` (a share of the radius) and phase ``2 pi m /
    count``; the permutation and the speckle are drawn from the seed."""
    order = seed_rng(seed, "clips").permutation(count)
    gen = torch_generator(seed, "speckle", device)
    speckle = torch.rand((count, h, w), generator=gen, device=device)
    speckle = _blur(speckle, 1.2)
    lo = speckle.amin(dim=(1, 2), keepdim=True)
    hi = speckle.amax(dim=(1, 2), keepdim=True)
    speckle = (speckle - lo) / (hi - lo)
    geo = sector_geometry(h, w, device)
    ring = torch.exp(-((geo["r_ell"] - 1.0) / 0.25) ** 2)
    img = (30.0 + 200.0 * ring) * (0.35 + 0.65 * speckle)
    img = torch.where(geo["cavity"], img * 0.15, img)
    img = torch.where(geo["sector"], img, torch.zeros_like(img))
    img = img.clamp(0, 255)
    amp = torch.tensor([amplitudes[int(k) % len(amplitudes)] for k in order],
                       dtype=torch.float32, device=device)
    k = torch.arange(frames, dtype=torch.float32, device=device)
    ph = torch.tensor([2 * math.pi * int(m) / count for m in order],
                      dtype=torch.float32, device=device)
    c = amp[:, None] * torch.sin(2 * math.pi * k[None] / period + ph[:, None])
    # frame k shows I(x_c + (1 + c_k)(x - x_c)), sampled bicubically
    cy, cx = 0.55 * h, 0.5 * w
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    sx = cx + (1 + c[..., None, None]) * (xx - cx)
    sy = cy + (1 + c[..., None, None]) * (yy - cy)
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], dim=-1)
    out = torch.empty((count, frames, h, w), dtype=torch.uint8, device=device)
    for j in range(count):
        f = F.grid_sample(img[j][None, None].expand(frames, 1, h, w),
                          grid[j], mode="bicubic", padding_mode="border",
                          align_corners=True)[:, 0]
        f = torch.where(geo["sector"], f, torch.zeros_like(f))
        out[j] = torch.round(f.clamp(0, 255)).to(torch.uint8)
    return out


def _element(group: int, elem: int, vr: bytes, payload: bytes) -> bytes:
    """One explicit-VR-LE data element (even-length padded)."""
    head = struct.pack("<HH", group, elem) + vr
    if vr in _LONG_LEN_VRS:
        if len(payload) % 2:
            payload += b"\x00"
        return head + b"\x00\x00" + struct.pack("<I", len(payload)) + payload
    if len(payload) % 2:
        payload += b" " if vr in (b"UI", b"LO", b"CS", b"IS", b"DS") \
            else b"\x00"
    return head + struct.pack("<H", len(payload)) + payload


def write_dicom(path: str, frames: np.ndarray, *, frame_rate: float,
                pixel_spacing: float,
                rwave_times: Optional[Sequence[float]] = (10.0, 800.0),
                patient_id: str = "BENCH", heart_rate: int = 72) -> None:
    """Write a (N, H, W, 3) or (N, H, W) uint8 clip as an uncompressed
    part-10 DICOM (explicit VR little endian)."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w = frames.shape[:3]
    samples = 1 if frames.ndim == 3 else frames.shape[3]
    meta = _element(0x0002, 0x0010, b"UI", EXPLICIT_VR_LE.encode())
    item_body = _element(0x0018, 0x602C, b"FD",
                         struct.pack("<d", pixel_spacing))
    item = struct.pack("<HHI", 0xFFFE, 0xE000, len(item_body)) + item_body
    elements = [
        _element(0x0010, 0x0020, b"LO", patient_id.encode()),
        _element(0x0018, 0x0040, b"IS", str(int(frame_rate)).encode()),
        _element(0x0018, 0x1088, b"IS", str(int(heart_rate)).encode()),
        _element(0x0018, 0x6011, b"SQ", item),
    ]
    if rwave_times is not None:
        elements.append(_element(
            0x0018, 0x6060, b"UL",
            b"".join(struct.pack("<I", int(r)) for r in rwave_times)))
    elements += [
        _element(0x0028, 0x0002, b"US", struct.pack("<H", samples)),
        _element(0x0028, 0x0004, b"CS",
                 b"RGB" if samples == 3 else b"MONOCHROME2"),
        _element(0x0028, 0x0008, b"IS", str(n).encode()),
        _element(0x0028, 0x0010, b"US", struct.pack("<H", h)),
        _element(0x0028, 0x0011, b"US", struct.pack("<H", w)),
        _element(0x0028, 0x0100, b"US", struct.pack("<H", 8)),
        _element(0x7FE0, 0x0010, b"OB", frames.tobytes()),
    ]
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + b"".join(elements))
