"""Minimal dependency-free renderers: PNG (pure-python zlib encoder) for
waterfalls, ASCII PSD plots for terminals — replaces the Swing paint
paths for a headless host. A copy of :mod:`jsdr_tpu.display.render`
(numpy only)."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    c = tag + data
    return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))


def write_png_gray(path: str | Path, img: np.ndarray) -> None:
    """8-bit grayscale PNG writer (stdlib only)."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(raw, 6))
           + _png_chunk(b"IEND", b""))
    Path(path).write_bytes(out)


def write_png_rgb(path: str | Path, img: np.ndarray) -> None:
    """8-bit RGB PNG writer (stdlib only). img: [h, w, 3] uint8."""
    img = np.asarray(img, dtype=np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(raw, 6))
           + _png_chunk(b"IEND", b""))
    Path(path).write_bytes(out)


CYAN = (0, 255, 255)


def render_waterfall_png(path: str | Path, waterfall_buf: np.ndarray,
                         peak=CYAN) -> None:
    """Waterfall image with the reference's peak-color law: each pixel is
    the peak color scaled by intensity/256 (waterfall.java:100-104;
    default peak CYAN as the reference's default). ``peak=None`` keeps
    the raw intensity as grayscale."""
    buf = np.asarray(waterfall_buf, dtype=np.uint16)
    if peak is None:
        write_png_gray(path, buf.astype(np.uint8))
        return
    rgb = np.stack([buf * c // 256 for c in peak], axis=-1).astype(np.uint8)
    write_png_rgb(path, rgb)


_FILTER_BAND_COLOR = (0x1F, 0x1F, 0x00)    # fft.java:32 tcol
_RETICLE = (0x40, 0x40, 0x40)              # Color.DARK_GRAY
_TRACE = (0, 255, 0)                       # Color.GREEN psd trace
_TUNE = (0, 255, 255)                      # Color.CYAN tuning bars


def render_spectrum_png(path: str | Path, psd: np.ndarray, rate: float,
                        filter_band=None, tunings=(), centre_bins=(),
                        width: int = 1024, height: int = 512) -> None:
    """Spectrum display with the reference's overlays (fft.java paint):

    - demod filter band as a shaded region, x = width*f/rate + centre
      (fft.java:98-106, fed by the demod-filter-low/high topics)
    - dB reticle every height/10 (-10 dB per line) and symmetric
      frequency gridlines every (rate/20/10)*10 Hz (fft.java:108-128)
    - per-pixel-column max PSD trace with the 0->+f/2->-f/2 wrap so 0 Hz
      sits mid-screen (fft.java:142-150)
    - BPSK tuning bars: ``tunings`` in Hz (FUNcube<n>-bpsk-tune) and
      ``centre_bins`` as FFT bin indices (FUNcube<n>-bpsk-centre),
      full-height cyan lines (fft.java:152-173)
    """
    psd = np.asarray(psd, dtype=np.float32)
    n = len(psd)
    img = np.zeros((height, width, 3), np.uint8)
    off = width // 2

    def fx(f):   # frequency -> pixel column (fft.java:103-104, 168)
        return int(width * float(f) / float(rate)) + off

    if filter_band is not None:
        lo, hi = sorted(fx(f) for f in filter_band)
        img[:, max(lo, 0):min(hi, width)] = _FILTER_BAND_COLOR

    yh = height // 10
    for y in range(yh, height, yh):             # dB reticle
        img[y, :] = np.maximum(img[y, :], _RETICLE)
    fs = (int(rate) // 20 // 10) * 10           # freq gridline step
    xs = max(int(width * fs / rate), 1)
    for x in range(0, off, xs):
        img[:, off + x] = np.maximum(img[:, off + x], _RETICLE)
        if x > 0:
            img[:, off - x] = np.maximum(img[:, off - x], _RETICLE)

    step = n / width                            # fft.java:96 resampling
    # (dat.length/2 = N samples; psd has N bins spread over the width)
    ys = height / -100.0                        # -100 dBFS at bottom edge
    ly = int(np.clip(psd[0] * ys, 0, height - 1))
    for p in range(width - 1):
        i = (p + off) % width                   # 0-<pos>-<neg> wrap
        a = int(p * step)
        b = max(a + int(step), a + 1)
        y = int(np.clip(psd[min(a, n - 1):min(b, n)].max() * ys,
                        0, height - 1))
        y0, y1 = sorted((ly, y))
        img[y0:y1 + 1, i] = _TRACE
        ly = y
    for cb in centre_bins:                      # centre bars are bin-indexed
        x = int(cb / step) + off                # fft.java:159
        if 0 <= x < width:
            img[:, x] = _TUNE
    for f in tunings:                           # tune bars are Hz
        x = fx(f)
        if 0 <= x < width:
            img[:, x] = _TUNE
    write_png_rgb(path, img)


def render_psd_ascii(psd: np.ndarray, width: int = 100, height: int = 20,
                     db_lo: float = -100.0, db_hi: float = 0.0) -> str:
    """Centered-spectrum ASCII plot (0 Hz mid-screen like fft.java)."""
    psd = np.asarray(psd)
    n = len(psd)
    psd_c = np.roll(psd, n // 2)
    step = max(n // width, 1)
    cols = [psd_c[i * step:(i + 1) * step].max()
            for i in range(min(width, n // step))]
    rows = []
    for r in range(height):
        thresh = db_hi - (r + 1) * (db_hi - db_lo) / height
        rows.append("".join("#" if c >= thresh else " " for c in cols))
    return "\n".join(rows)


def render_phase_png(path: str | Path, points: np.ndarray,
                     i_trace: np.ndarray, q_trace: np.ndarray,
                     size: int = 256) -> None:
    """Phase-scope image: constellation dot cloud (top square) over the
    column-averaged I and Q time traces (bottom strip) — the headless
    analog of phase.java:43-121's paint."""
    img = np.zeros((size + size // 2, size), np.uint8)
    pts = np.asarray(points)
    px = np.clip(((pts[:, 0] + 1) * 0.5 * (size - 1)).astype(int), 0, size - 1)
    py = np.clip(((1 - pts[:, 1]) * 0.5 * (size - 1)).astype(int), 0, size - 1)
    img[py, px] = 255
    img[size // 2, :] = np.maximum(img[size // 2, :], 48)      # axes
    img[:size, size // 2] = np.maximum(img[:size, size // 2], 48)
    h2, y0 = size // 2, size
    for name, tr, shade in (("i", i_trace, 255), ("q", q_trace, 160)):
        tr = np.asarray(tr)
        xs = np.clip((np.arange(len(tr)) * size) // max(len(tr), 1),
                     0, size - 1)
        ys = np.clip(y0 + ((1 - tr) * 0.5 * (h2 - 1)).astype(int),
                     y0, y0 + h2 - 1)
        img[ys, xs] = shade
    img[y0 + h2 // 2, :] = np.maximum(img[y0 + h2 // 2, :], 48)
    write_png_gray(path, img)


def render_trace_ascii(trace: np.ndarray, width: int = 100,
                       height: int = 12) -> str:
    """ASCII line plot of a -1..1 trace (terminal phase-scope strip)."""
    tr = np.asarray(trace)
    step = max(len(tr) // width, 1)
    cols = [tr[i * step:(i + 1) * step].mean()
            for i in range(min(width, len(tr) // step))]
    rows = []
    for r in range(height):
        hi = 1.0 - 2.0 * r / height
        lo = 1.0 - 2.0 * (r + 1) / height
        rows.append("".join("*" if lo <= c < hi else
                            ("-" if lo <= 0 < hi else " ") for c in cols))
    return "\n".join(rows)
