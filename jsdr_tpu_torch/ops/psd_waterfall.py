"""Fused |X|^2 -> dBFS -> max-decimate -> 8-bit waterfall line — the port
of ``jsdr_tpu/ops/pallas_kernels.py::_psd_waterfall_kernel`` (wrapper
``psd_waterfall``).

Over [B, N] spectrum rows: power = (re^2 + im^2) * (2/N)^2, db =
10*log10(max(power, 1e-30)), the maximum of db over each of ``width``
groups of N/width bins, intensity = clip(255 - max * -2.55, 0, 255)
truncated to u8 (waterfall.java:90-107), and the line rolled by
width // 2 so that 0 Hz sits mid-screen (waterfall.java:96-106; the
reference's jnp version, ``_psd_waterfall_ref``). :func:`psd_waterfall`
launches the CUDA kernel (``csrc/psd_waterfall.cu``) for CUDA tensors and
runs :func:`psd_waterfall_ref` for CPU tensors. :func:`_psd_waterfall_tiles`
is the kernel's walk (tiles of :func:`tile_groups` whole groups, a group
larger than a slab walked alone) in plain PyTorch; only the tests call it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .cplx import CF

_EPS = 1e-30
_INTENSITY = -2.55  # waterfall.java:92: 255 - psd * -2.55
# csrc/psd_waterfall.cu: threads a CTA, bins of dB a CTA keeps in shared
# memory, CTAs an SM wanted at few rows; an H100's SMs
THREADS = 256
SLAB = 2048
CTAS_PER_SM = 4
H100_SMS = 132


def power_scale(n: int) -> float:
    """(2/N)^2 as the float32 both versions multiply by."""
    return float(np.float32((2.0 / n) ** 2))


def psd_waterfall_ref(spec: CF, width: int):
    """Plain PyTorch version (counterpart of ``_psd_waterfall_ref``,
    pallas_kernels.py:29-41): returns (db [B, N] f32, line [B, width]
    u8). Every operation rounds to float32 in the kernel's order."""
    n = spec.shape[-1]
    power = (spec.re * spec.re + spec.im * spec.im) * power_scale(n)
    db = 10.0 * torch.log10(torch.clamp_min(power, _EPS))
    dec = db.reshape(*db.shape[:-1], width, n // width).amax(dim=-1)
    inten = torch.clamp(255.0 - dec * _INTENSITY, 0.0, 255.0).to(torch.uint8)
    return db, torch.roll(inten, width // 2, dims=-1)


def tile_groups(n: int, width: int, rows: int, n_sm: int = H100_SMS) -> int:
    """Groups a CTA of the kernel takes (the C rule ``tile_groups``): as
    many tiles a row as give rows * tiles >= CTAS_PER_SM CTAs an SM, but
    no tile over SLAB bins (one group if a group is larger); then rounded
    up so that a tile spans a multiple of 4 bins (16-byte aligned tiles
    where n is a multiple of 4), back by that much if the tile outgrew a
    slab, and at most width."""
    step = n // width
    g_max = 1 if step >= SLAB else SLAB // step
    want = -(-CTAS_PER_SM * n_sm // rows)
    tiles = max(-(-width // g_max), min(width, want))
    g = -(-width // tiles)
    align = 1 if n % 4 else 4 // (4 if step % 4 == 0 else
                                  2 if step % 2 == 0 else 1)
    g = -(-g // align) * align
    if g * step > SLAB and g > 1:
        g -= align
    return max(1, min(g, width))


def _psd_waterfall_tiles(spec: CF, width: int, g: int | None = None):
    """The kernel's walk in plain PyTorch, each value in
    :func:`psd_waterfall_ref`'s arithmetic, so the two agree bit for bit.
    A CTA takes the ``g`` whole groups (:func:`tile_groups` by default)
    from group g0 of a row: the dB of their bins, written to db and kept
    as the tile, then each group's maximum from the tile, its intensity
    at (g0 + group + width // 2) % width of the line. A tile of one group
    larger than SLAB bins is walked as the kernel does: each of THREADS
    threads takes a running maximum of the bins it reads (float4 v of the
    row's aligned part where v % THREADS is its index, then the rest one
    at a time), then the maximum over the threads. Returns what
    :func:`psd_waterfall` returns. Nothing on the main path calls it."""
    b, n = spec.shape
    step, half = n // width, width // 2
    g = min(tile_groups(n, width, b) if g is None else g, width)
    cf = power_scale(n)
    db = torch.empty((b, n), dtype=torch.float32)
    line = torch.empty((b, width), dtype=torch.uint8)
    for g0 in range(0, width, g):
        gn = min(g, width - g0)
        lo, hi = g0 * step, (g0 + gn) * step
        power = (spec.re[:, lo:hi] * spec.re[:, lo:hi]
                 + spec.im[:, lo:hi] * spec.im[:, lo:hi]) * cf
        tile = 10.0 * torch.log10(torch.clamp_min(power, _EPS))
        db[:, lo:hi] = tile
        if gn * step <= SLAB or gn > 1:
            mx = tile.reshape(b, gn, step).amax(dim=-1)
        else:
            mx = torch.stack([_thread_max(tile[r], (r * n + lo) % 4 == 0)
                              for r in range(b)])[:, None]
        inten = torch.clamp(255.0 - mx * _INTENSITY, 0.0, 255.0)
        line[:, (g0 + torch.arange(gn) + half) % width] = inten.to(torch.uint8)
    return db, line


def _thread_max(tile: torch.Tensor, aligned: bool) -> torch.Tensor:
    """The kernel's maximum over one group's bins: per thread over the
    float4s (aligned) or bins it walks, then over the threads."""
    cnt = tile.shape[0]
    done = 4 * (cnt // 4) if aligned else 0
    ninf = torch.tensor(float("-inf"))
    per = torch.full((THREADS,), float("-inf"))
    if done:
        v = tile[:done].reshape(-1, 4).amax(dim=-1)        # float4 v
        v = torch.cat([v, ninf.expand((-v.shape[0]) % THREADS)])
        per = torch.maximum(per, v.reshape(-1, THREADS).amax(dim=0))
    rest = tile[done:]
    if rest.shape[0]:                                  # one bin at a time
        rest = torch.cat([rest, ninf.expand((-rest.shape[0]) % THREADS)])
        per = torch.maximum(per, rest.reshape(-1, THREADS).amax(dim=0))
    return per.amax()


def psd_waterfall(spec: CF, width: int = 960):
    """[B, N] spectrum (a CF pair of float32 planes) -> (psd_db [B, N] f32,
    line [B, width] u8). ``width`` must divide N.

    CPU tensors run :func:`psd_waterfall_ref`; CUDA tensors launch the
    kernel (and count the launch in ``psd_waterfall.launches``)."""
    if spec.re.dim() != 2:
        raise ValueError(f"psd_waterfall: want [B, N] rows, got "
                         f"{tuple(spec.shape)}")
    b, n = spec.shape
    dev = spec.re.device
    if width <= 0 or n % width:
        raise ValueError(f"psd_waterfall: width {width} must divide the FFT "
                         f"size {n}")
    for name, x in (("spec.re", spec.re), ("spec.im", spec.im)):
        _build.check_tensor("psd_waterfall", name, x, (b, n), torch.float32,
                            dev)
    if dev.type == "cpu":
        return psd_waterfall_ref(spec, width)
    if dev.type != "cuda":
        raise ValueError(f"psd_waterfall: unsupported device {dev}")

    db = torch.empty((b, n), dtype=torch.float32, device=dev)
    line = torch.empty((b, width), dtype=torch.uint8, device=dev)
    if b:
        lib = _build.kernels()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.jsdr_psd_waterfall(
                spec.re.data_ptr(), spec.im.data_ptr(), db.data_ptr(),
                line.data_ptr(), b, n, width, power_scale(n), stream)
        _build.check(code, "psd_waterfall")
        psd_waterfall.launches += 1
    return db, line


psd_waterfall.launches = 0
