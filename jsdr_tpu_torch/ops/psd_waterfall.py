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
runs :func:`psd_waterfall_ref` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .cplx import CF

_EPS = 1e-30
_INTENSITY = -2.55  # waterfall.java:92: 255 - psd * -2.55


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
