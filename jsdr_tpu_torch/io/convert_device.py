"""Device-side sample conversion: upload raw int16 and convert on the card —
the port of :mod:`jsdr_tpu.io.convert_device`.

Shipping the raw S16LE values to the device halves the transfer size
against a float32 planar pair and moves the convert loop off the host.
Semantics identical to ``io.convert.s16le_to_complex`` (wrapping 16-bit
DC correction, then the 1/32767 scale, JavaAudio.java:275-293); the
output is a planar :class:`~jsdr_tpu_torch.ops.cplx.CF` pair.

Uploads to a CUDA device go through pinned host memory without a
synchronise, so the host can frame and convert the next block while the
card still works on this one (what JAX's asynchronous dispatch gave the
reference).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cplx import CF

_SCALE = float(np.float32(1.0 / 32767.0))


def _to_device(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """Host array -> tensor on ``device``; a CUDA copy is enqueued from a
    pinned buffer and does not wait for the device."""
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def upload_raw(raw: bytes | np.ndarray,
               device: torch.device | str) -> torch.Tensor:
    """Host bytes -> device int16 tensor (half the bytes of a float pair)."""
    s = (np.frombuffer(raw, dtype="<i2") if not isinstance(raw, np.ndarray)
         else np.ascontiguousarray(raw, dtype="<i2"))
    return _to_device(s, device)


def upload_cf(iq: np.ndarray, device: torch.device | str) -> CF:
    """Host complex64 block -> CF on ``device`` (host split, then upload)."""
    iq = np.asarray(iq)
    return CF(_to_device(np.ascontiguousarray(iq.real, np.float32), device),
              _to_device(np.ascontiguousarray(iq.imag, np.float32), device))


def s16_to_cf(samples: torch.Tensor, i_corr: int, q_corr: int,
              channels: int = 2) -> CF:
    """Interleaved int16 I/Q on the device -> planar CF float32.

    ``samples``: [2N] (channels=2) or [N] (mono -> Q=0) int16. The DC
    correction is added with Java ``short`` wrap-around semantics
    (JavaAudio.java:275-293): computed in int32, wrapped to
    [-32768, 32767]."""
    s = samples.to(torch.int32)
    if channels == 2:
        s = s.view(-1, 2)
        i, q = s[:, 0], s[:, 1]
    else:
        i, q = s, torch.zeros_like(s)

    def wrap16(x):
        return ((x + 32768) & 0xFFFF) - 32768

    i = wrap16(i + int(i_corr))
    q = wrap16(q + int(q_corr))
    return CF((i.to(torch.float32) * _SCALE).contiguous(),
              (q.to(torch.float32) * _SCALE).contiguous())
