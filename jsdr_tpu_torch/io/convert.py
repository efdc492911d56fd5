"""Sample format conversion.

Reference semantics (JavaAudio.java:275-293): interleaved S16LE I/Q;
the I/Q DC correction is added AS A WRAPPING 16-BIT INTEGER before the
float scale by 1/32767 (Java ``short`` addition overflows silently —
reproduced here with uint16 arithmetic). Mono input maps to Q = 0.

A copy of :mod:`jsdr_tpu.io.convert`, native C++ fast path included
(:mod:`jsdr_tpu_torch.io.native`, the port's own build of the sources).
"""

from __future__ import annotations

import numpy as np


def s16le_to_complex(raw: bytes | np.ndarray, channels: int = 2,
                     i_corr: int = 0, q_corr: int = 0) -> np.ndarray:
    """Interleaved S16LE bytes -> complex64 IQ, scaled by 1/32767.

    Uses the native C++ converter (native/jsdr_io.cpp) when built;
    numpy fallback is semantically identical.
    """
    s = np.frombuffer(raw, dtype="<i2") if not isinstance(raw, np.ndarray) else raw
    from . import native
    out = native.s16le_to_complex_native(s, channels, i_corr, q_corr)
    if out is not None:
        return out
    if channels == 2:
        s = s.reshape(-1, 2)
        i = (s[:, 0].astype(np.uint16) + np.uint16(i_corr & 0xFFFF)).astype(np.int16)
        q = (s[:, 1].astype(np.uint16) + np.uint16(q_corr & 0xFFFF)).astype(np.int16)
    else:
        i = (s.astype(np.uint16) + np.uint16(i_corr & 0xFFFF)).astype(np.int16)
        q = np.zeros_like(i)
    scale = np.float32(1.0 / 32767.0)
    return (i.astype(np.float32) * scale + 1j * (q.astype(np.float32) * scale)
            ).astype(np.complex64)


def complex_to_s16le(iq: np.ndarray) -> bytes:
    """complex64 IQ -> interleaved S16LE bytes (recorder/test fixtures)."""
    out = np.empty((iq.shape[0], 2), dtype="<i2")
    out[:, 0] = np.clip(np.round(iq.real * 32767.0), -32768, 32767)
    out[:, 1] = np.clip(np.round(iq.imag * 32767.0), -32768, 32767)
    return out.tobytes()
