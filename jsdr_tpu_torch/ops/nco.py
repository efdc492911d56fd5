"""Numerically-controlled oscillators and mixers — the port of
:mod:`jsdr_tpu.ops.nco`.

The reference advances a phase accumulator one sample at a time and looks
up 256-entry sin/cos tables (FUNcubeBPSKDemod.java:93-95, 381-397,
511-516; demod.java:423-434). Every phase increment is constant, so the
whole phase trajectory is a closed-form ramp: an elementwise op, not a
recurrence. The carried state is the scalar starting phase.

Two flavours, as in the reference:

- ``quantized``: the reference's table quantization and its non-complex
  mix quirk (i*cos, q*sin — NOT a complex multiply), needed for
  frame-level parity with the Java demodulator;
- the clean complex mixers (``mix_complex``, ``_cmix``).

Values follow the reference's float32 arithmetic op for op (float64 host
ramps rounded to float32, then float32 sums and ``fmod``), so a table
index matches the reference's at a boundary too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

SINCOS_SIZE = 256  # FUNcubeBPSKDemod.java:93
TWO_PI = 2.0 * np.pi


def quantized_cos_sin(phase: torch.Tensor, dtype=torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin via the reference's 256-entry table quantization.

    Index = ((int)(phase * 256 / 2pi)) % 256 (FUNcubeBPSKDemod.java:
    389-390); the table holds sin/cos at exact bin centres (:159-162)."""
    idx = (phase * (SINCOS_SIZE / TWO_PI)).to(torch.int32) % SINCOS_SIZE
    ang = idx.to(dtype) * (TWO_PI / SINCOS_SIZE)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def phase_ramp(n: int, phase0: torch.Tensor, inc, chunk: int = 2048
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phases of ``for t: phase += inc; wrap 2pi`` from ``phase0``: sample t
    sees phase0 + (t+1)*inc, wrapped. Returns (phases [n], final phase).

    A python-number ``inc`` (a static frequency) takes a float64 host
    ramp rounded to float32; a tensor ``inc`` takes the coarse/fine split
    (t = chunk*c + f), which bounds the float32 rounding to ~(n/chunk +
    chunk) ulps of 2pi instead of ~n."""
    dev = phase0.device
    p0 = phase0.to(torch.float32)
    if isinstance(inc, (int, float)):
        ramp = np.mod(np.arange(1, n + 1, dtype=np.float64) * float(inc),
                      TWO_PI).astype(np.float32)
        phases = torch.remainder(p0 + torch.as_tensor(ramp, device=dev),
                                 TWO_PI)
        return phases, phases[..., -1]
    inc = torch.as_tensor(inc, dtype=torch.float32, device=dev)
    t = torch.arange(1, n + 1, device=dev)
    coarse = (t // chunk).to(torch.float32)
    fine = (t % chunk).to(torch.float32)
    inc_c = torch.remainder(chunk * inc, TWO_PI)
    phases = torch.remainder(p0 + torch.remainder(coarse * inc_c, TWO_PI)
                             + fine * inc, TWO_PI)
    return phases, phases[..., -1]


def mix_quirk(i: torch.Tensor, q: torch.Tensor, phases: torch.Tensor,
              dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's non-complex mix: (i*cos(p), q*sin(p))
    (FUNcubeBPSKDemod.java:389-390 and :515-516)."""
    c, s = quantized_cos_sin(phases, dtype)
    return i * c, q * s


def mix_complex(iq: torch.Tensor, phases: torch.Tensor) -> torch.Tensor:
    """Clean complex mixer: iq * exp(-1j*phase) (down-conversion)."""
    rot = torch.polar(torch.ones_like(phases), -phases).to(iq.dtype)
    return iq * rot


def tuner_mix(i: torch.Tensor, q: torch.Tensor, phase0, inc,
              compat: bool = True):
    """Software tuner front end (FUNcubeBPSKDemod.java:366-397).

    Mixes only where the running phase is > 0 (with inc <= 0 the phase
    never goes positive, so the signal passes through — the reference's
    behaviour at :388-396). Returns (mi, mq, final phase)."""
    phase0 = torch.as_tensor(phase0, dtype=torch.float32, device=i.device)
    phases, phase_out = phase_ramp(i.shape[-1], phase0, inc)
    mi, mq = (mix_quirk(i, q, phases, dtype=i.dtype) if compat
              else _cmix(i, q, phases))
    use = phases > 0.0
    return torch.where(use, mi, i), torch.where(use, mq, q), phase_out


def _cmix(i, q, phases):
    c = torch.cos(phases).to(i.dtype)
    s = torch.sin(phases).to(i.dtype)
    return i * c + q * s, q * c - i * s
