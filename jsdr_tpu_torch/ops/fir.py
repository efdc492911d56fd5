"""FIR application with carried history — plain PyTorch counterparts of
:func:`jsdr_tpu.ops.fir.fir_apply_streaming` and
:func:`jsdr_tpu.ops.fir.polyphase_decimate`.

Both are one ``conv1d`` over ``[tail ++ x]`` (a strided one for the
decimator), in true float32: :func:`jsdr_tpu_torch.runtime.device.
require_device` turns cuDNN's TF32 off. The reference runs the same
contractions as banded matmuls (bf16x3 or HIGHEST), so results agree to
float32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cplx import CF


def _fir_valid(x: torch.Tensor, taps: torch.Tensor, stride: int = 1):
    """y[k] = sum_a x[..., k*stride + n-1-a] * taps[a] over the valid
    region (n = len(taps)); x: [..., L]."""
    w = taps.to(x.dtype).flip(0).reshape(1, 1, -1)
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), w, stride=stride)
    return y.reshape(*x.shape[:-1], -1)


def _planes(x: CF) -> torch.Tensor:
    return torch.stack([x.re, x.im])


def _tail(xp: torch.Tensor, t_len: int) -> CF:
    """The carried history: the last n-1 samples of [tail ++ x]."""
    return CF(xp[0, ..., t_len:].contiguous(), xp[1, ..., t_len:].contiguous())


def fir_apply_streaming(x: CF, taps: torch.Tensor, tail: CF):
    """FIR over a block with carried history: y[t] = sum_a xp[t+n-1-a] *
    taps[a] with xp = [tail ++ x] and tail the previous n-1 samples.
    Returns (y CF [..., T], new_tail CF [..., n-1])."""
    xp = torch.cat([_planes(tail), _planes(x)], dim=-1)
    y = _fir_valid(xp, taps)
    return CF(y[0], y[1]), _tail(xp, x.shape[-1])


def polyphase_decimate(x: CF, taps: torch.Tensor, m: int, tail: CF,
                       gain: float = 1.0):
    """Decimate-by-m FIR evaluated at the kept instants only: output k =
    gain * sum_a xp[(k+1)m - 1 + n-1 - a] * taps[a] over xp = [tail ++ x]
    (FUNcubeBPSKDemod.java:470-492). x: [..., T] with T % m == 0.
    Returns (y CF [..., T//m], new_tail CF [..., n-1])."""
    t_len = x.shape[-1]
    if t_len % m:
        raise ValueError(f"block length {t_len} is not a multiple of the "
                         f"decimation {m}")
    xp = torch.cat([_planes(tail), _planes(x)], dim=-1)
    y = _fir_valid(xp[..., m - 1:], taps, stride=m) * gain
    return CF(y[0], y[1]), _tail(xp, t_len)
