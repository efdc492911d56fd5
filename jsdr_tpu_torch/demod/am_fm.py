"""AM / narrow-FM / wide-FM audio demodulation — the port of
:mod:`jsdr_tpu.demod.am_fm` (the per-sample loop at demod.java:398-483).

One block at a time, [T] or [S, T] streams at once: optional 21-tap
band-pass select, optional down-shift by the filter's low edge, mode
demodulation, block AGC. The carried state (FIR delay tail, carrier
phase, FM previous sample) is an explicit tuple of tensors, so streams
chain seamlessly across blocks and a checkpoint holds the reference's
leaves (demod.java:60-69 keeps them as mutable fields).

A batched ``[S, T]`` call equals ``jax.vmap`` of the reference's
``demod_block`` over the streams: reductions (AM mean, block max) run per
stream along the last axis, and the state carries a leading ``S``.

The values follow the reference's arithmetic: the down-conversion ramp is
built in float64 on the host and rounded to float32 (cached on the
device, so a step uploads nothing and reads nothing back), the mix keeps
the angle-sum order, the carried phase wraps with a floor-mod equal to
``jnp.mod``, and the AGC multiplies by the reciprocal of the block max.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.cplx import CF
from ..ops.fir import bandpass_weights, fir_apply_streaming
from ..runtime.device import device_table
from ..runtime.state import tree_map

TWO_PI = 2.0 * np.pi


class Mode(enum.IntEnum):
    """demod.java:39-43."""
    OFF = 0
    RAW = 1
    AM = 2
    NFM = 3
    WFM = 4


class AmFmConfig(NamedTuple):
    """The reference's fields, so a config reads the same in either
    package. ``fir_precision`` names a TPU matmul pass count there; here
    both values compute the FIR in true float32."""

    rate: int
    mode: int = int(Mode.OFF)
    dofir: bool = False
    dodwn: bool = False
    doagc: bool = False
    flo: int | None = None      # band-pass low edge Hz (None = all-pass)
    fhi: int | None = None
    ntaps: int = 21             # fixed order 20 (demod.java:82-85)
    fir_precision: str = "highest"

    def weights(self, device: torch.device | str) -> torch.Tensor:
        return _weights(self.ntaps, self.flo, self.fhi, float(self.rate),
                        torch.device(device))

    def phi(self) -> float:
        """Down-conversion carrier phase step (demod.java:368)."""
        if self.flo is None:
            return 0.0
        return TWO_PI * (self.flo / float(self.rate))


class AmFmState(NamedTuple):
    fir_tail: CF            # [..., ntaps-1] planar FIR history
    car: torch.Tensor       # [...] f32 carrier phase in [0, 2pi)
    last_iq: torch.Tensor   # [..., 2] f32 previous sample (FM discriminator)

    @staticmethod
    def init(cfg: AmFmConfig, device: torch.device | str,
             n_streams: Optional[int] = None) -> "AmFmState":
        """Zero state on ``device``: unbatched (``fir_tail`` [ntaps-1],
        ``car`` [], ``last_iq`` [2]) or, with ``n_streams=S``, each leaf
        with a leading S."""
        lead = () if n_streams is None else (n_streams,)

        def z(*shape):
            return torch.zeros((*lead, *shape), dtype=torch.float32,
                               device=device)

        return AmFmState(fir_tail=CF(z(cfg.ntaps - 1), z(cfg.ntaps - 1)),
                         car=z(), last_iq=z(2))


def state_from_numpy(st, device: torch.device | str) -> AmFmState:
    """A reference ``jsdr_tpu.demod.am_fm.AmFmState`` whose leaves are
    numpy arrays (``AmFmState.init``, or ``np.asarray`` of a JAX step's
    output) -> this package's state on ``device``."""
    like = AmFmState.init(AmFmConfig(rate=1), "meta")    # the port's types
    return tree_map(lambda _, x: torch.as_tensor(np.array(x, np.float32),
                                                 device=device), like, st)


def state_to_numpy(st: AmFmState) -> AmFmState:
    """The reverse of :func:`state_from_numpy`: the same tuple structure
    with numpy leaves."""
    return tree_map(lambda x: x.cpu().numpy(), st)


@device_table(maxsize=16)
def _weights(ntaps: int, flo, fhi, rate: float, device: torch.device):
    return bandpass_weights(ntaps, flo, fhi, rate, device=device)


@device_table(maxsize=16)
def _ramp(n: int, phi: float, device: torch.device) -> torch.Tensor:
    """mod(t*phi, 2pi) for t < n, float64 on the host rounded to float32
    (long streams accumulate no float32 phase error), uploaded once."""
    ramp = np.mod(np.arange(n, dtype=np.float64) * phi,
                  TWO_PI).astype(np.float32)
    return torch.as_tensor(ramp, device=device)


def _mod_2pi(x: torch.Tensor) -> torch.Tensor:
    """Floor-mod by float32 2pi with ``jnp.mod``'s rule: the exact
    remainder, moved into [0, 2pi) when its sign differs from 2pi's."""
    r = torch.fmod(x, TWO_PI)
    return torch.where((r != 0) & (r < 0), r + TWO_PI, r)


def demod_block(iq: CF, cfg: AmFmConfig, state: AmFmState
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           AmFmState]:
    """Demodulate one block: ``iq`` a CF of [T] or [S, T] float32 on the
    state's device.

    Returns (audio [..., T] float32 in -1..1, block max [...], block avg
    [...], new state); max and avg stay tensors. fmgain = rate/5000 (NFM)
    or rate/75000 (the other modes), demod.java:409."""
    dev = iq.re.device
    mode = int(cfg.mode)
    x = iq
    fir_tail = state.fir_tail
    if cfg.dofir:
        x, fir_tail = fir_apply_streaming(x, cfg.weights(dev), fir_tail)
    car = state.car
    if cfg.dodwn:
        # carrier retards by phi per sample, evaluated before the decrement
        # (demod.java:423-434): x * (cos(car + ramp) - j sin(car + ramp))
        # by the angle sum; cos/sin of the shared ramp once for every
        # stream, the carried phase entering as two values a stream
        n = x.shape[-1]
        phi = cfg.phi()
        ramp = _ramp(n, phi, dev)
        delta = float(np.float32(np.mod(n * phi, TWO_PI)))
        cr, sr = torch.cos(ramp), torch.sin(ramp)
        cc, cs = torch.cos(car)[..., None], torch.sin(car)[..., None]
        o_re, o_im = cc * cr + cs * sr, cs * cr - cc * sr
        x = CF(x.re * o_re - x.im * o_im, x.re * o_im + x.im * o_re)
        car = _mod_2pi(car - delta)

    i, q = x.re, x.im
    avg = torch.zeros(i.shape[:-1], dtype=torch.float32, device=dev)
    last_iq = state.last_iq
    if mode == Mode.OFF:
        audio = torch.zeros_like(i)
        mx = torch.zeros_like(avg)
    elif mode == Mode.RAW:
        audio = i
        mx = audio.abs().amax(dim=-1)
    elif mode == Mode.AM:
        mag = torch.sqrt(i * i + q * q)
        avg = mag.mean(dim=-1)
        audio = mag - avg[..., None]
        mx = mag.amax(dim=-1) - avg
    else:  # NFM / WFM quadrature-delay discriminator (demod.java:453-460)
        fmgain = float(np.float32(
            cfg.rate / (5000.0 if mode == Mode.NFM else 75000.0)))
        li = torch.cat([last_iq[..., 0:1], i[..., :-1]], dim=-1)
        lq = torch.cat([last_iq[..., 1:2], q[..., :-1]], dim=-1)
        audio = (li * q - lq * i) * fmgain
        mx = audio.abs().amax(dim=-1)
        last_iq = torch.stack([i[..., -1], q[..., -1]], dim=-1)
    if cfg.doagc:
        gain = torch.where(mx > 0, 1.0 / mx, torch.ones_like(mx))
        audio = audio * gain[..., None]
    return audio, mx, avg, AmFmState(fir_tail=fir_tail, car=car,
                                     last_iq=last_iq)


def audio_to_s16_stereo(audio: torch.Tensor) -> torch.Tensor:
    """Duplicate mono audio into interleaved S16LE stereo frames
    (demod.java:473-477): clip audio*32767 to the int16 range, truncate
    toward zero, then [v, v] per sample, flattened."""
    v = (audio * 32767.0).clamp(-32768, 32767).to(torch.int16)
    return torch.stack([v, v], dim=-1).reshape(-1)
