"""The benchmark's traffic generator: a looped FUNcube capture.

One general generator reads every traffic file (``portbench/traffic/
<mix>.json``): trains of AO-40 frames, back to back as the satellite sends
them during a pass, on carriers at the offsets the file names for the
configuration's rate, plus complex Gaussian noise, as raw interleaved
S16LE values (what ``JavaAudio.java:58-59`` reads from a FUNcube dongle,
and what ``telemetry --device-convert`` feeds the Session).

The modulation is a frozen copy of the port's ``synth_bpsk_stream``
(``jsdr_tpu_torch/io/sources.py``): differential BPSK at 1200 bps
(symbol 1 = no phase flip), zero-order-hold pulses, the 1200 Hz baseband
carrier shifted to the offset, i.e. an analytic tone at offset + 1200 Hz;
the S16 conversion is that of ``complex_to_s16le``. Unlike the original,
the capture is circular: it holds whole frame periods of every carrier
(so whole symbols), whole cycles of every carrier (checked), and each
carrier's loop holds an even number of phase flips, so the looped stream
has no seam. The frames of the carriers start
at staggered offsets, so that the drains load evenly.

Payloads and phases are drawn from the seed with numpy's generator; the
waveform and the noise are made with torch on the device the run uses (a
``torch.Generator`` there), in float64, and rounded once to int16.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..reference.ao40 import encode_batch

BIT_RATE = 1200
FRAME_SYMBOLS = 5200
S16_SCALE = 32767.0


@dataclass
class Capture:
    """A looped capture and what it carries.

    ``raw``: int16 [n_samples, 2] interleaved I/Q (host). ``payloads``:
    [F, 256] uint8, one row per sent frame; ``carrier`` [F] its offset in
    Hz; ``last_sample`` [F] the capture index of its last sample (frames
    may wrap around the loop's seam). ``rate`` in S/s."""
    raw: np.ndarray
    rate: int
    payloads: np.ndarray
    carrier: np.ndarray
    last_sample: np.ndarray

    @property
    def n_samples(self) -> int:
        return self.raw.shape[0]

    def chunks(self, chunk_samples: int) -> list[np.ndarray]:
        """The capture as flat int16 chunks of ``chunk_samples`` I/Q pairs
        (views), the reads of a capture device."""
        if self.n_samples % chunk_samples:
            raise ValueError(f"{self.n_samples} samples are not whole chunks "
                             f"of {chunk_samples}")
        flat = self.raw.reshape(-1)
        step = 2 * chunk_samples
        return [flat[i:i + step] for i in range(0, flat.shape[0], step)]


def _draw_payloads(rng: np.random.Generator, n_carriers: int,
                   frames: int) -> np.ndarray:
    """[C, frames, 256] payloads, unique within the capture, each carrier's
    loop with an even number of 0 symbols (phase flips), so that its
    differential phase closes over the loop: a carrier whose count is odd
    has its last payload drawn again until it is even."""
    pay = rng.integers(0, 256, (n_carriers, frames, 256), dtype=np.uint8)
    syms = encode_batch(pay.reshape(-1, 256)).reshape(n_carriers, frames, -1)
    for c in range(n_carriers):
        while (syms[c] == 0).sum() % 2:
            pay[c, -1] = rng.integers(0, 256, 256, dtype=np.uint8)
            syms[c, -1] = encode_batch(pay[c, -1:])[0]
    flat = pay.reshape(-1, 256)
    if len({row.tobytes() for row in flat}) != flat.shape[0]:
        raise ValueError("payload draw repeated a payload; use another seed")
    return pay


def make_capture(rate: int, carriers, amplitude: float, noise_rms: float,
                 frame_periods: int, seed: int, device) -> Capture:
    """The looped capture of ``frame_periods`` AO-40 frame periods (5200
    symbols each) at ``rate``: a frame train on each offset of
    ``carriers`` (Hz), carrier k's frames starting k/len(carriers) of a
    period after carrier 0's, at ``amplitude`` each, plus complex noise of
    ``noise_rms`` per component. Raises if the sum could clip S16."""
    if rate % BIT_RATE:
        raise ValueError(f"rate {rate} is not a whole number of samples a "
                         f"symbol at {BIT_RATE} bps")
    carriers = [int(c) for c in carriers]
    sps = rate // BIT_RATE
    n_sym = frame_periods * FRAME_SYMBOLS
    n = n_sym * sps
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    f64 = torch.float64
    re = torch.zeros(n, dtype=f64, device=dev)
    im = torch.zeros(n, dtype=f64, device=dev)
    payloads, carrier_of, last = [], [], []
    if carriers:
        pay = _draw_payloads(rng, len(carriers), frame_periods)
        phases = rng.uniform(0.0, 2 * np.pi, len(carriers))
        t = torch.arange(n, dtype=torch.int64, device=dev)
        for k, off in enumerate(carriers):
            f = off + BIT_RATE
            if (f * n) % rate:
                raise ValueError(f"carrier {off} Hz is not whole cycles over "
                                 "the loop")
            syms = encode_batch(pay[k]).reshape(-1)
            flips = np.where(syms > 0, 1.0, -1.0)
            d = np.cumprod(flips)                       # closes over the loop
            lag = (k * FRAME_SYMBOLS) // len(carriers)  # staggered start
            d = np.roll(d, lag)
            m = torch.as_tensor(d, dtype=f64, device=dev).repeat_interleave(
                sps)
            # exact phase: (f * t) mod rate in integers, then the angle
            ang = ((f * t) % rate).to(f64) * (2 * np.pi / rate) + phases[k]
            re += amplitude * m * torch.cos(ang)
            im += amplitude * m * torch.sin(ang)
            starts = (lag + np.arange(frame_periods) * FRAME_SYMBOLS) % n_sym
            payloads.append(pay[k])
            carrier_of.append(np.full(frame_periods, off))
            last.append(((starts + FRAME_SYMBOLS) * sps - 1) % n)
        del t, m, ang
    if noise_rms > 0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) % (1 << 63))
        noise = torch.randn((2, n), generator=gen, dtype=f64, device=dev)
        re += noise_rms * noise[0]
        im += noise_rms * noise[1]
        del noise
    peak = float(torch.maximum(re.abs().max(), im.abs().max()))
    if peak * S16_SCALE >= S16_SCALE:
        raise ValueError(f"the capture clips S16 (peak {peak:.4f}); lower "
                         "the traffic's amplitude or noise")
    raw = torch.stack([torch.round(re * S16_SCALE),
                       torch.round(im * S16_SCALE)], dim=1).to(torch.int16)
    del re, im
    if payloads:
        payloads = np.concatenate(payloads)
        carrier_of = np.concatenate(carrier_of)
        last = np.concatenate(last)
    else:
        payloads = np.zeros((0, 256), np.uint8)
        carrier_of = last = np.zeros(0, np.int64)
    return Capture(raw.cpu().numpy(), rate, payloads, carrier_of, last)
