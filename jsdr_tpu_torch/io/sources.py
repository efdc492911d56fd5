"""Signal sources: file readers (raw S16LE / WAV) with the reference's
loop-at-EOF semantics (JavaAudio.java:252-256), and synthetic generators
(the TPU framework's equivalent of fir.java's noise/sine/NCO testbench
plus a full BPSK telemetry modulator for closed-loop decode tests).

A copy of :mod:`jsdr_tpu.io.sources` (numpy only), numbers and behaviour
unchanged, including ``read_wav``'s known fault: it rejects a fmt chunk
that comes after the data chunk (ROADMAP.md, queue 3). tests/test_torch_host_copies.py holds its outputs
byte-equal to the reference's.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..fec.ref_numpy import encode_fec40
from .convert import s16le_to_complex


def read_wav(path: str | Path) -> tuple[np.ndarray, int, int]:
    """Minimal RIFF/WAVE reader with format normalization — the analog of
    the reference's AudioSystem format-conversion fallback, which accepts
    any javax-convertible capture format and converts it to the S16
    target (JavaAudio.java:369-395). Handles integer PCM at 8 (unsigned,
    per the WAV spec), 16, 24 and 32 bits plus IEEE float 32/64
    (format tag 3, which the stdlib ``wave`` module rejects) and
    WAVE_FORMAT_EXTENSIBLE wrappers of both. Everything is normalized to
    the 16-bit full-scale convention the FLAC path already uses
    (wider widths shift down; 8-bit shifts up; float clips to +-1.0 and
    scales by 32767 so downstream s/32767 recovers the value).

    Returns (int16 interleaved samples, channels, rate).
    """
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, data = 12, None, None
    while pos + 8 <= len(raw):
        cid, size = raw[pos:pos + 4], struct.unpack_from("<I", raw, pos + 4)[0]
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = list(struct.unpack_from("<HHIIHH", body, 0))
            if fmt[0] == 0xFFFE and size >= 26:   # WAVE_FORMAT_EXTENSIBLE
                fmt[0] = struct.unpack_from("<H", body, 24)[0]
        elif cid == b"data":
            if len(body) < size:
                raise ValueError(
                    f"{path}: truncated data chunk (header declares "
                    f"{size} bytes, {len(body)} present)")
            data = body
            break          # first data chunk wins (spec allows only one)
        pos += 8 + size + (size & 1)              # chunks are word-aligned
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, channels, rate, _, _, bits = fmt
    width = max(bits // 8, 1)
    if len(data) % width:                         # trim a ragged tail byte
        data = data[: len(data) - len(data) % width]
    if tag == 1:                                  # integer PCM
        if bits == 8:                             # unsigned by spec
            s16 = ((np.frombuffer(data, np.uint8).astype(np.int16) - 128)
                   * 256)
        elif bits == 16:
            s16 = np.frombuffer(data, "<i2")
        elif bits == 24:
            b3 = np.frombuffer(data, np.uint8)[: len(data) // 3 * 3]
            b3 = b3.reshape(-1, 3).astype(np.int32)
            v = b3[:, 0] | (b3[:, 1] << 8) | (b3[:, 2] << 16)
            v = (v ^ 0x800000) - 0x800000         # sign-extend 24 -> 32
            s16 = (v >> 8).astype(np.int16)
        elif bits == 32:
            s16 = (np.frombuffer(data, "<i4") >> 16).astype(np.int16)
        else:
            raise ValueError(f"{path}: unsupported PCM width {bits}")
    elif tag == 3:                                # IEEE float
        if bits == 32:
            f = np.frombuffer(data, "<f4")
        elif bits == 64:
            f = np.frombuffer(data, "<f8")
        else:
            raise ValueError(f"{path}: unsupported float width {bits}")
        s16 = np.round(np.clip(f, -1.0, 1.0) * 32767.0).astype(np.int16)
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {tag}")
    return s16, int(channels), int(rate)


class FileSource:
    """Streams complex64 IQ blocks from a raw S16LE, WAV, or FLAC file.

    ``loop=True`` rewinds at EOF like the reference's file sources. WAV
    files of any common width (8/16/24/32-bit PCM, 32/64-bit float) are
    normalized to 16-bit full scale (``read_wav`` — the analog of the
    reference's AudioSystem format-conversion fallback,
    JavaAudio.java:369-395). FLAC is decoded by the in-tree codec
    (io/flac.py, pure Python) — the analog of the reference's
    transparent jflac javax SPI ingestion (Makefile:9-10).
    """

    def __init__(self, path: str | Path, rate: int = 96000, channels: int = 2,
                 i_corr: int = 0, q_corr: int = 0, loop: bool = False):
        self.path = Path(path)
        self.channels = channels
        self.rate = rate
        self.i_corr = i_corr
        self.q_corr = q_corr
        self.loop = loop
        if self.path.suffix.lower() == ".wav":
            self._data, self.channels, self.rate = read_wav(self.path)
        elif self.path.suffix.lower() == ".flac":
            from .flac import read_flac
            samples, rate, bps = read_flac(self.path)
            self.channels = samples.shape[1]
            self.rate = rate
            shift = max(bps - 16, 0)     # normalize to 16-bit full scale
            self._data = (samples >> shift).astype(np.int16).reshape(-1)
        else:
            self._data = np.fromfile(self.path, dtype="<i2")

    def blocks(self, block_samples: int) -> Iterator[np.ndarray]:
        """Yield complex64 blocks of ``block_samples`` IQ samples."""
        vals_per_sample = self.channels
        n = block_samples * vals_per_sample
        pos = 0
        data = self._data
        while True:
            if pos + n > len(data):
                if not self.loop:
                    return
                pos = 0
            chunk = data[pos:pos + n]
            pos += n
            yield s16le_to_complex(chunk, self.channels, self.i_corr, self.q_corr)

    def raw_blocks(self, block_samples: int) -> Iterator[np.ndarray]:
        """Yield raw interleaved int16 blocks (no conversion) — the
        pre-conversion capture stream for device-side convert sessions
        and raw record taps (JavaAudio.java:261-265)."""
        n = block_samples * self.channels
        pos = 0
        data = self._data
        while True:
            if pos + n > len(data):
                if not self.loop:
                    return
                pos = 0
            yield data[pos:pos + n]
            pos += n

    def all(self) -> np.ndarray:
        return s16le_to_complex(self._data, self.channels, self.i_corr, self.q_corr)


def open_source(name: str, **kw) -> FileSource:
    """Open ``file:<path>`` source names (jsdr.java:256-265 CLI style)."""
    if name.startswith("file:"):
        name = name[5:]
    return FileSource(name, **kw)


def synth_sine(n: int, freq: float, rate: float, amplitude: float = 0.5,
               analytic: bool = True, phase0: float = 0.0) -> np.ndarray:
    """Complex tone (analytic) or real tone in I with Q=0 (like the
    sine4410 fixtures, which show mirrored +/- lines)."""
    t = np.arange(n, dtype=np.float64)
    ang = 2 * np.pi * freq * t / rate + phase0
    i = amplitude * np.cos(ang)
    q = amplitude * np.sin(ang) if analytic else np.zeros_like(i)
    return (i + 1j * q).astype(np.complex64)


def synth_noise(n: int, amplitude: float = 0.25,
                seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (amplitude * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def synth_bpsk_stream(payloads: np.ndarray, rate: int = 96000,
                      carrier_offset: float = 12000.0,
                      amplitude: float = 0.8,
                      preamble_bits: int = 600,
                      tail_bits: int = 16,
                      noise_rms: float = 0.0,
                      seed: int = 0,
                      phase0: float = 0.3) -> np.ndarray:
    """Modulate AO-40 frames as the FUNcube downlink would appear in an
    IQ capture: differential BPSK at 1200 bps (symbol 1 = no phase flip,
    matching the demodulator's decision di<0 at
    FUNcubeBPSKDemod.java:539-546), 1200 Hz baseband carrier, shifted to
    ``carrier_offset`` — i.e. an analytic tone at offset+1200 Hz, BPSK
    modulated, at the input rate.

    payloads: [F, 256] uint8. Returns complex64 [T].
    """
    payloads = np.atleast_2d(np.asarray(payloads, dtype=np.uint8))
    rng = np.random.default_rng(seed)
    sym = np.concatenate([
        rng.integers(0, 2, preamble_bits),
        np.concatenate([encode_fec40(p) for p in payloads]),
        rng.integers(0, 2, tail_bits),
    ]).astype(np.int8)
    # differential: d_k = d_{k-1} * (+1 if sym else -1)
    flips = np.where(sym > 0, 1, -1)
    d = np.cumprod(flips).astype(np.float64)
    sps = rate // 1200                      # input samples per bit
    m = np.repeat(d, sps)                   # ZOH pulse shaping
    t = np.arange(m.shape[0], dtype=np.float64)
    ang = 2 * np.pi * (carrier_offset + 1200.0) * t / rate + phase0
    sig = amplitude * m * np.exp(1j * ang)
    if noise_rms > 0:
        sig = sig + noise_rms * (rng.standard_normal(len(t)) +
                                 1j * rng.standard_normal(len(t)))
    return sig.astype(np.complex64)
