"""FUNcube 1200 bps BPSK telemetry demodulator — the PyTorch port of
:mod:`jsdr_tpu.demod.bpsk`, every tuning mode of its front end.

Per block of [S, T] stream rows (T a multiple of 8*decim):

1. the front end, picked per batch as the reference's
   ``_front_dispatch`` picks it (:func:`bpsk_block_batch` names the mode):

   - "pattern" (every tuning's quantized NCO index sequence is
     128-periodic, ``pattern_mix_ok``: e.g. any multiple of 750 Hz at
     96 kS/s): tuner mix + 27-tap decimating FIR x 0.9*32768 as ONE
     kernel, :func:`jsdr_tpu_torch.ops.mix_decimate.mix_decimate`;
   - "general" (tunings that are multiples of 0.1 Hz): the exact
     integer-numerator mix at full length, then
     :func:`jsdr_tpu_torch.ops.fir.polyphase_decimate` (plain torch, as
     the reference's is plain XLA);
   - "static" (sub-0.1 Hz tunings): the float64 host ramp mix, then the
     same decimator;
   - "dofft" (the FFT auto-tuner, :mod:`jsdr_tpu_torch.demod.fft_tuner`):
     its real-only feed through kernel 1 with an all-ones pattern;
   - "mixed:<manual mode>": both front ends, selected per stream by its
     dofft flag;
2. 1200 Hz VCO mix (exactly pi/4 per decimated sample) and the 65-tap
   matched filter with its carried tail (plain torch); with
   ``BpskConfig.fuse_mf`` in the modes the reference fuses (dofft,
   pattern, mixed:pattern) steps 1 and 2 are ONE kernel,
   :func:`jsdr_tpu_torch.ops.mix_decimate_mf.mix_decimate_mf`;
3. bit-timing recovery — the timing kernel,
   :func:`jsdr_tpu_torch.ops.timing_kernel.timing_recover_batch`, or with
   ``BpskConfig.compat_scan`` the per-sample scan
   :func:`_timing_scan_batch` in the Java original's order (a torch loop,
   no kernel: for fp-order parity checks, slow on a card);
4. bit compaction, stride-80 sync correlation at every bit position and
   soft-window extraction (plain torch).

:func:`bpsk_block_batch_spectrum` adds the display spectrum to the same
step: one kernel (``ops.spectrum_front``) reads the input once for the
waterfall and for step 1, or, where the reference's rule says so (every
mode but pattern, and ``fuse_mf``), the staged pair runs
(``ops.spectrum_fused.spectrum_waterfall``, then :func:`bpsk_block_batch`).

Values, layouts and carried state match the reference; where the JAX code
avoids TPU gathers (one-hot row matmuls, masked reductions) this port
indexes directly.
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..fec.tables import SYNC_VECTOR

from ..ops.cplx import CF
from ..ops.fir import fir_apply_streaming, polyphase_decimate
from ..ops.mix_decimate import mix_decimate
from ..ops.mix_decimate_mf import mix_decimate_mf
from ..ops.spectrum import bin_to_hz
from ..ops.spectrum_front import sf_geometry, spectrum_front_fused
from ..ops.spectrum_fused import spectrum_waterfall
from ..ops.timing_kernel import timing_recover_batch
from ..runtime.device import device_table
from ..runtime.state import tree_map
from .fft_tuner import FftTunerState, fft_tuner_blocks, fft_tuner_init

# Constants copied from jsdr_tpu/demod/bpsk.py:52-107 (that module imports
# jax); tests/test_torch_constants.py holds them equal to the reference.
DOWN_SAMPLE_RATE = 9600
BIT_RATE = 1200
SAMPLES_PER_BIT = DOWN_SAMPLE_RATE // BIT_RATE          # 8
HOWARD_FUDGE_FACTOR = 0.9 * 32768.0                      # :56, :469
BIT_SMOOTH1 = 1.0 / 200.0
BIT_SMOOTH2 = 1.0 / 800.0
ENERGY_GATE = 100.0                                      # :544
SYNC_THRESHOLD = 45                                      # :560
FEC_BITS = 5200
SINCOS_SIZE = 256
TWO_PI = 2.0 * np.pi

# 27-tap decimation low-pass (FUNcubeBPSKDemod.java:27-55)
DS_FILTER = np.array([
    -6.103515625000e-004, -1.220703125000e-004, +2.380371093750e-003,
    +6.164550781250e-003, +7.324218750000e-003, +7.629394531250e-004,
    -1.464843750000e-002, -3.112792968750e-002, -3.225708007813e-002,
    -1.617431640625e-003, +6.463623046875e-002, +1.502380371094e-001,
    +2.231445312500e-001, +2.518310546875e-001, +2.231445312500e-001,
    +1.502380371094e-001, +6.463623046875e-002, -1.617431640625e-003,
    -3.225708007813e-002, -3.112792968750e-002, -1.464843750000e-002,
    +7.629394531250e-004, +7.324218750000e-003, +6.164550781250e-003,
    +2.380371093750e-003, -1.220703125000e-004, -6.103515625000e-004,
])

# 65-tap root-raised-cosine matched filter (FUNcubeBPSKDemod.java:58-77)
DM_FILTER = np.array([
    -0.0101130691, -0.0086975143, -0.0038246093, +0.0033563764,
    +0.0107237026, +0.0157790936, +0.0164594107, +0.0119213911,
    +0.0030315224, -0.0076488191, -0.0164594107, -0.0197184277,
    -0.0150109226, -0.0023082460, +0.0154712381, +0.0327423589,
    +0.0424493086, +0.0379940454, +0.0154712381, -0.0243701991,
    -0.0750320094, -0.1244834076, -0.1568500423, -0.1553748911,
    -0.1061032953, -0.0015013786, +0.1568500423, +0.3572048240,
    +0.5786381191, +0.7940228249, +0.9744923010, +1.0945250059,
    +1.1366117829, +1.0945250059, +0.9744923010, +0.7940228249,
    +0.5786381191, +0.3572048240, +0.1568500423, -0.0015013786,
    -0.1061032953, -0.1553748911, -0.1568500423, -0.1244834076,
    -0.0750320094, -0.0243701991, +0.0154712381, +0.0379940454,
    +0.0424493086, +0.0327423589, +0.0154712381, -0.0023082460,
    -0.0150109226, -0.0197184277, -0.0164594107, -0.0076488191,
    +0.0030315224, +0.0119213911, +0.0164594107, +0.0157790936,
    +0.0107237026, +0.0033563764, -0.0038246093, -0.0086975143,
    -0.0101130691,
])

# VCO: phase advances exactly pi/4 per decimated sample
_VCO_ANG = (np.arange(1, 9) % 8) * (TWO_PI / 8.0)   # phase of sample k ~ (k+1)
_VCO_COS = np.cos(_VCO_ANG).astype(np.float32)
_VCO_SIN = np.sin(_VCO_ANG).astype(np.float32)

NU_SCALE = 10                 # tuner numerator units per Hz (0.1 Hz)

_SYNC = np.asarray(SYNC_VECTOR, dtype=np.int32)     # [65] of +/-1


# The tables on a device, uploaded once per device and kept: a step makes
# no pageable host-to-device copy (which waits for the card, and which a
# CUDA graph cannot capture). Callers must not write to them. Tables that
# follow a stage's tunings and shapes sit in bounded caches; a graphed
# step holds those its graphs read (:func:`~jsdr_tpu_torch.runtime.device.
# device_table`, :class:`~jsdr_tpu_torch.runtime.graph.GraphStep`).

@device_table(maxsize=None)
def _ds_taps(dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(DS_FILTER, dtype=torch.float32, device=dev)


@device_table(maxsize=None)
def _mf_taps(dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(DM_FILTER, dtype=torch.float32, device=dev)


@device_table(maxsize=None)
def _vco_tables(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(_VCO_COS, device=dev),
            torch.as_tensor(_VCO_SIN, device=dev))


@device_table(maxsize=None)
def _sync_taps(dev: torch.device) -> torch.Tensor:
    """The sync vector as float32 [1, 1, 65] conv1d weights."""
    return torch.as_tensor(_SYNC, dtype=torch.float32, device=dev
                           ).view(1, 1, -1)


@device_table(maxsize=256)
def _host_vector(values: tuple, dtype: torch.dtype,
                 dev: torch.device) -> torch.Tensor:
    """A per-stream host vector (tunings, flags) on ``dev``, uploaded once
    for the blocks that share it."""
    return torch.as_tensor(values, dtype=dtype, device=dev)


def _flags(values, s: int) -> tuple:
    """A bool or [S] bools as a tuple of S bools."""
    return tuple(np.broadcast_to(np.asarray(values, bool), (s,)).tolist())


class BpskConfig(NamedTuple):
    rate: int = 96000          # input sample rate
    tuning: float = 12000.0    # NCO Hz for streams without their own
    max_hits_per_block: int = 4
    dofft: bool = False        # FFT auto-tune front end (doBufferFFT)
    track_high: bool = False   # auto-tune searches the upper half-band
    compat_scan: bool = False  # per-sample timing scan in the Java
                               # original's fp order (_timing_scan_batch);
                               # forces fuse_mf off
    fuse_mf: bool = False      # VCO + matched filter in the front-end
                               # kernel (mix_decimate_mf) where the
                               # reference fuses (dofft, pattern,
                               # mixed:pattern); the spectrum step then
                               # takes its staged branch

    @property
    def decim(self) -> int:
        return self.rate // DOWN_SAMPLE_RATE


class TimingState(NamedTuple):
    e_ema: torch.Tensor     # [S, 8] f32 smoothed bit energy per phase
    pos: torch.Tensor       # [S] i32 dmBitPos (always 0 between blocks)
    peak: torch.Tensor      # [S] i32 dmPeakPos
    new_peak: torch.Tensor  # [S] i32 dmNewPeak
    e_out: torch.Tensor     # [S] f32 dmEnergyOut
    last_iq: torch.Tensor   # [S, 2] f32 dmLastIQ


class BpskState(NamedTuple):
    tu_phase: torch.Tensor  # [S] f32 tuner NCO phase numerator in
                            # [0, NU_SCALE*rate)
    ds_tail: CF             # [S, 26] decimator history (mixed domain)
    vco_idx: torch.Tensor   # [S] i32 decimated-sample counter mod 8
    mf_tail: CF             # [S, 64] matched-filter history
    timing: TimingState
    ring: torch.Tensor      # [S, 5199] i8 last bits (+1/-1; 0 unfilled)
    counters: torch.Tensor  # [S, 4] i32: raw, ds, bit, fec(sync hits)
    fft_tuner: FftTunerState


class BpskBlockOut(NamedTuple):
    windows: torch.Tensor   # [S, max_hits, 5200] uint8 soft symbols
    hit_corr: torch.Tensor  # [S, max_hits] i32 sync correlation per hit
    n_hits: torch.Tensor    # [S] i32
    bits: torch.Tensor      # [S, max_bits] i8 +/-1 (0 pad)
    n_bits: torch.Tensor    # [S] i32
    energies: torch.Tensor  # [S, 2] f32: (e_out, max hit corr)


def bpsk_init_batch(cfg: BpskConfig, n_streams: int,
                    device: torch.device | str) -> BpskState:
    """Fresh state for ``n_streams`` independent streams on ``device``."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros((n_streams, *shape), dtype=dtype, device=device)

    i32 = torch.int32
    return BpskState(
        tu_phase=z(),
        ds_tail=CF(z(len(DS_FILTER) - 1), z(len(DS_FILTER) - 1)),
        vco_idx=z(dtype=i32),
        mf_tail=CF(z(len(DM_FILTER) - 1), z(len(DM_FILTER) - 1)),
        timing=TimingState(
            e_ema=z(SAMPLES_PER_BIT), pos=z(dtype=i32), peak=z(dtype=i32),
            new_peak=z(dtype=i32), e_out=z() + 1.0, last_iq=z(2)),
        ring=z(FEC_BITS - 1, dtype=torch.int8),
        counters=z(4, dtype=i32),
        fft_tuner=fft_tuner_init(n_streams, device),
    )


def bpsk_init(cfg: BpskConfig, device: torch.device | str) -> BpskState:
    """Fresh state for one stream (no batch axis)."""
    return tree_map(lambda x: x[0], bpsk_init_batch(cfg, 1, device))


def state_from_numpy(st, device: torch.device | str) -> BpskState:
    """A reference ``jsdr_tpu.demod.bpsk.BpskState`` whose leaves are
    numpy arrays (``bpsk_init_batch``, or ``np.asarray`` of a JAX step's
    output) -> this package's state on ``device``. Fields correspond by
    name and order, so a checkpoint moves between the packages."""
    like = bpsk_init_batch(BpskConfig(), 0, "meta")    # the port's types
    return tree_map(lambda _, x: torch.as_tensor(np.array(x), device=device),
                    like, st)


def state_to_numpy(st: BpskState) -> BpskState:
    """The reverse of :func:`state_from_numpy`: the same tuple structure
    with numpy leaves (``jax.tree.unflatten`` with the reference's
    structure rebuilds its ``BpskState``)."""
    return tree_map(lambda x: x.cpu().numpy(), st)


# ---------------------------------------------------------------------------
# Tuner NCO: exact integer phase numerators in 0.1 Hz units
# (jsdr_tpu/demod/bpsk.py:183-355). nu_k = (nu_0 + k*tu10) mod den with
# den = NU_SCALE*rate; table index = floor(256*nu_k/den). The reference
# keeps every intermediate inside int32 with double-and-add modmuls; the
# port computes the same exact values in int64.
# ---------------------------------------------------------------------------

def _modmul_static(tu: torch.Tensor, m: int, den: int) -> torch.Tensor:
    """(m * tu) mod den for int64 tu, static int m (any sign/size)."""
    return (tu % den) * (int(m) % den) % den


def _modmul_traced(tu: torch.Tensor, k: torch.Tensor, den: int
                   ) -> torch.Tensor:
    """(k * tu) mod den for int tensors tu and k (any sign or size below
    2^31): the values of the reference's int32 double-and-add
    (jsdr_tpu/demod/bpsk.py:227), whose product in int32 would wrap, from
    one int64 product of the two residues (each < den < 2^31)."""
    return (tu.long() % den) * (k.long() % den) % den


def nco_numerators(nu0: torch.Tensor, tu: torch.Tensor, n: int, den: int,
                   start: int = 1) -> torch.Tensor:
    """[..., n] exact numerators (nu0 + (start+i)*tu) mod den, int64."""
    tu = tu.long() % den
    i = torch.arange(n, dtype=torch.int64, device=tu.device)
    base = (nu0.long() + _modmul_static(tu, start, den)) % den
    return (base[..., None] + tu[..., None] * i % den) % den


def _num_to_cossin(nums: torch.Tensor, den: int):
    """Numerators -> quantized-table (cos, sin) values (:93-95)."""
    idx = (nums * SINCOS_SIZE) // den
    ang = idx.to(torch.float32) * float(np.float32(TWO_PI / SINCOS_SIZE))
    return torch.cos(ang), torch.sin(ang)


def _nco_pattern(nu0: torch.Tensor, tu: torch.Tensor, rate: int):
    """[S, 128] mix pattern (cos, sin) for the mix+decimate kernel; valid
    when (128 * tu) % (NU_SCALE*rate) == 0. Streams with tu <= 0 pass
    through un-mixed (:388, :394-396)."""
    den = NU_SCALE * rate
    nums = nco_numerators(nu0.long(), tu, 128, den, start=1)
    c, s = _num_to_cossin(nums, den)
    on = (tu > 0)[..., None]
    return torch.where(on, c, 1.0), torch.where(on, s, 1.0)


def _nco_advance(nu0: torch.Tensor, tu: torch.Tensor, rate: int, n: int):
    """Carried numerator after n samples (tu <= 0: phase frozen)."""
    den = NU_SCALE * rate
    nu = nu0.long()
    adv = (nu + _modmul_static(tu.long() % den, n, den)) % den
    return torch.where(tu > 0, adv, nu).to(torch.float32)


def tunings_to_nu(tunings) -> np.ndarray | None:
    """Host Hz values -> exact 0.1 Hz numerator ints, or None when some
    value is not a multiple of 0.1 Hz."""
    t10 = np.asarray(tunings, np.float64).reshape(-1) * NU_SCALE
    r = np.round(t10)
    if not np.allclose(t10, r, atol=1e-6, rtol=0):
        return None
    return np.maximum(r, 0.0).astype(np.int32)


def pattern_mix_ok(tunings, rate: int) -> bool:
    """True when every stream's quantized NCO index sequence is 128-lane
    periodic: tuning a multiple of 0.1 Hz with (128 * tu10) %
    (NU_SCALE * rate) == 0."""
    nu = tunings_to_nu(tunings)
    if nu is None:
        return False
    return all((128 * int(v)) % (NU_SCALE * rate) == 0 for v in nu)


def _tuner_full_mix(iq: CF, nu0: torch.Tensor, tu: torch.Tensor, rate: int):
    """Full-length quantized-table tuner mix (mi = i*cos, mq = q*sin — the
    reference's non-complex quirk, :389-390) from exact numerators, for
    0.1 Hz-multiple tunings of ANY period (the "general" mode,
    jsdr_tpu/demod/bpsk.py:298-313). iq: [S, T]; nu0, tu: [S], tu in
    0.1 Hz units; streams with tu <= 0 pass through. Returns (mixed, the
    carried numerator)."""
    den = NU_SCALE * rate
    n = iq.shape[-1]
    c, s = _num_to_cossin(nco_numerators(nu0.long(), tu, n, den, start=1),
                          den)
    on = (tu > 0)[:, None]
    mixed = CF(iq.re * torch.where(on, c, 1.0),
               iq.im * torch.where(on, s, 1.0))
    return mixed, _nco_advance(nu0, tu, rate, n)


@device_table(maxsize=4)
def _static_ramp(tunings: tuple, n: int, rate: int,
                 device: torch.device) -> torch.Tensor:
    """[S, n] float64 host ramps (t+1)*tuning mod rate, rounded to
    float32, for the static mode (constant for a tuning set and block
    length, so kept on the device between blocks)."""
    t = np.arange(1, n + 1, dtype=np.float64)
    ramp = np.stack([np.mod(t * tun, rate) for tun in tunings])
    return torch.as_tensor(ramp.astype(np.float32), device=device)


def _tuner_mix(iq: CF, nu0: torch.Tensor, tunings: tuple, rate: int):
    """The "static" mix for sub-0.1 Hz tunings (jsdr_tpu/demod/bpsk.py:
    316-335), all streams at once: a float64 host ramp per stream, then
    the reference's float32 arithmetic op for op (nu + ramp, mod rate,
    * 256/rate, truncate, % 256), so the table index agrees at a boundary
    too. The carried numerator is in 0.1 Hz units like every other
    mode's; streams with tuning <= 0 pass through with it unchanged.
    Returns (mixed, carried numerator)."""
    n = iq.shape[-1]
    dev = iq.re.device
    nu_r = nu0.to(torch.float32) / float(NU_SCALE)
    nums = torch.fmod(nu_r[:, None] + _static_ramp(tunings, n, rate, dev),
                      float(rate))
    idx = ((nums * float(np.float32(SINCOS_SIZE / rate))).to(torch.int32)
           % SINCOS_SIZE)
    ang = idx.to(torch.float32) * float(np.float32(TWO_PI / SINCOS_SIZE))
    tun = np.asarray(tunings, np.float64)
    on = _host_vector(tuple((tun > 0.0).tolist()), torch.bool, dev)
    mixed = CF(iq.re * torch.where(on[:, None], torch.cos(ang), 1.0),
               iq.im * torch.where(on[:, None], torch.sin(ang), 1.0))
    adv = _host_vector(tuple(np.mod(n * tun, rate).astype(np.float32)
                             .tolist()), torch.float32, dev)
    nu_out = torch.fmod(nu_r + adv, float(rate)) * float(NU_SCALE)
    return mixed, torch.where(on, nu_out, nu0)


# ---------------------------------------------------------------------------
# Decimated-domain stages
# ---------------------------------------------------------------------------

def _vco_mix(ds: CF, vco_idx: torch.Tensor):
    """bi = i*cos(vco), bq = q*sin(vco) (:515-516); vco phase = pi/4 * m.
    ds: [S, K]; vco_idx: [S]."""
    k = ds.shape[-1]
    dev = ds.re.device
    m = (vco_idx.long()[:, None]
         + torch.arange(k, device=dev)[None, :]) % SAMPLES_PER_BIT
    cos, sin = _vco_tables(dev)
    c, s = cos[m], sin[m]
    return CF(ds.re * c, ds.im * s), ((vco_idx.long() + k) % 8).to(torch.int32)


def _vco_pattern(vco_idx: torch.Tensor):
    """[S, 128] VCO quadrature patterns for the fused front-end kernel
    (:801-807): decimated position p has phase index (vco_idx + p) % 8,
    and 128 % 8 == 0, so the pattern repeats over the whole block."""
    dev = vco_idx.device
    m8 = (vco_idx.long()[:, None]
          + torch.arange(128, device=dev)[None, :]) % SAMPLES_PER_BIT
    cos, sin = _vco_tables(dev)
    return cos[m8], sin[m8]


@device_table(maxsize=16)
def _ema_tables(a: float, l: int, c: int, dev: torch.device):
    """:func:`_const_ema_trajectory`'s float64 host tables for decay
    ``a``, chunks of ``l`` groups and ``c`` chunks, rounded to float32 on
    ``dev``: the in-chunk [L, L] triangle (transposed), the [C, C]
    chunk-carry matrix, a^(l*c) per chunk and a^(k+1) per lane."""
    k = np.arange(l)
    tri_t = np.where(k[:, None] <= k[None, :],
                     np.power(a, np.maximum(k[None, :] - k[:, None], 0)),
                     0.0).astype(np.float32)
    cc = np.arange(c)
    dec_l = float(a) ** l
    inter = np.where(cc[:, None] > cc[None, :],
                     np.power(dec_l, np.maximum(cc[:, None] - 1 - cc[None, :],
                                                0)),
                     0.0).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (
        tri_t, inter, np.power(dec_l, cc).astype(np.float32),
        np.power(a, k + 1).astype(np.float32)))


def _const_ema_trajectory(b: torch.Tensor, a: float, init: torch.Tensor,
                          chunk: int = 128) -> torch.Tensor:
    """Trajectory of y_g = a*y_{g-1} + b_g (y_{-1} = init) for a constant
    decay ``a`` as chunked triangular matmuls — the reference's form
    (jsdr_tpu/demod/bpsk.py:401), batched over leading dims.

    b: [..., G, P]; init: [..., P]; returns [..., G, P]. Within a chunk
    of L groups local[l] = sum_{j<=l} a^(l-j) b_j is one [L, L] lower-
    triangular product; chunk carries compose through a [C, C] one; the
    float64 host tables are rounded to float32 as the reference rounds
    them, and the products run in true float32 (``require_device`` turns
    TF32 off on a card)."""
    *lead, g, p = b.shape
    dev = b.device
    l = min(chunk, max(8, 1 << (g - 1).bit_length())) if g < chunk else chunk
    c = -(-g // l)
    bt = F.pad(b, (0, 0, 0, c * l - g)).reshape(*lead, c, l, p
                                                ).transpose(-1, -2)
    tri_t, inter, pw_c, pw = _ema_tables(float(a), l, c, dev)
    local = bt @ tri_t                                      # [..., C, P, L]
    carry_b = inter @ local[..., -1]                        # [..., C, P]
    carries = pw_c[:, None] * init[..., None, :] + carry_b
    traj = pw * carries[..., None] + local                 # [..., C, P, L]
    return traj.transpose(-1, -2).reshape(*lead, c * l, p)[..., :g, :]


def _extract_rows(w: torch.Tensor, starts: torch.Tensor, out_len: int
                  ) -> torch.Tensor:
    """w[s, start : start + out_len] for every start of each row: [S, L]
    and [S, H] -> [S, H, out_len]. The reference's gather-free form
    (jsdr_tpu/demod/bpsk.py:618) gives the same values."""
    span = torch.arange(out_len, device=w.device)
    return torch.gather(w[:, None, :].expand(-1, starts.shape[1], -1), 2,
                        starts.long()[:, :, None] + span)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) in float32: float64 holds the product of two float32
    values exactly, so the sum is rounded once to float64 and then to
    float32. That can differ from one rounding only where the float64 sum
    lands exactly half way between two float32 values."""
    return (a.double() * b + c).float()


def _timing_scan_batch(mf: CF, ts: TimingState):
    """Bit-energy timing + differential decision per decimated sample
    (FUNcubeBPSKDemod.java:505-595): the port of the reference's
    ``compat_scan`` path (``jsdr_tpu.demod.bpsk._timing_scan``, a
    ``lax.scan``), a loop over the K samples of [S, K] matched-filter
    rows, vectorised over the streams, on their device.

    Every step evaluates the reference's operations in the order its CPU
    build evaluates them: XLA contracts a product and a sum into one fused
    multiply-add (:func:`_fma`), and the constants are float32 roundings of
    Python scalars (1 - BIT_SMOOTH1 is computed in float64 first, as JAX
    does for a weak-typed scalar). Which product XLA contracts depends on
    the batch: it compiles one stream and a batch of several differently.
    The forms, found by comparing with JAX 0.9's CPU output
    (tests/test_torch_compat_scan.py holds them at S = 1 and S = 3):

    - ``e1 = fma(fi, fi, fq*fq)``;
    - ``e_ema[pos]``: one stream ``fma(e_ema[pos], 1-s1, e1*s1)``, a
      batch ``fma(e1, s1, e_ema[pos]*(1-s1))``; ``e_out`` at the peak
      phase likewise with s2;
    - ``di = -fma(l0, fi, l1*fq)``, ``bit = di < 0``;
    - ``e2 = sqrt(fma(d, d, dq*dq))`` with ``dq = fma(l0, fq, -(l1*fi))``
      and ``d = di`` for one stream, ``d = -fma(l1, fq, l0*fi)`` for a
      batch (XLA evaluates di a second time inside e2).

    ``pos`` advances in lockstep across a batch (every stream starts a
    block at the same pos), so it is read once and the ``pos == 7``
    argmax and the phase of each step are taken on the host's step
    counter; the returned state carries pos advanced by K. The peak
    hand-off stays per stream. Returns (valid, bit, di, e2, new state):
    [S, K] bool, bool, float32, float32 and a :class:`TimingState`.
    ``_timing_scan_batch.runs`` counts the calls.
    """
    _timing_scan_batch.runs += 1
    s, k_len = mf.shape
    dev = mf.re.device
    pos_h = ts.pos.cpu()
    if s and not bool((pos_h == pos_h[0]).all()):
        raise ValueError(f"compat_scan needs one pos for the whole batch; "
                         f"got {pos_h.tolist()}")
    pos0 = int(pos_h[0]) if s else 0
    s1, a1 = (float(np.float32(v)) for v in (BIT_SMOOTH1, 1.0 - BIT_SMOOTH1))
    s2, a2 = (float(np.float32(v)) for v in (BIT_SMOOTH2, 1.0 - BIT_SMOOTH2))
    fi, fq = mf.re, mf.im
    e1 = _fma(fi, fi, fq * fq)
    if s == 1:      # fma(carried, 1-s, e1*s)
        w1, w2 = e1 * s1, e1 * s2

        def ema(prev, w, a):
            return prev.double() * a + w
    else:           # fma(e1, s, carried*(1-s)); w: exact products
        w1, w2 = e1.double() * s1, e1.double() * s2

        def ema(prev, w, a):
            return w + prev * a
    fifq = torch.stack([fi, fq], dim=2)
    e_ema, e_out, last = ts.e_ema.clone(), ts.e_out.clone(), ts.last_iq
    peak, new_peak = ts.peak, ts.new_peak
    at_hist = torch.empty((s, k_len), dtype=torch.bool, device=dev)
    last_hist = torch.empty((s, k_len, 2), dtype=torch.float32, device=dev)
    for k in range(k_len):
        p = (pos0 + k) % SAMPLES_PER_BIT
        e_ema[:, p] = ema(e_ema[:, p], w1[:, k], a1)
        at = peak == p
        at_hist[:, k] = at
        last_hist[:, k] = last
        last = torch.where(at[:, None], fifq[:, k], last)
        e_out = torch.where(at, ema(e_out, w2[:, k], a2).float(), e_out)
        # half-bit hand-off of the peak-energy phase (:577-578)
        peak = torch.where((peak + 4) % SAMPLES_PER_BIT == p, new_peak, peak)
        if p == SAMPLES_PER_BIT - 1:
            # end of bit group: rescan peak energy (:581-592)
            new_peak = torch.argmax(e_ema, dim=1).to(torch.int32)
    l0, l1 = last_hist[..., 0], last_hist[..., 1]
    di = -_fma(l0, fi, l1 * fq)
    dq = _fma(l0, fq, -(l1 * fi))
    # float32 sqrt, correctly rounded (float64 holds it exactly enough;
    # torch's float32 sqrt on the CPU is not always correctly rounded)
    d = di if s == 1 else -_fma(l1, fq, l0 * fi)
    e2 = torch.sqrt(_fma(d, d, dq * dq).double()).float()
    valid = at_hist & (e2 > ENERGY_GATE)
    pos = ((ts.pos.long() + k_len) % SAMPLES_PER_BIT).to(torch.int32)
    return valid, di < 0.0, di, e2, TimingState(e_ema, pos, peak, new_peak,
                                                e_out, last)


_timing_scan_batch.runs = 0


def compat_scan_warning(device) -> str | None:
    """The RuntimeWarning text for ``compat_scan`` on ``device``, or None
    where the scan costs what it should (the CPU), as the reference warns
    on any accelerator (jsdr_tpu/demod/bpsk.py:1136-1149)."""
    if torch.device(device).type == "cpu":
        return None
    return (
        "compat_scan=True runs the per-sample timing scan, a loop of ~17 "
        "torch launches per decimated sample: measured 1.97-2.82 s per 1 s "
        "block on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase "
        "15, PERF.md), slower than real time, where the default timing "
        "kernel takes 0.016 ms. Use compat_scan only for fp-order parity "
        "checks, ideally on the CPU.")


def _warn_compat_scan(cfg: "BpskConfig", device) -> None:
    msg = compat_scan_warning(device) if cfg.compat_scan else None
    if msg:
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _compact_bits(valid: torch.Tensor, bit: torch.Tensor, max_bits: int):
    """Valid decisions as +/-1 int8, in order, into [S, max_bits] (0 pad);
    n_bits = min(#valid, max_bits). ``valid``/``bit``: [S, N], two slots a
    bit period from the timing kernel, or one a sample from the scan."""
    s, n = valid.shape
    pos = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    # invalids, and valids past max_bits, land in a spare column
    dest = torch.where(valid & (pos < max_bits), pos, max_bits)
    pm = torch.where(bit, 1, -1).to(torch.int8)
    out = torch.zeros((s, max_bits + 1), dtype=torch.int8, device=valid.device)
    out.scatter_(1, dest, pm)
    n_bits = torch.clamp(valid.sum(dim=1), max=max_bits).to(torch.int32)
    return out[:, :max_bits], n_bits


def _first_k_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """[S, k] indices of the first k True entries of each row (-1 pad)."""
    rank = torch.cumsum(mask.to(torch.int32), dim=1)
    want = torch.arange(1, k + 1, device=mask.device)[None, :, None]
    cand = mask[:, None, :] & (rank[:, None, :] == want)   # [S, k, N]
    idx = torch.argmax(cand.to(torch.uint8), dim=2)
    return torch.where(cand.any(dim=2), idx, -1)


def sync_correlate(window_buf: torch.Tensor) -> torch.Tensor:
    """corr[:, j] = sum_n W[:, j + 80n] * SYNC[n] for every start j in
    [0, max_bits) (:556-559). window_buf: [S, 5199 + max_bits] of
    +/-1/0. One dilated float32 convolution: the sums are of at most 65
    terms of +/-1, exact in float32 (and in TF32)."""
    max_bits = window_buf.shape[1] - (FEC_BITS - 1)
    corr = F.conv1d(window_buf.to(torch.float32)[:, None, :],
                    _sync_taps(window_buf.device), dilation=80)
    return corr[:, 0, :max_bits].to(torch.int32)


def soft_frames_from_bits(bits: torch.Tensor, n_bits: torch.Tensor,
                          ring: torch.Tensor, max_hits: int):
    """Sync-search the bit streams and extract soft FEC windows.

    bits [S, max_bits] i8, n_bits [S], ring [S, 5199] i8. Returns
    (windows [S, max_hits, 5200] u8, hit_corr [S, max_hits] i32, n_hits
    [S] i32, new_ring [S, 5199] i8); unused window slots are all 0x40."""
    w = torch.cat([ring, bits], dim=1)                # [S, 5199 + max_bits]
    w_len = w.shape[1]
    corr = sync_correlate(w)
    j = torch.arange(corr.shape[1], device=w.device)
    hits = (corr >= SYNC_THRESHOLD) & (j[None, :] < n_bits[:, None])
    hit_idx = _first_k_indices(hits, max_hits)
    hit_ok = hit_idx >= 0
    start = torch.clamp(torch.where(hit_ok, hit_idx, 0), 0, w_len - FEC_BITS)
    ext = _extract_rows(w, start, FEC_BITS)          # [S, max_hits, 5200]
    windows = torch.where((ext == 1) & hit_ok[:, :, None], 0xC0, 0x40
                          ).to(torch.uint8)
    hit_corr = torch.where(hit_ok, corr.gather(1, start), 0).to(torch.int32)
    n_hits = hit_ok.sum(dim=1).to(torch.int32)
    ring = _extract_rows(w, n_bits[:, None], FEC_BITS - 1)[:, 0]
    return windows, hit_corr, n_hits, ring


# ---------------------------------------------------------------------------
# The block step
# ---------------------------------------------------------------------------

def _block_tunings(iq: CF, cfg: BpskConfig, tunings) -> np.ndarray:
    """Check a block and its configuration against what the port runs;
    returns the per-stream tunings in Hz [S] (default cfg.tuning)."""
    s, t_len = iq.shape
    m = cfg.decim
    if t_len % (8 * m):
        raise ValueError(
            f"block length {t_len} must be a multiple of 8*decim = {8 * m} "
            "(timing recovery groups the decimated stream into whole "
            "8-sample bit periods)")
    if tunings is None:
        tunings = np.full(s, cfg.tuning, np.float64)
    tun = np.asarray(tunings, np.float64).reshape(-1)
    if tun.shape[0] != s:
        raise ValueError(f"{tun.shape[0]} tunings for {s} streams")
    return tun


def mix_mode_for(tunings, rate: int, dofft) -> str:
    """The front end a batch takes (jsdr_tpu/demod/bpsk.py:1150-1195):
    the manual mode is "pattern" when ``pattern_mix_ok``, "general" when
    every tuning is a multiple of 0.1 Hz, "static" otherwise; then
    "dofft" when every stream auto-tunes, "mixed:<manual mode>" when some
    do, the manual mode when none does. ``dofft``: [S] bools."""
    if tunings_to_nu(tunings) is None:
        manual = "static"
    elif pattern_mix_ok(tunings, rate):
        manual = "pattern"
    else:
        manual = "general"
    dofft = np.asarray(dofft, bool)
    if dofft.all():
        return "dofft"
    return f"mixed:{manual}" if dofft.any() else manual


@functools.lru_cache(maxsize=64)
def front_mode(tunings: tuple, rate: int, dofft: tuple) -> str:
    """:func:`mix_mode_for` of a tuning set (a tuple of Hz values and one
    of bools), decided once a set: the mode :func:`bpsk_block_batch`
    takes and a telemetry stage counts, with no host work a block beyond
    the cache's lookup."""
    return mix_mode_for(tunings, rate, dofft)


def _front_manual(iq: CF, states: BpskState, tun: np.ndarray, mode: str,
                  rate: int, fuse_mf: bool):
    """Manual-tune front end (RxMixTuner + decimator, :366-397, 466-492)
    in the pattern, general or static mode (jsdr_tpu/demod/bpsk.py:
    844-889). Returns (x, ds_tail, mf_tail, tu_phase): x is the decimated
    stream, or the matched-filter output with its tail under ``fuse_mf``
    (pattern mode only; mf_tail is None otherwise)."""
    dev = iq.re.device
    m = rate // DOWN_SAMPLE_RATE
    t_len = iq.shape[-1]
    taps = _ds_taps(dev)
    if mode == "static":
        mixed, tu_phase = _tuner_mix(iq, states.tu_phase,
                                     tuple(float(t) for t in tun), rate)
        ds, ds_tail = polyphase_decimate(mixed, taps, m, states.ds_tail,
                                         gain=HOWARD_FUDGE_FACTOR)
        return ds, ds_tail, None, tu_phase
    tu = _host_vector(tuple(tunings_to_nu(tun).tolist()), torch.int64, dev)
    if mode == "general":
        mixed, tu_phase = _tuner_full_mix(iq, states.tu_phase, tu, rate)
        ds, ds_tail = polyphase_decimate(mixed, taps, m, states.ds_tail,
                                         gain=HOWARD_FUDGE_FACTOR)
        return ds, ds_tail, None, tu_phase
    assert mode == "pattern", mode
    cos_pat, sin_pat = _nco_pattern(states.tu_phase, tu, rate)
    tu_phase = _nco_advance(states.tu_phase, tu, rate, t_len)
    if fuse_mf:
        # front end + VCO + matched filter: one kernel (:857-864, :973-979)
        vco_cos, vco_sin = _vco_pattern(states.vco_idx)
        mf, ds_tail, mf_tail = mix_decimate_mf(
            iq, cos_pat, sin_pat, taps, m, states.ds_tail, vco_cos,
            vco_sin, _mf_taps(dev), states.mf_tail, HOWARD_FUDGE_FACTOR)
        return mf, ds_tail, mf_tail, tu_phase
    ds, ds_tail = mix_decimate(iq, cos_pat, sin_pat, taps, m,
                               states.ds_tail, HOWARD_FUDGE_FACTOR)
    return ds, ds_tail, None, tu_phase


def _front_dofft(iq: CF, states: BpskState, track_high: torch.Tensor,
                 rate: int, fuse_mf: bool):
    """FFT auto-tune front end (doBufferFFT, :406-464) for all streams
    (jsdr_tpu/demod/bpsk.py:810-841): the tuner's real-only feed through
    kernel 1 with an all-ones pattern, or kernel 6 under ``fuse_mf``.
    Returns (x, ds_tail, mf_tail, tuner state) as :func:`_front_manual`
    (tu_phase is left as it was)."""
    dev = iq.re.device
    m = rate // DOWN_SAMPLE_RATE
    s, t_len = iq.shape
    samples = rate // 10      # the reference's 0.1 s FFT cadence
    if t_len % samples:
        raise ValueError(
            f"block length {t_len} is not whole 0.1 s sub-blocks of "
            f"{samples} samples, which the FFT auto-tuner (dofft) needs")
    feed, _centres, ft_state = fft_tuner_blocks(
        CF(iq.re.reshape(s, -1, samples), iq.im.reshape(s, -1, samples)),
        states.fft_tuner, track_high)
    taps = _ds_taps(dev)
    ones = torch.ones((s, 128), dtype=torch.float32, device=dev)
    if fuse_mf:
        vco_cos, vco_sin = _vco_pattern(states.vco_idx)
        mf, ds_tail, mf_tail = mix_decimate_mf(
            feed, ones, ones, taps, m, states.ds_tail, vco_cos, vco_sin,
            _mf_taps(dev), states.mf_tail, HOWARD_FUDGE_FACTOR)
        return mf, ds_tail, mf_tail, ft_state
    ds, ds_tail = mix_decimate(feed, ones, ones, taps, m, states.ds_tail,
                               HOWARD_FUDGE_FACTOR)
    return ds, ds_tail, None, ft_state


def _front_dispatch(iq: CF, states: BpskState, tun: np.ndarray,
                    dofft: np.ndarray, track_high: torch.Tensor, mode: str,
                    rate: int, fuse_mf: bool):
    """Run the front end(s) of ``mode`` (:func:`mix_mode_for`; the
    reference's ``_front_dispatch``, jsdr_tpu/demod/bpsk.py:893-931).
    "mixed:<manual>" runs both front ends and takes each stream's x,
    tails, tu_phase and tuner state from the one its dofft flag names: a
    manual stream's tuner state never advances, an auto-tuned stream's
    tu_phase never moves. Returns (x, ds_tail, mf_tail, tu_phase, tuner
    state)."""
    if mode == "dofft":
        x, ds_tail, mf_tail, ft = _front_dofft(iq, states, track_high, rate,
                                               fuse_mf)
        return x, ds_tail, mf_tail, states.tu_phase, ft
    if not mode.startswith("mixed:"):
        x, ds_tail, mf_tail, tu_phase = _front_manual(iq, states, tun, mode,
                                                      rate, fuse_mf)
        return x, ds_tail, mf_tail, tu_phase, states.fft_tuner
    x_f, tail_f, mft_f, ft_f = _front_dofft(iq, states, track_high, rate,
                                            fuse_mf)
    x_m, tail_m, mft_m, ph_m = _front_manual(
        iq, states, tun, mode[len("mixed:"):], rate, fuse_mf)
    auto = _host_vector(tuple(np.asarray(dofft, bool).tolist()), torch.bool,
                        iq.re.device)

    def sel(a, b):
        return torch.where(auto.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    def sel_cf(a, b):
        return CF(sel(a.re, b.re), sel(a.im, b.im))

    mf_tail = sel_cf(mft_f, mft_m) if fuse_mf else None
    return (sel_cf(x_f, x_m), sel_cf(tail_f, tail_m), mf_tail,
            sel(states.tu_phase, ph_m),
            FftTunerState(*map(sel, ft_f, states.fft_tuner)))


def _post_batch(ds: CF, states: BpskState, tu_phase: torch.Tensor,
                ds_tail: CF, ft_state: FftTunerState, t_len: int,
                max_hits: int, compat_scan: bool = False
                ) -> Tuple[BpskBlockOut, BpskState]:
    """The decimated-domain stages after the front end (the counterpart of
    ``jsdr_tpu.demod.bpsk._bpsk_post_batch``): VCO mix + matched filter,
    then :func:`_post_mf_batch`."""
    bb, vco_idx = _vco_mix(ds, states.vco_idx)
    mf, mf_tail = fir_apply_streaming(bb, _mf_taps(ds.re.device),
                                      states.mf_tail)
    return _post_mf_batch(mf, states, tu_phase, ds_tail, mf_tail, vco_idx,
                          ft_state, t_len, max_hits, compat_scan)


def _post_mf_batch(mf: CF, states: BpskState, tu_phase: torch.Tensor,
                   ds_tail: CF, mf_tail: CF, vco_idx: torch.Tensor,
                   ft_state: FftTunerState, t_len: int, max_hits: int,
                   compat_scan: bool = False
                   ) -> Tuple[BpskBlockOut, BpskState]:
    """The chain from the matched-filter output onward (the counterpart of
    ``jsdr_tpu.demod.bpsk._bpsk_post_mf_batch``): timing recovery (the
    timing kernel, or :func:`_timing_scan_batch` under ``compat_scan``),
    compaction, sync search, window extraction, and the carried state."""
    tm = states.timing
    ds_len = mf.shape[-1]
    max_bits = 2 * (ds_len // SAMPLES_PER_BIT) + 2
    if compat_scan:
        # one row a sample, more rows than max_bits; its decisions, at
        # most two a bit period (the peak phase moves once a bit), fit
        valid, bit, _di, _e2, timing = _timing_scan_batch(mf, tm)
    else:
        valid, bit, e_ema, peak, new_peak, e_out, last_iq = (
            timing_recover_batch(
                mf.re, mf.im, tm.e_ema, tm.peak, tm.new_peak, tm.e_out,
                tm.last_iq, smooth1=BIT_SMOOTH1, smooth2=BIT_SMOOTH2,
                gate=ENERGY_GATE))
        # two slots a bit period: every decision fits, none is cut off
        assert valid.shape[1] < max_bits
        timing = TimingState(e_ema, tm.pos, peak, new_peak, e_out, last_iq)

    # compaction, sync search, window extraction
    bits, n_bits = _compact_bits(valid, bit, max_bits)
    windows, hit_corr, n_hits, ring = soft_frames_from_bits(
        bits, n_bits, states.ring, max_hits)
    counters = states.counters + torch.stack(
        [torch.full_like(n_bits, t_len), torch.full_like(n_bits, ds_len),
         n_bits, n_hits], dim=1)
    out = BpskBlockOut(
        windows=windows, hit_corr=hit_corr, n_hits=n_hits, bits=bits,
        n_bits=n_bits,
        energies=torch.stack([timing.e_out,
                              hit_corr.max(dim=1).values.float()], dim=1))
    new_state = BpskState(tu_phase, ds_tail, vco_idx, mf_tail, timing, ring,
                          counters, ft_state)
    return out, new_state


def bpsk_block_batch(iq: CF, cfg: BpskConfig, states: BpskState,
                     tunings=None, dofft=None, track_high=None
                     ) -> Tuple[BpskBlockOut, BpskState]:
    """Batched telemetry chain over independent streams: [S, T] blocks.

    ``iq``: CF of float32 [S, T] tensors, all on one device, which the
    state must share; T a multiple of 8*cfg.decim. ``tunings``: host
    array-like [S] of per-stream NCO Hz (default cfg.tuning for every
    stream), any values: :func:`mix_mode_for` picks the front end, once
    a tuning set (:func:`front_mode`).
    ``dofft`` / ``track_high``: host bool array-likes [S], the
    per-instance FUNcube<n>-bpsk-dofft / -upper keys
    (FUNcubeBPSKDemod.java:97-99), default cfg.dofft / cfg.track_high for
    every stream; an auto-tuned block must be whole 0.1 s sub-blocks.
    With ``cfg.fuse_mf`` the dofft, pattern and mixed:pattern front ends
    run the VCO mix and matched filter in their kernel
    (``mix_decimate_mf``); the general and static modes keep the unfused
    chain, as in the reference (:966-967). ``cfg.compat_scan`` runs the
    per-sample timing scan (:func:`_timing_scan_batch`) in place of the
    timing kernel and forces ``fuse_mf`` off, as the reference does; on a
    card it warns (:func:`compat_scan_warning`). Returns the block's
    output and the carried state."""
    s, t_len = iq.shape
    dev = iq.re.device
    tun = _block_tunings(iq, cfg, tunings)
    _warn_compat_scan(cfg, dev)
    flags = _flags(cfg.dofft if dofft is None else dofft, s)
    high = _host_vector(_flags(
        cfg.track_high if track_high is None else track_high, s),
        torch.bool, dev)
    mode = front_mode(tuple(tun.tolist()), cfg.rate, flags)
    fuse_mf = (cfg.fuse_mf and not cfg.compat_scan
               and mode in ("dofft", "pattern", "mixed:pattern"))
    iq = CF(iq.re.contiguous(), iq.im.contiguous())
    x, ds_tail, mf_tail, tu_phase, ft_state = _front_dispatch(
        iq, states, tun, np.asarray(flags), high, mode, cfg.rate, fuse_mf)
    if fuse_mf:
        vco_idx = ((states.vco_idx.long() + t_len // cfg.decim)
                   % SAMPLES_PER_BIT).to(torch.int32)
        return _post_mf_batch(x, states, tu_phase, ds_tail, mf_tail,
                              vco_idx, ft_state, t_len,
                              cfg.max_hits_per_block)
    return _post_batch(x, states, tu_phase, ds_tail, ft_state, t_len,
                       cfg.max_hits_per_block, cfg.compat_scan)


class WaterfallOut(NamedTuple):
    wf: torch.Tensor         # [T//n, S, G, 128] dB max-decimated lines
    peak_freq: torch.Tensor  # [S, T//n] Hz (signed, reference truncation)
    peak_db: torch.Tensor    # [S, T//n]


def spectrum_step_merged(cfg: BpskConfig, t_len: int, tunings,
                         device=None) -> bool:
    """Whether the spectrum-telemetry step runs the merged kernel 3.

    Without a device, or on the CPU, the reference's rule
    (``jsdr_tpu.demod.bpsk.bpsk_block_batch_spectrum``): manual tuning
    only, no fused matched filter, T a multiple of the merged kernel's
    chunk (``sf_geometry``: 4 FFT blocks at 96 k, 2 at 192 k),
    128-periodic tunings, and T a multiple of 8*decim. On a CUDA device
    the card's rule: the same, with T a multiple of one FFT block
    (n = rate/10) in place of the chunk, since the CUDA kernel takes one
    FFT block a CTA (0.1 s blocks at either rate, 1 s blocks at 96 k)."""
    n = cfg.rate // 10
    card = device is not None and torch.device(device).type == "cuda"
    chunk = n if card else sf_geometry(n, cfg.decim)[0] * n
    return (not cfg.dofft and not cfg.fuse_mf
            and t_len % chunk == 0
            and pattern_mix_ok(tunings, cfg.rate)
            and t_len % (8 * cfg.decim) == 0)


def _waterfall_out(wf, mx, idx, rate: int) -> WaterfallOut:
    n = rate // 10
    n1 = n // 128
    k_nat = n1 * (idx % 128) + idx // 128
    signed = torch.where(k_nat < n // 2, k_nat, k_nat - n)
    freq = bin_to_hz(signed, rate, n).to(torch.int32)
    return WaterfallOut(wf, freq.T, mx.T)


def bpsk_block_batch_spectrum(iq: CF, cfg: BpskConfig, states: BpskState,
                              tunings=None, window: bool = True):
    """Batched telemetry chain PLUS the display spectrum in one step: the
    flagship per-step call of a deployment that renders a waterfall while
    decoding (the reference runs fft.java and FUNcubeBPSKDemod.java side
    by side on every block). FFT blocks are n = rate/10 samples.

    Returns (WaterfallOut, BpskBlockOut, new_states). When
    :func:`spectrum_step_merged` holds on the input's device (the card's
    rule on a card, the reference's elsewhere), one kernel
    (:func:`jsdr_tpu_torch.ops.spectrum_front.spectrum_front_fused`)
    reads the input once for both the waterfall and the front end;
    otherwise the staged pair runs (``spectrum_waterfall``, then
    :func:`bpsk_block_batch`: one more read of the input) with the same
    results. The general, static and dofft modes (``cfg.dofft``,
    ``cfg.track_high``) and ``fuse_mf`` take the staged branch, whose
    :func:`bpsk_block_batch` runs their front end. ``compat_scan`` runs
    the per-sample timing scan on either branch, as the reference threads
    it through (jsdr_tpu/demod/bpsk.py:1014-1031)."""
    t_len = iq.shape[-1]
    dev = iq.re.device
    tun = _block_tunings(iq, cfg, tunings)
    n = cfg.rate // 10
    iq = CF(iq.re.contiguous(), iq.im.contiguous())
    if not spectrum_step_merged(cfg, t_len, tun, dev):
        # staged pair (two input reads)
        wf, mx, idx = spectrum_waterfall(iq, n, window=window)
        out, new_states = bpsk_block_batch(iq, cfg, states, tun)
        return _waterfall_out(wf, mx, idx, cfg.rate), out, new_states
    _warn_compat_scan(cfg, dev)
    tu = _host_vector(tuple(tunings_to_nu(tun).tolist()), torch.int64, dev)
    cos_pat, sin_pat = _nco_pattern(states.tu_phase, tu, cfg.rate)
    tu_phase = _nco_advance(states.tu_phase, tu, cfg.rate, t_len)
    taps = _ds_taps(dev)
    wf, mx, idx, ds, ds_tail = spectrum_front_fused(
        iq, n, cos_pat, sin_pat, taps, cfg.decim, states.ds_tail,
        gain=HOWARD_FUDGE_FACTOR, window=window)
    out, new_states = _post_batch(ds, states, tu_phase, ds_tail,
                                  states.fft_tuner, t_len,
                                  cfg.max_hits_per_block, cfg.compat_scan)
    return _waterfall_out(wf, mx, idx, cfg.rate), out, new_states


def bpsk_block(iq: CF, cfg: BpskConfig, state: BpskState,
               tuning=None) -> Tuple[BpskBlockOut, BpskState]:
    """One stream's block [T] through the chain (unbatched state)."""
    states = tree_map(lambda x: x[None], state)
    tunings = None if tuning is None else np.asarray([tuning])
    out, new_states = bpsk_block_batch(CF(iq.re[None], iq.im[None]), cfg,
                                       states, tunings)
    return (BpskBlockOut(*(x[0] for x in out)),
            tree_map(lambda x: x[0], new_states))
