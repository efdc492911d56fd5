"""Batched soft-decision Viterbi decoder (k=7, r=1/2) for AO-40 frames —
the port of :mod:`jsdr_tpu.fec.viterbi` (FECDecoder.java:203-278).

:func:`viterbi27_bytes` decodes frames to bytes: for CUDA tensors it
launches kernel A (``ops/csrc/fec_viterbi.cu``: deinterleave, branch
metrics, the 2566 ACS steps, the chain-back and the byte packing in one
launch, one warp a frame), for CPU tensors it runs the plain version
:func:`viterbi27_bits_ref`: the 64-state add-compare-select as a loop over
the 2566 bit steps, vectorised over the batch, with the reference's tie
rule (``dec = b > a``) and int32 metrics, and the chain-back from state 0.
The METTAB lookup indexes the table directly (the reference's nibble
one-hot matmul exists to avoid TPU gathers). :func:`_viterbi_lanes` is
kernel A's lane layout in plain PyTorch; only the tests call it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _build
from . import _device
from .tables import COLUMNS, METTAB, NBITS, ROWS, SYMPBLOCK, SYMS

K_FLUSH = 6
_N_STATES = 64
_INIT_METRIC = -999999

# new state 2j comes from old states j (symbol pair SYMS[2j]) and j+32
# (SYMS[2j+1]); new state 2j+1 swaps the branch symbols (:229-247).
# Path a of every new state, then path b: its old state and branch pair.
_SYM_A = np.asarray(SYMS[0:64:2], dtype=np.int64)     # [32]
_SYM_B = np.asarray(SYMS[1:64:2], dtype=np.int64)     # [32]
_FROM = np.concatenate([np.repeat(np.arange(32), 2),
                        np.repeat(np.arange(32, 64), 2)])         # [128]
_PAIR = np.concatenate([np.stack([_SYM_A, _SYM_B], axis=1).reshape(-1),
                        np.stack([_SYM_B, _SYM_A], axis=1).reshape(-1)])

# de-interleave gather: symbols[(col-1)*65 + row] = raw[row*80 + col]
_COL = np.arange(1, ROWS).repeat(COLUMNS)
_ROW = np.tile(np.arange(COLUMNS), ROWS - 1)
_DEINT_IDX = np.asarray((_ROW * ROWS + _COL)[: 2 * NBITS], dtype=np.int64)
_OUT_BYTES = (NBITS - K_FLUSH) // 8


def branch_metrics(symbols: torch.Tensor) -> torch.Tensor:
    """[B, 2*NBITS] uint8 soft symbols -> [B, NBITS, 4] int32 metrics of
    the hypothesis pairs i = (bitA << 1 | bitB) (:219-225)."""
    mettab = torch.as_tensor(METTAB, dtype=torch.int32, device=symbols.device)
    s = symbols.long().reshape(symbols.shape[0], -1, 2)
    m0, m1 = mettab[0][s], mettab[1][s]                # [B, NBITS, 2]
    a0, b0, a1, b1 = m0[..., 0], m0[..., 1], m1[..., 0], m1[..., 1]
    return torch.stack([a0 + b0, a0 + b1, a1 + b0, a1 + b1], dim=-1)


def _acs(mets: torch.Tensor) -> torch.Tensor:
    """Forward add-compare-select. mets [B, NBITS, 4] -> decisions
    [NBITS, B, 64] bool (True: the path from old state j+32 won)."""
    dev = mets.device
    n_batch, n_steps, _ = mets.shape
    branch = mets[..., torch.as_tensor(_PAIR, device=dev)]   # [B, N, 128]
    src = torch.as_tensor(_FROM, device=dev)
    metric = torch.full((n_batch, _N_STATES), _INIT_METRIC, dtype=torch.int32,
                        device=dev)
    metric[:, 0] = 0
    decisions = torch.empty((n_steps, n_batch, _N_STATES), dtype=torch.bool,
                            device=dev)
    for t in range(n_steps):
        ab = (metric[:, src] + branch[:, t]).view(n_batch, 2, _N_STATES)
        torch.gt(ab[:, 1], ab[:, 0], out=decisions[t])
        metric = ab.amax(dim=1)
    return decisions


def _traceback(decisions: torch.Tensor) -> torch.Tensor:
    """Chain back from state 0 (:264-277). decisions [NBITS, B, 64] ->
    bits [B, NBITS - K_FLUSH] uint8. The predecessor of state s at step t
    is (s >> 1) | (dec[t, s] << 5) and the decoded bit is dec[t, s]: one
    table for all steps, then one gather per step."""
    n_steps, n_batch, _ = decisions.shape
    dev = decisions.device
    s = torch.arange(_N_STATES, device=dev)
    prev = ((s >> 1) | (decisions[K_FLUSH:].to(torch.int64) << 5))
    state = torch.zeros((n_batch, 1), dtype=torch.int64, device=dev)
    states = torch.empty((n_steps - K_FLUSH, n_batch, 1), dtype=torch.int64,
                         device=dev)
    for i in range(n_steps - K_FLUSH - 1, -1, -1):
        state = torch.gather(prev[i], 1, state, out=states[i])
    return (states[..., 0].T >> 5).to(torch.uint8)


def viterbi27_bits_ref(symbols: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, 2*NBITS] soft symbols -> [B, NBITS - 6] decoded
    bits (uint8)."""
    return _traceback(_acs(branch_metrics(symbols)))


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """Pack MSB-first bits (a multiple of 8 per row) into uint8 bytes."""
    b = bits.reshape(*bits.shape[:-1], -1, 8).to(torch.int32)
    weights = 1 << torch.arange(7, -1, -1, device=bits.device,
                                dtype=torch.int32)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def deinterleave(raw: torch.Tensor) -> torch.Tensor:
    """[B, 5200] soft symbols -> [B, 5132] Viterbi input."""
    return raw[:, torch.as_tensor(_DEINT_IDX, device=raw.device)]


def viterbi27_bytes(x: torch.Tensor) -> torch.Tensor:
    """[B, 5132] soft symbols, or [B, 5200] channel frames (deinterleaved
    on the way in), uint8 -> [B, 320] decoded bytes.

    CPU tensors run :func:`viterbi27_bits_ref`; CUDA tensors launch
    kernel A (and count the launch in ``viterbi27_bytes.launches``)."""
    if x.dim() != 2 or x.shape[1] not in (2 * NBITS, SYMPBLOCK):
        raise ValueError(f"viterbi27_bytes: want [B, {2 * NBITS}] symbols "
                         f"or [B, {SYMPBLOCK}] frames, got {tuple(x.shape)}")
    dev = x.device
    _build.check_tensor("viterbi27_bytes", "x", x, tuple(x.shape),
                        torch.uint8, dev)
    frames = x.shape[1] == SYMPBLOCK
    n = x.shape[0]
    if dev.type == "cpu":
        if not n:
            return torch.empty((0, _OUT_BYTES), dtype=torch.uint8)
        return bits_to_bytes(viterbi27_bits_ref(
            deinterleave(x) if frames else x))
    if dev.type != "cuda":
        raise ValueError(f"viterbi27_bytes: unsupported device {dev}")
    out = torch.empty((n, _OUT_BYTES), dtype=torch.uint8, device=dev)
    if n:
        tab = _device.device_table("viterbi", dev)
        lib = _build.kernels()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.jsdr_fec_viterbi(x.data_ptr(), tab.data_ptr(),
                                        out.data_ptr(), n, int(frames),
                                        stream)
        _build.check(code, "viterbi27_bytes")
        viterbi27_bytes.launches += 1
    return out


viterbi27_bytes.launches = 0


def viterbi27_bits(symbols: torch.Tensor) -> torch.Tensor:
    """[B, 2*NBITS] soft symbols -> [B, NBITS - 6] decoded bits (uint8):
    :func:`viterbi27_bits_ref` on the CPU, kernel A's bytes unpacked on
    a card."""
    if symbols.device.type == "cpu":
        return viterbi27_bits_ref(symbols)
    packed = viterbi27_bytes(symbols)
    shifts = torch.arange(7, -1, -1, device=symbols.device,
                          dtype=torch.uint8)
    return ((packed[..., None] >> shifts) & 1).reshape(packed.shape[0], -1)


def viterbi27(symbols: torch.Tensor) -> torch.Tensor:
    """Batched Viterbi decode: [..., 2*NBITS] soft bytes -> [..., 320]
    bytes (the counterpart of ``jsdr_tpu.fec.viterbi.viterbi27``)."""
    lead = symbols.shape[:-1]
    flat = symbols.reshape(-1, symbols.shape[-1]).contiguous()
    return viterbi27_bytes(flat).reshape(*lead, _OUT_BYTES)


def _viterbi_lanes(symbols: torch.Tensor) -> torch.Tensor:
    """Kernel A's walk in plain PyTorch: [B, 2*NBITS] symbols -> [B, 320]
    bytes. Lane l holds old states l and l+32 and forms new states 2l and
    2l+1 from its branch pairs SYM_A[l], SYM_B[l] (each metric
    METTAB[bitA][s0] + METTAB[bitB][s1]); a step's decisions are two
    ballot words (bit l of word 0: new state 2l, of word 1: new state
    2l+1); the new metrics go back to the lanes as the four shuffles do
    (state l from lane l >> 1, state l+32 from lane 16 + (l >> 1), the
    even or odd one by l's parity). The chain-back reads the packed words
    (state s: word s & 1, bit s >> 1) and packs bytes as lane 0 does.
    Nothing on the main path calls it."""
    n = symbols.shape[0]
    met = torch.as_tensor(METTAB, dtype=torch.int32)
    lane = torch.arange(32)
    sa, sb = torch.as_tensor(_SYM_A), torch.as_tensor(_SYM_B)
    s = symbols.long().reshape(n, -1, 2)
    a0, a1 = met[0][s[..., :1]], met[1][s[..., :1]]           # [B, N, 1]
    b0, b1 = met[0][s[..., 1:]], met[1][s[..., 1:]]
    bma = (torch.where(sa & 2 > 0, a1, a0)
           + torch.where(sa & 1 > 0, b1, b0))                  # [B, N, 32]
    bmb = (torch.where(sb & 2 > 0, a1, a0)
           + torch.where(sb & 1 > 0, b1, b0))
    lo = torch.full((n, 32), _INIT_METRIC, dtype=torch.int32)
    lo[:, 0] = 0
    hi = torch.full((n, 32), _INIT_METRIC, dtype=torch.int32)
    src, odd = lane >> 1, (lane & 1) > 0
    weight = 1 << lane
    words = torch.empty((NBITS, n, 2), dtype=torch.int64)
    for t in range(NBITS):
        ca, cb = bma[:, t], bmb[:, t]
        ea, eb, oa, ob = lo + ca, hi + cb, lo + cb, hi + ca
        words[t, :, 0] = ((eb > ea).long() * weight).sum(dim=1)
        words[t, :, 1] = ((ob > oa).long() * weight).sum(dim=1)
        ne, no = torch.maximum(ea, eb), torch.maximum(oa, ob)
        lo = torch.where(odd, no[:, src], ne[:, src])
        hi = torch.where(odd, no[:, src + 16], ne[:, src + 16])
    state = torch.zeros((n, 1), dtype=torch.int64)
    byte = torch.zeros(n, dtype=torch.int64)
    out = torch.empty((n, _OUT_BYTES), dtype=torch.uint8)
    for k in range(NBITS - K_FLUSH - 1, -1, -1):
        word = words[k + K_FLUSH].gather(1, state & 1)
        bit = (word >> (state >> 1)) & 1
        byte |= bit[:, 0] << (7 - (k & 7))
        if k & 7 == 0:
            out[:, k >> 3] = byte
            byte = torch.zeros_like(byte)
        state = (state >> 1) | (bit << 5)
    return out
