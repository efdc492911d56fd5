"""Batched soft-decision Viterbi decoder (k=7, r=1/2) for AO-40 frames —
the port of :mod:`jsdr_tpu.fec.viterbi` (FECDecoder.java:203-278).

:func:`viterbi27_bytes` decodes frames to bytes: for CUDA tensors it
launches kernel A (``ops/csrc/fec_viterbi.cu``: deinterleave, pair
metrics, the 2566 ACS steps with a survivor word a state, the 80-step
chain-back over the window words and the byte packing in one launch, one
CTA a frame), for CPU tensors it runs the plain version
:func:`viterbi27_bits_ref`: the 64-state add-compare-select as a loop over
the 2566 bit steps, vectorised over the batch, with the reference's tie
rule (``dec = b > a``) and int32 metrics, and the chain-back from state 0.
The METTAB lookup indexes the table directly (the reference's nibble
one-hot matmul exists to avoid TPU gathers). :func:`_viterbi_lanes` is
kernel A's walk in plain PyTorch, :func:`_window_words` and
:func:`_chain_back` its register exchange and chain-back on any
decisions; only the tests call them.
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
_WINDOW = 32                                   # steps a survivor word holds
_WINDOWS = (NBITS - K_FLUSH) // _WINDOW        # 80


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


@_build.counts_launches
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
        tab = _device.viterbi_table_on(dev)
        lib = _build.kernels()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.jsdr_fec_viterbi(x.data_ptr(), tab.data_ptr(),
                                        out.data_ptr(), n, int(frames),
                                        stream)
        _build.check(code, "viterbi27_bytes")
        viterbi27_bytes.launches += 1
    return out


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


def _pair_metrics(symbols: torch.Tensor) -> torch.Tensor:
    """Kernel A's pre-pass: [B, 2*NBITS] symbols -> [B, NBITS, 4] pair
    metrics METTAB[a][s0] + METTAB[b][s1] at pair (a << 1) | b, as int16
    (METTAB lies in [-372, 20], so a pair in [-744, 40])."""
    return branch_metrics(symbols).to(torch.int16)


def _window_words(decisions: torch.Tensor) -> torch.Tensor:
    """The register exchange on given decisions [NBITS, B, 64] (True: the
    path from old state j+32 won): each state's survivor word becomes its
    chosen predecessor's word shifted left with the decision in bit 0
    (the predecessor of state s is (s >> 1) | (dec << 5)). Returns the
    words at the last step of each window, [80, B, 64] int64 (32 bits):
    window w covers steps 6 + 32w ... 37 + 32w."""
    n_steps, n_batch, _ = decisions.shape
    s = torch.arange(_N_STATES)
    word = torch.zeros((n_batch, _N_STATES), dtype=torch.int64)
    out = torch.empty((_WINDOWS, n_batch, _N_STATES), dtype=torch.int64)
    for t in range(n_steps):
        d = decisions[t].long()
        pred = (s >> 1) | (d << 5)
        word = ((word.gather(1, pred) << 1) | d) & 0xFFFFFFFF
        if t >= K_FLUSH and (t - K_FLUSH) % _WINDOW == _WINDOW - 1:
            out[(t - K_FLUSH) // _WINDOW] = word
    return out


def _chain_back(words: torch.Tensor) -> torch.Tensor:
    """Kernel A's chain-back over the window words [80, B, 64]: one
    dependent step a window from state 0 (``word = W[w][s]``, its bytes
    big-endian are output bytes 4w ... 4w+3, ``s = word >> 26``, the
    window's six earliest decisions). Returns [B, 320] uint8."""
    n_batch = words.shape[1]
    state = torch.zeros((n_batch, 1), dtype=torch.int64)
    out = torch.empty((n_batch, _OUT_BYTES), dtype=torch.uint8)
    shifts = torch.tensor([24, 16, 8, 0])
    for w in range(_WINDOWS - 1, -1, -1):
        word = words[w].gather(1, state)                      # [B, 1]
        out[:, 4 * w:4 * w + 4] = ((word >> shifts) & 0xFF).to(torch.uint8)
        state = word >> 26
    return out


def _viterbi_lanes(symbols: torch.Tensor) -> torch.Tensor:
    """Kernel A's walk in plain PyTorch: [B, 2*NBITS] symbols -> [B, 320]
    bytes. The pre-pass's int16 pair metrics (:func:`_pair_metrics`);
    lane l holds states l and l + 32 (metric and survivor word) and pulls
    its four predecessors as the shuffles do: old states j = l >> 1 and
    j + 32 (registers lo and hi of lane j) for new state l, j + 16 and
    j + 48 (lo and hi of lane j + 16) for new state l + 32, each path's
    pair from SYM_A / SYM_B by l's parity, each compare with the tie rule
    b > a and each word shifted with its decision. The window stores and
    the 80-step chain-back (:func:`_chain_back`) follow. Nothing on the
    main path calls it."""
    n = symbols.shape[0]
    pm = _pair_metrics(symbols).to(torch.int32)              # [B, N, 4]
    lane = torch.arange(32)
    j = lane >> 1
    odd = (lane & 1) > 0
    sa, sb = torch.as_tensor(_SYM_A), torch.as_tensor(_SYM_B)
    pa, pb = torch.where(odd, sb[j], sa[j]), torch.where(odd, sa[j], sb[j])
    pc = torch.where(odd, sb[j + 16], sa[j + 16])
    pd = torch.where(odd, sa[j + 16], sb[j + 16])
    lo = torch.full((n, 32), _INIT_METRIC, dtype=torch.int32)
    lo[:, 0] = 0
    hi = torch.full((n, 32), _INIT_METRIC, dtype=torch.int32)
    wlo = torch.zeros((n, 32), dtype=torch.int64)
    whi = torch.zeros((n, 32), dtype=torch.int64)
    words = torch.empty((_WINDOWS, n, _N_STATES), dtype=torch.int64)
    for t in range(NBITS):
        p = pm[:, t]
        m0, m1, m2, m3 = lo[:, j], hi[:, j], lo[:, j + 16], hi[:, j + 16]
        w0, w1, w2, w3 = wlo[:, j], whi[:, j], wlo[:, j + 16], whi[:, j + 16]
        a, b = m0 + p[:, pa], m1 + p[:, pb]
        c, d = m2 + p[:, pc], m3 + p[:, pd]
        d1, d2 = b > a, d > c
        lo, hi = torch.maximum(a, b), torch.maximum(c, d)
        wlo = ((torch.where(d1, w1, w0) << 1) | d1.long()) & 0xFFFFFFFF
        whi = ((torch.where(d2, w3, w2) << 1) | d2.long()) & 0xFFFFFFFF
        if t >= K_FLUSH and (t - K_FLUSH) % _WINDOW == _WINDOW - 1:
            words[(t - K_FLUSH) // _WINDOW] = torch.cat([wlo, whi], dim=1)
    return _chain_back(words)
