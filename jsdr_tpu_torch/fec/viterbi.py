"""Batched soft-decision Viterbi decoder (k=7, r=1/2) for AO-40 frames —
the port of :mod:`jsdr_tpu.fec.viterbi` (FECDecoder.java:203-278).

The 64-state add-compare-select runs as a loop over the 2566 bit steps,
vectorised over the batch, with the reference's tie rule (``dec = b > a``)
and int32 metrics; the chain-back starts from state 0. The METTAB lookup
indexes the table directly (the reference's nibble one-hot matmul exists
to avoid TPU gathers).
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import METTAB, SYMS

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


def viterbi27_bits(symbols: torch.Tensor) -> torch.Tensor:
    """[B, 2*NBITS] soft symbols -> [B, NBITS - 6] decoded bits (uint8)."""
    return _traceback(_acs(branch_metrics(symbols)))


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """Pack MSB-first bits (a multiple of 8 per row) into uint8 bytes."""
    b = bits.reshape(*bits.shape[:-1], -1, 8).to(torch.int32)
    weights = 1 << torch.arange(7, -1, -1, device=bits.device,
                                dtype=torch.int32)
    return (b * weights).sum(dim=-1).to(torch.uint8)

