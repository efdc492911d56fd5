"""Batched AO-40 encoder on the device — the port of
:mod:`jsdr_tpu.fec.encode` used by the decoder's re-encode check
(FECDecoder.java:538-688, 831-847).

RS parity is a 128-step LFSR over both interleaved codewords, vectorised
over the batch; scrambling is an XOR; the convolutional encoder needs no
shift register (the state after bit t is the window of the last 7 bits);
interleaving and the sync column are index writes. Nothing is built on
the host: the reference's affine bit-matrix form (~5 s of host numpy per
process) is not needed here.
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import (
    A0, ALPHA_TO, BLOCKSIZE, COLUMNS, CPOLYA, CPOLYB, INDEX_OF, NBITS, NROOTS,
    PARTAB, ROWS, RS_POLY, SCRAMBLER, SYMPBLOCK, SYNC_BITS,
)

# generator coefficients g[1..31] in log form, palindromic (:544-546,
# 634-641); g[0] = 0 feeds the shifted-out register cell
_GPOLY = np.zeros(NROOTS, dtype=np.int64)
_GPOLY[1:16] = RS_POLY[:15]
_GPOLY[16] = RS_POLY[15]
_GPOLY[17:32] = RS_POLY[14::-1][:15]

# channel-symbol index of encoder output t, and the sync column
_BINDEX = np.arange(2 * NBITS) + COLUMNS
_INTERLEAVE_POS = (_BINDEX % COLUMNS) * ROWS + (_BINDEX // COLUMNS)
_SYNC_POS = np.arange(COLUMNS) * ROWS


def rs_parity(payload: torch.Tensor) -> torch.Tensor:
    """[B, 256] payload bytes -> [B, 2, 32] RS parity (:614-655); byte i
    feeds codeword i & 1."""
    dev = payload.device
    alpha = torch.as_tensor(ALPHA_TO, dtype=torch.int64, device=dev)
    index = torch.as_tensor(INDEX_OF, dtype=torch.int64, device=dev)
    glog = torch.as_tensor(_GPOLY, device=dev)
    data = payload.long().reshape(-1, BLOCKSIZE // 2, 2)      # [B, 128, 2]
    reg = torch.zeros((data.shape[0], 2, NROOTS), dtype=torch.int64,
                      device=dev)
    for k in range(BLOCKSIZE // 2):
        fb = index[data[:, k] ^ reg[..., 0]][..., None]      # [B, 2, 1]
        t = torch.where(fb == A0, 0, alpha[(fb + glog) % 255])
        reg = torch.cat([(reg ^ t)[..., 1:], t[..., :1]], dim=-1)
    return reg.to(torch.uint8)


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """[B, NBITS] input bits -> [B, 2*NBITS] channel symbols. The state
    after bit t is bits[t-6..t] packed oldest-first (:559-566)."""
    dev = bits.device
    partab = torch.as_tensor(PARTAB, dtype=torch.int64, device=dev)
    padded = torch.nn.functional.pad(bits.long(), (6, 0))
    weights = 1 << torch.arange(6, -1, -1, device=dev)
    states = (padded.unfold(1, 7, 1) * weights).sum(dim=-1)  # [B, NBITS]
    sym_a = partab[states & CPOLYA]
    sym_b = 1 - partab[states & CPOLYB]
    return torch.stack([sym_a, sym_b], dim=-1).reshape(bits.shape[0], -1)


def encode_frame(payload: torch.Tensor) -> torch.Tensor:
    """[B, 256] payload bytes -> [B, 5200] hard channel symbols (0/1
    uint8): RS parity, scramble, convolutional encode, interleave, sync."""
    dev = payload.device
    n_batch = payload.shape[0]
    parity = rs_parity(payload)                               # [B, 2, 32]
    seq = torch.cat([payload.long(),
                     parity.long().transpose(1, 2).reshape(n_batch, -1)],
                    dim=1)                                    # [B, 320]
    scram = torch.as_tensor(np.asarray(SCRAMBLER[:320]), device=dev)
    scrambled = seq ^ scram
    shifts = torch.arange(7, -1, -1, device=dev)
    bits = ((scrambled[..., None] >> shifts) & 1).reshape(n_batch, -1)
    bits = torch.nn.functional.pad(bits, (0, 6))              # flush
    syms = conv_encode(bits)
    frame = torch.zeros((n_batch, SYMPBLOCK), dtype=torch.uint8, device=dev)
    frame[:, torch.as_tensor(_SYNC_POS, device=dev)] = torch.as_tensor(
        SYNC_BITS, device=dev)
    frame[:, torch.as_tensor(_INTERLEAVE_POS, device=dev)] = syms.to(
        torch.uint8)
    return frame
