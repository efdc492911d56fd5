"""Full AO-40 frame decode, batched — the port of
:mod:`jsdr_tpu.fec.decoder` (``FECDecoder.FECDecode``,
FECDecoder.java:703-852).

1. de-interleave 5200 soft symbols -> 5132 (index gather)
2. Viterbi k=7 r=1/2 -> 320 bytes (:mod:`jsdr_tpu_torch.fec.viterbi`)
3. descramble + demux -> 2x shortened RS(255,223)
4. RS decode both codewords (:mod:`jsdr_tpu_torch.fec.rs`)
5. re-encode the payload and count channel symbol errors
   (:mod:`jsdr_tpu_torch.fec.encode`)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .tables import (
    COLUMNS, KK, NBITS, NN, ROWS, RSBLOCKS, RSPAD, SCRAMBLER,
)

from . import rs
from .encode import encode_frame
from .viterbi import bits_to_bytes, viterbi27_bits

# de-interleave gather: symbols[(col-1)*65 + row] = raw[row*80 + col]
_COL = np.arange(1, ROWS).repeat(COLUMNS)
_ROW = np.tile(np.arange(COLUMNS), ROWS - 1)
_DEINT_IDX = np.asarray((_ROW * ROWS + _COL)[: 2 * NBITS], dtype=np.int64)

_SCRAM320 = np.asarray(SCRAMBLER[:320], dtype=np.uint8)


class FecResult(NamedTuple):
    payload: torch.Tensor    # [..., 256] uint8 (zeros when not ok)
    ok: torch.Tensor         # [...] bool
    rs_errors: torch.Tensor  # [..., 2] int32, -1 per failed codeword
    rc: torch.Tensor         # [...] int32: channel symbol errors, or -1


def deinterleave(raw: torch.Tensor) -> torch.Tensor:
    """[B, 5200] soft symbols -> [B, 5132] Viterbi input."""
    return raw[:, torch.as_tensor(_DEINT_IDX, device=raw.device)]


def descramble_demux(vitdec: torch.Tensor) -> torch.Tensor:
    """[B, 320] bytes -> [B, 2, 255] zero-padded RS codewords."""
    un = vitdec ^ torch.as_tensor(_SCRAM320, device=vitdec.device)
    cols = un.reshape(-1, NN - RSPAD, RSBLOCKS).transpose(1, 2)
    pad = torch.zeros((un.shape[0], RSBLOCKS, RSPAD), dtype=torch.uint8,
                      device=un.device)
    return torch.cat([pad, cols], dim=2)


def fec_decode(raw: torch.Tensor) -> FecResult:
    """Batched frame decode: [..., 5200] uint8 soft symbols -> FecResult
    (>= 0x80 means symbol 1; the Viterbi metric reads the full byte)."""
    lead = raw.shape[:-1]
    raw = raw.reshape(-1, raw.shape[-1])
    n_batch = raw.shape[0]
    vitdec = bits_to_bytes(viterbi27_bits(deinterleave(raw)))
    blocks = descramble_demux(vitdec).reshape(n_batch * RSBLOCKS, NN)
    corrected, nerr = rs.decode_rs_codeword(blocks)
    corrected = corrected.reshape(n_batch, RSBLOCKS, NN)
    nerr = nerr.reshape(n_batch, RSBLOCKS)
    ok = (nerr >= 0).all(dim=1)
    payload = corrected[:, :, RSPAD:KK].transpose(1, 2).reshape(n_batch, -1)
    payload = torch.where(ok[:, None], payload, 0).to(torch.uint8)
    errors = (encode_frame(payload) != (raw >> 7)).sum(dim=1)
    rc = torch.where(ok, errors, -1).to(torch.int32)
    return FecResult(payload.reshape(*lead, -1), ok.reshape(lead),
                     nerr.reshape(*lead, RSBLOCKS), rc.reshape(lead))
