"""Constant tables of the FEC kernels (``ops/csrc/fec_viterbi.cu`` and
``ops/csrc/fec_rs.cu``), built on the host from :mod:`.tables` and
uploaded once a device. The layouts are the kernels' (each source names
its offsets)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..runtime.device import device_table
from .tables import (
    ALPHA_TO, INDEX_OF, METTAB, NN, NROOTS, RS_POLY, SCRAMBLER, SYMS,
    SYNC_BITS,
)

# RS generator coefficients g[0..31] in log form, palindromic
# (FECDecoder.java:544-546, 634-641); g[0] = 0 feeds the shifted-out cell
GPOLY = np.zeros(NROOTS, dtype=np.int64)
GPOLY[1:16] = RS_POLY[:15]
GPOLY[16] = RS_POLY[15]
GPOLY[17:32] = RS_POLY[14::-1][:15]

# kernel A: int32 METTAB row 0, row 1, then the branch pairs SYM_A, SYM_B
VITERBI_TABLE = np.concatenate([
    np.asarray(METTAB, np.int64).reshape(-1), SYMS[0:64:2], SYMS[1:64:2],
]).astype(np.int32)

# ALPHA_TO doubled: entry i is alpha^(i % 255), so that alpha^(a + b) for
# logs a, b < 255 is one lookup (entries 510, 511 are read only where a
# log is A0, and discarded)
ALPHA2 = np.asarray(ALPHA_TO)[np.arange(512) % NN].astype(np.uint8)

# kernel B: uint8 ALPHA2 [0, 512), INDEX_OF [512, 768), the parity map's
# logs [768, 4864) (R[k][j] at 768 + 32k + j), SCRAMBLER[:320] [4864,
# 5184), SYNC_BITS [5184, 5249), zeros to 5264
RS_OFFSETS = {"alpha": 0, "index": 512, "parity": 768, "scrambler": 4864,
              "sync": 5184, "end": 5264}


@functools.lru_cache(maxsize=None)
def parity_map() -> np.ndarray:
    """R [128, 32] uint8: the RS parity of a codeword is linear over
    GF(256) in its 128 data bytes, parity[j] = XOR_k data[k] * R[k][j].
    Row k is the parity of the unit input (data byte k = 1, the rest 0),
    from the port's own plain LFSR (:func:`.encode.rs_parity`)."""
    from .encode import rs_parity

    n_data = 128
    unit = torch.zeros((n_data, 2 * n_data), dtype=torch.uint8)
    unit[torch.arange(n_data), 2 * torch.arange(n_data)] = 1
    return rs_parity(unit)[:, 0].numpy()          # codeword 0's parity


@functools.lru_cache(maxsize=None)
def rs_table() -> np.ndarray:
    """Kernel B's uint8 table blob, laid out as ``RS_OFFSETS`` says."""
    off = RS_OFFSETS
    tab = np.zeros(off["end"], np.uint8)
    tab[off["alpha"]:off["index"]] = ALPHA2
    tab[off["index"]:off["parity"]] = INDEX_OF
    tab[off["parity"]:off["scrambler"]] = np.asarray(INDEX_OF)[
        parity_map()].reshape(-1)
    tab[off["scrambler"]:off["sync"]] = SCRAMBLER[:320]
    tab[off["sync"]:off["sync"] + len(SYNC_BITS)] = SYNC_BITS
    return tab


@device_table(maxsize=None)
def viterbi_table_on(device: torch.device) -> torch.Tensor:
    """Kernel A's ``VITERBI_TABLE`` on ``device``."""
    return torch.as_tensor(VITERBI_TABLE, device=device)


@device_table(maxsize=None)
def rs_table_on(device: torch.device) -> torch.Tensor:
    """Kernel B's :func:`rs_table` on ``device``."""
    return torch.as_tensor(rs_table(), device=device)
