"""Constant tables of the FEC kernels (``ops/csrc/fec_viterbi.cu`` and
``ops/csrc/fec_rs.cu``), built on the host from :mod:`.tables` and
uploaded once a device. The layouts are the kernels' (each source names
its offsets)."""

from __future__ import annotations

import numpy as np
import torch

from .tables import (
    ALPHA_TO, INDEX_OF, METTAB, NROOTS, RS_POLY, SCRAMBLER, SYMS, SYNC_BITS,
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

# kernel B: uint8 ALPHA_TO [0, 256), INDEX_OF [256, 512), g [512, 544),
# SCRAMBLER[:320] [544, 864), SYNC_BITS [864, 929)
RS_OFFSETS = {"alpha": 0, "index": 256, "gen": 512, "scrambler": 544,
              "sync": 864}
RS_TABLE = np.concatenate([
    np.asarray(ALPHA_TO), np.asarray(INDEX_OF), GPOLY,
    np.asarray(SCRAMBLER[:320]), np.asarray(SYNC_BITS),
]).astype(np.uint8)

_CACHE: dict = {}


def device_table(name: str, device: torch.device) -> torch.Tensor:
    """``VITERBI_TABLE`` ("viterbi") or ``RS_TABLE`` ("rs") on ``device``,
    uploaded on its first use there and kept."""
    key = (name, str(device))
    if key not in _CACHE:
        host = {"viterbi": VITERBI_TABLE, "rs": RS_TABLE}[name]
        _CACHE[key] = torch.as_tensor(host, device=device)
    return _CACHE[key]
