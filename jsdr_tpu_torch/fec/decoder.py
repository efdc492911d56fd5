"""Full AO-40 frame decode, batched — the port of
:mod:`jsdr_tpu.fec.decoder` (``FECDecoder.FECDecode``,
FECDecoder.java:703-852).

1. de-interleave 5200 soft symbols -> 5132 (index gather)
2. Viterbi k=7 r=1/2 -> 320 bytes (:mod:`jsdr_tpu_torch.fec.viterbi`)
3. descramble + demux -> 2x shortened RS(255,223)
4. RS decode both codewords (:mod:`jsdr_tpu_torch.fec.rs`)
5. re-encode the payload and count channel symbol errors
   (:mod:`jsdr_tpu_torch.fec.encode`)

On a card, :func:`fec_decode` is two launches: kernel A
(``viterbi27_bytes``: steps 1-2) and kernel B (:func:`fec_check`: steps
3-5, ``ops/csrc/fec_rs.cu``); on the CPU the same two wrappers run the
plain versions. :func:`_fec_check_lanes` is kernel B's walk in plain
PyTorch; only the tests call it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import _build
from . import _device, rs
from .encode import _channel_symbols, _rs_parity_lanes, encode_frame
from .tables import (
    BLOCKSIZE, KK, NN, NROOTS, RSBLOCKS, RSPAD, SCRAMBLER, SYMPBLOCK,
)
from .viterbi import deinterleave, viterbi27_bytes  # noqa: F401

_SCRAM320 = np.asarray(SCRAMBLER[:320], dtype=np.uint8)
_VIT_BYTES = 320


class FecResult(NamedTuple):
    payload: torch.Tensor    # [..., 256] uint8 (zeros when not ok)
    ok: torch.Tensor         # [...] bool
    rs_errors: torch.Tensor  # [..., 2] int32, -1 per failed codeword
    rc: torch.Tensor         # [...] int32: channel symbol errors, or -1


def descramble_demux(vitdec: torch.Tensor) -> torch.Tensor:
    """[B, 320] bytes -> [B, 2, 255] zero-padded RS codewords."""
    un = vitdec ^ torch.as_tensor(_SCRAM320, device=vitdec.device)
    cols = un.reshape(-1, NN - RSPAD, RSBLOCKS).transpose(1, 2)
    pad = torch.zeros((un.shape[0], RSBLOCKS, RSPAD), dtype=torch.uint8,
                      device=un.device)
    return torch.cat([pad, cols], dim=2)


def _finish(raw, corrected, nerr, reencode) -> FecResult:
    """payload, ok, rs_errors and rc from both codewords' decode [B, 2,
    255] / [B, 2] and the re-encode of a payload ([B, 256] -> [B, 5200])."""
    n_batch = raw.shape[0]
    ok = (nerr >= 0).all(dim=1)
    payload = corrected[:, :, RSPAD:KK].transpose(1, 2).reshape(n_batch,
                                                              BLOCKSIZE)
    payload = torch.where(ok[:, None], payload, 0).to(torch.uint8)
    errors = (reencode(payload) != (raw >> 7)).sum(dim=1)
    rc = torch.where(ok, errors, -1).to(torch.int32)
    return FecResult(payload, ok, nerr, rc)


def _fec_check_ref(vitdec: torch.Tensor, raw: torch.Tensor) -> FecResult:
    """Plain version of kernel B: steps 3-5 over [B, 320] Viterbi bytes
    and the [B, 5200] channel frames they came from."""
    n_batch = raw.shape[0]
    blocks = descramble_demux(vitdec).reshape(n_batch * RSBLOCKS, NN)
    corrected, nerr = rs.decode_rs_codeword(blocks)
    return _finish(raw, corrected.reshape(n_batch, RSBLOCKS, NN),
                   nerr.reshape(n_batch, RSBLOCKS), encode_frame)


def _fec_check_lanes(vitdec: torch.Tensor, raw: torch.Tensor) -> FecResult:
    """Kernel B's walk in plain PyTorch (CPU): each codeword through the
    4-warp walk :func:`rs._decode_rs_lanes` (syndromes from RSPAD on: the
    pad is zero), the re-encode through the parity's table product
    :func:`_rs_parity_lanes` and the per-position symbols of
    :func:`_channel_symbols`. Nothing on the main path calls it."""
    n_batch = raw.shape[0]
    blocks = descramble_demux(vitdec).reshape(n_batch * RSBLOCKS, NN)
    corrected, nerr = rs._decode_rs_lanes(blocks, first=RSPAD)

    def reencode(payload):
        parity = _rs_parity_lanes(payload).transpose(1, 2).reshape(
            n_batch, 2 * NROOTS)
        seq = torch.cat([payload, parity], dim=1)
        scram = torch.as_tensor(_SCRAM320)
        return _channel_symbols(seq ^ scram)

    return _finish(raw, corrected.reshape(n_batch, RSBLOCKS, NN),
                   nerr.reshape(n_batch, RSBLOCKS), reencode)


@_build.counts_launches
def fec_check(vitdec: torch.Tensor, raw: torch.Tensor) -> FecResult:
    """Kernel B: [B, 320] Viterbi bytes and the [B, 5200] uint8 channel
    frames they came from -> FecResult over [B] (descramble + demux, both
    RS codewords, payload, ok, the re-encode and rc).

    CPU tensors run :func:`_fec_check_ref`; CUDA tensors launch the frame
    kernel (and count the launch in ``fec_check.launches``)."""
    n = raw.shape[0]
    dev = raw.device
    _build.check_tensor("fec_check", "vitdec", vitdec, (n, _VIT_BYTES),
                        torch.uint8, dev)
    _build.check_tensor("fec_check", "raw", raw, (n, SYMPBLOCK),
                        torch.uint8, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fec_check: unsupported device {dev}")
    if dev.type == "cpu" and n:
        return _fec_check_ref(vitdec, raw)
    payload = torch.empty((n, BLOCKSIZE), dtype=torch.uint8, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    rs_errors = torch.empty((n, RSBLOCKS), dtype=torch.int32, device=dev)
    rc = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        tab = _device.rs_table_on(dev)
        lib = _build.kernels()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.jsdr_fec_frame(
                vitdec.data_ptr(), raw.data_ptr(), tab.data_ptr(),
                payload.data_ptr(), ok.data_ptr(), rs_errors.data_ptr(),
                rc.data_ptr(), n, stream)
        _build.check(code, "fec_check")
        fec_check.launches += 1
    return FecResult(payload, ok, rs_errors, rc)


def fec_decode(raw: torch.Tensor) -> FecResult:
    """Batched frame decode: [..., 5200] uint8 soft symbols -> FecResult
    (>= 0x80 means symbol 1; the Viterbi metric reads the full byte).
    Kernels A and B on a card (two launches, none for an empty batch),
    their plain versions on the CPU."""
    lead = raw.shape[:-1]
    flat = raw.reshape(-1, raw.shape[-1]).contiguous()
    res = fec_check(viterbi27_bytes(flat), flat)
    return FecResult(res.payload.reshape(*lead, BLOCKSIZE),
                     res.ok.reshape(lead),
                     res.rs_errors.reshape(*lead, RSBLOCKS),
                     res.rc.reshape(lead))
