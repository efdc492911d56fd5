"""Batched AO-40 encoder on the device — the port of
:mod:`jsdr_tpu.fec.encode` used by the decoder's re-encode check
(FECDecoder.java:538-688, 831-847).

The plain version :func:`encode_frame`: RS parity is a 128-step LFSR
over both interleaved codewords, vectorised over the batch; scrambling is
an XOR; the convolutional encoder needs no shift register (the state
after bit t is the window of the last 7 bits); interleaving and the sync
column are index writes. :func:`encode_fec40` takes any leading shape:
CPU tensors run the plain version, CUDA tensors launch the encode kernel
of ``ops/csrc/fec_rs.cu`` (the re-encode of the drain's kernel B runs the
same device code, the parity as a table product over
``_device.parity_map``). :func:`_rs_parity_lanes` and
:func:`_channel_symbols` are that code's walk in plain PyTorch; only the
tests call them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _build
from . import _device
from ._device import GPOLY as _GPOLY
from .rs import xor_reduce
from .tables import (
    A0, ALPHA_TO, BLOCKSIZE, COLUMNS, CPOLYA, CPOLYB, INDEX_OF, NBITS, NROOTS,
    PARTAB, ROWS, SCRAMBLER, SYMPBLOCK, SYNC_BITS,
)

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


def encode_bytes(seq: torch.Tensor) -> torch.Tensor:
    """[B, 320] frame bytes (payload, then the parity interleaved) -> [B,
    5200] hard channel symbols (0/1 uint8): scramble, convolutional
    encode, interleave, sync."""
    dev = seq.device
    n_batch = seq.shape[0]
    scram = torch.as_tensor(np.asarray(SCRAMBLER[:320]), device=dev)
    scrambled = seq.long() ^ scram
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


def encode_frame(payload: torch.Tensor) -> torch.Tensor:
    """[B, 256] payload bytes -> [B, 5200] hard channel symbols (0/1
    uint8): RS parity, scramble, convolutional encode, interleave, sync."""
    n_batch = payload.shape[0]
    parity = rs_parity(payload)                               # [B, 2, 32]
    seq = torch.cat([payload.long(),
                     parity.long().transpose(1, 2).reshape(n_batch, -1)],
                    dim=1)                                    # [B, 320]
    return encode_bytes(seq)


@_build.counts_launches
def encode_fec40(payload: torch.Tensor) -> torch.Tensor:
    """Batched encode: [..., 256] uint8 payload -> [..., 5200] symbols, the
    counterpart of ``jsdr_tpu.fec.encode.encode_fec40``.

    CPU tensors run :func:`encode_frame`; CUDA tensors launch the encode
    kernel (and count the launch in ``encode_fec40.launches``)."""
    if payload.dim() < 1 or payload.shape[-1] != BLOCKSIZE:
        raise ValueError(f"encode_fec40: want [..., {BLOCKSIZE}] payloads, "
                         f"got {tuple(payload.shape)}")
    lead = payload.shape[:-1]
    flat = payload.reshape(-1, BLOCKSIZE).contiguous()
    dev = flat.device
    _build.check_tensor("encode_fec40", "payload", flat, tuple(flat.shape),
                        torch.uint8, dev)
    n = flat.shape[0]
    if dev.type == "cpu" and n:
        frame = encode_frame(flat)
    elif dev.type in ("cpu", "cuda"):
        frame = torch.empty((n, SYMPBLOCK), dtype=torch.uint8, device=dev)
        if n:
            tab = _device.rs_table_on(dev)
            lib = _build.kernels()
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                code = lib.jsdr_fec_encode(flat.data_ptr(), tab.data_ptr(),
                                           frame.data_ptr(), n, stream)
            _build.check(code, "encode_fec40")
            encode_fec40.launches += 1
    else:
        raise ValueError(f"encode_fec40: unsupported device {dev}")
    return frame.reshape(*lead, SYMPBLOCK)


def encode_frame_affine(payload: torch.Tensor) -> torch.Tensor:
    """[..., 256] payload bytes -> [..., 5200] symbols: the port's encoder
    (:func:`encode_fec40`) under the reference's name. The reference's
    affine form (one 0/1 MXU matmul with a bit matrix built from 2,049
    host encodes) is a TPU form; its values are the contract, and these
    are the same bits."""
    return encode_fec40(payload)


def _rs_parity_lanes(payload: torch.Tensor) -> torch.Tensor:
    """The encode kernel's RS parity in plain PyTorch (CPU): [B, 256] ->
    [B, 2, 32], as the table product the kernel takes. Thread (q, c, j)
    XORs data[k] * R[k][j] over k in [32q, 32q + 32) (data byte k of
    codeword c is payload[2k + c]; R from :func:`_device.parity_map`,
    stored as logs; the product one lookup in the doubled ALPHA_TO, zero
    where either log is A0), and the four quarters are XORed."""
    tab = torch.as_tensor(_device.rs_table()).long()
    off = _device.RS_OFFSETS
    alpha2 = tab[off["alpha"]:off["index"]]
    index = tab[off["index"]:off["parity"]]
    rlog = tab[off["parity"]:off["scrambler"]].reshape(BLOCKSIZE // 2,
                                                       NROOTS)
    n = payload.shape[0]
    dlog = index[payload.long().reshape(n, BLOCKSIZE // 2, 2)]  # [B, k, c]
    dl = dlog.transpose(1, 2)[..., None]                     # [B, c, k, 1]
    term = torch.where((dl == A0) | (rlog == A0), 0, alpha2[dl + rlog])
    quarters = xor_reduce(term.reshape(n, 2, 4, 32, NROOTS), dim=3)
    return xor_reduce(quarters, dim=2).to(torch.uint8)       # [B, 2, 32]


def _channel_symbols(scrambled: torch.Tensor) -> torch.Tensor:
    """The kernel's channel symbols in plain PyTorch (CPU): [B, 320]
    scrambled frame bytes -> [B, 5200]. Position p = col * 80 + row holds
    the sync bit of its column where row = 0, else convolutional symbol
    t = row * 65 + col - 65 (0 past the 5132 symbols), whose state is the
    7-bit window of bits t/2 - 6 .. t/2 read from bytes l - 1 and l of the
    sequence (l = (t/2) >> 3, a zero byte before it and after it), its
    parity a popcount."""
    n = scrambled.shape[0]
    sb = torch.nn.functional.pad(scrambled.long(), (1, 1))   # [B, 322]
    p = torch.arange(SYMPBLOCK)
    row, col = p % ROWS, p // ROWS
    t = row * COLUMNS + col - COLUMNS
    i = (t >> 1).clamp(0, NBITS - 1)
    lb = i >> 3
    window = ((sb[:, lb] << 8 | sb[:, lb + 1]) >> (7 - (i & 7))) & 0x7F
    bit = torch.arange(7)

    def parity(x):
        return ((x[..., None] >> bit) & 1).sum(dim=-1) & 1

    sym = torch.where(t & 1 > 0, 1 - parity(window & CPOLYB),
                      parity(window & CPOLYA))
    sym = torch.where(t >= 2 * NBITS, 0, sym)
    sync = torch.as_tensor(SYNC_BITS, dtype=torch.int64)[col]
    return torch.where(row == 0, sync.expand(n, -1), sym).to(torch.uint8)
