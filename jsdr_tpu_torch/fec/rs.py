"""Batched decoder for the AO-40 shortened RS(255,223) code — the port of
:mod:`jsdr_tpu.fec.rs` (FECDecoder.java:325-519).

The plain version :func:`decode_rs_codeword`: syndromes,
Berlekamp-Massey (32 masked steps), the Chien sweep over all 255 field
points and Forney's error values, each vectorised over the batch of
codewords. GF(256) elements are int64 tensors; A0 (=255) marks log(0).
The log/antilog tables are indexed directly (the reference uses GF(2)
bit-matmuls and nibble one-hot lookups to avoid TPU gathers).
:func:`decode_rs` takes any leading shape: CPU tensors run the plain
version, CUDA tensors launch the RS kernel of ``ops/csrc/fec_rs.cu`` (4
warps a codeword; the frame kernel B of the drain runs the same device
code). :func:`_decode_rs_lanes` is that walk in plain PyTorch; only the
tests call it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _build
from . import _device
from .tables import A0, ALPHA_TO, FCR, INDEX_OF, IPRIM, NN, NROOTS, PRIM

# s_i = XOR_j gfmul(data[j], alpha^SYND_POW[i, j])  (Horner form, :336-347)
_SYND_POW = np.asarray(
    np.outer((FCR + np.arange(NROOTS)) * PRIM, NN - 1 - np.arange(NN)) % 255)
# lambda(alpha^i) = XOR_j gfmul(lam[j], alpha^(i*j)) for i = 1..255
_CHIEN_POW = np.asarray(
    np.outer(np.arange(1, NN + 1), np.arange(NROOTS + 1)) % 255)


class _GF:
    """GF(256) tables on one device."""

    def __init__(self, device):
        self.alpha = torch.as_tensor(ALPHA_TO, dtype=torch.int64,
                                     device=device)
        self.index = torch.as_tensor(INDEX_OF, dtype=torch.int64,
                                     device=device)

    def mul_log(self, log_a, log_b):
        """alpha^log_a * alpha^log_b, zero when either log is A0."""
        zero = (log_a == A0) | (log_b == A0)
        return torch.where(zero, 0, self.alpha[(log_a + log_b) % 255])


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of byte values along ``dim`` (bitwise parity per bit plane)."""
    out = torch.zeros_like(x.select(dim, 0))
    for k in range(8):
        out |= ((x >> k) & 1).sum(dim=dim) % 2 << k
    return out


def syndromes(data: torch.Tensor, gf: _GF) -> torch.Tensor:
    """[B, 255] codeword bytes -> [B, 32] syndromes (poly form)."""
    pw = torch.as_tensor(_SYND_POW, device=data.device)          # [32, 255]
    terms = gf.mul_log(gf.index[data.long()][:, None, :], pw[None])
    return xor_reduce(terms, dim=2)


def _berlekamp_massey(s_log: torch.Tensor, gf: _GF) -> torch.Tensor:
    """Error locator polynomial (poly form [B, 33]) from log-form
    syndromes [B, 32]; mirrors :385-427 with no erasures."""
    n_batch = s_log.shape[0]
    dev = s_log.device
    idx = torch.arange(NROOTS + 1, device=dev)
    lam = torch.zeros((n_batch, NROOTS + 1), dtype=torch.int64, device=dev)
    lam[:, 0] = 1
    b = torch.full_like(lam, A0)
    b[:, 0] = 0
    el = torch.zeros((n_batch, 1), dtype=torch.int64, device=dev)
    a0_col = torch.full((n_batch, 1), A0, dtype=torch.int64, device=dev)
    for r in range(1, NROOTS + 1):
        # discrepancy: XOR_{i<r} gfmul(lam[i], s[r-1-i])
        s_at = s_log[:, (r - 1 - idx).clamp(0, NROOTS - 1)]
        terms = torch.where(idx < r, gf.mul_log(gf.index[lam], s_at), 0)
        discr_log = gf.index[xor_reduce(terms, dim=1)][:, None]
        no_update = discr_log == A0
        xb = torch.cat([a0_col, b[:, :-1]], dim=1)          # x * b(x)
        t = lam ^ gf.mul_log(discr_log.expand_as(xb), xb)
        grow = (2 * el) <= (r - 1)
        b_scaled = torch.where(lam == 0, A0,
                               (gf.index[lam] - discr_log + NN) % 255)
        b = torch.where(no_update | ~grow, xb, b_scaled)
        el = torch.where(no_update | ~grow, el, r - el)
        lam = torch.where(no_update, lam, t)
    return lam


def _chien_forney(lam: torch.Tensor, s_log: torch.Tensor, gf: _GF):
    """Error locations and values: (err [B, 255], count [B], fail [B])."""
    dev = lam.device
    n_batch = lam.shape[0]
    lam_log = gf.index[lam]                                      # [B, 33]
    j_idx = torch.arange(NROOTS + 1, device=dev)
    deg = torch.where(lam_log != A0, j_idx, 0).amax(dim=1)

    # Chien sweep: evaluate lambda at alpha^i for i = 1..255
    pw = torch.as_tensor(_CHIEN_POW, device=dev)                # [255, 33]
    q = xor_reduce(gf.mul_log(lam_log[:, None, :], pw[None]), dim=2)
    is_root = q == 0                                             # [B, 255]
    count = is_root.sum(dim=1)
    # a degree-d polynomial has at most d roots: the full sweep finds the
    # set the reference's early-exit sweep finds
    fail = count != deg

    # the first NROOTS roots into fixed slots, in increasing order
    order = torch.argsort((~is_root).to(torch.uint8), dim=1, stable=True)
    root_pos = order[:, :NROOTS]
    valid = is_root.gather(1, root_pos)
    roots = torch.where(valid, root_pos + 1, 0)                  # [B, 32]
    locs = (IPRIM - 1 + (roots - 1) * IPRIM) % 255

    # omega(x) = s(x) * lambda(x) mod x^NROOTS, log form
    i_o = torch.arange(NROOTS, device=dev)[:, None]
    j_o = torch.arange(NROOTS + 1, device=dev)[None, :]
    s_at = s_log[:, (i_o - j_o).clamp(0, NROOTS - 1)]           # [B, 32, 33]
    terms = torch.where(j_o <= i_o, gf.mul_log(s_at, lam_log[:, None, :]), 0)
    omega_log = gf.index[xor_reduce(terms, dim=2)]               # [B, 32]

    # Forney: error value at each root
    r = roots[:, :, None]                                        # [B, 32, 1]
    k = torch.arange(NROOTS, device=dev)[None, None, :]
    num1 = xor_reduce(gf.mul_log(omega_log[:, None, :], (k * r) % 255), dim=2)
    num2 = gf.alpha[(roots * (FCR - 1) + NN) % 255]
    d_j = torch.arange(0, NROOTS, 2, device=dev)[None, None, :]  # even i
    den = xor_reduce(gf.mul_log(lam_log[:, None, 1::2][..., :d_j.shape[-1]],
                                (d_j * r) % 255), dim=2)
    den_fail = (valid & (den == 0)).any(dim=1)

    mag_log = (gf.index[num1] + gf.index[num2] + NN - gf.index[den]) % 255
    mag = torch.where(valid & (num1 != 0) & (den != 0), gf.alpha[mag_log], 0)

    # invalid slots go to a spare column that is dropped
    err = torch.zeros((n_batch, NN + 1), dtype=torch.int64, device=dev)
    err.scatter_(1, torch.where(valid, locs, NN), mag)
    return err[:, :NN], count, fail | den_fail


def decode_rs_codeword(data: torch.Tensor):
    """Decode a batch of 255-byte codewords [B, 255] uint8.

    Returns (corrected [B, 255] uint8, n_errors [B] int32) with n_errors
    -1 where the codeword is uncorrectable (decode_rs_8, :325-519)."""
    gf = _GF(data.device)
    s = syndromes(data, gf)
    clean = ~(s != 0).any(dim=1)
    s_log = gf.index[s]
    lam = _berlekamp_massey(s_log, gf)
    err, count, fail = _chien_forney(lam, s_log, gf)
    keep = (clean | fail)[:, None]
    corrected = torch.where(keep, data, (data.long() ^ err).to(torch.uint8))
    n_err = torch.where(clean, 0, torch.where(fail, -1, count))
    return corrected, n_err.to(torch.int32)


@_build.counts_launches
def decode_rs(data: torch.Tensor):
    """Batched RS decode: [..., 255] uint8 -> (corrected [..., 255] uint8,
    n_errors [...] int32), the counterpart of ``jsdr_tpu.fec.rs.decode_rs``.

    CPU tensors run :func:`decode_rs_codeword`; CUDA tensors launch the
    RS kernel (and count the launch in ``decode_rs.launches``)."""
    if data.dim() < 1 or data.shape[-1] != NN:
        raise ValueError(f"decode_rs: want [..., {NN}] codewords, got "
                         f"{tuple(data.shape)}")
    lead = data.shape[:-1]
    flat = data.reshape(-1, NN).contiguous()
    dev = flat.device
    _build.check_tensor("decode_rs", "data", flat, tuple(flat.shape),
                        torch.uint8, dev)
    n = flat.shape[0]
    if dev.type == "cpu" and n:
        corrected, n_err = decode_rs_codeword(flat)
    elif dev.type in ("cpu", "cuda"):
        corrected = torch.empty_like(flat)
        n_err = torch.empty(n, dtype=torch.int32, device=dev)
        if n:
            tab = _device.rs_table_on(dev)
            lib = _build.kernels()
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                code = lib.jsdr_rs_decode(flat.data_ptr(), tab.data_ptr(),
                                          corrected.data_ptr(),
                                          n_err.data_ptr(), n, stream)
            _build.check(code, "decode_rs")
            decode_rs.launches += 1
    else:
        raise ValueError(f"decode_rs: unsupported device {dev}")
    return corrected.reshape(*lead, NN), n_err.reshape(lead)


def _popc(mask: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit ballot word (int64)."""
    return ((mask[..., None] >> torch.arange(32)) & 1).sum(dim=-1)


def _decode_rs_lanes(data: torch.Tensor, first: int = 0):
    """The RS kernel's walk in plain PyTorch (CPU): [B, 255] uint8 ->
    (corrected [B, 255] uint8, n_errors [B] int32), as the kernel computes
    it with 4 warps a codeword. Lane i of warp q computes syndrome s_i over
    its quarter of the bytes [first, 255) (the bytes before ``first`` must
    be zero; the frame kernel passes RSPAD), its power stepping down by
    (FCR + i) * PRIM, and the quarters are XORed; a clean word stops
    there. Berlekamp-Massey keeps lambda_i and b_i in lane i and lambda's
    coefficient 32 in every lane (b's never reaches x * b), the
    discrepancy an XOR butterfly over the lanes, x * b(x) a shift up. The
    Chien sweep takes the 255 points in 8 rounds of 32 lanes (warp q:
    rounds q and q + 4), each round's roots a ballot word; a root's slot
    is its rank over the rounds before it and the lanes below it. Lane i
    computes omega_i, lane k Forney's value at slot k. GF products are one
    lookup in the doubled ALPHA_TO (``_device.ALPHA2``), zero where either
    log is A0. Nothing on the main path calls it."""
    from ._device import ALPHA2

    gf = _GF(data.device)
    index = gf.index
    alpha2 = torch.as_tensor(ALPHA2).long()

    def mul_log(la, lb):
        return torch.where((la == A0) | (lb == A0), 0, alpha2[la + lb])

    n = data.shape[0]
    lane = torch.arange(32)
    d = data.long()
    c = ((FCR + lane) * PRIM) % NN
    quarter = (NN - first + 3) // 4
    s = torch.zeros((n, 32), dtype=torch.int64)
    for q in range(4):
        lo, hi = first + q * quarter, min(first + (q + 1) * quarter, NN)
        part = torch.zeros((n, 32), dtype=torch.int64)
        pw = (c * (NN - 1 - lo)) % NN
        for j in range(lo, hi):
            dj = d[:, j:j + 1]
            part ^= torch.where(dj != 0, alpha2[index[dj] + pw], 0)
            pw = (pw - c) % NN
        s ^= part
    clean = ~(s != 0).any(dim=1)
    s_log = index[s]

    lam = torch.zeros((n, 32), dtype=torch.int64)
    lam[:, 0] = 1
    b = torch.full((n, 32), A0, dtype=torch.int64)
    b[:, 0] = 0
    lam32 = torch.zeros((n, 1), dtype=torch.int64)
    el = torch.zeros((n, 1), dtype=torch.int64)
    a0_col = torch.full((n, 1), A0, dtype=torch.int64)
    for r in range(1, NROOTS + 1):
        sl = s_log[:, (r - 1 - lane) & 31]
        term = torch.where(lane < r, mul_log(index[lam], sl), 0)
        for o in (16, 8, 4, 2, 1):
            term = term ^ term[:, lane ^ o]
        dlog = index[term[:, :1]]
        xb = torch.cat([a0_col, b[:, :31]], dim=1)
        xb32 = b[:, 31:]
        no_update = dlog == A0
        keep = no_update | (2 * el > r - 1)
        bs = torch.where(lam == 0, A0, (index[lam] - dlog + NN) % NN)
        t = lam ^ mul_log(dlog.expand_as(xb), xb)
        t32 = lam32 ^ mul_log(dlog, xb32)
        b = torch.where(keep, xb, bs)
        el = torch.where(keep, el, r - el)
        lam = torch.where(no_update, lam, t)
        lam32 = torch.where(no_update, lam32, t32)
    lamlog = index[torch.cat([lam, lam32], dim=1)]               # [B, 33]
    deg = torch.where(lamlog[:, :32] != A0, lane, 0).amax(dim=1)
    deg = torch.where(lamlog[:, 32] != A0, NROOTS, deg)

    masks, is_root = [], []
    for q in range(8):
        i = 32 * q + lane + 1
        v = torch.zeros((n, 32), dtype=torch.int64)
        p = torch.zeros(32, dtype=torch.int64)
        for j in range(NROOTS + 1):
            v ^= mul_log(lamlog[:, j:j + 1], p.expand(n, 32))
            p = torch.where(p + i >= NN, p + i - NN, p + i)
        root_q = (i <= NN) & (v == 0)
        is_root.append(root_q)
        masks.append((root_q.long() << lane).sum(dim=1, keepdim=True))
    pops = torch.cat([_popc(m) for m in masks], dim=1)           # [B, 8]
    count = pops.sum(dim=1)
    before = pops.cumsum(dim=1) - pops
    below = (1 << lane) - 1
    root = torch.zeros((n, NROOTS + 1), dtype=torch.int64)  # + a spare
    for q in range(8):
        rank = before[:, q:q + 1] + _popc(masks[q] & below)
        slot = torch.where(is_root[q] & (rank < NROOTS), rank, NROOTS)
        root.scatter_(1, slot, torch.where(slot < NROOTS, 32 * q + lane + 1,
                                           0))
    root = root[:, :NROOTS]
    fail = count != deg

    om = torch.zeros((n, 32), dtype=torch.int64)
    for j in range(NROOTS):
        term = mul_log(s_log[:, (lane - j).clamp(min=0)],
                       lamlog[:, j:j + 1].expand(n, 32))
        om ^= torch.where(j <= lane, term, 0)
    omlog = index[om]

    valid = lane < count[:, None]
    num1 = torch.zeros((n, 32), dtype=torch.int64)
    for k in range(NROOTS):
        num1 ^= mul_log(omlog[:, k:k + 1].expand(n, 32), (k * root) % NN)
    num2 = alpha2[(root * (FCR - 1) + NN) % NN]
    den = torch.zeros((n, 32), dtype=torch.int64)
    for m in range(NROOTS // 2):
        den ^= mul_log(lamlog[:, 2 * m + 1:2 * m + 2].expand(n, 32),
                       (2 * m * root) % NN)
    den_zero = (valid & (den == 0)).any(dim=1)
    good = valid & (num1 != 0) & (den != 0)
    mag = torch.where(
        good, alpha2[(index[num1] + index[num2] + NN - index[den]) % NN], 0)
    loc = (IPRIM - 1 + (root - 1) * IPRIM) % NN
    failed = fail | den_zero
    err = torch.zeros((n, NN + 1), dtype=torch.int64)
    err.scatter_(1, torch.where(valid, loc, NN), mag)
    keep = (clean | failed)[:, None]
    corrected = torch.where(keep, data, (d ^ err[:, :NN]).to(torch.uint8))
    n_err = torch.where(clean, 0, torch.where(failed, -1, count))
    return corrected, n_err.to(torch.int32)
