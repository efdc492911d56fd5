"""Batched decoder for the AO-40 shortened RS(255,223) code — the port of
:mod:`jsdr_tpu.fec.rs` (FECDecoder.java:325-519).

Syndromes, Berlekamp-Massey (32 masked steps), the Chien sweep over all
255 field points and Forney's error values, each vectorised over the
batch of codewords. GF(256) elements are int64 tensors; A0 (=255) marks
log(0). The log/antilog tables are indexed directly (the reference uses
GF(2) bit-matmuls and nibble one-hot lookups to avoid TPU gathers).
"""

from __future__ import annotations

import numpy as np
import torch

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
