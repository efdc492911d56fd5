"""Plain numpy AO-40 FEC codec for the benchmark: the traffic generator's
encoder and the reference's frame decoder.

The semantics are those of the reference implementation
(FECDecoder.java:677-852), as the port's numpy oracle
``jsdr_tpu_torch/fec/ref_numpy.py`` has them; this file is a frozen copy
of that oracle with the per-frame loops batched over frames, so that a
drain's few hundred windows decode in a fraction of a second:

- :func:`encode_batch`: [F, 256] payloads -> [F, 5200] hard channel
  symbols (RS parity, scramble, convolutional encode, block interleave,
  sync column);
- :func:`decode_batch`: [B, 5200] soft symbols -> payloads, ok flags and
  the re-encoded channel-symbol error counts (de-interleave, Viterbi,
  descramble, two RS(255,223) codewords, re-encode check).

:func:`decode_rs_8` is the oracle's per-codeword decoder, which corrects
a codeword whose syndromes are not all zero; its syndromes come from the
batched :func:`syndromes_batch`. The tests hold both directions to the
port's oracle.
"""

from __future__ import annotations

import numpy as np

from .ao40_tables import (
    A0, ALPHA_TO, BLOCKSIZE, COLUMNS, CPOLYA, CPOLYB, FCR, INDEX_OF, IPRIM,
    K, KK, METTAB, NBITS, NN, NROOTS, PARTAB, PRIM, ROWS, RSBLOCKS, RSPAD,
    RS_POLY, SCRAMBLER, SYMPBLOCK, SYMS, SYNC_BITS,
)

K_FLUSH = K - 1          # convolutional tail bits
_SCRAM320 = SCRAMBLER[:320].astype(np.uint8)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _gf_mul_log(log_a, log_b):
    """GF(256) product of elements given in log form (A0 marks zero)."""
    log_a, log_b = np.asarray(log_a), np.asarray(log_b)
    prod = ALPHA_TO[(log_a + log_b) % 255]
    return np.where((log_a == A0) | (log_b == A0), 0, prod)


def rs_parity_batch(payloads: np.ndarray) -> np.ndarray:
    """RS(255,223) parity of the two interleaved codewords of each
    payload: [F, 256] -> [F, 2, 32]. Byte n feeds codeword n & 1
    (FECDecoder.java:614-655)."""
    payloads = np.asarray(payloads, np.uint8)
    f = payloads.shape[0]
    blocks = np.zeros((f, RSBLOCKS, NROOTS), np.int64)
    for n in range(BLOCKSIZE):
        reg = blocks[:, n & 1]
        feedback = INDEX_OF[payloads[:, n].astype(np.int64) ^ reg[:, 0]]
        for j in range(15):
            t = _gf_mul_log(feedback, int(RS_POLY[j]))
            reg[:, j + 1] ^= t
            reg[:, 31 - j] ^= t
        reg[:, 16] ^= _gf_mul_log(feedback, int(RS_POLY[15]))
        reg[:, :31] = reg[:, 1:].copy()
        reg[:, 31] = np.where(feedback != A0, ALPHA_TO[feedback % 256], 0)
    return blocks.astype(np.uint8)


def frame_bytes_batch(payloads: np.ndarray) -> np.ndarray:
    """[F, 256] payloads -> [F, 320] scrambler-input bytes (payload, then
    the two codewords' parity interleaved)."""
    parity = rs_parity_batch(payloads)
    tail = parity.transpose(0, 2, 1).reshape(parity.shape[0], 2 * NROOTS)
    return np.concatenate([np.asarray(payloads, np.uint8), tail], axis=1)


def _channel_symbols(scrambled: np.ndarray) -> np.ndarray:
    """[F, 320] scrambled bytes -> [F, 5200] interleaved channel symbols."""
    f = scrambled.shape[0]
    bits = np.unpackbits(scrambled, axis=1)
    bits = np.concatenate([bits, np.zeros((f, K_FLUSH), np.uint8)], axis=1)
    # the encoder's shift register after bit t: bits t-6 ... t, newest low
    padded = np.concatenate([np.zeros((f, K - 1), np.int64),
                             bits.astype(np.int64)], axis=1)
    sr = np.zeros((f, NBITS), np.int64)
    for k in range(K):
        sr |= padded[:, K - 1 - k:K - 1 - k + NBITS] << k
    syms = np.empty((f, 2 * NBITS), np.uint8)
    syms[:, 0::2] = PARTAB[sr & CPOLYA]
    syms[:, 1::2] = 1 - PARTAB[sr & CPOLYB]
    frame = np.zeros((f, COLUMNS, ROWS), np.uint8)
    frame[:, :, 0] = SYNC_BITS
    bindex = np.arange(2 * NBITS) + COLUMNS
    frame[:, bindex % COLUMNS, bindex // COLUMNS] = syms
    return frame.reshape(f, SYMPBLOCK)


def encode_batch(payloads: np.ndarray) -> np.ndarray:
    """[F, 256] uint8 payloads -> [F, 5200] hard channel symbols (0/1),
    symbol i transmitted i-th."""
    return _channel_symbols(frame_bytes_batch(payloads) ^ _SCRAM320)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def deinterleave_batch(raw: np.ndarray) -> np.ndarray:
    """[B, 5200] soft symbols -> [B, 5132] de-interleaved symbols, the sync
    column skipped (FECDecoder.java:707-723)."""
    raw = np.asarray(raw, np.uint8).reshape(-1, COLUMNS, ROWS)
    return raw[:, :, 1:].transpose(0, 2, 1).reshape(raw.shape[0], -1)[
        :, :2 * NBITS]


def viterbi_batch(symbols: np.ndarray) -> np.ndarray:
    """Soft-decision Viterbi, k=7 r=1/2 (FECDecoder.java:203-278), over
    [B, 5132] symbols -> [B, 320] bytes; the chain-back starts at state
    0. Metrics are int64, ties keep the first path, as the oracle's."""
    symbols = np.asarray(symbols, np.int64)
    b = symbols.shape[0]
    n_even = np.arange(0, 64, 2)
    sym_a, sym_b = SYMS[n_even], SYMS[n_even + 1]
    metric = np.full((b, 64), -999999, np.int64)
    metric[:, 0] = 0
    decisions = np.zeros((NBITS, b, 64), bool)
    nmetric = np.empty_like(metric)
    for t in range(NBITS):
        s0, s1 = symbols[:, 2 * t], symbols[:, 2 * t + 1]
        mets = np.stack([METTAB[0, s0] + METTAB[0, s1],
                         METTAB[0, s0] + METTAB[1, s1],
                         METTAB[1, s0] + METTAB[0, s1],
                         METTAB[1, s0] + METTAB[1, s1]], axis=1)
        b1, b2 = mets[:, sym_a], mets[:, sym_b]
        lo, hi = metric[:, :32], metric[:, 32:]
        even_a, even_b = lo + b1, hi + b2
        odd_a, odd_b = lo + b2, hi + b1
        nmetric[:, 0::2] = np.maximum(even_a, even_b)
        nmetric[:, 1::2] = np.maximum(odd_a, odd_b)
        decisions[t, :, 0::2] = even_b > even_a
        decisions[t, :, 1::2] = odd_b > odd_a
        metric, nmetric = nmetric, metric
    out = np.zeros((b, NBITS), np.uint8)
    state = np.zeros(b, np.int64)
    rows = np.arange(b)
    for i in range(NBITS - 7, -1, -1):
        dec = decisions[i + 6, rows, state]
        out[:, i] = dec
        state = (state >> 1) | np.where(dec, 0x20, 0)
    return np.packbits(out[:, :NBITS - K_FLUSH], axis=1)


def descramble_demux_batch(vitdec: np.ndarray) -> np.ndarray:
    """[B, 320] Viterbi bytes -> [B, 2, 255] zero-padded RS codewords
    (FECDecoder.java:763-771)."""
    un = np.asarray(vitdec, np.uint8) ^ _SCRAM320
    out = np.zeros((un.shape[0], RSBLOCKS, NN), np.uint8)
    out[:, :, RSPAD:] = un.reshape(-1, NN - RSPAD, RSBLOCKS).transpose(0, 2, 1)
    return out


def syndromes_batch(words: np.ndarray) -> np.ndarray:
    """[W, 255] codewords -> [W, 32] syndromes s_i = data(alpha^((FCR+i)
    * PRIM)) by Horner's rule, as :func:`decode_rs_8` computes them."""
    words = np.asarray(words, np.int64)
    mul = (FCR + np.arange(NROOTS)) * PRIM % 255
    acc = np.repeat(words[:, :1], NROOTS, axis=1)
    for j in range(1, NN):
        step = ALPHA_TO[(INDEX_OF[acc] + mul) % 255]
        acc = words[:, j:j + 1] ^ np.where(acc == 0, 0, step)
    return acc


def decode_rs_8(data: np.ndarray) -> tuple[np.ndarray, int]:
    """One RS(255,223) codeword: (corrected copy, errors corrected) or
    (data, -1) on failure; Berlekamp-Massey, Chien and Forney without
    erasures (FECDecoder.java:325-519). The oracle's function."""
    data = np.asarray(data, dtype=np.uint8).copy()
    s = syndromes_batch(data[None])[0]
    if not s.any():
        return data, 0
    s_log = INDEX_OF[s]

    lam = np.zeros(NROOTS + 1, dtype=np.int64)
    lam[0] = 1
    b = INDEX_OF[lam].copy()
    el = 0
    for r in range(1, NROOTS + 1):
        discr = 0
        for i in range(r):
            if lam[i] != 0 and s_log[r - i - 1] != A0:
                discr ^= int(ALPHA_TO[(int(INDEX_OF[lam[i]])
                                       + int(s_log[r - i - 1])) % 255])
        discr_log = int(INDEX_OF[discr])
        if discr_log == A0:
            b[1:] = b[:-1].copy()
            b[0] = A0
        else:
            t = np.zeros(NROOTS + 1, dtype=np.int64)
            t[0] = lam[0]
            for i in range(NROOTS):
                if b[i] != A0:
                    t[i + 1] = lam[i + 1] ^ int(
                        ALPHA_TO[(discr_log + int(b[i])) % 255])
                else:
                    t[i + 1] = lam[i + 1]
            if 2 * el <= r - 1:
                el = r - el
                b = np.where(lam == 0, A0,
                             (INDEX_OF[lam] - discr_log + NN) % 255)
            else:
                b[1:] = b[:-1].copy()
                b[0] = A0
            lam = t
    lam_log = INDEX_OF[lam]
    deg_lambda = (int(np.max(np.nonzero(lam_log != A0)[0]))
                  if (lam_log != A0).any() else 0)

    reg = lam_log.copy()
    roots, locs = [], []
    k = IPRIM - 1
    for i in range(1, NN + 1):
        q = 1
        for j in range(deg_lambda, 0, -1):
            if reg[j] != A0:
                reg[j] = (reg[j] + j) % 255
                q ^= int(ALPHA_TO[reg[j]])
        if q == 0:
            roots.append(i)
            locs.append(k)
            if len(roots) == deg_lambda:
                break
        k = (k + IPRIM) % 255
    if deg_lambda != len(roots):
        return data, -1

    omega_log = np.full(NROOTS + 1, A0, dtype=np.int64)
    deg_omega = 0
    for i in range(NROOTS):
        tmp = 0
        for j in range(min(deg_lambda, i), -1, -1):
            if s_log[i - j] != A0 and lam_log[j] != A0:
                tmp ^= int(ALPHA_TO[(int(s_log[i - j])
                                     + int(lam_log[j])) % 255])
        if tmp != 0:
            deg_omega = i
        omega_log[i] = INDEX_OF[tmp]

    for j in range(len(roots) - 1, -1, -1):
        num1 = 0
        for i in range(deg_omega, -1, -1):
            if omega_log[i] != A0:
                num1 ^= int(ALPHA_TO[(int(omega_log[i]) + i * roots[j])
                                     % 255])
        num2 = int(ALPHA_TO[(roots[j] * (FCR - 1) + NN) % 255])
        den = 0
        for i in range(min(deg_lambda, NROOTS - 1) & ~1, -1, -2):
            if lam_log[i + 1] != A0:
                den ^= int(ALPHA_TO[(int(lam_log[i + 1]) + i * roots[j])
                                    % 255])
        if den == 0:
            return data, -1
        if num1 != 0:
            data[locs[j]] ^= ALPHA_TO[
                (int(INDEX_OF[num1]) + int(INDEX_OF[num2]) + NN
                 - int(INDEX_OF[den])) % 255]
    return data, len(roots)


def decode_batch(raw: np.ndarray):
    """Full AO-40 frame decode (FECDecoder.java:703-852) of [B, 5200] soft
    symbol bytes (>= 0x80 is symbol 1). Returns (payload [B, 256] uint8,
    zeros where not ok; ok [B] bool; rc [B] int: the re-encoded frame's
    channel-symbol errors against the hard symbols, -1 where not ok)."""
    raw = np.asarray(raw, np.uint8).reshape(-1, SYMPBLOCK)
    b = raw.shape[0]
    payload = np.zeros((b, BLOCKSIZE), np.uint8)
    ok = np.zeros(b, bool)
    rc = np.full(b, -1, np.int64)
    if not b:
        return payload, ok, rc
    words = descramble_demux_batch(viterbi_batch(deinterleave_batch(raw)))
    flat = words.reshape(b * RSBLOCKS, NN)
    dirty = syndromes_batch(flat).any(axis=1)
    fixed = flat.copy()
    good = np.ones(b * RSBLOCKS, bool)
    for w in np.nonzero(dirty)[0]:
        fixed[w], n_err = decode_rs_8(flat[w])
        good[w] = n_err >= 0
    ok = good.reshape(b, RSBLOCKS).all(axis=1)
    data = fixed.reshape(b, RSBLOCKS, NN)[:, :, RSPAD:KK]
    payload = np.where(ok[:, None],
                       data.transpose(0, 2, 1).reshape(b, BLOCKSIZE), 0
                       ).astype(np.uint8)
    if ok.any():
        reenc = encode_batch(payload[ok])
        rc[ok] = np.count_nonzero(reenc != (raw[ok] >> 7), axis=1)
    return payload, ok, rc
