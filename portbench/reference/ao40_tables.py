"""AO-40 FEC constant tables for the benchmark's reference and generator.

A frozen copy of the port's ``jsdr_tpu_torch/fec/tables.py`` (numpy only),
kept under ``portbench/`` so that the reference and the traffic generator
import nothing of the program. The tables are derived from their
polynomials (parity, GF(256) log/antilog, encoder symbols, CCSDS
scrambler, sync vector) except the soft-decision Viterbi metric table,
which is public data (FECDecoder.java:67-100).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Code parameters (FECDecoder.java:14-36)
# ---------------------------------------------------------------------------
NN = 255          # RS codeword length
KK = 223          # RS data length
NROOTS = 32       # RS parity symbols per codeword
FCR = 112         # first consecutive root
PRIM = 11         # primitive element exponent used by the generator
IPRIM = 116       # inverse of PRIM mod 255
A0 = NN           # log-table marker for zero
BLOCKSIZE = 256   # payload bytes per frame
RSBLOCKS = 2      # interleaved RS codewords
RSPAD = 95        # leading pad (shortened code: 95 + 128 + 32 = 255)

K = 7             # convolutional constraint length
CPOLYA = 0x4F     # first convolutional polynomial
CPOLYB = 0x6D     # second convolutional polynomial (output inverted)
NBITS = (BLOCKSIZE + NROOTS * RSBLOCKS) * 8 + K - 1   # 2566 decoded bits

ROWS = 80         # interleaver columns-per-row in symbol order
COLUMNS = 65      # interleaver rows (symbols per column)
SYMPBLOCK = ROWS * COLUMNS  # 5200 channel symbols per frame
SYNC_POLY = 0x48  # sync-vector LFSR polynomial

GF_POLY = 0x187   # GF(256) field polynomial x^8+x^7+x^2+x+1 (CCSDS)


def _gen_partab() -> np.ndarray:
    """8-bit parity lookup (FECDecoder.java:40-57 embeds the result)."""
    n = np.arange(256, dtype=np.uint16)
    n ^= n >> 4
    n ^= n >> 2
    n ^= n >> 1
    return (n & 1).astype(np.uint8)


PARTAB = _gen_partab()


def _gen_gf_tables() -> tuple[np.ndarray, np.ndarray]:
    """GF(256) antilog/log tables for poly 0x187 (FECDecoder.java:145-181)."""
    alpha_to = np.zeros(256, dtype=np.int64)
    index_of = np.zeros(256, dtype=np.int64)
    sr = 1
    for i in range(255):
        alpha_to[i] = sr
        index_of[sr] = i
        sr <<= 1
        if sr & 0x100:
            sr ^= GF_POLY
        sr &= 0xFF
    alpha_to[255] = 0      # alpha^A0 is read as 0 nowhere, keep 0
    index_of[0] = A0       # log(0) marker
    return alpha_to, index_of


ALPHA_TO, INDEX_OF = _gen_gf_tables()


def _gen_syms() -> np.ndarray:
    """Symbol pair emitted per 7-bit encoder shift-register state.

    Syms[sr] = (symA << 1) | symB with symA = parity(sr & CPOLYA) and
    symB = 1 - parity(sr & CPOLYB) (second encoder output is inverted);
    matches the embedded table at FECDecoder.java:105-114.
    """
    sr = np.arange(128)
    sym_a = PARTAB[sr & CPOLYA].astype(np.int64)
    sym_b = 1 - PARTAB[sr & CPOLYB].astype(np.int64)
    return (sym_a << 1) | sym_b


SYMS = _gen_syms()


def _gen_scrambler() -> np.ndarray:
    """CCSDS pseudo-randomizer byte sequence (FECDecoder.java:118-139).

    Bit stream from the LFSR with characteristic polynomial
    x^8 + x^7 + x^5 + x^3 + 1, seeded all-ones; packed MSB-first into
    320 bytes (the sequence period is 255 bits so bytes repeat after 255
    bytes x 8 bits / gcd math — the reference just stores 320 bytes).
    """
    state = 0xFF
    bits = []
    for _ in range(320 * 8):
        bit = (state >> 7) & 1
        bits.append(bit)
        fb = ((state >> 7) ^ (state >> 4) ^ (state >> 2) ^ state) & 1
        state = ((state << 1) | fb) & 0xFF
    bits = np.asarray(bits, dtype=np.int64).reshape(320, 8)
    weights = 1 << np.arange(7, -1, -1)
    return (bits * weights).sum(axis=1)


SCRAMBLER = _gen_scrambler()


def _gen_sync_vector() -> np.ndarray:
    """65-symbol sync column as +/-1 (FUNcubeBPSKDemod.java:79-81).

    Generated by the sync LFSR (FECDecoder.java:600-605): sr starts 0x7f,
    emits bit 6, shifts in parity(sr & SYNC_POLY).
    """
    sr = 0x7F
    out = np.zeros(COLUMNS, dtype=np.int8)
    for i in range(COLUMNS):
        out[i] = 1 if (sr & 64) else -1
        sr = ((sr << 1) | int(PARTAB[sr & SYNC_POLY])) & 0xFF
    return out


SYNC_VECTOR = _gen_sync_vector()
SYNC_BITS = (SYNC_VECTOR > 0).astype(np.uint8)

# RS generator polynomial exponents, palindromic half (FECDecoder.java:544-546)
RS_POLY = np.array(
    [249, 59, 66, 4, 43, 126, 251, 97, 30, 3, 213, 50, 66, 170, 5, 24],
    dtype=np.int64,
)

# ---------------------------------------------------------------------------
# Soft-decision Viterbi metric table (FECDecoder.java:67-100).
# Log-likelihood metric for an 8-bit ADC, indexed [sent bit][received byte].
# Public constant from Phil Karn's AO-40 reference decoder; no closed form.
# ---------------------------------------------------------------------------
_METTAB0 = [
    20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20,
    20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20,
    20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20,
    20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20,
    20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20,
    20, 20, 20, 20, 20, 20, 20, 19, 19, 19, 19, 19, 19, 19, 19, 19,
    19, 19, 18, 18, 18, 18, 18, 18, 17, 17, 17, 16, 16, 16, 15, 15,
    14, 14, 13, 13, 12, 11, 10, 10, 9, 8, 7, 6, 5, 3, 2, 1,
    -1, -2, -4, -5, -7, -9, -11, -13, -15, -17, -19, -21, -23, -25, -28, -30,
    -32, -35, -37, -40, -42, -45, -47, -50, -52, -55, -58, -60, -63, -66, -68, -71,
    -74, -77, -79, -82, -85, -88, -90, -93, -96, -99, -102, -104, -107, -110, -113, -116,
    -119, -121, -124, -127, -130, -133, -136, -138, -141, -144, -147, -150, -153, -155, -158, -161,
    -164, -167, -170, -172, -175, -178, -181, -184, -187, -190, -192, -195, -198, -201, -204, -207,
    -210, -212, -215, -218, -221, -224, -227, -229, -232, -235, -238, -241, -244, -247, -249, -252,
    -255, -258, -261, -264, -267, -269, -272, -275, -278, -281, -284, -286, -289, -292, -295, -298,
    -301, -304, -306, -309, -312, -315, -318, -320, -324, -326, -329, -332, -335, -337, -341, -372,
]
_METTAB1 = [
    -372, -341, -338, -335, -332, -329, -326, -324, -321, -318, -315, -312, -309, -306, -304, -301,
    -298, -295, -292, -289, -286, -284, -281, -278, -275, -272, -269, -267, -264, -261, -258, -255,
    -252, -249, -247, -244, -241, -238, -235, -232, -229, -227, -224, -221, -218, -215, -212, -210,
    -207, -204, -201, -198, -195, -192, -190, -187, -184, -181, -178, -175, -172, -170, -167, -164,
    -161, -158, -155, -153, -150, -147, -144, -141, -138, -136, -133, -130, -127, -124, -121, -119,
    -116, -113, -110, -107, -104, -102, -99, -96, -93, -90, -88, -85, -82, -79, -77, -74,
    -71, -68, -66, -63, -60, -58, -55, -52, -50, -47, -45, -42, -40, -37, -35, -32,
    -30, -28, -25, -23, -21, -19, -17, -15, -13, -11, -9, -7, -5, -4, -2, -1,
    1, 2, 3, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 13, 14, 14,
    15, 15, 16, 16, 16, 17, 17, 17, 18, 18, 18, 18, 18, 18, 19, 19,
    19, 19, 19, 19, 19, 19, 19, 19, 19, 20, 20, 20, 20, 20, 20, 20,
    20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20,
    20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20,
    20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20,
    20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20,
    20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20,
]
METTAB = np.array([_METTAB0, _METTAB1], dtype=np.int64)
