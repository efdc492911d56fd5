"""The FEC kernels' walks (``ops/csrc/fec_viterbi.cu``, kernel A, and
``ops/csrc/fec_rs.cu``, kernel B), rehearsed on the CPU through their plain
mirrors: ``fec/viterbi.py::_viterbi_lanes`` (int16 pair metrics, two
states a lane pulling their four predecessors by shuffle, a survivor word
a state, the window stores and the 80-step chain-back ``_chain_back``),
``fec/rs.py::_decode_rs_lanes`` (syndromes in four quarters, Berlekamp-
Massey over the lanes, the Chien roots ranked over rounds by ballot +
popc, Forney a slot a lane), ``fec/encode.py::_rs_parity_lanes`` (the
parity as a table product over the map R of ``fec/_device.py``) and
``::_channel_symbols`` (each channel position from its 7-bit window),
composed in ``fec/decoder.py::_fec_check_lanes``. Each must equal the
plain version and the JAX package bit for bit, on golden windows, flipped
and random windows, all-0x80 and all-zero windows, windows whose
codewords carry exactly 16 and 17 byte errors, and every METTAB input.
The jump chain-back must equal the step-by-step one on any decisions, and
R the JAX package's LFSR on every single-bit payload. The kernels'
constants are held to ``fec/tables.py``. chip_smoke.py phase 18 holds the
CUDA kernels against the plain versions on the card."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.fec import decoder as JD
from jsdr_tpu.fec import encode as JE
from jsdr_tpu.fec import rs as JRS
from jsdr_tpu.fec import viterbi as JV
from jsdr_tpu_torch.fec import _device
from jsdr_tpu_torch.fec import decoder as TD
from jsdr_tpu_torch.fec import encode as TE
from jsdr_tpu_torch.fec import ref_numpy as R
from jsdr_tpu_torch.fec import rs as TRS
from jsdr_tpu_torch.fec import tables as T
from jsdr_tpu_torch.fec import viterbi as TV

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "jsdr_tpu_torch" / "ops" / "csrc"
GOLDEN = Path(__file__).parent / "golden"
SETS = ("clean", "flipped", "random", "flat", "rs16_17", "beyond")


def _soft(frame_syms: np.ndarray) -> np.ndarray:
    return np.where(frame_syms > 0, 0xC0, 0x40).astype(np.uint8)


def _rs_error_windows(rng) -> np.ndarray:
    """Two windows whose Viterbi output carries exactly 16 byte errors in
    codeword 0 and 17 in codeword 1: the 320-byte sequence of a payload
    (``ref_numpy.frame_bytes``) with those bytes changed, encoded."""
    out = []
    for c, n_err in ((0, 16), (1, 17)):
        seq = R.frame_bytes(rng.integers(0, 256, 256, dtype=np.uint8))
        k = rng.choice(160, n_err, replace=False)
        seq[2 * k + c] ^= rng.integers(1, 256, n_err).astype(np.uint8)
        out.append(_soft(TE.encode_bytes(torch.from_numpy(seq)[None])[0]
                         .numpy()))
    return np.stack(out)


@pytest.fixture(scope="module")
def windows():
    """Named sets of two [5200] windows each."""
    rng = np.random.default_rng(13)
    clean = np.concatenate([np.load(GOLDEN / n)["clean_windows"]
                            for n in ("golden_96k.npz", "golden_192k.npz")])
    flipped = []
    for src, n_flip in ((0, 25), (2, 90)):
        w = clean[src].astype(np.int32).copy()
        pos = rng.choice(w.shape[0], n_flip, replace=False)
        w[pos] = 0x100 - w[pos]
        w += rng.integers(-40, 40, w.shape)
        flipped.append(np.clip(w, 0, 255).astype(np.uint8))
    bad = clean[1].copy()
    pos = rng.choice(5200, 1500, replace=False)
    bad[pos] = 0x100 - bad[pos].astype(np.int32)
    return {
        "clean": clean[:2],
        "flipped": np.stack(flipped),
        "random": rng.integers(0, 256, (2, 5200)).astype(np.uint8),
        "flat": np.stack([np.full(5200, 0x80, np.uint8),
                          np.zeros(5200, np.uint8)]),
        "rs16_17": _rs_error_windows(rng),
        "beyond": np.stack([bad, clean[2]]),
    }


@pytest.mark.parametrize("name", SETS)
def test_viterbi_lanes(windows, name):
    raw = torch.from_numpy(windows[name])
    sym = TV.deinterleave(raw)
    got = TV._viterbi_lanes(sym)
    np.testing.assert_array_equal(got.numpy(), TV.viterbi27_bytes(raw).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JV.viterbi27(jnp.asarray(sym.numpy()))))


def test_viterbi_lanes_all_mettab_inputs():
    """Every soft byte in both symbol positions of a pair."""
    v = np.arange(256)
    pairs = np.concatenate([np.stack([v, v[::-1]], axis=1).reshape(-1),
                            np.stack([v[::-1], v], axis=1).reshape(-1)])
    sym = np.stack([np.resize(pairs, 2 * T.NBITS),
                    np.resize(pairs[::-1], 2 * T.NBITS)]).astype(np.uint8)
    got = TV._viterbi_lanes(torch.from_numpy(sym)).numpy()
    np.testing.assert_array_equal(
        got, TV.viterbi27_bytes(torch.from_numpy(sym)).numpy())
    np.testing.assert_array_equal(got,
                                  np.asarray(JV.viterbi27(jnp.asarray(sym))))


def _codewords(raw: np.ndarray) -> torch.Tensor:
    vit = TV.viterbi27_bytes(torch.from_numpy(raw))
    return TD.descramble_demux(vit).reshape(-1, T.NN)


def _check_rs(words: torch.Tensor):
    got_c, got_n = TRS._decode_rs_lanes(words)
    want_c, want_n = TRS.decode_rs_codeword(words)
    assert torch.equal(got_n, want_n) and torch.equal(got_c, want_c)
    jc, jn = JRS.decode_rs(jnp.asarray(words.numpy()))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(jc))
    return got_n


@pytest.mark.parametrize("name", SETS)
def test_rs_lanes(windows, name):
    n_err = _check_rs(_codewords(windows[name])).tolist()
    if name == "rs16_17":
        assert n_err == [16, 0, 0, -1]


def test_rs_lanes_error_counts():
    """A codeword with 0, 1, 16, 17 and 30 byte errors, the all-zero
    codeword and an all-0xFF word."""
    rng = np.random.default_rng(7)
    seq = R.frame_bytes(rng.integers(0, 256, 256, dtype=np.uint8))
    word = R.descramble_demux(seq ^ R.SCRAMBLER[:320].astype(np.uint8))[0]
    batch = []
    for n_err in (0, 1, 16, 17, 30):
        w = word.copy()
        pos = rng.choice(np.arange(T.RSPAD, T.NN), n_err, replace=False)
        w[pos] ^= rng.integers(1, 256, n_err).astype(np.uint8)
        batch.append(w)
    batch += [np.zeros(T.NN, np.uint8), np.full(T.NN, 0xFF, np.uint8),
              np.zeros(T.NN, np.uint8)]
    n_err = _check_rs(torch.from_numpy(np.stack(batch))).tolist()
    assert n_err[:4] == [0, 1, 16, -1] and n_err[5] == 0


@pytest.mark.parametrize("name", SETS)
def test_fec_check_lanes(windows, name):
    raw = torch.from_numpy(windows[name])
    vit = TV.viterbi27_bytes(raw)
    got = TD._fec_check_lanes(vit, raw)
    for g, w in zip(got, TD._fec_check_ref(vit, raw)):
        assert torch.equal(g, w)
    for g, w in zip(got, JD.fec_decode(jnp.asarray(windows[name]))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_encode_lanes():
    """The lane-wise LFSR and the per-position symbols against the plain
    encoder, on random, all-zero and all-0xFF payloads."""
    rng = np.random.default_rng(9)
    pay = torch.from_numpy(np.concatenate([
        rng.integers(0, 256, (2, 256), dtype=np.uint8),
        np.zeros((1, 256), np.uint8), np.full((1, 256), 255, np.uint8)]))
    parity = TE._rs_parity_lanes(pay)
    assert torch.equal(parity, TE.rs_parity(pay))
    seq = torch.cat([pay, parity.transpose(1, 2).reshape(4, -1)], dim=1)
    scram = torch.as_tensor(np.asarray(T.SCRAMBLER[:320]))
    got = TE._channel_symbols(seq ^ scram)
    assert torch.equal(got, TE.encode_frame(pay))
    for p, g in zip(pay.numpy(), got.numpy()):
        np.testing.assert_array_equal(g, R.encode_fec40(p))


def _constants(path: Path) -> dict:
    return {k: int(v, 0) for k, v in re.findall(
        r"constexpr int (k\w+) = (0x[0-9A-Fa-f]+|-?\d+);", path.read_text())}


def test_kernel_constants_match_tables():
    """What the kernels hard-code: the tables' scalars, the table blobs'
    offsets and contents (``fec/_device.py``: the doubled ALPHA_TO, the
    parity map R as logs), and the parity the re-encode takes as a
    popcount (``PARTAB`` is the bit parity)."""
    a = _constants(CSRC / "fec_viterbi.cu")
    assert (a["kNBits"], a["kFlush"], a["kRows"], a["kCols"], a["kFrame"],
            a["kInit"]) == (T.NBITS, TV.K_FLUSH, T.ROWS, T.COLUMNS,
                            T.SYMPBLOCK, TV._INIT_METRIC)
    assert a["kWindow"] == TV._WINDOW and TV._WINDOWS * TV._WINDOW == (
        T.NBITS - TV.K_FLUSH)
    assert a["kTabWords"] == _device.VITERBI_TABLE.shape[0]
    met = np.asarray(T.METTAB)        # a pair metric is kept as int16
    assert -2 ** 15 <= 2 * met.min() and 2 * met.max() < 2 ** 15
    b = _constants(CSRC / "fec_rs.cu")
    assert (b["kNN"], b["kRoots"], b["kA0"], b["kFcr"], b["kPrim"],
            b["kIprim"], b["kRsPad"], b["kPayload"], b["kNBits"],
            b["kFrame"], b["kRows"], b["kCols"], b["kPolyA"],
            b["kPolyB"]) == (T.NN, T.NROOTS, T.A0, T.FCR, T.PRIM, T.IPRIM,
                             T.RSPAD, T.BLOCKSIZE, T.NBITS, T.SYMPBLOCK,
                             T.ROWS, T.COLUMNS, T.CPOLYA, T.CPOLYB)
    assert b["kData"] == T.BLOCKSIZE // 2
    off = _device.RS_OFFSETS
    assert (b["kTabAlpha"], b["kTabIndex"], b["kTabParity"], b["kTabScr"],
            b["kTabSync"], b["kTabBytes"]) == (
                off["alpha"], off["index"], off["parity"], off["scrambler"],
                off["sync"], off["end"])
    tab = _device.rs_table()
    assert tab.shape == (off["end"],) and off["end"] % 16 == 0
    alpha2 = tab[off["alpha"]:off["index"]]
    np.testing.assert_array_equal(alpha2[:255], np.asarray(T.ALPHA_TO)[:255])
    np.testing.assert_array_equal(alpha2[255:510], alpha2[:255])
    i, j = np.meshgrid(np.arange(255), np.arange(255))
    np.testing.assert_array_equal(alpha2[i + j],
                                  np.asarray(T.ALPHA_TO)[(i + j) % 255])
    np.testing.assert_array_equal(tab[off["index"]:off["parity"]],
                                  T.INDEX_OF)
    r = _device.parity_map()
    assert r.shape == (128, 32)
    rlog = tab[off["parity"]:off["scrambler"]].reshape(128, 32)
    np.testing.assert_array_equal(rlog == T.A0, r == 0)
    np.testing.assert_array_equal(
        np.where(r == 0, 0, np.asarray(T.ALPHA_TO)[rlog % 255]), r)
    np.testing.assert_array_equal(tab[off["scrambler"]:off["sync"]],
                                  T.SCRAMBLER[:320])
    np.testing.assert_array_equal(tab[off["sync"]:off["sync"] + 65],
                                  T.SYNC_BITS)
    assert not tab[off["sync"] + 65:].any()
    v = np.arange(256)
    np.testing.assert_array_equal(
        T.PARTAB, [bin(x).count("1") & 1 for x in v])
    np.testing.assert_array_equal(_device.VITERBI_TABLE[:512],
                                  np.asarray(T.METTAB).reshape(-1))


@pytest.mark.parametrize("kind", ["random", "all_false", "all_true",
                                  "acs"])
def test_jump_chain_back(kind):
    """The 80-step chain-back over the window words equals the
    step-by-step chain-back (``_traceback``) on any decisions: random
    arrays, all ties (no path from j+32 wins: all False), all True, and
    real ACS decisions of random symbols."""
    rng = np.random.default_rng(23)
    shape = (T.NBITS, 3, 64)
    if kind == "random":
        dec = torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
    elif kind == "all_false":
        dec = torch.zeros(shape, dtype=torch.bool)
    elif kind == "all_true":
        dec = torch.ones(shape, dtype=torch.bool)
    else:
        sym = torch.from_numpy(rng.integers(0, 256, (3, 2 * T.NBITS))
                               .astype(np.uint8))
        dec = TV._acs(TV.branch_metrics(sym))
    got = TV._chain_back(TV._window_words(dec))
    want = TV.bits_to_bytes(TV._traceback(dec))
    assert torch.equal(got, want)
    if kind == "all_false":
        assert not got.any()


@pytest.mark.parametrize("codeword", [0, 1])
def test_parity_map_single_bits(codeword):
    """R reproduces the JAX package's LFSR (``jsdr_tpu.fec.encode.
    rs_parity``) on every single-bit payload of a codeword (1,024 of them;
    the map is linear over GF(2), so this is exhaustive) and on random
    payloads, through the kernel's table product ``_rs_parity_lanes``."""
    k, bit = np.divmod(np.arange(1024), 8)
    pay = np.zeros((1024, 256), np.uint8)
    pay[np.arange(1024), 2 * k + codeword] = (1 << bit).astype(np.uint8)
    rng = np.random.default_rng(31 + codeword)
    pay = np.concatenate([pay, rng.integers(0, 256, (16, 256),
                                            dtype=np.uint8)])
    got = TE._rs_parity_lanes(torch.from_numpy(pay)).numpy()
    want = np.asarray(jax.vmap(JE.rs_parity)(jnp.asarray(pay)))
    np.testing.assert_array_equal(got, want)
    assert not got[:1024, 1 - codeword].any()
