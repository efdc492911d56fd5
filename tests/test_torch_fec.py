"""The port's AO-40 FEC decode against the JAX decoder and the numpy
oracle (``jsdr_tpu.fec.ref_numpy``). Everything here is integer
arithmetic: payload, ok, rs_errors and rc must be bit-exact."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.fec import ref_numpy as R
from jsdr_tpu.fec import decoder as JD
from jsdr_tpu.fec import rs as JRS
from jsdr_tpu.fec import viterbi as JV
from jsdr_tpu.fec.tables import METTAB, NBITS, NN, RSPAD
from jsdr_tpu_torch.fec import decoder as TD
from jsdr_tpu_torch.fec import rs as TRS
from jsdr_tpu_torch.fec import viterbi as TV
from jsdr_tpu_torch.fec.encode import encode_frame

GOLDEN = Path(__file__).parent / "golden"


def _frames():
    """Golden clean windows (rc 0), the same with soft noise and a few
    dozen flipped symbols (correctable), and frames beyond correction."""
    rng = np.random.default_rng(11)
    clean = np.concatenate([np.load(GOLDEN / n)["clean_windows"]
                            for n in ("golden_96k.npz", "golden_192k.npz")])
    out = [clean]
    for n_flip in (25, 90):
        w = clean[:1].astype(np.int32).copy()
        pos = rng.choice(w.shape[1], n_flip, replace=False)
        w[0, pos] = 0x100 - w[0, pos]                 # 0x40 <-> 0xC0
        w += rng.integers(-40, 40, w.shape)           # soft, same side
        out.append(np.clip(w, 0, 255).astype(np.uint8))
    out.append(rng.integers(0, 256, (2, 5200)).astype(np.uint8))
    bad = clean[1:2].copy()
    pos = rng.choice(5200, 1500, replace=False)
    bad[0, pos] = 0x100 - bad[0, pos].astype(np.int32)
    out.append(bad)
    return np.concatenate(out)


@pytest.fixture(scope="module")
def decoded():
    raw = _frames()
    port = TD.fec_decode(torch.from_numpy(raw))
    jax_res = JD.fec_decode(jnp.asarray(raw))
    return raw, [t.numpy() for t in port], [np.asarray(a) for a in jax_res]


def test_fec_decode_matches_jax(decoded):
    _raw, port, want = decoded
    for g, w in zip(port, want):
        np.testing.assert_array_equal(g, w)


def test_fec_decode_matches_numpy_oracle(decoded):
    raw, port, _ = decoded
    payload, ok, _rs, rc = port
    for i, frame in enumerate(raw):
        p, r = R.fec_decode(frame)
        assert rc[i] == r
        assert ok[i] == (r >= 0)
        np.testing.assert_array_equal(payload[i], p)


def test_fec_decode_covers_clean_corrected_and_failed(decoded):
    _raw, (_p, ok, _rs, rc), _ = decoded
    assert rc[:3].tolist() == [0, 0, 0]               # golden clean windows
    assert rc[3] == 25 and rc[4] == 90                # flipped symbols
    assert not ok[5:].any() and (rc[5:] == -1).all()  # beyond correction


def test_fec_decode_golden_payloads(decoded):
    _raw, (payload, *_), _ = decoded
    want = np.concatenate([np.load(GOLDEN / n)["payloads"]
                           for n in ("golden_96k.npz", "golden_192k.npz")])
    np.testing.assert_array_equal(payload[:3], want)


def test_mettab_lookup_all_256_inputs():
    """Every soft byte in both symbol positions of a pair."""
    v = np.arange(256)
    pairs = np.stack([v, v[::-1]], axis=1).reshape(-1)           # 512
    sym = np.resize(pairs, 2 * NBITS).astype(np.uint8)
    got = TV.branch_metrics(torch.from_numpy(sym)[None])[0].numpy()
    want = np.asarray(JV.branch_metrics(jnp.asarray(sym)))
    np.testing.assert_array_equal(got, want)
    a, b = sym[0::2].astype(int), sym[1::2].astype(int)
    np.testing.assert_array_equal(
        got, np.stack([METTAB[0][a] + METTAB[0][b], METTAB[0][a] + METTAB[1][b],
                       METTAB[1][a] + METTAB[0][b], METTAB[1][a] + METTAB[1][b]],
                      axis=1))


def test_rs_decode_error_counts_match_reference():
    """0..16 byte errors are corrected with their count; 17 and more
    fail (-1) — the same as the JAX decoder and the numpy oracle."""
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, 256, dtype=np.uint8)
    frame = R.frame_bytes(payload) ^ R.SCRAMBLER[:320].astype(np.uint8)
    words = R.descramble_demux(frame)                 # [2, 255] clean
    batch = []
    for n_err in (0, 1, 5, 16, 17, 30):
        w = words[n_err % 2].copy()
        pos = rng.choice(np.arange(RSPAD, NN), n_err, replace=False)
        w[pos] ^= rng.integers(1, 256, n_err).astype(np.uint8)
        batch.append(w)
    batch = np.stack(batch)
    got_c, got_n = (t.numpy() for t in TRS.decode_rs_codeword(
        torch.from_numpy(batch)))
    want_c, want_n = (np.asarray(a) for a in JRS.decode_rs(jnp.asarray(batch)))
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(got_c, want_c)
    for i, w in enumerate(batch):
        fixed, n = R.decode_rs_8(w)
        assert got_n[i] == n
        np.testing.assert_array_equal(got_c[i], fixed)
    assert got_n[:4].tolist() == [0, 1, 5, 16] and (got_n[4:] == -1).all()


def test_encode_matches_numpy_oracle():
    rng = np.random.default_rng(3)
    payloads = rng.integers(0, 256, (3, 256), dtype=np.uint8)
    got = encode_frame(torch.from_numpy(payloads)).numpy()
    for p, g in zip(payloads, got):
        np.testing.assert_array_equal(g, R.encode_fec40(p))
