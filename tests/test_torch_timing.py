"""The port's timing recovery (plain PyTorch version, which the wrapper
runs for CPU tensors) against the reference: the Pallas kernel in
interpret mode and the XLA oracle ``_timing_parallel``.

Shapes and tolerances are those of tests/test_timing_kernel.py.
Decisions (valid, and bit where valid) and the peak schedule must be
equal; the EMA composes in another fp order (serial here, triangular
matmuls in the reference), so e_ema is held to rtol 1e-5 / atol 1e-2,
e_out (serial here, closed form there) to rtol 1e-4 / atol 1e-2, and
last_iq, a copied sample, to rtol 1e-6 / atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.demod import bpsk as JB
from jsdr_tpu.ops.cplx import CF as JCF
from jsdr_tpu.ops.timing_kernel import timing_recover_batch as jtrb
from jsdr_tpu_torch.ops.timing_kernel import timing_recover_batch

KW = dict(smooth1=JB.BIT_SMOOTH1, smooth2=JB.BIT_SMOOTH2,
          gate=JB.ENERGY_GATE)


def _state(rng, s):
    return (rng.random((s, 8)).astype(np.float32) * 2e4,
            rng.integers(0, 8, s).astype(np.int32),
            rng.integers(0, 8, s).astype(np.int32),
            rng.random(s).astype(np.float32) * 100,
            rng.standard_normal((s, 2)).astype(np.float32) * 50)


def _bpsk_like(rng, s, t_ds, amp=150):
    mfr = (rng.standard_normal((s, t_ds)) * 30
           + amp * np.sign(rng.standard_normal((s, t_ds // 8)))
           .repeat(8, axis=1)).astype(np.float32)
    mfi = (rng.standard_normal((s, t_ds)) * 30).astype(np.float32)
    return mfr, mfi


def _port(mfr, mfi, st):
    out = timing_recover_batch(*(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in (mfr, mfi, *st)), **KW)
    return [o.numpy() for o in out]


def _assert_same(got, want):
    v = want[0]
    np.testing.assert_array_equal(got[0], v)
    np.testing.assert_array_equal(got[1][v], want[1][v])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got[5], want[5], rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got[6], want[6], rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("s,t_ds", [(3, 4800), (8, 9600), (5, 2048 * 8)])
def test_timing_matches_reference(rng, s, t_ds):
    st = _state(rng, s)
    mfr, mfi = _bpsk_like(rng, s, t_ds)
    got = _port(mfr, mfi, st)

    pal = jtrb(mfr, mfi, *st, interpret=True, **KW)
    _assert_same(got, [np.asarray(a) for a in pal])

    tm = JB.TimingState(e_ema=st[0], pos=np.zeros(s, np.int32), peak=st[1],
                        new_peak=st[2], e_out=st[3], last_iq=st[4])
    v, b, _di, _e2, ts = jax.vmap(JB._timing_parallel)(
        JCF(jnp.asarray(mfr), jnp.asarray(mfi)), tm)
    _assert_same(got, [np.asarray(a) for a in (
        v, b, ts.e_ema, ts.peak, ts.new_peak, ts.e_out, ts.last_iq)])
    assert got[0].any() and not got[0].all()


def test_timing_chained_blocks(rng):
    """Two chained blocks equal one double-length call, and the Pallas
    kernel's chained blocks."""
    s, t_ds = 4, 4800
    st = _state(rng, s)
    mfr, mfi = _bpsk_like(rng, s, 2 * t_ds, amp=140)
    a = _port(mfr[:, :t_ds], mfi[:, :t_ds], st)
    b = _port(mfr[:, t_ds:], mfi[:, t_ds:], a[2:])
    full = _port(mfr, mfi, st)
    chained = [np.concatenate([a[0], b[0]], axis=1),
               np.concatenate([a[1], b[1]], axis=1), *b[2:]]
    _assert_same(chained, full)

    ja = jtrb(mfr[:, :t_ds], mfi[:, :t_ds], *st, interpret=True, **KW)
    jb = jtrb(mfr[:, t_ds:], mfi[:, t_ds:], *ja[2:], interpret=True, **KW)
    want = [np.concatenate([np.asarray(ja[0]), np.asarray(jb[0])], axis=1),
            np.concatenate([np.asarray(ja[1]), np.asarray(jb[1])], axis=1),
            *(np.asarray(x) for x in jb[2:])]
    _assert_same(chained, want)


def test_timing_rejects_bad_shapes(rng):
    st = _state(rng, 2)
    mfr, mfi = _bpsk_like(rng, 2, 80)
    with pytest.raises(ValueError, match="multiple of 8"):
        _port(mfr[:, :76], mfi[:, :76], st)
    with pytest.raises(ValueError, match="int32"):
        _port(mfr, mfi, (st[0], st[1].astype(np.int64), *st[2:]))
