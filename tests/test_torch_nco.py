"""The port's NCOs and tuner mixes (``jsdr_tpu_torch/ops/nco.py`` and the
general and static front-end mixes of ``demod/bpsk.py``) against the JAX
package's, on the same seeded numpy inputs.

Table indices, integer numerators and the general mode's carried
numerator are held equal. cos/sin values may differ by one float32 ulp
between the two libraries' ``cos``/``sin``, so the table values and
mixed samples are held to 1.2e-7 (absolute, on unit-scale values) and
2.5e-7 of the largest sample. The static mode's carried numerator is the
reference's float32 arithmetic op for op: held to 1e-6 relative. Phases
of ``phase_ramp`` with a traced increment (coarse/fine split; the
reference's compiler may fuse a multiply-add there) to 1e-6 rad."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.demod import bpsk as JB
from jsdr_tpu.ops import nco as JN
from jsdr_tpu.ops.cplx import CF as JCF
from jsdr_tpu_torch.demod import bpsk as TB
from jsdr_tpu_torch.ops import nco as TN
from jsdr_tpu_torch.ops.cplx import CF


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_quantized_nco_table():
    """tests/test_ops.py:115's inputs, plus phases beyond [0, 2pi) on both
    sides: the same table indices, values to an ulp."""
    ph = np.linspace(0, 2 * np.pi, 100, endpoint=False).astype(np.float32)
    more = np.random.default_rng(7).uniform(-20, 20, 1000).astype(np.float32)
    for p in (ph, more):
        jc, js = JN.quantized_cos_sin(jnp.asarray(p))
        tc, ts = TN.quantized_cos_sin(_t(p))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1.2e-7)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1.2e-7)
    idx = (ph * 256 / (2 * np.pi)).astype(int) % 256
    np.testing.assert_allclose(TN.quantized_cos_sin(_t(ph))[0].numpy(),
                               np.cos(idx * 2 * np.pi / 256), atol=1e-6)


@pytest.mark.parametrize("inc", [0.7853, 2 * np.pi * 1234.5 / 96000,
                                 -0.01])
def test_phase_ramp_and_tuner_mix(inc):
    rng = np.random.default_rng(11)
    n = 5000
    i = rng.normal(size=n).astype(np.float32)
    q = rng.normal(size=n).astype(np.float32)
    p0 = np.float32(1.25)
    # static increment: float64 host ramp, then float32 mod
    jp, jf = JN.phase_ramp(n, jnp.asarray(p0), float(inc))
    tp, tf = TN.phase_ramp(n, torch.tensor(p0), float(inc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert float(tf) == float(jf)
    # traced increment: coarse/fine split
    jp2, _ = JN.phase_ramp(n, jnp.asarray(p0), jnp.float32(inc))
    tp2, _ = TN.phase_ramp(n, torch.tensor(p0), torch.tensor(inc))
    np.testing.assert_allclose(tp2.numpy(), np.asarray(jp2), atol=1e-6)
    for compat in (True, False):
        ji, jq, jph = JN.tuner_mix(jnp.asarray(i), jnp.asarray(q), p0,
                                   float(inc), compat=compat)
        ti, tq, tph = TN.tuner_mix(_t(i), _t(q), p0, float(inc),
                                   compat=compat)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=5e-7)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=5e-7)
        assert float(tph) == float(jph)
    z = (i + 1j * q).astype(np.complex64)
    got = TN.mix_complex(_t(z), tp).numpy()
    want = np.asarray(JN.mix_complex(jnp.asarray(z), jp))
    np.testing.assert_allclose(got, want, atol=2e-6)


def _mix_inputs(s, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s, n)).astype(np.float32)
    return x, JCF(jnp.asarray(x[0]), jnp.asarray(x[1])), CF(_t(x[0]),
                                                             _t(x[1]))


@pytest.mark.parametrize("rate", [96000, 192000])
def test_general_mix_matches_reference(rate):
    """Exact numerators at full length for 0.1 Hz-multiple tunings of any
    period (and a pass-through stream): the same mixed samples to an ulp
    and the same carried numerator, from a mid-stream phase."""
    tun = np.array([1200.0, 12000.5, 12345.0, 0.0, 23999.9])
    nu = JB.tunings_to_nu(tun)
    assert not JB.pattern_mix_ok(tun, rate)
    n = rate // 10
    x, jx, tx = _mix_inputs(len(tun), n, 3)
    nu0 = (np.arange(len(tun)) * 104729 % (10 * rate)).astype(np.float32)
    jm, jph = JB._tuner_full_mix(jx, jnp.asarray(nu0), jnp.asarray(nu), rate)
    tm, tph = TB._tuner_full_mix(tx, _t(nu0), _t(nu).long(), rate)
    for p in ("re", "im"):
        np.testing.assert_allclose(getattr(tm, p).numpy(),
                                   np.asarray(getattr(jm, p)),
                                   atol=2.5e-7 * np.abs(x).max())
    np.testing.assert_array_equal(tm.re[3].numpy(), x[0, 3])  # tu = 0
    np.testing.assert_array_equal(tph.numpy(), np.asarray(jph))


@pytest.mark.parametrize("rate", [96000, 192000])
def test_static_mix_matches_reference(rate):
    """Sub-0.1 Hz tunings (and one <= 0: pass-through, numerator kept):
    all streams at once against the reference's per-stream loop."""
    tun = (12000.05, 1234.567, 0.0, 20000.123)
    n = rate // 10
    x, jx, tx = _mix_inputs(len(tun), n, 4)
    nu0 = np.array([0.0, 123457.0, 5.0, 959999.0], np.float32)
    tm, tph = TB._tuner_mix(tx, _t(nu0), tun, rate)
    for s, tu in enumerate(tun):
        jm, jph = JB._tuner_mix(JCF(jx.re[s], jx.im[s]),
                                jnp.asarray(nu0[s]), tu, rate)
        for p in ("re", "im"):
            np.testing.assert_allclose(getattr(tm, p)[s].numpy(),
                                       np.asarray(getattr(jm, p)),
                                       atol=2.5e-7 * np.abs(x).max())
        np.testing.assert_allclose(float(tph[s]), float(jph), rtol=1e-6)
    np.testing.assert_array_equal(tm.im[2].numpy(), x[1, 2])
    assert float(tph[2]) == 5.0


def test_static_fractional_tuner_mix():
    """tests/test_ops.py:244 on the port: a fractional tuning from phase 0
    advances the numerator to (t * 12000.5) mod rate in 0.1 Hz units."""
    rate, t = 96000, 1024
    rng = np.random.default_rng(1234)
    x = CF(_t(rng.normal(size=(1, t)).astype(np.float32)),
           _t(rng.normal(size=(1, t)).astype(np.float32)))
    mixed, nu = TB._tuner_mix(x, torch.zeros(1), (12000.5,), rate)
    np.testing.assert_allclose(float(nu[0]),
                               ((t * 12000.5) % rate) * TB.NU_SCALE, atol=5.0)
    assert not np.allclose(mixed.re.numpy(), x.re.numpy())
