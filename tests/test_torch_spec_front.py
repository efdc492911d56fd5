"""The merged spectrum + front end module of the port
(``ops/spectrum_front.py``; its wrapper runs ``spectrum_front_ref`` for
CPU tensors, the CUDA kernel is held against it on the card by
chip_smoke.py) against the JAX package's ``spectrum_front_fused``.

Geometries of the flagship step: 96 kS/s (n = 9600, m = 10, q = 5) and
192 kS/s (n = 19200, m = 20, q = 10), T = 38400, a tone per stream over
a noise floor. The reference runs its merged Pallas kernel in interpret
mode at HIGHEST precision, and its CPU path (``use_pallas=False``: the
interpreted spectrum kernel + ``_mix_decimate_ref``) at the default
bf16x3 precision. Tolerances: waterfall lines 2e-3 dB against HIGHEST,
0.2 dB against bf16x3; peak dB 1e-3 dB; argmax equal; ``ds`` rtol 2e-5,
atol 1e-4 and tails atol 1e-5, as tests/test_torch_mix_decimate.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.ops import pallas_kernels as jpk
from jsdr_tpu.ops.cplx import CF as JCF
from jsdr_tpu_torch.ops import spectrum_front as tsfr
from jsdr_tpu_torch.ops.cplx import CF
from jsdr_tpu_torch.ops.mix_decimate import mix_decimate_ref
from jsdr_tpu_torch.ops.spectrum_fused import spectrum_waterfall

NT = 27
CASES = [(96000, 2), (192000, 1)]     # (rate, streams)


def _inputs(rate, s, t=38400, seed=0):
    rng = np.random.default_rng(seed)
    f = 3000.0 + 4250.0 * np.arange(s)[:, None]
    tone = 1.5 * np.exp(2j * np.pi * f * np.arange(t)[None, :] / rate)
    x = (0.3 * (rng.standard_normal((s, t)) + 1j * rng.standard_normal((s, t)))
         + tone).astype(np.complex64)
    ang = (np.arange(128) % 8) * (2 * np.pi / 8)
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return dict(x=x, cos=np.tile(np.cos(ang).astype(np.float32), (s, 1)),
                sin=np.tile(np.sin(ang).astype(np.float32), (s, 1)),
                taps=np.random.default_rng(7).standard_normal(NT)
                .astype(np.float32),
                tail=(f32(s, NT - 1), f32(s, NT - 1)))


def _port(d, n, m, gain, fn=tsfr.spectrum_front_fused):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return fn(CF(t(d["x"].real), t(d["x"].imag)), n, t(d["cos"]),
              t(d["sin"]), t(d["taps"]), m,
              CF(t(d["tail"][0]), t(d["tail"][1])), gain)


def _jax(d, n, m, gain, **kw):
    return jpk.spectrum_front_fused(
        JCF(jnp.asarray(d["x"].real), jnp.asarray(d["x"].imag)), n,
        jnp.asarray(d["cos"]), jnp.asarray(d["sin"]), d["taps"], m,
        JCF(jnp.asarray(d["tail"][0]), jnp.asarray(d["tail"][1])),
        gain=gain, **kw)


@pytest.mark.parametrize("rate,s", CASES)
def test_spectrum_front_matches_reference(rate, s):
    n, m = rate // 10, rate // 9600
    d = _inputs(rate, s)
    got = _port(d, n, m, 3.0)
    q = tsfr.wf_group_for(n)
    assert tuple(got[0].shape) == (38400 // n, s, n // 128 // q, 128)
    refs = ((_jax(d, n, m, 3.0, use_pallas=True, interpret=True,
                  precision="highest"), 2e-3),
            (_jax(d, n, m, 3.0, use_pallas=False), 0.2))
    for want, db in refs:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=db)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=1e-3)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        for g, w in ((got[3].re, want[3].re), (got[3].im, want[3].im)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                       atol=1e-4)
        for g, w in ((got[4].re, want[4].re), (got[4].im, want[4].im)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("rate,s", CASES)
def test_plain_version_is_the_staged_pair(rate, s):
    """spectrum_front_ref's ds and tail are mix_decimate_ref's, and its
    waterfall is spectrum_waterfall's, bit for bit."""
    n, m = rate // 10, rate // 9600
    d = _inputs(rate, s, seed=1)
    wf, mx, idx, ds, tail = _port(d, n, m, 29491.2,
                                  fn=tsfr.spectrum_front_ref)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    iq = CF(t(d["x"].real), t(d["x"].imag))
    ds_r, tail_r = mix_decimate_ref(iq, t(d["cos"]), t(d["sin"]),
                                    t(d["taps"]), m,
                                    CF(t(d["tail"][0]), t(d["tail"][1])),
                                    29491.2)
    for a, b in ((ds.re, ds_r.re), (ds.im, ds_r.im), (tail.re, tail_r.re),
                 (tail.im, tail_r.im)):
        assert torch.equal(a, b)
    for a, b in zip((wf, mx, idx), spectrum_waterfall(iq, n)):
        assert torch.equal(a, b)


def test_sf_geometry_matches_reference():
    for n, m in ((9600, 10), (19200, 20), (4800, 5), (1280, 1)):
        assert tsfr.sf_geometry(n, m) == jpk.sf_geometry(n, m)


def test_wrapper_checks_inputs_and_runs_plain_on_cpu():
    d = _inputs(96000, 2, t=9600)
    before = tsfr.spectrum_front_fused.launches
    got = _port(d, 9600, 10, 3.0)
    want = _port(d, 9600, 10, 3.0, fn=tsfr.spectrum_front_ref)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    for a, b in zip(got[3:], want[3:]):
        assert torch.equal(a.re, b.re) and torch.equal(a.im, b.im)
    assert tsfr.spectrum_front_fused.launches == before
    with pytest.raises(ValueError, match="multiple of n"):
        _port(dict(d, x=d["x"][:, :9000]), 9600, 10, 3.0)
    with pytest.raises(ValueError, match="decimation"):
        _port(d, 9600, 7, 3.0)
    with pytest.raises(ValueError, match="shape"):
        _port(dict(d, cos=d["cos"][:, :64]), 9600, 10, 3.0)
