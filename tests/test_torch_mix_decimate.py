"""The port's mix + decimate (plain PyTorch version, which the wrapper runs
for CPU tensors) against the reference: the Pallas kernel in interpret
mode at HIGHEST precision, and its jnp oracle ``_mix_decimate_ref``.

Tolerances are those of tests/test_ops.py's kernel test: outputs rtol
2e-5, atol 1e-4 (float32 sums of 27 products in another order, values up
to ~1e2); the carried tail is a copy of mixed samples, atol 1e-5. The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.ops.cplx import CF as JCF
from jsdr_tpu.ops.pallas_kernels import _mix_decimate_ref, mix_decimate as jmd
from jsdr_tpu_torch.ops.cplx import CF
from jsdr_tpu_torch.ops.mix_decimate import mix_decimate, mix_decimate_ref

NT = 27


def _inputs(rng, s, t):
    taps = np.random.default_rng(7).standard_normal(NT).astype(np.float32)
    ang = (np.arange(128) % 8) * (2 * np.pi / 8)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    return dict(x=(f(s, t), f(s, t)),
                cos=np.tile(np.cos(ang).astype(np.float32), (s, 1)),
                sin=np.tile(np.sin(ang).astype(np.float32), (s, 1)),
                taps=taps, tail=(f(s, NT - 1), f(s, NT - 1)))


def _port(d, m, gain, fn=mix_decimate):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    y, tl = fn(CF(t(d["x"][0]), t(d["x"][1])), t(d["cos"]), t(d["sin"]),
               t(d["taps"]), m, CF(t(d["tail"][0]), t(d["tail"][1])), gain)
    return [a.numpy() for a in (y.re, y.im, tl.re, tl.im)]


@pytest.mark.parametrize("m", [10, 20])
@pytest.mark.parametrize("s,t", [(1, 12800), (3, 25600), (2, 640),
                                 (2, 48000)])
def test_mix_decimate_matches_reference(rng, s, t, m):
    d = _inputs(rng, s, t)
    x = JCF(jnp.asarray(d["x"][0]), jnp.asarray(d["x"][1]))
    tail = JCF(jnp.asarray(d["tail"][0]), jnp.asarray(d["tail"][1]))
    cos, sin = jnp.asarray(d["cos"]), jnp.asarray(d["sin"])
    ref_y, ref_t = _mix_decimate_ref(x, cos, sin, d["taps"], m, tail, 3.0)
    pal_y, pal_t = jmd(x, cos, sin, d["taps"], m, tail, 3.0,
                       use_pallas=True, interpret=True, precision="highest")
    got = _port(d, m, 3.0)
    for ref in ((ref_y, ref_t), (pal_y, pal_t)):
        want = [np.asarray(a) for a in (ref[0].re, ref[0].im,
                                        ref[1].re, ref[1].im)]
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-4)
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g, w, atol=1e-5)


def test_wrapper_on_cpu_runs_the_plain_version(rng):
    d = _inputs(rng, 2, 640)
    before = mix_decimate.launches
    got = _port(d, 10, 29491.2)
    want = _port(d, 10, 29491.2, fn=mix_decimate_ref)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert mix_decimate.launches == before        # no kernel launched


def test_wrapper_rejects_bad_inputs(rng):
    d = _inputs(rng, 2, 640)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    iq, tail = CF(t(d["x"][0]), t(d["x"][1])), CF(t(d["tail"][0]),
                                                   t(d["tail"][1]))
    args = (t(d["cos"]), t(d["sin"]), t(d["taps"]))
    with pytest.raises(ValueError, match="multiple"):
        mix_decimate(CF(iq.re[:, :635], iq.im[:, :635]), *args, 10, tail, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        mix_decimate(CF(iq.re.T.contiguous().T, iq.im), *args, 10, tail, 1.0)
    with pytest.raises(ValueError, match="float32"):
        mix_decimate(CF(iq.re.double(), iq.im), *args, 10, tail, 1.0)
    meta = CF(iq.re.to("meta"), iq.im.to("meta"))
    with pytest.raises(ValueError):
        mix_decimate(meta, *args, 10, tail, 1.0)
