"""The port's PSD + waterfall-line module (``ops/psd_waterfall.py``; its
wrapper runs the plain version for CPU tensors) against the reference's
``psd_waterfall``: the jnp version (``use_pallas=False``) and the Pallas
kernel in interpret mode at even widths, and the jnp version
``_psd_waterfall_ref`` at an odd width.

Tolerances are the reference's own (tests/test_ops.py:124-134): db within
1e-4 dB (float32 log10 from two libraries), lines equal. The CUDA kernel
is held against the plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.ops.pallas_kernels import _psd_waterfall_ref, psd_waterfall as jpw
from jsdr_tpu_torch.ops.cplx import CF
from jsdr_tpu_torch.ops.psd_waterfall import psd_waterfall, psd_waterfall_ref


def _spec(seed, b, n):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n)))
            .astype(np.complex64) * 40)


def _port(spec, width, fn=psd_waterfall):
    db, line = fn(CF(torch.from_numpy(np.ascontiguousarray(spec.real)),
                     torch.from_numpy(np.ascontiguousarray(spec.imag))),
                  width)
    return db.numpy(), line.numpy()


@pytest.mark.parametrize("b,n,width", [(16, 1920, 960), (10, 9600, 960),
                                       (3, 19200, 1920), (5, 9600, 64)])
def test_psd_waterfall_matches_reference(b, n, width):
    spec = _spec(b * n, b, n)
    db, line = _port(spec, width)
    assert db.dtype == np.float32 and line.dtype == np.uint8
    assert db.shape == (b, n) and line.shape == (b, width)
    for use_pallas in (False, True):
        db_j, line_j = jpw(jnp.asarray(spec), width=width,
                           use_pallas=use_pallas, interpret=use_pallas)
        np.testing.assert_allclose(db, np.asarray(db_j), atol=1e-4)
        np.testing.assert_array_equal(line, np.asarray(line_j))


def test_odd_width_follows_the_jnp_roll():
    """At an odd width (75 divides 9600) the port puts 0 Hz at width // 2
    as the reference's jnp version does; the reference's Pallas kernel
    swaps halves and so lands one pixel further (ROADMAP.md, queue 3)."""
    spec = _spec(75, 4, 9600)
    db, line = _port(spec, 75)
    db_r, line_r = _psd_waterfall_ref(jnp.asarray(spec.real),
                                      jnp.asarray(spec.imag), 75)
    np.testing.assert_allclose(db, np.asarray(db_r), atol=1e-4)
    np.testing.assert_array_equal(line, np.asarray(line_r))
    _db_p, line_p = jpw(jnp.asarray(spec), width=75, use_pallas=True,
                        interpret=True)
    assert not np.array_equal(line, np.asarray(line_p))
    np.testing.assert_array_equal(np.roll(line, 1, axis=-1),
                                  np.asarray(line_p))


def test_wrapper_on_cpu_runs_the_plain_version():
    spec = _spec(1, 4, 1920)
    before = psd_waterfall.launches
    got = _port(spec, 960)
    want = _port(spec, 960, fn=psd_waterfall_ref)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert psd_waterfall.launches == before       # no kernel launched


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(4, 1920)
    with pytest.raises(ValueError, match="divide"):
        psd_waterfall(CF(x, x), 7)
    with pytest.raises(ValueError, match="contiguous"):
        psd_waterfall(CF(x.T.contiguous().T, x), 960)
    with pytest.raises(ValueError, match="float32"):
        psd_waterfall(CF(x.double(), x), 960)
    with pytest.raises(ValueError, match=r"\[B, N\]"):
        psd_waterfall(CF(x[0], x[0]), 960)
