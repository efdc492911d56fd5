"""The spectrum kernels' FFT plan (``ops/fft_plan.py``) and the plain
mirror of their pass order (``spectrum_fused.spectrum_fft_ref``), on the
CPU. The CUDA body (``csrc/spectrum_body.cuh``) reads exactly these
tables; chip_smoke.py holds it against the plain version on the card.

* The plan, for every n1 the card takes (1 .. MAX_N1 = 512: one CTA a
  block up to 225, a 4-CTA cluster above, both from these tables): stage 1
  applied in float64 with the exact tables equals ``np.fft.fft`` down 128
  random columns within 1e-9 of the column RMS, and in float32 with the
  float32 tables within 1e-5 (an fp32 FFT's error is ~1e-7 of the RMS);
  ``perm`` and the k2 map are permutations, and the k2 map gives each
  lane four consecutive bins from a multiple of 4 (the kernel writes them
  as one float4).
* The whole n-point transform of the plan in float64 equals
  ``np.fft.fft`` within 1e-9 of the block's RMS.
* ``spectrum_fft_ref`` against ``spectrum_wf_ref`` and the JAX package's
  kernel (Pallas interpret mode, its "highest" precision) on tones over
  noise, with the limits chip_smoke.py holds the kernels to: waterfall
  lines within 2e-3 dB, peaks within 1e-3 dB, equal argmax; the full PSD
  (q = 1) within 2e-3 dB on bins at or above the row's median and within
  3e-4 of the block's RMS amplitude everywhere (bins far below the floor
  differ by more dB under another fp32 summation order; their amplitudes
  do not).
* Its q-lines equal its full PSD max-decimated, exactly.
"""

import numpy as np
import pytest
import torch

from jsdr_tpu.ops import pallas_kernels as jpk
from jsdr_tpu.ops.cplx import from_complex as j_from_complex
from jsdr_tpu_torch.ops import fft_plan as fp
from jsdr_tpu_torch.ops import spectrum_fused as tsf
from jsdr_tpu_torch.ops.cplx import from_complex
from jsdr_tpu_torch.ops.mxu_fft import _twiddles

DB_WF, DB_PEAK, AMP = 2e-3, 1e-3, 3e-4
N1S = range(1, tsf.MAX_N1 + 1)


def _columns(seed, n1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n1, 128))
            + 1j * rng.standard_normal((n1, 128)))


def _col_err(plan, x, dtype, exact):
    re, im = fp.stage1(plan, torch.tensor(x.real, dtype=dtype),
                       torch.tensor(x.imag, dtype=dtype), exact)
    got = (re.double().numpy() + 1j * im.double().numpy())[plan.perm]
    want = np.fft.fft(x, axis=0)
    rms = np.sqrt((np.abs(want) ** 2).mean(axis=0))
    return float((np.abs(got - want) / rms).max())


def test_plan_stage1_is_the_column_dft_in_float64():
    errs = {n1: _col_err(fp.fft_plan(n1), _columns(n1, n1), torch.float64,
                         True) for n1 in N1S}
    bad = {n1: e for n1, e in errs.items() if not e <= 1e-9}
    assert not bad, bad


def test_plan_stage1_is_the_column_dft_in_float32():
    errs = {n1: _col_err(fp.fft_plan(n1), _columns(1000 + n1, n1),
                         torch.float32, False) for n1 in N1S}
    bad = {n1: e for n1, e in errs.items() if not e <= 1e-5}
    assert not bad, bad


def test_plan_indices_are_permutations():
    want_k2 = sorted(range(128))
    for n1 in N1S:
        p = fp.fft_plan(n1)
        assert sorted(p.perm.tolist()) == list(range(n1)), n1
        assert p.perm.dtype == np.int32 and p.k2map.dtype == np.int32
        radices, rg = fp.factor(n1)
        assert p.radices == radices and int(np.prod(radices)) * rg == n1
        assert all(r in (2, 3, 4, 5) for r in p.radices)
        assert all(rg % f for f in (2, 3, 5)), (n1, rg)
        # passes: radix, L = product of this and later radices, stride L/r
        length = n1
        for (r, big_l, s, _), want in zip(p.passes.tolist(), p.radices):
            assert (r, big_l, s) == (want, length, length // want)
            length //= want
    k2 = fp.fft_plan(75).k2map
    assert sorted(k2.reshape(-1).tolist()) == want_k2
    assert (k2[:, 0] % 4 == 0).all()
    assert (k2 - k2[:, :1] == np.arange(4)[None, :]).all()


@pytest.mark.parametrize("n1", [1, 2, 7, 75, 105, 150, 179, 225, 245, 300,
                                509, 512])
def test_plan_is_the_block_fft_in_float64(n1):
    rng = np.random.default_rng(n1)
    n = n1 * 128
    a = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    dr, di = fp.fft_block(fp.fft_plan(n1),
                          torch.tensor(a.real.reshape(n1, 128)),
                          torch.tensor(a.imag.reshape(n1, 128)), exact=True)
    x = np.fft.fft(a)
    want = x[n1 * np.arange(128)[None, :] + np.arange(n1)[:, None]]
    err = np.abs(dr.numpy() + 1j * di.numpy() - want).max()
    assert err <= 1e-9 * np.sqrt((np.abs(x) ** 2).mean())


@pytest.mark.parametrize("n1", [75, 105, 150, 225, 300, 512])
def test_plan_twiddle_rounds_to_the_kernels_table(n1):
    tw = fp.twiddle(n1)
    tr, ti = _twiddles(n1, 128, -1.0)
    assert np.array_equal(tw.real.astype(np.float32), tr)
    assert np.array_equal(tw.imag.astype(np.float32), ti)


def test_plan_tables_are_the_plans_float32_tables():
    p = fp.fft_plan(105)
    t = fp.plan_tables(105, "cpu")
    assert t.passes.dtype == t.perm.dtype == t.k2map.dtype == torch.int32
    assert torch.equal(t.passes, torch.from_numpy(p.passes))
    assert torch.equal(t.ptw_r, torch.from_numpy(p.ptw.real.astype(np.float32)))
    assert torch.equal(t.gw_i, torch.from_numpy(p.gw.imag.astype(np.float32)))
    assert tuple(t.s2_r.shape) == (32, 7) and p.rg == 7
    assert tsf.plan_ints(105 * 128) == (2, 7)


def _tones(seed, s, n, nblk):
    """A tone per stream at its own whole bin (n = rate / 10: 10 Hz bins)
    over a 0.3 noise floor."""
    rng = np.random.default_rng(seed)
    rate = 10 * n
    t = np.arange(nblk * n)
    f = 10.0 * ((np.arange(s) * 397) % (n // 2)) - rate / 4
    x = (0.3 * (rng.standard_normal((s, t.size))
                + 1j * rng.standard_normal((s, t.size)))
         + 1.5 * np.exp(2j * np.pi * f[:, None] * t[None, :] / rate))
    return x.astype(np.complex64), f, rate


def _psd_errors(k, p):
    """Largest dB difference at or above the row's median, and largest
    amplitude difference over the row's RMS amplitude ([nblk, S, n1, 128]
    dB tensors)."""
    d = (k - p).abs()
    med = p.flatten(2).median(dim=2).values[..., None, None]
    ak, ap = torch.pow(10.0, k.double() / 20), torch.pow(10.0, p.double() / 20)
    rms = ap.square().mean(dim=(2, 3), keepdim=True).sqrt()
    return float(d[p >= med].max()), float(((ak - ap).abs() / rms).max())


# n = 9600 and 19200 (96 k and 192 k), and n1 = 105 = 3*5*7 (the generic
# radix): 3 streams x 2 blocks
@pytest.mark.parametrize("n", [9600, 19200, 13440])
@pytest.mark.parametrize("full", [True, False])
def test_fft_ref_matches_plain_and_reference(n, full):
    x, f, rate = _tones(n, 3, n, 2)
    iq = from_complex(x, "cpu")
    q = 1 if full else tsf.wf_group_for(n)
    got = tsf.spectrum_fft_ref(iq, n, True, q)
    plain = tsf.spectrum_wf_ref(iq, n, True, q)
    jx = j_from_complex(x)
    if full:
        ref = jpk.spectrum_fused(jx, n, interpret=True, precision="highest",
                                 with_peaks=True)
    else:
        ref = jpk.spectrum_waterfall(jx, n, interpret=True,
                                     precision="highest")
    ref = tuple(torch.from_numpy(np.array(a)) for a in ref)
    assert tuple(got[0].shape) == (2, 3, n // 128 // q, 128)
    for want in (plain, ref):
        if full:
            db_above, amp = _psd_errors(got[0], want[0])
            assert db_above <= DB_WF and amp <= AMP, (db_above, amp)
        else:
            assert float((got[0] - want[0]).abs().max()) <= DB_WF
        assert float((got[1] - want[1]).abs().max()) <= DB_PEAK
        assert torch.equal(got[2], want[2].to(torch.int32))
    # the peak is the tone
    n1 = n // 128
    k_nat = n1 * (got[2].long() % 128) + got[2].long() // 128
    want_bin = torch.as_tensor(np.round(f * n / rate).astype(np.int64) % n)
    assert torch.equal(k_nat, want_bin[None, :].expand_as(k_nat))


@pytest.mark.parametrize("n", [9600, 13440])
def test_fft_ref_lines_are_its_decimated_psd(n):
    x, _, _ = _tones(7 + n, 2, n, 2)
    iq = from_complex(x, "cpu")
    psd, mx, idx = tsf.spectrum_fft_ref(iq, n, True, 1)
    q = tsf.wf_group_for(n)
    wf, mx2, idx2 = tsf.spectrum_fft_ref(iq, n, True, q)
    assert torch.equal(mx, mx2) and torch.equal(idx, idx2)
    nat = tsf.spectrum_natural_order(psd)
    want = nat.reshape(2, 2, n // q, q).amax(dim=-1)
    assert torch.equal(tsf.waterfall_natural_order(wf), want)
    assert bool(torch.isfinite(wf).all())
