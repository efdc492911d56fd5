"""The port's spectrum modules against the JAX package's, on the CPU:
``ops/windows.py``, ``ops/mxu_fft.py``, ``ops/spectrum.py`` and the
waterfall spectrum kernel's module ``ops/spectrum_fused.py`` (whose
wrappers run the plain version ``spectrum_wf_ref`` for CPU tensors; the
CUDA kernel is held against it on the card by chip_smoke.py).

The reference's kernel runs in Pallas interpret mode. Tolerances:
  * against its HIGHEST path (f32-exact products, another summation
    order) 2e-3 dB on every PSD/waterfall value of inputs with a noise
    floor, and 1e-3 dB on peaks;
  * against its default bf16x3 path 0.2 dB (its kernel documents up to
    0.13 dB against HIGHEST) on the same inputs. A noiseless tone has
    nulls far below the floor where bf16x3's error is not bounded by that
    figure, so PSD values are compared on 0.3*(randn + i*randn) inputs,
    as tests/test_ops.py does.
  * The argmax and peak frequency must be equal on a clear tone in noise.
    On pure noise a near-tie between bins may fall either way under
    another summation order, so there only dB values are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.ops import mxu_fft as j_fft
from jsdr_tpu.ops import pallas_kernels as jpk
from jsdr_tpu.ops import spectrum as j_spec
from jsdr_tpu.ops import windows as j_win
from jsdr_tpu.ops.cplx import CF as JCF
from jsdr_tpu.ops.cplx import from_complex as j_from_complex
from jsdr_tpu_torch.ops import mxu_fft as t_fft
from jsdr_tpu_torch.ops import spectrum as t_spec
from jsdr_tpu_torch.ops import spectrum_fused as tsf
from jsdr_tpu_torch.ops import windows as t_win
from jsdr_tpu_torch.ops.cplx import CF, from_complex

DB_HIGHEST, DB_DEFAULT, DB_PEAK = 2e-3, 0.2, 1e-3


def _noise(seed, s, t):
    rng = np.random.default_rng(seed)
    return (0.3 * (rng.standard_normal((s, t))
                   + 1j * rng.standard_normal((s, t)))).astype(np.complex64)


def _tones(seed, s, t, rate):
    """A clear tone per stream (its own frequency) over a noise floor."""
    f = 1000.0 + 2750.0 * np.arange(s)[:, None] - 20000.0 * (
        np.arange(s)[:, None] % 2)
    tone = 1.5 * np.exp(2j * np.pi * f * np.arange(t)[None, :] / rate)
    return (_noise(seed, s, t) + tone).astype(np.complex64)


def _np(x):
    return np.asarray(x)


def test_windows_match_reference():
    for n in (64, 1280, 9600):
        np.testing.assert_array_equal(t_win.hamming_np(n), j_win.hamming_np(n))
        np.testing.assert_allclose(t_win.hamming(n).numpy(),
                                   _np(j_win.hamming(n)), atol=1e-6)
        np.testing.assert_allclose(t_win.hamming_symmetric(n).numpy(),
                                   _np(j_win.hamming_symmetric(n)), atol=1e-6)


@pytest.mark.parametrize("n", [75, 128, 150])
def test_dft_tables_equal_reference(n):
    for a, b in zip(t_fft._dft_mats(n, -1.0), j_fft._dft_mats(n, -1.0)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(t_fft._twiddles(n, 128, -1.0),
                    j_fft._twiddles(n, 128, -1.0)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n", [960, 9600])
def test_fft_cf_matches_reference(n):
    x = _noise(11, 3, n)
    j = JCF(jnp.asarray(x.real), jnp.asarray(x.imag))
    t = from_complex(x, "cpu")
    for inverse in (False, True):
        want = j_fft.fft_cf(j, inverse=inverse)
        got = t_fft.fft_cf(t, inverse=inverse)
        scale = float(np.abs(_np(want.re)).max())
        for g, w in ((got.re, want.re), (got.im, want.im)):
            np.testing.assert_allclose(g.numpy(), _np(w), rtol=0,
                                       atol=2e-6 * scale)


@pytest.mark.parametrize("rate,n", [(96000, 9600), (96000, 192000),
                                    (192000, 19200), (44100, 4410),
                                    (250000, 25600), (2_400_000, 240_000)])
def test_bin_to_hz_matches_reference(rate, n):
    """Same integers as the reference, including transforms where the
    naive int32 product signed*rate would wrap (n = 192000 at 96 kS/s)."""
    bins = np.concatenate([np.arange(-n // 2, n // 2, max(n // 997, 1)),
                           [-n // 2, n // 2 - 1, -1, 0, 1]]).astype(np.int32)
    want = _np(j_spec.bin_to_hz(jnp.asarray(bins), rate, n))
    got = t_spec.bin_to_hz(torch.from_numpy(bins), rate, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    exact = [(int(b) * rate) // n for b in bins]
    np.testing.assert_array_equal(got.numpy().astype(np.int64), exact)


@pytest.mark.parametrize("window", [True, False])
def test_spectrum_block_matches_reference(window):
    x = _tones(12, 4, 1920, 19200.0)
    want = j_spec.spectrum_block(JCF(jnp.asarray(x.real),
                                     jnp.asarray(x.imag)),
                                 rate=19200.0, window=window)
    got = t_spec.spectrum_block(from_complex(x, "cpu"), rate=19200.0,
                                window=window)
    np.testing.assert_allclose(got.psd.numpy(), _np(want.psd), atol=1e-3)
    np.testing.assert_array_equal(got.peak_freq.numpy(), _np(want.peak_freq))
    np.testing.assert_allclose(got.peak_db.numpy(), _np(want.peak_db),
                               atol=DB_PEAK)
    assert got.peak_freq.dtype == torch.int32


def test_spectrum_wide_matches_block():
    """n = 1280 (n1 = 10): the fused path against reshape + spectrum_block
    of both packages (tests/test_ops.py's kernel check)."""
    rng = np.random.default_rng(3)
    s, t, n = 3, 2 * 1280, 1280
    sig = (rng.standard_normal((s, t))
           + 1j * rng.standard_normal((s, t))).astype(np.complex64)
    cf = j_from_complex(sig)
    ref = j_spec.spectrum_block(cf.reshape(s, t // n, n), rate=9600.0)
    jw = j_spec.spectrum_wide(cf, n, rate=9600.0, interpret=True)
    got = t_spec.spectrum_wide(from_complex(sig, "cpu"), n, rate=9600.0)
    assert tuple(got.psd.shape) == (s, t // n, n)
    for want in (ref, jw):
        np.testing.assert_allclose(got.psd.numpy(), _np(want.psd), rtol=0,
                                   atol=DB_HIGHEST)
        np.testing.assert_allclose(got.peak_db.numpy(), _np(want.peak_db),
                                   atol=DB_PEAK)
    np.testing.assert_array_equal(got.peak_freq.numpy(), _np(ref.peak_freq))
    perm = t_spec.spectrum_wide(from_complex(sig, "cpu"), n, rate=9600.0,
                                natural=False)
    assert torch.equal(tsf.spectrum_natural_order(perm.psd), got.psd)


def test_spectrum_wide_falls_back_to_block():
    """n % 128 != 0 takes reshape + spectrum_block, as in the reference."""
    x = _tones(4, 2, 2 * 4410, 44100.0)
    want = j_spec.spectrum_wide(j_from_complex(x), 4410, rate=44100.0)
    before = tsf.spectrum_fused.launches
    got = t_spec.spectrum_wide(from_complex(x, "cpu"), 4410, rate=44100.0)
    np.testing.assert_allclose(got.psd.numpy(), _np(want.psd), atol=1e-3)
    np.testing.assert_array_equal(got.peak_freq.numpy(), _np(want.peak_freq))
    assert tsf.spectrum_fused.launches == before


@pytest.mark.parametrize("waterfall", [False, True])
@pytest.mark.parametrize("precision,atol", [("highest", DB_HIGHEST),
                                            ("bf16x3", DB_DEFAULT)])
def test_fused_spectrum_matches_reference(waterfall, precision, atol):
    """n = 9600 (n1 = 75), S = 8, 3 blocks; full PSD (q = 1) and the
    waterfall (q = 5) against the interpreted Pallas kernel."""
    n, x = 9600, _noise(21, 8, 3 * 9600)
    if waterfall:
        want = jpk.spectrum_waterfall(j_from_complex(x), n, interpret=True,
                                      precision=precision)
        got = tsf.spectrum_waterfall(from_complex(x, "cpu"), n)
        assert tuple(got[0].shape) == (3, 8, 15, 128)
    else:
        want = jpk.spectrum_fused(j_from_complex(x), n, interpret=True,
                                  precision=precision, with_peaks=True)
        got = tsf.spectrum_fused(from_complex(x, "cpu"), n, with_peaks=True)
        assert tuple(got[0].shape) == (3, 8, 75, 128)
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(got[1].numpy(), _np(want[1]), rtol=0,
                               atol=DB_PEAK)
    assert got[2].dtype == torch.int32


@pytest.mark.parametrize("rate", [96000, 192000])
def test_peaks_equal_reference_on_tones(rate):
    n = rate // 10
    x = _tones(31, 4, 2 * n, float(rate))
    jw = jpk.spectrum_waterfall(j_from_complex(x), n, interpret=True,
                                precision="highest")
    got = tsf.spectrum_waterfall(from_complex(x, "cpu"), n)
    np.testing.assert_array_equal(got[2].numpy(), _np(jw[2]))
    np.testing.assert_allclose(got[1].numpy(), _np(jw[1]), atol=DB_PEAK)
    want = j_spec.spectrum_wide(j_from_complex(x), n, rate=float(rate),
                                interpret=True)
    res = t_spec.spectrum_wide(from_complex(x, "cpu"), n, rate=float(rate))
    np.testing.assert_array_equal(res.peak_freq.numpy(),
                                  _np(want.peak_freq))
    # the tones sit where they were put (one bin is 10 Hz)
    f = 1000.0 + 2750.0 * np.arange(4) - 20000.0 * (np.arange(4) % 2)
    assert np.all(np.abs(res.peak_freq.numpy() - f[:, None]) <= 10)


def test_waterfall_equals_decimated_full_psd():
    """wf equals the full PSD max-decimated in natural order, exactly,
    and both modes give the same peaks (tests/test_ops.py's identity)."""
    n = 9600
    iq = from_complex(_noise(1234, 8, 3 * n), "cpu")
    psd, mx, idx = tsf.spectrum_fused(iq, n, with_peaks=True)
    wf, mx2, idx2 = tsf.spectrum_waterfall(iq, n)
    assert torch.equal(mx, mx2) and torch.equal(idx, idx2)
    q = tsf.wf_group_for(n)
    assert q == 5 and tuple(wf.shape) == (3, 8, 15, 128)
    nat = tsf.spectrum_natural_order(psd)            # [S, nblk, n]
    ref = nat.reshape(8, 3, n // q, q).amax(dim=-1)
    assert torch.equal(tsf.waterfall_natural_order(wf), ref)
    # mx is the PSD value at idx
    flat = psd.reshape(3, 8, -1)
    assert torch.equal(flat.gather(2, idx.long()[..., None])[..., 0], mx)


def test_wf_group_for():
    assert tsf.wf_group_for(9600) == 5 == jpk.wf_group_for(9600)
    assert tsf.wf_group_for(19200) == 10 == jpk.wf_group_for(19200)
    for n in (1280, 4480, 38400, 65536):
        for w in (512, 2048):
            assert tsf.wf_group_for(n, w) == jpk.wf_group_for(n, w)


def test_all_zero_rows_give_bin_zero_and_floor():
    x = CF(torch.zeros(2, 1280), torch.zeros(2, 1280))
    wf, mx, idx = tsf.spectrum_waterfall(x, 1280)
    assert torch.equal(idx, torch.zeros_like(idx))
    assert torch.all(mx == torch.tensor(-300.0))
    assert torch.all(wf == torch.tensor(-300.0))


def test_intensity_and_maxima_match_reference():
    """Intensities within one step of the reference's on a noise floor;
    the packed maxima (peak Hz, peak dB) of tones as in the reference."""
    noise = _noise(5, 2, 4 * 1280)
    want = j_spec.spectrum_wide(j_from_complex(noise), 1280, rate=12800.0,
                                interpret=True)
    got = t_spec.spectrum_wide(from_complex(noise, "cpu"), 1280,
                               rate=12800.0)
    wi = _np(j_spec.waterfall_intensity(want.psd)).astype(np.int32)
    gi = t_spec.waterfall_intensity(got.psd)
    assert gi.dtype == torch.uint8
    assert np.abs(gi.numpy().astype(np.int32) - wi).max() <= 1

    tones = _tones(5, 2, 4 * 1280, 12800.0)
    want = j_spec.spectrum_wide(j_from_complex(tones), 1280, rate=12800.0,
                                interpret=True)
    got = t_spec.spectrum_wide(from_complex(tones, "cpu"), 1280,
                               rate=12800.0)
    packed = t_spec.psd_with_maxima(got)
    ref = _np(j_spec.psd_with_maxima(want))
    assert tuple(packed.shape) == ref.shape == (2, 4, 1282)
    assert torch.equal(packed[..., :1280], got.psd)
    np.testing.assert_array_equal(packed[..., 1280].numpy(), ref[..., 1280])
    np.testing.assert_allclose(packed[..., 1281].numpy(), ref[..., 1281],
                               atol=DB_PEAK)


def test_wrapper_checks_inputs_and_runs_plain_on_cpu():
    x = from_complex(_noise(2, 2, 2560), "cpu")
    before = tsf.spectrum_fused.launches
    got = tsf.spectrum_waterfall(x, 1280)
    want = tsf.spectrum_wf_ref(x, 1280, True, tsf.wf_group_for(1280))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tsf.spectrum_fused.launches == before       # no kernel launched
    with pytest.raises(ValueError, match="multiple of n"):
        tsf.spectrum_fused(CF(x.re[:, :2000], x.im[:, :2000]), 1280)
    with pytest.raises(ValueError, match="multiple of 128"):
        tsf.spectrum_fused(x, 1000)
    with pytest.raises(ValueError, match="contiguous"):
        tsf.spectrum_fused(CF(x.re.T.contiguous().T, x.im), 1280)
    with pytest.raises(ValueError, match="float32"):
        tsf.spectrum_fused(CF(x.re.double(), x.im), 1280)
    with pytest.raises(ValueError):
        tsf.spectrum_fused(CF(x.re.to("meta"), x.im.to("meta")), 1280)


def test_cuda_size_limit_is_the_shared_memory_limit():
    """The card's rule follows from the kernels' shared memory
    (csrc/spectrum_body.cuh::smem_bytes: a CTA's columns of the block
    only, 1024 bytes per row of 128 samples, plus the merged kernel's
    1,408 bytes of static arrays, within 232,448 bytes): one CTA holds a
    block up to n1 = 225 (every rate up to 288 kS/s at n = rate/10); a
    4-CTA cluster, 32 columns a CTA, holds one at every n1 up to the
    reference's 512, so no n1 the wrappers take is refused on the card."""
    n1 = tsf.ONE_CTA_MAX_N1
    assert tsf.smem_bytes(n1) == 1024 * n1 and tsf.STATIC_SMEM == 1408
    assert 1024 * n1 + 1408 <= 232448 < 1024 * (n1 + 1) + 1408
    assert n1 == 225
    assert tsf.smem_bytes(tsf.MAX_N1, tsf.CLUSTER) == 131072
    for m in range(1, tsf.MAX_N1 + 1):
        ranks = tsf.cuda_ranks(128 * m)
        assert ranks == (1 if m <= n1 else tsf.CLUSTER)
        assert tsf.smem_bytes(m, ranks) + tsf.STATIC_SMEM <= tsf.SMEM_PER_CTA
        tsf.check_geometry("k", 128 * m, 128 * m, 1)       # taken, no raise
    with pytest.raises(ValueError, match="512"):
        tsf.check_geometry("k", 128 * 513, 128 * 513, 1)


def test_spectrum_wide_matches_reference_above_one_cta():
    """n = 38,400 at 384 kS/s (n1 = 300: the card's cluster path), against
    the JAX package in Pallas interpret mode: on a noise floor the full
    PSD and peaks of its kernel at HIGHEST within 2e-3 and 1e-3 dB; on
    tones the peak frequencies of spectrum_wide equal, at the tones."""
    rate, n = 384000, 38400
    x = _noise(300, 2, n)
    want = jpk.spectrum_fused(j_from_complex(x), n, interpret=True,
                              precision="highest", with_peaks=True)
    got = tsf.spectrum_fused(from_complex(x, "cpu"), n, with_peaks=True)
    assert tuple(got[0].shape) == (1, 2, 300, 128)
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=0,
                               atol=DB_HIGHEST)
    np.testing.assert_allclose(got[1].numpy(), _np(want[1]), rtol=0,
                               atol=DB_PEAK)
    x = _tones(301, 2, n, float(rate))
    want = j_spec.spectrum_wide(j_from_complex(x), n, rate=float(rate),
                                interpret=True)
    got = t_spec.spectrum_wide(from_complex(x, "cpu"), n, rate=float(rate))
    assert tuple(got.psd.shape) == (2, 1, n)
    np.testing.assert_array_equal(got.peak_freq.numpy(),
                                  _np(want.peak_freq))
    f = 1000.0 + 2750.0 * np.arange(2) - 20000.0 * (np.arange(2) % 2)
    assert np.all(np.abs(got.peak_freq.numpy() - f[:, None]) <= 10)
