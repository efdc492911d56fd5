"""The port's ``compat_scan`` timing path (``jsdr_tpu_torch/demod/bpsk.py::
_timing_scan_batch``, a per-sample torch loop) against the JAX package's
(``jsdr_tpu.demod.bpsk._timing_scan``, a ``lax.scan``), on the CPU.

The scan keeps the reference's fp order, so nothing is held to a
tolerance: the decisions (``valid``, ``bit``), ``di``, ``e2`` and the
final ``TimingState`` are equal to JAX's bit for bit over chained blocks.
That holds because the port evaluates each step in the form XLA's CPU
build takes, which contracts five products into fused multiply-adds
(``_timing_scan_batch``'s docstring lists them). ``test_fp_forms`` shows
that the plain unfused order would not be equal, so the FMA forms are the
contract, not a detail. Both goldens decode bit-exact through the port's
``compat_scan`` and its decisions equal the port's default path (the
timing kernel's plain version), as tests/test_bpsk_chain.py holds the
reference's two paths. JAX's ``compat_scan`` over the goldens runs in
tests/test_golden.py and is not repeated here."""

import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.demod import bpsk as JB
from jsdr_tpu_torch.demod import bpsk as TB
from jsdr_tpu_torch.fec.decoder import fec_decode
from jsdr_tpu_torch.io.convert import s16le_to_complex
from jsdr_tpu_torch.io.sources import synth_bpsk_stream
from jsdr_tpu_torch.ops.cplx import CF, from_complex

GOLDEN = Path(__file__).parent / "golden"


def _states(rng, s):
    """A mid-stream timing state: EMAs, peaks and last_iq off their init."""
    return dict(
        e_ema=(rng.uniform(0, 2e5, (s, 8))).astype(np.float32),
        pos=np.zeros(s, np.int32),
        peak=rng.integers(0, 8, s).astype(np.int32),
        new_peak=rng.integers(0, 8, s).astype(np.int32),
        e_out=rng.uniform(1.0, 1e4, s).astype(np.float32),
        last_iq=(rng.standard_normal((s, 2)) * 100).astype(np.float32))


@pytest.mark.parametrize("s,scale", [(1, 300.0), (3, 300.0), (3, 6.0)],
                         ids=["one_stream", "batch", "near_gate"])
def test_timing_scan_equals_jax_compat_scan(s, scale):
    """Three chained blocks of s streams x 960 samples with a carried
    state; at scale 6 the energies straddle the gate (e2 ~ 100). One
    stream and a batch take different FMA forms in XLA's CPU build, and
    the port takes the same ones, so every output is bit-equal."""
    rng = np.random.default_rng(11)
    k = 960
    init = _states(rng, s)
    j_st = JB.TimingState(**{n: jnp.asarray(v) for n, v in init.items()})
    t_st = TB.TimingState(**{n: torch.from_numpy(v) for n, v in init.items()})
    scan = jax.jit(jax.vmap(JB._timing_scan))
    gated = 0
    for _ in range(3):
        re = (rng.standard_normal((s, k)) * scale).astype(np.float32)
        im = (rng.standard_normal((s, k)) * scale).astype(np.float32)
        jv, jb, jdi, je2, j_st = scan(JB.CF(jnp.asarray(re), jnp.asarray(im)),
                                      j_st)
        tv, tb, tdi, te2, t_st = TB._timing_scan_batch(
            CF(torch.from_numpy(re), torch.from_numpy(im)), t_st)
        for name, got, want in (("valid", tv, jv), ("bit", tb, jb),
                                ("di", tdi, jdi), ("e2", te2, je2)):
            want = np.array(want)
            assert got.numpy().dtype == want.dtype, name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        gated += int((np.asarray(je2) <= JB.ENERGY_GATE).sum())
        for name in TB.TimingState._fields:
            got, want = getattr(t_st, name).numpy(), np.asarray(
                getattr(j_st, name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert (gated > 0) == (scale < 10)


@pytest.mark.parametrize("s", [1, 3])
def test_fp_forms(s):
    """The FMA forms are what makes the scan equal, and they differ with
    the batch: the EMA in the plain order (every product rounded), or in
    the other batch size's form, differs from JAX's e_ema."""
    rng = np.random.default_rng(3)
    k = 960
    init = _states(rng, s)
    re = (rng.standard_normal((s, k)) * 300).astype(np.float32)
    im = (rng.standard_normal((s, k)) * 300).astype(np.float32)
    j_st = JB.TimingState(**{n: jnp.asarray(v) for n, v in init.items()})
    want = np.asarray(jax.jit(jax.vmap(JB._timing_scan))(
        JB.CF(jnp.asarray(re), jnp.asarray(im)), j_st)[4].e_ema)
    s1 = np.float32(JB.BIT_SMOOTH1)
    a1 = np.float32(1.0 - JB.BIT_SMOOTH1)
    e1 = TB._fma(torch.from_numpy(re), torch.from_numpy(re),
                 torch.from_numpy(im * im)).numpy()
    forms = {
        "plain": lambda e, x: e * a1 + x * s1,
        "one": lambda e, x: TB._fma(torch.from_numpy(e), float(a1),
                                    torch.from_numpy(x * s1)).numpy(),
        "batch": lambda e, x: TB._fma(torch.from_numpy(x), float(s1),
                                      torch.from_numpy(e * a1)).numpy(),
    }
    equal = []
    for name, step in forms.items():
        ema = init["e_ema"].copy()
        for j in range(k):
            ema[:, j % 8] = step(ema[:, j % 8], e1[:, j])
        if np.array_equal(ema, want):
            equal.append(name)
    assert equal == ["one" if s == 1 else "batch"]


def _decode(sig, cfg, n_blocks, block):
    st = TB.bpsk_init(cfg, "cpu")
    payloads, rcs, corrs, bits = [], [], [], []
    for b in range(n_blocks):
        out, st = TB.bpsk_block(from_complex(sig[b * block:(b + 1) * block],
                                             "cpu"), cfg, st)
        bits.append(out.bits[:int(out.n_bits)].numpy())
        nh = int(out.n_hits)
        if nh:
            res = fec_decode(out.windows[:nh])
            assert bool(res.ok.all())
            payloads += list(res.payload.numpy())
            rcs += res.rc.tolist()
            corrs += out.hit_corr[:nh].tolist()
    return payloads, rcs, corrs, bits, st


@pytest.mark.parametrize("name", ["golden_96k.npz", "golden_192k.npz"])
def test_golden_decodes_bit_exact_through_compat_scan(name):
    g = np.load(GOLDEN / name)
    rate = int(g["rate"])
    sig = s16le_to_complex(np.asarray(g["raw_s16le"]))
    sig = np.concatenate([sig, np.zeros((-len(sig)) % rate, np.complex64)])
    cfg = TB.BpskConfig(rate=rate, tuning=float(g["tuning"]),
                        compat_scan=True)
    payloads, rcs, corrs, _, st = _decode(sig, cfg, len(sig) // rate, rate)
    np.testing.assert_array_equal(np.stack(payloads), g["payloads"])
    assert rcs == list(g["rc"])
    assert corrs == list(g["hit_corr"])
    assert int(st.timing.pos) == 0


def test_compat_scan_decisions_equal_the_default_path():
    """The counterpart of tests/test_bpsk_chain.py::
    test_parallel_timing_equals_scan: the same stream through the scan and
    through the timing kernel's plain version gives the same bits, hits
    and peak schedule."""
    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads, rate=96000, noise_rms=0.4, seed=8)
    sig = np.concatenate([sig, np.zeros((-len(sig)) % 96000, np.complex64)])
    n = len(sig) // 96000
    cfg = TB.BpskConfig(rate=96000, tuning=12000.0)
    a = _decode(sig, cfg._replace(compat_scan=True), n, 96000)
    b = _decode(sig, cfg, n, 96000)
    assert len(a[0]) == 1
    np.testing.assert_array_equal(np.stack(a[0]), payloads)
    for x, y in zip(a[3], b[3]):
        np.testing.assert_array_equal(x, y)
    assert a[1:3] == b[1:3]
    for name in ("peak", "new_peak", "pos"):
        assert int(getattr(a[4].timing, name)) == int(
            getattr(b[4].timing, name)), name


def test_compat_scan_through_the_spectrum_step_forces_fuse_mf_off(
        monkeypatch):
    """bpsk_block_batch_spectrum threads compat_scan through its merged
    branch (4 FFT blocks at 96 kS/s) as bpsk_block_batch does; fuse_mf is
    forced off under compat_scan (kernel 6 is never called)."""
    rng = np.random.default_rng(4)
    s, t = 2, 38400
    x = (0.3 * (rng.standard_normal((s, t)) + 1j * rng.standard_normal(
        (s, t)))).astype(np.complex64)
    iq = from_complex(x, "cpu")
    cfg = TB.BpskConfig(rate=96000, tuning=12000.0, compat_scan=True)
    st = TB.bpsk_init_batch(cfg, s, "cpu")
    assert TB.spectrum_step_merged(cfg, t, [12000.0] * s)
    _, out_s, st_s = TB.bpsk_block_batch_spectrum(iq, cfg, st)

    def no_kernel_6(*a, **k):
        raise AssertionError("fuse_mf ran under compat_scan")

    monkeypatch.setattr(TB, "mix_decimate_mf", no_kernel_6)
    out_b, st_b = TB.bpsk_block_batch(iq, cfg._replace(fuse_mf=True), st)
    for name in ("bits", "n_bits", "n_hits", "hit_corr"):
        assert torch.equal(getattr(out_s, name), getattr(out_b, name)), name
    for name in ("peak", "new_peak", "pos"):
        assert torch.equal(getattr(st_s.timing, name),
                           getattr(st_b.timing, name)), name


def test_compat_scan_warning_decision():
    """A card gets the reference's RuntimeWarning (decided from the device
    alone, so it is checked here without one); the CPU gets none."""
    msg = TB.compat_scan_warning(torch.device("cuda"))
    assert "compat_scan" in msg and "H100" in msg
    assert TB.compat_scan_warning(torch.device("cuda", 1)) == msg
    assert TB.compat_scan_warning("cpu") is None
    cfg = TB.BpskConfig(rate=96000, compat_scan=True)
    x = CF(torch.zeros(1, 960), torch.zeros(1, 960))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TB.bpsk_block_batch(x, cfg, TB.bpsk_init_batch(cfg, 1, "cpu"))
