"""The port's fused mix + decimate + VCO mix + matched filter
(``ops/mix_decimate_mf.py``; its wrapper runs the plain version for CPU
tensors) against the reference's ``mix_decimate_mf``: the Pallas kernel
in interpret mode, at the shape of the reference's own test
(tests/test_ops.py:277-334: S = 3, T = 26,240, a ragged last chunk) and
at 192 kS/s's decimation.

Tolerances are the reference test's: mf and the new mf tail within
2e-5 * max|mf| (float32 sums of 27 and 65 products in other orders); the
new ds tail is a copy of mixed input samples, within 1e-5. The plain
version must equal the port's own unfused chain (kernel 1's plain
version, ``demod.bpsk._vco_mix``, ``fir_apply_streaming``) bit for bit.
The CUDA kernel is held against the plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.demod.bpsk import _vco_pattern as j_vco_pattern
from jsdr_tpu.ops.cplx import CF as JCF
from jsdr_tpu.ops.pallas_kernels import mix_decimate_mf as jmdmf
from jsdr_tpu_torch.demod.bpsk import (DM_FILTER, DS_FILTER,
                                       HOWARD_FUDGE_FACTOR, _vco_mix,
                                       _vco_pattern)
from jsdr_tpu_torch.ops.cplx import CF
from jsdr_tpu_torch.ops.fir import fir_apply_streaming
from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
from jsdr_tpu_torch.ops.mix_decimate_mf import (mix_decimate_mf,
                                                mix_decimate_mf_ref)

VCO_IDX = np.array([0, 3, 6, 5], np.int32)


def _inputs(seed, s, t):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    ang = (np.arange(128) * 3 % 128) * (2 * np.pi / 128)
    return dict(x=(0.3 * f(s, t), 0.3 * f(s, t)),
                cos=np.tile(np.cos(ang).astype(np.float32), (s, 1)),
                sin=np.tile(np.sin(ang).astype(np.float32), (s, 1)),
                tail=(f(s, 26), f(s, 26)), mf_tail=(f(s, 64), f(s, 64)),
                vco_idx=VCO_IDX[:s])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_args(d, m):
    vc, vs = _vco_pattern(_t(d["vco_idx"]))
    return (CF(_t(d["x"][0]), _t(d["x"][1])), _t(d["cos"]), _t(d["sin"]),
            torch.as_tensor(DS_FILTER, dtype=torch.float32), m,
            CF(_t(d["tail"][0]), _t(d["tail"][1])), vc, vs,
            torch.as_tensor(DM_FILTER, dtype=torch.float32),
            CF(_t(d["mf_tail"][0]), _t(d["mf_tail"][1])),
            HOWARD_FUDGE_FACTOR)


@pytest.mark.parametrize("precision", ["bf16x3", "highest"])
@pytest.mark.parametrize("s,t,m", [(3, 12800 * 2 + 640, 10),
                                   (2, 25600 * 2 + 1280, 20)])
def test_mix_decimate_mf_matches_reference(s, t, m, precision):
    d = _inputs(s * t + m, s, t)
    j = lambda a: jnp.asarray(a)
    vcoc, vcos = j_vco_pattern(j(d["vco_idx"]))
    mf_j, tail_j, mft_j = jmdmf(
        JCF(j(d["x"][0]), j(d["x"][1])), j(d["cos"]), j(d["sin"]),
        DS_FILTER.astype(np.float32), m, JCF(j(d["tail"][0]),
                                             j(d["tail"][1])),
        vcoc, vcos, DM_FILTER.astype(np.float32),
        JCF(j(d["mf_tail"][0]), j(d["mf_tail"][1])),
        gain=HOWARD_FUDGE_FACTOR, use_pallas=True, interpret=True,
        precision=precision)
    mf, tail, mft = mix_decimate_mf(*_port_args(d, m))
    scale = float(np.abs(np.asarray(mf_j.re)).max())
    for got, want, atol in ((mf, mf_j, 2e-5 * scale), (tail, tail_j, 1e-5),
                            (mft, mft_j, 2e-5 * scale)):
        for p in ("re", "im"):
            np.testing.assert_allclose(getattr(got, p).numpy(),
                                       np.asarray(getattr(want, p)),
                                       atol=atol, rtol=0)
    assert mf.re.shape == (s, t // m) and mft.re.shape == (s, 64)


@pytest.mark.parametrize("s,t,m", [(3, 12800 * 2 + 640, 10), (2, 1280, 20)])
def test_plain_version_is_the_unfused_chain(s, t, m):
    d = _inputs(7, s, t)
    args = _port_args(d, m)
    mf, tail, mft = mix_decimate_mf_ref(*args)
    ds, tail_u = mix_decimate(*args[:6], HOWARD_FUDGE_FACTOR)
    bb, _ = _vco_mix(ds, _t(d["vco_idx"]))
    mf_u, mft_u = fir_apply_streaming(bb, args[8], args[9])
    for got, want in ((mf, mf_u), (tail, tail_u), (mft, mft_u)):
        assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)


def test_wrapper_on_cpu_runs_the_plain_version():
    d = _inputs(3, 2, 1280)
    before = mix_decimate_mf.launches
    got = mix_decimate_mf(*_port_args(d, 10))
    want = mix_decimate_mf_ref(*_port_args(d, 10))
    for g, w in zip(got, want):
        assert torch.equal(g.re, w.re) and torch.equal(g.im, w.im)
    assert mix_decimate_mf.launches == before     # no kernel launched


def test_wrapper_rejects_bad_inputs():
    args = list(_port_args(_inputs(3, 2, 1280), 10))
    with pytest.raises(ValueError, match="multiple"):
        mix_decimate_mf(CF(args[0].re[:, :1275], args[0].im[:, :1275]),
                        *args[1:])
    bad = list(args)
    bad[9] = CF(args[9].re[:, :63], args[9].im[:, :63])
    with pytest.raises(ValueError, match="mf_tail"):
        mix_decimate_mf(*bad)
    bad = list(args)
    bad[6] = args[6].double()
    with pytest.raises(ValueError, match="float32"):
        mix_decimate_mf(*bad)
