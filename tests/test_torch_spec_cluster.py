"""The cluster path of the spectrum kernels (``csrc/spectrum_body.cuh``
with kRanks = 4), rehearsed on the CPU through its plain mirror
(``spectrum_fused.spectrum_fft_ref(..., ranks=4)``, i.e.
``fft_plan.fft_block(..., ranks=4)``): stage 1 on each rank's 32 columns
stored as flat [n1][32] planes, then stage 2 reading row k1's register i
of lane l from rank i at word perm[k1]*32 + l, the generic radix
included. It must equal the one-CTA walk (``ranks=1``) bit for bit on the
full PSD (q = 1) and on the waterfall lines, peaks and argmax, at the
FUNcube rate's n1 = 75 (which the card's forced cluster launch is
compared at), 245 = 5*7^2 (generic radix 49), 300 (384 kS/s) and the
reference's largest n1, 512. chip_smoke.py phase 7 holds the CUDA
cluster path against the one-CTA kernel and a float64 FFT on the card."""

import numpy as np
import pytest
import torch

from jsdr_tpu_torch.ops import spectrum_fused as tsf
from jsdr_tpu_torch.ops.cplx import from_complex


def _tones(seed, s, n, nblk):
    """A tone per stream at its own whole bin over a 0.3 noise floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(nblk * n)
    f = (np.arange(s) * 397 + 11) % n
    x = (0.3 * (rng.standard_normal((s, t.size))
                + 1j * rng.standard_normal((s, t.size)))
         + 1.5 * np.exp(2j * np.pi * f[:, None] * t[None, :] / n))
    return x.astype(np.complex64), f


@pytest.mark.parametrize("n1", [75, 245, 300, 512])
@pytest.mark.parametrize("waterfall", [False, True])
def test_cluster_walk_equals_one_cta_walk(n1, waterfall):
    n = 128 * n1
    x, f = _tones(n1, 2, n, 2)
    iq = from_complex(x, "cpu")
    q = tsf.wf_group_for(n) if waterfall else 1
    one = tsf.spectrum_fft_ref(iq, n, True, q)
    four = tsf.spectrum_fft_ref(iq, n, True, q, ranks=tsf.CLUSTER)
    assert tuple(four[0].shape) == (2, 2, n1 // q, 128)
    for a, b in zip(one, four):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the peak is the tone (natural bin of the flat permuted argmax)
    k_nat = n1 * (four[2].long() % 128) + four[2].long() // 128
    assert torch.equal(k_nat, torch.as_tensor(f)[None, :].expand_as(k_nat))


def test_cuda_ranks_rule():
    """One CTA a block up to ONE_CTA_MAX_N1 (225), the cluster above, to
    MAX_N1; the forced cluster at any n1."""
    assert tsf.ONE_CTA_MAX_N1 == 225 and tsf.CLUSTER == 4
    for n1 in range(1, tsf.MAX_N1 + 1):
        want = 1 if n1 <= 225 else 4
        assert tsf.cuda_ranks(128 * n1) == want, n1
        assert tsf.cuda_ranks(128 * n1, cluster=True) == 4
