"""The roofline work functions: with a row per tab they reproduce the
kernels' own bounds in PERF.md (chip_smoke.py's counts); for a Session
they count the shared stream once, so a kernel that reads it once cannot
read over 100%."""

import math

import pytest

from portbench.roofline import k2_timing, k3_spec_front, k6_mix_dec_mf
from portbench.roofline import kA_viterbi
from portbench.roofline.peaks import bound_s


@pytest.mark.parametrize("what, work, ms, by", [
    ("kernel 2 at 128 x 9,600", k2_timing.work(128, 9600), 0.00312,
     "bytes"),
    ("kernel 6 at 128 x 96,000", k6_mix_dec_mf.work(128, 96000, 10, 128),
     0.0324, "bytes"),
    ("kernel 3 at 128 x 460,800", k3_spec_front.work(128, 460800, 9600, 5,
                                                     10, 128), 0.1691,
     "bytes"),
    ("kernel A at 128 frames", kA_viterbi.work(128), 0.00128, "operations"),
])
def test_reproduces_perf_md_bounds(what, work, ms, by):
    least, bound_by = bound_s(*work)
    assert least * 1e3 == pytest.approx(ms, abs=5e-5 * max(1, ms / 0.01)), what
    assert bound_by == by


def test_session_counts_the_stream_once():
    for per_row, once in (
            (k6_mix_dec_mf.work(128, 96000, 10, 128),
             k6_mix_dec_mf.work(128, 96000, 10)),
            (k3_spec_front.work(128, 921600, 19200, 10, 20, 128),
             k3_spec_front.work(128, 921600, 19200, 10, 20))):
        assert once[1] < per_row[1] and once[0] <= per_row[0]
    # kernel 6: the stream once is 96,000 x 8 bytes, not 128 rows of it
    assert (k6_mix_dec_mf.work(128, 96000, 10, 128)[1]
            - k6_mix_dec_mf.work(128, 96000, 10)[1]) == 127 * 8.0 * 96000
    # kernel 3: one display spectrum, not 128
    ops_rows = k3_spec_front.work(128, 921600, 19200, 10, 20, 128)[0]
    ops_once = k3_spec_front.work(128, 921600, 19200, 10, 20)[0]
    one = 48 * (5.0 * 19200 * math.log2(19200) + 8.0 * 19200)
    assert ops_rows - ops_once == pytest.approx(127 * one)
