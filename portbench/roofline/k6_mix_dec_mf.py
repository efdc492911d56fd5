"""Work of kernel 6, the fused tuner mix, 27-tap decimator, 1200 Hz VCO
mix and 65-tap matched filter (``ops/csrc/mix_dec_mf.cu``), for one call
over ``tabs`` tabs of a ``t_len``-sample block decimated by ``m``.

Counted from the logical problem: the stream is read once however many
tabs share it (``stream_rows=1``; ``stream_rows=tabs`` counts a row per
tab, as the kernel's own bound in PERF.md does), each tab's output and
tails are written once, its four 128-entry patterns read once. The
operations are the two filters' multiply-adds and the VCO product per
output and plane; the tuner's product per input sample is not counted,
since a periodic pattern can be folded into the taps. With one stream
row, operations bound it.
"""

KERNEL = "mix_dec_mf_kernel"
DS_TAPS, MF_TAPS = 27, 65


def work(tabs: int, t_len: int, m: int, stream_rows: int = 1
         ) -> tuple[float, float]:
    outs = tabs * (t_len // m)
    ops = (2 * DS_TAPS * 2 + 2 + 2 * MF_TAPS * 2) * float(outs)
    nbytes = (8.0 * stream_rows * t_len + 8.0 * outs + 4 * 4.0 * tabs * 128
              + 4 * (DS_TAPS + MF_TAPS)
              + 2 * 8.0 * tabs * (DS_TAPS - 1 + MF_TAPS - 1))
    return ops, nbytes
