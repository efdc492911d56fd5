"""Work of kernel 3, the merged waterfall spectrum + tuner mix + 27-tap
decimator (``ops/csrc/spec_front.cu``), for one call over ``tabs`` tabs of
a ``t_len``-sample block: the display spectrum of n-sample sub-blocks,
max-decimated by ``q`` bins, and each tab's front end decimated by ``m``.

Counted from the logical problem: the stream is read once and the shared
display spectrum computed and written once, however many tabs share the
stream (``stream_rows=1``; ``stream_rows=tabs`` counts a row per tab, as
the kernel's own bound in PERF.md does). Per sub-block the window (2n),
a factored FFT's 5 n log2 n and the power, scale and dB (6n); per tab
output the FIR's multiply-adds on both planes (the tuner's product folds
into the taps, as for kernel 6); bytes: the input, the window, the lines
and peaks, each tab's patterns, tails and output.
"""

import math

KERNEL = "spec_front_kernel"
DS_TAPS = 27


def work(tabs: int, t_len: int, n: int, q: int, m: int,
         stream_rows: int = 1) -> tuple[float, float]:
    nblk = t_len // n
    outs = tabs * (t_len // m)
    ops = (stream_rows * nblk * (5.0 * n * math.log2(n) + 8.0 * n)
           + 2 * DS_TAPS * 2.0 * outs)
    nbytes = (8.0 * stream_rows * t_len + 4.0 * n
              + 4.0 * stream_rows * nblk * (n // 128 // q) * 128
              + 8.0 * stream_rows * nblk
              + 8.0 * tabs * 128 + 4 * DS_TAPS + 2 * 8.0 * tabs * (DS_TAPS - 1)
              + 8.0 * outs)
    return ops, nbytes
