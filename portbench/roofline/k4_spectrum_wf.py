"""Work of kernel 4, the fused window + FFT + PSD + waterfall decimation
and peak (``ops/csrc/spectrum_wf.cu``), for one call over a
``t_len``-sample block: the display spectrum of n-sample sub-blocks,
max-decimated by ``q`` bins.

Counted from the logical problem: the stream is read once and the display
spectrum computed and its lines and peaks written once, however many tab
rows the call runs over (``stream_rows=1``; ``stream_rows=tabs`` counts a
row per tab, as the kernel's own bound in PERF.md does). Per sub-block the
window (2n), a factored FFT's 5 n log2 n and the power, scale and dB (6n);
bytes: the input, the window, the lines, and each peak's dB and index.
"""

import math

KERNEL = "spectrum_wf_kernel"
N2 = 128


def work(t_len: int, n: int, q: int,
         stream_rows: int = 1) -> tuple[float, float]:
    nblk = t_len // n
    ops = stream_rows * nblk * (5.0 * n * math.log2(n) + 8.0 * n)
    nbytes = (8.0 * stream_rows * t_len + 4.0 * n
              + 4.0 * stream_rows * nblk * (n // N2 // q) * N2
              + 8.0 * stream_rows * nblk)
    return ops, nbytes
