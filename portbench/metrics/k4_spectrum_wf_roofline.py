"""``k4_spectrum_wf_roofline``: kernel 4's share of its roofline over the
traced blocks, its work counted with the stream read once and the display
spectrum computed once (``roofline/k4_spectrum_wf.py``), %. The staged
spectrum-telemetry step runs kernel 4 over every tab's row of the same
stream and publishes row 0's, so the share reads at most 100 ÷ tabs. The
display lines' width is the stage's: n / q pixels, q the smallest divisor
of n / 128 that keeps them at most 2048 wide. None where the trace holds
no call of kernel 4. Layer: kernel 4, ``csrc/spectrum_wf.cu``."""

from portbench.roofline import k4_spectrum_wf as K
from portbench.roofline.peaks import bound_s


def read(run):
    calls = run.trace.kernel_calls(K.KERNEL) if run.trace else []
    if not calls:
        return None
    cfg = run.cell.config
    n = cfg["rate"] // 10
    n1 = n // K.N2
    q = next(q for q in range(1, n1 + 1)
             if n1 % q == 0 and (n1 // q) * K.N2 <= 2048)
    least, _ = bound_s(*K.work(cfg["block_samples"], n, q))
    return 100.0 * least * len(calls) / sum(calls)
