"""``k3_spec_front_roofline``: kernel 3's share of its roofline over
the traced blocks, its work counted with the stream read once and the
display spectrum computed once (``roofline/k3_spec_front.py``), %. The
display lines' width is the telemetry stage's: n / q pixels, q the
smallest divisor of n / 128 that keeps them at most 2048 wide. Layer:
kernel 3, ``csrc/spec_front.cu``."""

from portbench.roofline import k3_spec_front as K
from portbench.roofline.peaks import bound_s


def read(run):
    calls = run.trace.kernel_calls(K.KERNEL) if run.trace else []
    if not calls:
        return None
    cfg = run.cell.config
    n = cfg["rate"] // 10
    n1 = n // 128
    q = next(q for q in range(1, n1 + 1)
             if n1 % q == 0 and (n1 // q) * 128 <= 2048)
    least, _ = bound_s(*K.work(cfg["tabs"]["count"], cfg["block_samples"],
                               n, q, cfg["rate"] // 9600))
    return 100.0 * least * len(calls) / sum(calls)
