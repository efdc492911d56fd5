"""``k2_timing_roofline``: kernel 2's share of its roofline over the
traced blocks: the least time its calls' work needs
(``roofline/k2_timing.py``, every tab's matched-filter rows) over their
device time in the trace, %. Layer: kernel 2, ``csrc/timing.cu``."""

from portbench.roofline import k2_timing as K
from portbench.roofline.peaks import bound_s


def read(run):
    calls = run.trace.kernel_calls(K.KERNEL) if run.trace else []
    if not calls:
        return None
    cfg = run.cell.config
    t_ds = cfg["block_samples"] // (cfg["rate"] // 9600)
    least, _ = bound_s(*K.work(cfg["tabs"]["count"], t_ds))
    return 100.0 * least * len(calls) / sum(calls)
