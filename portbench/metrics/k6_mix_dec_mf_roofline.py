"""``k6_mix_dec_mf_roofline``: kernel 6's share of its roofline over
the traced blocks, its work counted with the shared stream read once
(``roofline/k6_mix_dec_mf.py``), %. Layer: kernel 6,
``csrc/mix_dec_mf.cu``."""

from portbench.roofline import k6_mix_dec_mf as K
from portbench.roofline.peaks import bound_s


def read(run):
    calls = run.trace.kernel_calls(K.KERNEL) if run.trace else []
    if not calls:
        return None
    cfg = run.cell.config
    least, _ = bound_s(*K.work(cfg["tabs"]["count"], cfg["block_samples"],
                               cfg["rate"] // 9600))
    return 100.0 * least * len(calls) / sum(calls)
