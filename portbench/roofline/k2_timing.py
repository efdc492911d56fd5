"""Work of kernel 2, the bit-timing recovery (``ops/csrc/timing.cu``), for
one call over ``tabs`` matched-filter rows of ``t_ds`` samples.

Each tab's rows are its own (no tab shares them), so every row counts.
Per 8-sample group: |v|^2 and the EMA of 8 phases (48 operations), the
argmax (8) and the two slot decisions (~20); bytes: both float32 planes
read once, a valid and a bit byte per slot written, and the carried state
(52 bytes a tab) read and written. Bytes bound it.
"""

KERNEL = "timing_kernel"


def work(tabs: int, t_ds: int) -> tuple[float, float]:
    groups = t_ds // 8
    ops = 76.0 * tabs * groups
    nbytes = 8.0 * tabs * t_ds + 2.0 * tabs * 2 * groups + 2 * 52.0 * tabs
    return ops, nbytes
