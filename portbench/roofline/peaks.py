"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit): float32 outside the tensor cores,
and HBM3 bandwidth. 32-bit integer work (the Viterbi's adds, compares and
table reads) is held to the same CUDA-core rate, as the data sheet gives
no int32 rate. A run states the card's ``power.limit`` beside its shares.
"""

PEAK_OPS = 67e12        # float32 (and int32) operations a second
PEAK_BYTES = 3.35e12    # bytes a second


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time (s) the card could take for this work, and which of
    operations and bytes bounds it."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
