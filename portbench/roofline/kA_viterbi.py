"""Work of kernel A, the FEC drain's Viterbi decoder (``ops/csrc/
fec_viterbi.cu``), for one call over ``frames`` windows: the frames a
drain actually decodes. Per frame 2,566 add-compare-select steps of 64
states (2 adds, a compare and a max each) and a 2,560-step chain-back (6
operations a step), as 32-bit integer operations; bytes: the 5,200-symbol
window read and 320 bytes written, and the 576-entry metric table.
Operations bound it.
"""

KERNEL = "viterbi_kernel"
OPS_PER_FRAME = 2566 * 64 * 4 + 2560 * 6


def work(frames: int) -> tuple[float, float]:
    return float(frames * OPS_PER_FRAME), frames * (5200.0 + 320) + 576 * 4.0
