"""``kA_viterbi_roofline``: kernel A's share of its roofline over the
traced drains: the least time for the frames each drain decoded (the
'telemetry-frame' publishes that followed its counters;
``roofline/kA_viterbi.py``) over its calls' device time, %. A drain
with no hit launches no kernel A. Layer: the FEC drain's kernel A,
``csrc/fec_viterbi.cu``."""

from portbench.roofline import kA_viterbi as K
from portbench.roofline.peaks import bound_s


def read(run):
    tr = run.trace
    calls = tr.kernel_calls(K.KERNEL) if tr else []
    traced = set(tr.drain_blocks) if tr else set()
    frames = [len(d.t_frames) for d in run.drains
              if d.block in traced and d.t_frames]
    pairs = list(zip(calls, frames))
    if not pairs:
        return None
    least = sum(bound_s(*K.work(f))[0] for _, f in pairs)
    return 100.0 * least / sum(c for c, _ in pairs)
