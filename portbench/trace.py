"""The traced run's reading of ``torch.profiler``'s trace.

The benchmark marks its blocks in the trace itself: a zero-length range
``pb.start.<block>`` where a block's upload starts, ``pb.tick.<block>``
where the Session publishes the block's 'audio-frame' tick and
``pb.drain.<block>`` where a telemetry drain starts, and a range
``pb.stage.<name>`` around every stage call (``harness.SpanTimers``). The
traced window runs from the start of its first block to the tick of its
last; the profiler runs on for two more blocks, because it can lose a
trace's last device records.

From the window: the device's busy time (the union of its kernels, copies
and sets), every kernel's calls by name, the host's kernel launches (the
runtime's and driver's launch calls), the drains, and the breakdown: the
device operations that took most time, and the device's idle time by what
the host was doing (the innermost benchmark range and operator at the
middle of each gap).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclass
class Summary:
    first_block: int
    last_block: int
    window_s: float
    busy_s: float
    launches: int
    kernels: dict = field(default_factory=dict)   # name -> [seconds]
    drain_blocks: list = field(default_factory=list)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    @property
    def blocks(self) -> int:
        return self.last_block - self.first_block + 1

    def kernel_calls(self, name: str) -> list[float]:
        """Device seconds of every call of kernels whose name holds
        ``name``, in order."""
        return [s for k, v in self.kernels.items() if name in k for s in v]

    def as_json(self) -> dict:
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(events, starts, t: float) -> str | None:
    """The name of the latest-starting event that covers time ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 200), -1):
        ts, end, name = events[j]
        if end >= t:
            return name
    return None


def summarise(path: str, first_block: int, last_block: int) -> Summary:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    marks = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(
                ("pb.start.", "pb.tick.", "pb.drain.")):
            marks.setdefault(e["name"], float(e["ts"]))
    t0 = marks[f"pb.start.{first_block}"]
    t1 = marks[f"pb.tick.{last_block}"]
    dev, kernels, launches = [], defaultdict(list), 0
    by_name = defaultdict(float)
    stages, ops = [], []
    for e in events:
        cat, ts = e.get("cat"), float(e["ts"])
        end = ts + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(ts, t0), min(end, t1)
            if b > a:
                dev.append((a, b))
            if t0 <= ts < t1:
                by_name[e["name"]] += end - ts
                if cat == "kernel":
                    kernels[e["name"]].append((end - ts) / 1e6)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if t0 <= ts < t1 and e["name"] in LAUNCHES:
                launches += 1
        elif cat == "user_annotation" and e["name"].startswith("pb.stage."):
            stages.append((ts, end, e["name"][len("pb.stage."):]))
        elif cat == "cpu_op":
            ops.append((ts, end, e["name"]))
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    stages.sort()
    ops.sort()
    s_starts = [s[0] for s in stages]
    o_starts = [o[0] for o in ops]
    idle = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    drains = sorted(int(k.rsplit(".", 1)[1]) for k in marks
                    if k.startswith("pb.drain."))
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        stage = _innermost(stages, s_starts, mid) or "between stages"
        op = _innermost(ops, o_starts, mid)
        idle[f"{stage}: {op}" if op else stage] += (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return Summary(
        first_block=first_block, last_block=last_block,
        window_s=(t1 - t0) / 1e6, busy_s=busy_us / 1e6, launches=launches,
        kernels=dict(kernels),
        drain_blocks=[b for b in drains if first_block <= b <= last_block],
        device_ops=[[name[:96], us / 1e6] for name, us in top],
        idle_gaps=[[name[:96], s] for name, s in gaps])
