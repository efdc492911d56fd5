#!/usr/bin/env python3
"""What the port's tracer costs, and how much of a block its spans cover,
in the benchmark's quiet cell, in turns on one card.

Run from the root of a checkout, with the other commit unpacked beside it
(e.g. ``git archive <commit> | tar -x -C build/parent``; ``build/`` is
copied to the card's machine):

    python3 tools/trace_cost.py --parent build/parent [--seconds 51] \
        [--rounds 3] [--seed 2400017001] [--cell fcd1-96k-tabs2.quiet]

Each round runs ``python3 -m portbench.run --trace 0`` three ways, each in
its own process, all three on the round's seed: in ``--parent`` (its own program), here with the tracer's
spans off (as the benchmark runs), and here with spans on and no
profiler; rounds alternate the order (parent, off, on; on, off,
parent). Then one ``--trace 1`` run here; one process here that runs the
cell's stages in a Session for ``--seconds`` with spans off and on in
turns every 100 blocks (the block walls a stretch, each side's median,
and the garbage collector's time a block); and the ns a call of the
tracer's pieces (a stage timer, a span, a count, a block's start; spans
off and on) here and of the stage timer in ``--parent``, each less an
empty loop's, on the card's host. The spans-on and traced runs
also print how much of each block's wall (from its ``session.frame``
start to the next block's) its top-level spans cover, over the window's
blocks after the profiled ones that the span ring holds. One line a run;
host-clock numbers: compare them only within one call. Imports no jax;
needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

# in a child: the benchmark's run in-process, spans on where asked, then
# the coverage of the program's top-level spans
CHILD = r'''
import json, sys
sys.path.insert(0, ".")
spans_on, args = sys.argv[1] == "1", sys.argv[2:]
import portbench.run  # first: its clock starts setup_s
from jsdr_tpu_torch.runtime import log
if spans_on:
    init = log.StageTimers.__init__
    log.StageTimers.__init__ = lambda self, spans=True: init(self, True)
rc = portbench.run.main(args)
tr = log.latest()
spans = tr.spans() if tr is not None else []
start = {b: t0 for name, b, _, t0, _ in spans if name == "session.frame"}
top = {}
for name, b, parent, t0, t1 in spans:
    if parent is None:
        top[b] = top.get(b, 0) + t1 - t0
from portbench import harness
from portbench.cells import load_cell
cfg = load_cell(args[args.index("--workload") + 1]).config
first = harness.WARM_BLOCKS + (cfg["trace_blocks"] + 3
                               if args[args.index("--trace") + 1] == "1"
                               else 0)
cover = sorted(top[b] / (start[b + 1] - start[b]) for b in start
               if b >= first and b + 1 in start)
if cover:
    print("COVER " + json.dumps({
        "blocks": len(cover), "min": cover[0],
        "p05": cover[len(cover) // 20], "median": cover[len(cover) // 2],
        "mean": sum(cover) / len(cover), "spans": len(spans),
        "counters": dict(tr.counters)}))
sys.exit(rc)
'''


# in a child: ns a call of the tracer's pieces on this host, less an empty
# loop's; in a checkout without spans, its stage timer alone
MICRO = r'''
import json, sys, time
sys.path.insert(0, ".")
from jsdr_tpu_torch.runtime.log import StageTimers
N = 200_000
def per_call(body):
    t0 = time.perf_counter_ns()
    for _ in range(N):
        body()
    return (time.perf_counter_ns() - t0) / N
out = {}
for spans in ((False, True) if hasattr(StageTimers, "span") else (None,)):
    tr = StageTimers() if spans is None else StageTimers(spans=spans)
    def stage():
        with tr.stage("h2d", 96000):
            pass
    empty = per_call(lambda: None)
    row = {"stage": per_call(stage) - empty}
    if spans is not None:
        tr.begin_block(0)
        def span():
            with tr.span("telemetry.step"):
                pass
        row.update(span=per_call(span) - empty,
                   count=per_call(lambda: tr.count("drain.runs")) - empty,
                   begin_block=per_call(lambda: tr.begin_block(1)) - empty)
    out["on" if spans else "off" if spans is False else "parent"] = row
print("MICRO " + json.dumps(out))
'''


# in a child: one Session of the cell's stages on its capture, with the
# benchmark's timers and a tick listener, spans toggled off and on every
# STRETCH blocks; block walls (tick to tick) by stretch, and the time the
# garbage collector took in each
INTERLEAVE = r'''
import gc, json, os, sys, time
sys.path.insert(0, ".")
from portbench.cells import load_cell
cell = load_cell(sys.argv[1])
cfg, mix = cell.config, cell.traffic
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = str(cfg["torch_threads"])
import torch
torch.set_num_threads(cfg["torch_threads"])
from portbench import harness
from portbench.gen.synth import make_capture
from jsdr_tpu_torch.runtime.executor import Session
seconds, seed, STRETCH = float(sys.argv[2]), int(sys.argv[3]), 100
dev, key = torch.device("cuda"), str(cfg["rate"])
cap = make_capture(cfg["rate"], mix["carriers_hz"][key],
                   mix["amplitude"][key], mix["noise_rms"][key],
                   mix["frame_periods"], seed, dev)
chunks = cap.chunks(cfg["chunk_samples"])
per_block = cfg["block_samples"] // cfg["chunk_samples"]
src = harness.LoopSource(chunks, per_block, harness.WARM_BLOCKS, seconds)
s = Session(source=iter(src), block_samples=cfg["block_samples"],
            device=dev, timers=harness.SpanTimers())
ticks, gc_ns, t_gc = [], [], [0]
def on_gc(phase, info):
    if phase == "start":
        t_gc[0] = time.perf_counter_ns()
    else:
        gc_ns.append((len(ticks), time.perf_counter_ns() - t_gc[0]))
def listen(topic, value):
    if topic == "audio-frame":
        ticks.append(time.perf_counter_ns())
        b = len(ticks) - harness.WARM_BLOCKS
        if b >= 0 and b % STRETCH == 0:
            s.tracer.spans_on = (b // STRETCH) % 2 == 1
s.pubsub.listen(listen)
gc.callbacks.append(on_gc)
n = s.run(harness.build_stages(cfg, dev))
gc.callbacks.remove(on_gc)
rows = {"off": [], "on": []}
for k in range((n - harness.WARM_BLOCKS) // STRETCH):
    a = harness.WARM_BLOCKS + k * STRETCH
    walls = [ticks[i] - ticks[i - 1] for i in range(a + 2, a + STRETCH)]
    g = sum(ns for i, ns in gc_ns if a + 1 <= i < a + STRETCH)
    rows["on" if k % 2 else "off"].append(
        (sum(walls) / len(walls) / 1e6, g / len(walls) / 1e6))
pairs = list(zip(rows["off"], rows["on"]))
print("INTERLEAVE " + json.dumps({
    "blocks": n, "stretches": len(rows["off"]) + len(rows["on"]),
    "off_ms": [r[0] for r in rows["off"]], "on_ms": [r[0] for r in rows["on"]],
    "gc_ms_off": sum(r[1] for r in rows["off"]) / max(len(rows["off"]), 1),
    "gc_ms_on": sum(r[1] for r in rows["on"]) / max(len(rows["on"]), 1),
    "on_slower_pairs": sum(b[0] > a[0] for a, b in pairs),
    "pairs": len(pairs)}))
'''


def interleave(cell: str, seconds: float, seed: int) -> dict:
    res = subprocess.run([sys.executable, "-c", INTERLEAVE, cell,
                          str(seconds), str(seed)], capture_output=True,
                         text=True, timeout=900)
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("INTERLEAVE ")]
    if not line:
        return {"rc": res.returncode, "stderr": res.stderr[-3000:]}
    out = json.loads(line[-1][11:])
    for side in ("off", "on"):
        out[f"{side}_median_ms"] = statistics.median(out[f"{side}_ms"])
    return out


def micro(root: str) -> dict:
    res = subprocess.run([sys.executable, "-c", MICRO], cwd=root,
                         capture_output=True, text=True, timeout=300)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("MICRO ")]
    return json.loads(line[-1][6:]) if line else {"stderr": res.stderr[-2000:]}


def one(root: str, spans_on: bool, args: list[str]) -> dict:
    t0 = time.perf_counter()
    cmd = ([sys.executable, "-c", CHILD, "1" if spans_on else "0"]
           if root == "." else [sys.executable, "-m", "portbench.run"])
    res = subprocess.run(cmd + args, cwd=root, capture_output=True,
                         text=True, timeout=900)
    lines = res.stdout.splitlines()
    result = [json.loads(ln) for ln in lines if ln.startswith("{")]
    cover = [json.loads(ln[6:]) for ln in lines if ln.startswith("COVER ")]
    out = {"rc": res.returncode, "seconds": time.perf_counter() - t0,
           "result": result[-1] if result else None,
           "cover": cover[-1] if cover else None}
    if res.returncode or not result:
        out["stderr"] = res.stderr[-3000:]
    return out


def main() -> int:
    p = argparse.ArgumentParser(prog="python3 tools/trace_cost.py")
    p.add_argument("--parent", required=True)
    p.add_argument("--cell", default="fcd1-96k-tabs2.quiet")
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--seed", type=int, default=2400017001)
    a = p.parse_args()
    rates = {"parent": [], "off": [], "on": []}
    failed = False
    for r in range(a.rounds):
        args = ["--workload", a.cell, "--seed", str(a.seed + r),
                "--seconds", str(a.seconds), "--trace", "0"]
        turns = [("parent", a.parent, False), ("off", ".", False),
                 ("on", ".", True)]
        for label, root, spans_on in (turns if r % 2 == 0 else turns[::-1]):
            res = one(root, spans_on, args)
            line = res["result"] or {}
            ok = res["rc"] == 0 and line.get("correct") is True
            failed |= not ok
            msps = line.get("metrics", {}).get("stream_msps", {}).get("value")
            if msps is not None:
                rates[label].append(msps)
            print("RUN " + json.dumps({
                "round": r, "side": label, "seed": a.seed + r,
                "rc": res["rc"], "correct": line.get("correct"),
                "stream_msps": msps,
                "setup_s": line.get("metrics", {}).get("setup_s",
                                                       {}).get("value"),
                "seconds": res["seconds"], "cover": res["cover"],
                **({"stderr": res["stderr"]} if "stderr" in res else {})}),
                flush=True)
    args = ["--workload", a.cell, "--seed", str(a.seed + a.rounds),
            "--seconds", str(a.seconds), "--trace", "1"]
    res = one(".", False, args)
    failed |= res["rc"] != 0 or not res["result"]
    print("TRACED " + json.dumps(res), flush=True)
    print("INTERLEAVE " + json.dumps(interleave(
        a.cell, a.seconds, a.seed + a.rounds + 1)), flush=True)
    print("MICRO " + json.dumps({"here": micro("."),
                                 "parent": micro(a.parent)}), flush=True)
    print("MEDIANS " + json.dumps({k: statistics.median(v) if v else None
                                   for k, v in rates.items()}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
