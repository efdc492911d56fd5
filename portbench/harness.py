"""One run of a cell: the capture from the seed, the configuration's stages
in the port's ``Session``, a warm-up, the measured window, the check of
``correct`` against the plain reference, and the metrics.

The loop is closed: the benchmark's source hands the Session its next raw
0.1 s chunk as soon as the Session asks, and records when it did. The
Session publishes on its bus what the stages produce; a listener records
the times and, for the blocks that the check samples, the outputs and the
telemetry stage's state before them. Nothing here calls a kernel: every
block goes through ``Session.run``.
"""

from __future__ import annotations

import gc
import json
import os
import tempfile
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from .cells import Cell, metric_reader, stage_check
from .checklib import frames_missed
from .gen.synth import make_capture
from . import trace as trace_mod

WARM_BLOCKS = 8          # two drains at sync_every = 4


class SpanTimers:
    """The Session's stage timers (``Session(timers=...)``): the wall of
    every stage call as a span (name, block, start, end) on the host clock,
    and with ``annotate`` a profiler range ``pb.stage.<name>`` around it.
    A block's first span is its upload ("h2d")."""

    def __init__(self):
        self.spans: list[tuple[str, int, float, float]] = []
        self.annotate = False
        self._block = -1

    @contextmanager
    def stage(self, name: str, samples: int = 0):
        if name == "h2d":
            self._block += 1
        ctx = (torch.profiler.record_function(f"pb.stage.{name}")
               if self.annotate else nullcontext())
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            self.spans.append((name, self._block, t0, time.perf_counter()))


class LoopSource:
    """The capture's chunks, looped, handed to the Session one at a time:
    ``warm`` blocks of warm-up, then blocks until ``seconds`` have passed
    since the first timed chunk (or ``max_blocks`` timed blocks), ending
    at a block boundary. ``handin[j]`` is when chunk j was handed in."""

    def __init__(self, chunks, per_block: int, warm: int, seconds: float,
                 max_blocks: int | None = None, on_window=None):
        self.chunks, self.per_block = chunks, per_block
        self.warm, self.seconds, self.max_blocks = warm, seconds, max_blocks
        self.on_window = on_window
        self.handin: list[float] = []
        self.t_window = None

    def __iter__(self):
        j, n = 0, len(self.chunks)
        while True:
            if j % self.per_block == 0:
                b = j // self.per_block
                if b == self.warm:
                    self.t_window = time.perf_counter()
                    if self.on_window:
                        self.on_window()
                if b > self.warm and (
                        b - self.warm >= self.max_blocks
                        if self.max_blocks is not None
                        else time.perf_counter() - self.t_window
                        >= self.seconds):
                    return
            self.handin.append(time.perf_counter())
            yield self.chunks[j % n]
            j += 1


@dataclass
class Group:
    """A group of ``sync_every`` blocks that the check replays: the
    telemetry stage's state before it (None for the start's groups, which
    the reference follows from its own fresh state), what the Session
    published while the group's blocks ran, and, once the window has
    closed, its raw blocks cut from the capture (``raw``)."""
    index: int
    first_block: int
    size: int
    state: dict | None = None
    raw: list = field(default_factory=list)
    per_block: dict = field(default_factory=dict)   # topic -> [values]
    counters: dict | None = None
    frames: list = field(default_factory=list)
    blocks_seen: int = 0

    @property
    def complete(self) -> bool:
        return self.blocks_seen == self.size and self.counters is not None


@dataclass
class Drain:
    """A telemetry drain: the block it followed, when it published its
    counters, and each frame's publish time and (tab, ok, payload)."""
    block: int
    t_counters: float
    t_frames: list = field(default_factory=list)
    frames: list = field(default_factory=list)


class Recorder:
    """The benchmark's listener on the Session's bus."""

    SAMPLED_TOPICS = ("fft-psd", "waterfall-line", "fft-peak")

    def __init__(self, session, telemetry_stage, sync_every: int,
                 start_groups: int, n_window_groups: int,
                 rng: np.random.Generator,
                 trace_stop_block: int | None = None, prof=None):
        self.session, self.stage = session, telemetry_stage
        self.sync_every = sync_every
        self.block = -1
        self.block_start: list[float] = []
        self.ticks: list[float] = []
        self.drains: list[Drain] = []
        self.groups: dict[int, Group] = {}
        self.start_groups = start_groups
        self.k, self.rng = n_window_groups, rng
        self.window_first_group: int | None = None
        self.seen = 0
        self.trace_stop_block, self.prof = trace_stop_block, prof
        self.annotate = prof is not None

    def _mark(self, what: str):
        if self.annotate:
            with torch.profiler.record_function(f"pb.{what}.{self.block}"):
                pass

    def window_opens(self, first_block: int):
        self.window_first_group = -(-first_block // self.sync_every)

    def _sample(self, g: int) -> bool:
        """The first ``start_groups`` groups always (the start, which the
        reference follows from its own state); of the window's later
        groups a reservoir of ``k`` drawn from the seed (a group is kept or
        dropped as it starts; one more is kept in case the last is cut
        off)."""
        if g < self.start_groups:
            return True
        if self.window_first_group is None or g < self.window_first_group:
            return False
        self.seen += 1
        keep = self.k + 1
        window = [i for i in self.groups if i >= self.start_groups]
        if len(window) < keep:
            return True
        if self.rng.random() < keep / self.seen:
            del self.groups[window[int(self.rng.integers(len(window)))]]
            return True
        return False

    def __call__(self, topic: str, value):
        now = time.perf_counter()
        if topic == "raw-block":
            self.block += 1
            self.block_start.append(now)
            self._mark("start")
            g, off = divmod(self.block, self.sync_every)
            if off == 0 and self._sample(g):
                self.groups[g] = Group(g, self.block, self.sync_every,
                                       state=None if g < self.start_groups
                                       else snapshot(self.stage.state))
            if g in self.groups:
                self.groups[g].blocks_seen += 1
        elif topic == "audio-frame":
            self.ticks.append(now)
            self._mark("tick")
            if (self.prof is not None
                    and self.block == self.trace_stop_block):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.prof.stop()
                self.prof = None
                self.annotate = False
                self.session.timers.annotate = False
        elif topic == "telemetry-counters":
            self._mark("drain")
            self.drains.append(Drain(self.block, now))
            grp = self.groups.get(self.block // self.sync_every)
            if grp is not None and (self.block + 1) % self.sync_every == 0:
                grp.counters = value
        elif topic == "telemetry-frame":
            d = self.drains[-1]
            d.t_frames.append(now)
            payload = value["payload"].tobytes()
            d.frames.append((value["demod"], value["ok"], payload))
            grp = self.groups.get(self.block // self.sync_every)
            if grp is not None and grp.counters is not None:
                grp.frames.append((value["demod"], value["ok"],
                                   value["corr"], value["channel_errors"],
                                   payload))
        elif topic in self.SAMPLED_TOPICS:
            grp = self.groups.get(self.block // self.sync_every)
            if grp is not None:
                grp.per_block.setdefault(topic, []).append(
                    (self.block, value))


def snapshot(state) -> dict:
    """The telemetry stage's carried state (the port's ``BpskState``) as
    the reference's state dict, copied on the device: the check follows
    the program from it (``reference.demod.STATE_KEYS``)."""
    t = state.timing
    return {"tu_phase": state.tu_phase.clone(),
            "ds_tail_re": state.ds_tail.re.clone(),
            "ds_tail_im": state.ds_tail.im.clone(),
            "vco_idx": state.vco_idx.clone(),
            "mf_tail_re": state.mf_tail.re.clone(),
            "mf_tail_im": state.mf_tail.im.clone(),
            "e_ema": t.e_ema.clone(), "peak": t.peak.clone(),
            "new_peak": t.new_peak.clone(), "e_out": t.e_out.clone(),
            "last_iq": t.last_iq.clone(), "ring": state.ring.clone(),
            "counters": state.counters.clone()}


def tunings(config: dict) -> np.ndarray:
    tb = config["tabs"]
    return (tb["first_hz"]
            + tb["step_hz"] * (np.arange(tb["count"]) % tb["grid"]))


def build_stages(config: dict, device):
    """The configuration's stages, by class name, on ``device``."""
    from jsdr_tpu_torch.demod.bpsk import BpskConfig
    from jsdr_tpu_torch.runtime import executor

    stages = []
    for spec in config["stages"]:
        cls = getattr(executor, spec["class"])
        kw = dict(spec.get("args", {}))
        if "bpsk" in spec:
            kw["cfg"] = BpskConfig(rate=config["rate"], **spec["bpsk"])
            kw["tunings"] = tunings(config)
            kw["device"] = device
        else:
            kw.setdefault("rate", config["rate"])
        stages.append(cls(**kw))
    return stages


@dataclass
class RunRecord:
    """What the metric readers read (``metrics/<name>.py``)."""
    cell: Cell
    block_samples: int
    warm_blocks: int
    n_blocks: int
    t_window: float
    t_end: float
    handin: list
    block_start: list
    ticks: list
    spans: list
    drains: list
    chunk_samples: int
    trace: object = None             # trace.Summary, with --trace 1
    untraced_from: int = 0           # first window block after the trace

    def window_blocks(self, start: int | None = None) -> range:
        return range(self.warm_blocks if start is None else start,
                     self.n_blocks)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, *, control: bool = False,
        max_blocks: int | None = None, fault=None) -> dict:
    """One run; returns the result line's object (without ``device``)."""
    from jsdr_tpu_torch.runtime.executor import Session

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    rate = cfg["rate"]
    key = str(rate)
    cap = make_capture(rate, tr["carriers_hz"][key], tr["amplitude"][key],
                       tr["noise_rms"][key], tr["frame_periods"], seed, dev)
    chunks = cap.chunks(cfg["chunk_samples"])
    per_block = cfg["block_samples"] // cfg["chunk_samples"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    stages = build_stages(cfg, dev)
    if fault is not None:
        fault(stages)
    tele = [s for s in stages if hasattr(s, "_drain")]
    telemetry = tele[0] if tele else None
    sync_every = telemetry.sync_every if telemetry else 1
    timers = SpanTimers()
    prof = None
    if trace:
        prof = trace_mod.profiler()
        timers.annotate = True
    session = Session(source=iter(()), block_samples=cfg["block_samples"],
                      device=dev, timers=timers)
    rng = np.random.default_rng([seed, 1])
    trace_blocks = cfg["trace_blocks"]
    recorder = Recorder(session, telemetry, sync_every,
                        cfg["check_start_groups"], cfg["check_groups"], rng,
                        WARM_BLOCKS + trace_blocks + 2 if trace else None,
                        prof)
    source = LoopSource(chunks, per_block, WARM_BLOCKS, seconds, max_blocks,
                        on_window=lambda: recorder.window_opens(WARM_BLOCKS))
    session.source = iter(source)
    session.pubsub.listen(recorder)
    if prof is not None:
        prof.start()
    n_blocks = session.run(stages)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    if recorder.prof is not None:          # the window ended first
        recorder.prof.stop()
    dropped = sum(session.dropped_blocks.values())
    memory = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
              else 0)
    tabs = list(telemetry.tunings or [telemetry.cfg.tuning]) if telemetry \
        else []
    record = RunRecord(
        cell=cell, block_samples=cfg["block_samples"],
        warm_blocks=WARM_BLOCKS, n_blocks=n_blocks,
        t_window=source.t_window, t_end=t_end, handin=source.handin,
        block_start=recorder.block_start, ticks=recorder.ticks,
        spans=timers.spans, drains=recorder.drains,
        chunk_samples=cfg["chunk_samples"],
        untraced_from=(WARM_BLOCKS + trace_blocks + 3 if trace
                       else WARM_BLOCKS))
    if trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            record.trace = trace_mod.summarise(
                path, WARM_BLOCKS, WARM_BLOCKS + trace_blocks - 1)
    # the program's state is freed before the reference runs
    stage_specs = [(type(s).__name__, s) for s in stages]
    specs = [(name, _stage_params(s, cfg)) for name, s in stage_specs]
    del stages, telemetry, tele, session, stage_specs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    groups = sorted((g for g in recorder.groups.values() if g.complete),
                    key=lambda g: g.index)
    start = [g for g in groups if g.index < cfg["check_start_groups"]]
    sampled = [g for g in groups if g.index >= cfg["check_start_groups"]]
    rng.shuffle(sampled)
    sampled = sampled[:cfg["check_groups"]]
    for g in start + sampled:
        g.raw = [block_raw(chunks, per_block, g.first_block + i)
                 for i in range(g.size)]
    t_ref = time.perf_counter()
    numbers = check(specs, start, sampled, dev, control)
    if tabs:
        numbers.append(("frames_missed", frames_missed(
            recorder.drains, cap, tabs, cfg["block_samples"], WARM_BLOCKS)))
    numbers.append(("groups_checked", len(start) + len(sampled)))
    ref_s = time.perf_counter() - t_ref
    limits = dict(cell.limits, groups_checked=2)
    verdicts = [(name, value, limits[name],
                 value >= limits[name] if name == "groups_checked"
                 else value <= limits[name]) for name, value in numbers]
    metrics = (end_to_end(record, setup_s=source.t_window - t_start)
               if not trace else per_layer(record))
    correct = all(v[3] for v in verdicts) and not dropped
    return {
        "correct": bool(correct),
        "attempted": int(n_blocks - WARM_BLOCKS),
        "failed": int(dropped),
        "metrics": metrics,
        "memory_peak_bytes": int(memory),
        "trace": record.trace,
        "check": [(name, value, limit) for name, value, limit, _ in verdicts],
        "check_seconds": ref_s,
        "window_s": t_end - source.t_window,
        "blocks": n_blocks,
        "per_second": per_second_rate(record),
    }


def _stage_params(stage, cfg: dict) -> dict:
    """What a stage's check needs to know of it."""
    out = {"rate": cfg["rate"], "block_samples": cfg["block_samples"]}
    for key in ("waterfall_width", "fft_n", "window", "sync_every"):
        if hasattr(stage, key):
            out[key] = getattr(stage, key)
    if hasattr(stage, "cfg"):
        out["tunings"] = list(stage.tunings or [stage.cfg.tuning])
        out["max_hits"] = stage.cfg.max_hits_per_block
    return out


def block_raw(chunks, per_block: int, block: int) -> np.ndarray:
    """Block ``block`` of the looped capture, as the source handed it in:
    ``per_block`` chunks, flat interleaved int16."""
    n = len(chunks)
    return np.concatenate([chunks[(block * per_block + i) % n]
                           for i in range(per_block)])


def check(specs, start, sampled, dev, control: bool) -> list:
    """Every stage's numbers over the checked groups, the start's and the
    sampled ones (the program's outputs, or with ``control`` the bfloat16
    reference's, against the float64 reference)."""
    numbers: dict[str, float] = {}
    for name, params in specs:
        mod = stage_check(name)
        for key, value in mod.numbers(params, start, sampled, dev,
                                      control).items():
            numbers[key] = max(numbers.get(key, 0.0), value)
    return [(k, v) for k, v in numbers.items()]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def end_to_end(rec: RunRecord, setup_s: float) -> dict:
    """The cell's end-to-end metrics over the window (host clock)."""
    wall = rec.t_end - rec.t_window
    values = {"stream_msps": len(rec.window_blocks()) * rec.block_samples
              / wall / 1e6, "setup_s": setup_s}
    return {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
            for m in rec.cell.end_to_end}


def p95(values) -> float | None:
    """The 95th percentile, or None where there is nothing to read."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), 95))


def block_latencies(rec: RunRecord, first: int) -> list[float]:
    """For every block from ``first`` on: from the hand-in of its last
    chunk to its 'audio-frame' tick, ms."""
    per_block = rec.block_samples // rec.chunk_samples
    return [(rec.ticks[b] - rec.handin[(b + 1) * per_block - 1]) * 1e3
            for b in rec.window_blocks(first)]


def per_second_rate(rec: RunRecord) -> list[float]:
    """MS/s in each whole second of the window (blocks by their tick): how
    the rate moved within the run."""
    ticks = np.asarray(rec.ticks[rec.warm_blocks:]) - rec.t_window
    if not len(ticks):
        return []
    counts = np.bincount(ticks.astype(int))
    return [float(c) * rec.block_samples / 1e6
            for c in counts[:int(ticks[-1])]]


def per_layer(rec: RunRecord) -> dict:
    out = {}
    for m in rec.cell.per_layer:
        value = metric_reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_json(res: dict) -> str:
    return json.dumps(res, separators=(", ", ": "))
