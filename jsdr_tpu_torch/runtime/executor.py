"""Streaming executor — the framework's main loop; the port of
:mod:`jsdr_tpu.runtime.executor` (the analog of the reference's capture
thread + handler fan-out, JavaAudio.java:195-329).

Composes: source -> block framing -> upload and conversion -> device
pipeline (spectrum and/or telemetry stages) -> taps (pub/sub
observability) -> sinks, with per-stage timers and optional periodic
state checkpointing. All carried DSP state lives in explicit trees of
tensors on the session's device, so a session can be stopped and resumed
exactly, and its checkpoints load in either package
(:mod:`jsdr_tpu_torch.runtime.state`).

Overlap: the host frames and uploads block N+1 while the card still runs
block N. Kernels and torch ops only enqueue on the current CUDA stream,
raw blocks are framed into pinned memory and go up without a synchronise
(:mod:`jsdr_tpu_torch.io.convert_device`), and the telemetry stages read
device values back only every ``sync_every`` blocks. So the stage timers
time the host's enqueue of each stage, not the device's work, as the
reference's timers did under JAX's asynchronous dispatch. A stage that
publishes host arrays every block (``SpectrumStage``) synchronises there,
as the reference's does.

Tracing (``Session.tracer``, a :class:`~jsdr_tpu_torch.runtime.log.
StageTimers`): each block's top-level spans are ``session.frame`` (waiting
for the source's chunks and the framer until the block is whole), ``h2d``,
one span a stage and ``publish:audio-frame``; inside them every
``publish:<topic>`` (the listeners' time), ``spectrum.readback``,
``telemetry.step`` (``spectrum_telemetry.step`` in a
``SpectrumTelemetryStage``), ``telemetry.drain`` and, inside a drain,
``drain.readback`` (every host wait on the card) and ``drain.fec``. The
counters are ``session.blocks``, ``session.retries``,
``session.framer_bytes`` (the bytes the framer copied while each block
was framed), ``session.h2d_pinned`` (a raw block framed into pinned
memory, uploaded from there and converted by the card's kernel),
``drain.runs`` (drains with blocks pending), ``drain.hits``
(windows decoded), ``drain.good``, ``drain.failed``, ``drain.waits``
(the drain's host waits on the card: one, and one more where it
decoded), one of
``telemetry.graph_replays``, ``telemetry.graph_captures`` and
``telemetry.graph_eager`` for each step of a ``TelemetryStage`` or a
``SpectrumTelemetryStage`` (a replayed CUDA graph, a new one, or eager
launches) and ``telemetry.front.<mode>`` (the front end it ran: general,
pattern, static, dofft or mixed_<manual mode>), for each
``SpectrumTelemetryStage`` step, one of
``spectrum_telemetry.merged`` (the merged kernel ran) and
``spectrum_telemetry.staged`` (the staged pair), and one of
``spectrum.graph_replays``, ``spectrum.graph_captures`` and
``spectrum.graph_eager`` for each block of a ``SpectrumStage`` in its
waterfall form.
Spans after the last block (the source's end, the final flush) carry
block n, the number of blocks.

The stages: ``SpectrumStage``, ``TelemetryStage`` (on one device, or
sharded over a device mesh, :mod:`jsdr_tpu_torch.parallel`),
``SpectrumTelemetryStage``, ``DemodStage`` (AM/NFM/WFM audio, published
as host arrays every block), ``AudioSinkStage`` and ``RecorderStage``
(the interactive shell, :mod:`jsdr_tpu_torch.app.tui`, swaps them live).
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..ops.cplx import CF
from ..runtime.device import require_device
from .graph import GraphStep
from .log import Logger, StageTimers, set_latest
from .pubsub import PubSub
from .state import load_state, save_state


def _same_device(a: torch.device, b: torch.device) -> bool:
    def key(d):
        d = torch.device(d)
        idx = d.index
        if d.type == "cuda" and idx is None:
            idx = torch.cuda.current_device()
        return d.type, idx
    return key(a) == key(b)


_NO_STAGE = nullcontext()


def _no_stage(name: str, samples: int = 0):
    return _NO_STAGE


@dataclass
class Session:
    """One streaming processing session.

    Sources may yield either complex64 chunks (host-converted) or
    interleaved int16 chunks (raw mode): raw chunks are published
    verbatim on the 'raw-block' topic BEFORE conversion (the IRawHandler
    fan-out, JavaAudio.java:261-265), uploaded as int16 (half the bytes
    of a float pair) and converted on the device
    (:func:`jsdr_tpu_torch.io.convert_device.s16_to_cf`), with ``i_corr``
    / ``q_corr`` applied there (JavaAudio.java:275-293 semantics). On a
    card they are framed straight into pinned host memory, go up in one
    asynchronous copy and are converted by one kernel.

    ``device`` (default ``"cuda"``, through
    :func:`~jsdr_tpu_torch.runtime.device.require_device`) is where blocks
    go; every stage that carries state must hold it on the same device
    (the stages take the same ``device`` argument).

    ``tracer`` is the Session's :class:`~jsdr_tpu_torch.runtime.log.
    StageTimers`: ``timers`` when that is one (a ``StageTimers(spans=
    True)`` records spans), else a new one. Another ``timers`` object
    (anything with ``stage(name, samples)``) gets exactly the stage calls:
    "h2d", then each stage's name, once a block; spans, counters and
    publishes go to the tracer alone. A ``run`` that starts while torch's
    profiler records keeps the tracer's spans on to its end.
    """

    source: Iterator[np.ndarray]          # complex64 or int16 chunks
    block_samples: int
    pubsub: PubSub = field(default_factory=PubSub)
    logger: Logger = field(default_factory=Logger)
    timers: Any = None
    checkpoint_path: Optional[Path] = None
    checkpoint_every_blocks: int = 0
    checkpoint_meta: dict = field(default_factory=dict)  # stamped + checked
    dropped_blocks: dict = field(default_factory=dict)  # stage name -> count
    i_corr: int = 0                      # DC corrections for raw-mode
    q_corr: int = 0                      # device conversion
    channels: int = 2
    device: Any = "cuda"

    def __post_init__(self):
        self.device = require_device(self.device)
        if self.timers is None:
            self.timers = StageTimers()
        self.tracer = (self.timers if isinstance(self.timers, StageTimers)
                       else StageTimers())

    def publish(self, topic: str, value):
        """Publish on the bus, the listeners' time in a span."""
        with self.tracer.span(f"publish:{topic}"):
            self.pubsub.publish(topic, value)

    def _blocks(self):
        """(block, raw) for every whole block of the source: int16 chunks
        are framed into tensors
        (:class:`~jsdr_tpu_torch.io.convert_device.TensorRawFramer`,
        pinned host memory on a card), and ``raw`` is the tensor that
        ``block`` views; complex chunks give ``raw`` None."""
        from ..io.convert_device import TensorRawFramer
        from ..io.framer import BlockFramer

        framer = None
        copied = 0
        for chunk in self.source:
            if framer is None:
                raw = np.asarray(chunk).dtype == np.int16
                framer = (TensorRawFramer(self.block_samples, self.channels,
                                          self.device) if raw
                          else BlockFramer(self.block_samples))
            for block in framer.push(chunk):
                self.tracer.count("session.framer_bytes",
                                  framer.copied_bytes - copied)
                copied = framer.copied_bytes
                yield block, framer.tensor if raw else None

    def run(self, stages: list["Stage"], max_blocks: Optional[int] = None):
        """Drive blocks through the stages until the source ends."""
        for stage in stages:
            dev = getattr(stage, "device", None)
            if dev is not None and not _same_device(dev, self.device):
                raise ValueError(
                    f"stage {stage.name} holds its state on {dev}, the "
                    f"session runs on {self.device}")
        tr = self.tracer
        set_latest(tr)
        spans_on = tr.spans_on
        tr.spans_on = spans_on or torch.autograd._profiler_enabled()
        try:
            return self._run(stages, max_blocks)
        finally:
            tr.spans_on = spans_on

    def _run(self, stages, max_blocks):
        from ..io.convert_device import s16_to_cf, upload_cf

        tr = self.tracer
        # a caller's own timers get the stage calls; the tracer's stage
        # spans run inside them
        outer = (_no_stage if self.timers is tr else self.timers.stage)
        blocks = self._blocks()
        n = 0
        while True:
            tr.begin_block(n)
            with tr.span("session.frame"):
                block, raw = next(blocks, (None, None))
            if block is None:
                break
            with (outer("h2d", samples=self.block_samples),
                  tr.stage("h2d", samples=self.block_samples)):
                if raw is not None:
                    # raw fan-out precedes conversion — recorder taps
                    # see the exact capture bytes (recorder.java:66-74)
                    self.publish("raw-block", block)
                    up = raw.to(self.device, non_blocking=True)
                    dev = s16_to_cf(up, self.i_corr, self.q_corr,
                                    channels=self.channels)
                    if up.is_cuda:
                        tr.count("session.h2d_pinned")
                else:
                    dev = upload_cf(block, self.device)
            for stage in stages:
                with (outer(stage.name, samples=len(block)),
                      tr.stage(stage.name, samples=len(block))):
                    # snapshot carried state so a retry re-runs the block
                    # against the SAME state the failed attempt saw (the
                    # first attempt may have advanced state before dying
                    # in e.g. a publish callback)
                    state0 = stage.state
                    try:
                        stage.process(dev, self)
                    except Exception as e:  # noqa: BLE001
                        # transient device faults: retry once, then
                        # skip the block for this stage and keep
                        # streaming
                        tr.count("session.retries")
                        self.logger.alert(
                            f"stage {stage.name} failed: {e!r:.120}; retrying")
                        stage.state = state0
                        try:
                            stage.process(dev, self)
                        except Exception as e2:  # noqa: BLE001
                            stage.state = state0
                            self.dropped_blocks[stage.name] = (
                                self.dropped_blocks.get(stage.name, 0) + 1)
                            self.logger.alert(
                                f"stage {stage.name} failed twice; "
                                f"dropping block {n} "
                                f"(total dropped: "
                                f"{self.dropped_blocks[stage.name]}): "
                                f"{e2!r:.120}")
                            self.publish(
                                "dropped-block",
                                {"stage": stage.name, "block": n,
                                 "total": self.dropped_blocks[stage.name]})
            self.publish("audio-frame", n)
            n += 1
            tr.count("session.blocks")
            if (self.checkpoint_path and self.checkpoint_every_blocks
                    and n % self.checkpoint_every_blocks == 0):
                self.save_checkpoint(stages)
            if max_blocks is not None and n >= max_blocks:
                tr.begin_block(n)
                break
        self._finish(stages)
        return n

    def _finish(self, stages: list["Stage"]):
        """Flush stages that defer device readbacks (e.g. telemetry
        batches counter/frame syncs every N blocks)."""
        for stage in stages:
            try:
                stage.finish(self)
            except Exception as e:  # noqa: BLE001
                self.logger.alert(f"stage {stage.name} finish: {e!r:.120}")

    def save_checkpoint(self, stages: list["Stage"]):
        state = {s.name: s.state for s in stages if s.state is not None}
        if state and self.checkpoint_path:
            save_state(self.checkpoint_path, state, meta=self.checkpoint_meta)
            self.logger.log(f"checkpoint -> {self.checkpoint_path}")

    def load_checkpoint(self, stages: list["Stage"]):
        if self.checkpoint_path and Path(self.checkpoint_path).exists():
            like = {s.name: s.state for s in stages if s.state is not None}
            loaded = load_state(self.checkpoint_path, like,
                                expect_meta=self.checkpoint_meta)
            for s in stages:
                if s.state is not None and s.name in loaded:
                    s.state = loaded[s.name]
            self.logger.status(f"resumed from {self.checkpoint_path}")


class Stage:
    """A pipeline stage with carried device state (subclass or wrap)."""

    name = "stage"
    state: Any = None

    def process(self, block, session: Session):
        raise NotImplementedError

    def finish(self, session: Session):
        """Flush deferred work at stream end (optional)."""


class SpectrumStage(Stage):
    """fft.java analog: PSD per sub-block, published as 'fft-psd'.

    Without ``waterfall_width`` each sub-block goes through
    ``ops.spectrum.spectrum_block`` and its last peak is published as
    'fft-peak'. With ``waterfall_width`` set (it must divide fft_n), the
    windowed sub-blocks go through ``ops.mxu_fft.fft_cf`` and the fused
    PSD + waterfall kernel (:func:`jsdr_tpu_torch.ops.psd_waterfall.
    psd_waterfall`), which also emits ready-to-render 8-bit lines
    ('waterfall-line'). The stage has no state; it runs on its blocks'
    device.

    The waterfall form runs :func:`waterfall_step` through a
    :class:`~jsdr_tpu_torch.runtime.graph.GraphStep` of one slot: on a
    card (its first block's device) blocks replay a captured CUDA graph.
    Each block's lines and dB come back in one copy to the host, in the
    ``spectrum.readback`` span, and are published as views into that
    block's own host array; each block counts ``spectrum.graph_replays``,
    ``spectrum.graph_captures`` or ``spectrum.graph_eager`` on the
    Session's tracer."""

    name = "spectrum"

    def __init__(self, rate: int, fft_n: Optional[int] = None,
                 window: bool = True, waterfall_width: Optional[int] = None):
        self.rate = rate
        self.fft_n = fft_n or rate // 10
        self.window = window
        self.waterfall_width = waterfall_width
        self._step = None       # the waterfall form's, made at its first block

    def process(self, block, session: Session):
        if self.waterfall_width:
            self._waterfall(block, session)
            return
        from ..ops.spectrum import spectrum_block
        n = (block.shape[-1] // self.fft_n) * self.fft_n
        blocks = CF(block.re[:n].reshape(-1, self.fft_n),
                    block.im[:n].reshape(-1, self.fft_n))
        res = spectrum_block(blocks, rate=float(self.rate),
                             window=self.window)
        with session.tracer.span("spectrum.readback"):
            psd = res.psd.cpu().numpy()
            peak = (int(res.peak_freq[-1]), float(res.peak_db[-1]))
        session.publish("fft-psd", psd)
        session.publish("fft-peak", peak)

    def _waterfall(self, block, session: Session):
        if self._step is None:
            # the stage reads each block's buffer back before the next
            self._step = GraphStep(
                1, graphable=block.re.device.type == "cuda")
        packed, _ = self._step(waterfall_step, block, None, slot=0,
                               fft_n=self.fft_n, width=self.waterfall_width,
                               window=self.window)
        session.tracer.count(SPECTRUM_STEP_COUNTERS[self._step.last])
        with session.tracer.span("spectrum.readback"):
            # a fresh host array a block: the graph's buffer is reused
            host = packed.to("cpu", copy=True).numpy()
        rows, width = block.shape[-1] // self.fft_n, self.waterfall_width
        nb = rows * self.fft_n * 4
        session.publish("waterfall-line", host[nb:].reshape(rows, width))
        session.publish("fft-psd",
                        host[:nb].view(np.float32).reshape(rows, self.fft_n))


def waterfall_step(iq: CF, states=None, *, fft_n: int, width: int,
                   window: bool):
    """``SpectrumStage``'s device work on a [T] block in its waterfall
    form, a step of no state for :class:`~jsdr_tpu_torch.runtime.graph.
    GraphStep`: the block's whole ``fft_n`` sub-blocks, times the Hamming
    window (a device table) if ``window``, through ``fft_cf`` and kernel 5
    (:func:`~jsdr_tpu_torch.ops.psd_waterfall.psd_waterfall`). Returns one
    uint8 buffer, the dB rows' float32 bytes then the lines, and the state
    ``None``."""
    from ..ops.mxu_fft import fft_cf
    from ..ops.psd_waterfall import psd_waterfall
    from ..ops.windows import hamming_on
    n = (iq.shape[-1] // fft_n) * fft_n
    blocks = CF(iq.re[:n].reshape(-1, fft_n), iq.im[:n].reshape(-1, fft_n))
    if window:
        w = hamming_on(fft_n, blocks.re.device)
        blocks = CF(blocks.re * w, blocks.im * w)
    db, lines = psd_waterfall(fft_cf(blocks), width=width)
    return torch.cat([db.view(torch.uint8).reshape(-1),
                      lines.reshape(-1)]), None


# what a telemetry stage's step did, counted once a block
STEP_COUNTERS = {"replay": "telemetry.graph_replays",
                 "capture": "telemetry.graph_captures",
                 "eager": "telemetry.graph_eager"}
# what SpectrumStage's waterfall step did, counted once a block
SPECTRUM_STEP_COUNTERS = {"replay": "spectrum.graph_replays",
                          "capture": "spectrum.graph_captures",
                          "eager": "spectrum.graph_eager"}


class TelemetryStage(Stage):
    """FUNcubeBPSKDemod + FECDecoder analog; publishes decoded frames.

    ``tunings``: optional list of per-instance NCO Hz — N demod tabs on
    the same stream in one batched call (jsdr.java:479-484), in any
    tuning mode (``demod.bpsk.mix_mode_for``). ``dofft`` / ``track_high``:
    optional per-instance bool lists (the FUNcube<n>-bpsk-dofft / -upper
    keys, FUNcubeBPSKDemod.java:97-99), default ``cfg.dofft`` /
    ``cfg.track_high``; a mixed set still runs as ONE batched call.

    ``sync_every``: device results are read back (counters published,
    frames decoded) only every N blocks — a per-block readback is a
    host<->device sync that serialises dispatch and defeats the overlap of
    host conversion with device work. Frames arrive at worst N blocks
    late (they are ~4.33 s apart); a final ``finish()`` flush drains the
    tail. A drain decodes every sync hit of its blocks in ONE batched
    ``fec_decode`` call and publishes the frames in the reference's order
    (block, instance, hit).

    ``mesh``: an optional ("dp", "sp") :class:`~jsdr_tpu_torch.parallel.
    mesh.Mesh` of one process — the production integration point of the
    multi-device path (the analog of the reference shell wiring its N
    demod tabs into the running system, jsdr.java:475-502). With a mesh,
    every block runs through :func:`~jsdr_tpu_torch.parallel.sharded.
    sharded_telemetry_step` (dp shards the demod instances, sp the time
    axis with halo exchange); results and chained state equal the
    single-device batched call's (module docstring of ``parallel.
    sharded``). The instance list is padded up to a multiple of dp
    (replicating the last instance; padding is dropped from published
    results), and the session's ``block_samples`` must come from
    :meth:`block_samples_for`. As in the reference, the mesh path takes
    the lists as given: without ``tunings`` and padding every instance
    runs at the sharded step's 12000 Hz, and without ``dofft`` /
    ``track_high`` none auto-tunes (``jsdr_tpu/runtime/executor.py:301``,
    ROADMAP.md queue 3).

    ``device`` (default ``"cuda"``) holds the state — with a mesh, the
    mesh's device; the session must run on it.

    Without a mesh the step runs through a :class:`~jsdr_tpu_torch.
    runtime.graph.GraphStep`: on a card, without ``compat_scan``, blocks
    replay captured CUDA graphs, a pending block's outputs in its own
    graph's memory; ``state`` is then one of the step's two static sets,
    valid until the block after the next one. Each block counts
    ``telemetry.graph_replays``, ``telemetry.graph_captures`` or
    ``telemetry.graph_eager`` on the Session's tracer, and
    ``telemetry.front.<mode>``, the front end its step ran (the mode
    ``demod.bpsk.mix_mode_for`` names, ':' written '_'), decided once a
    tuning set.
    """

    name = "telemetry"

    def __init__(self, cfg, tunings=None, dofft=None, track_high=None,
                 sync_every: int = 4, mesh=None, max_hits: int = 4,
                 device: Any = "cuda"):
        from ..demod.bpsk import bpsk_init_batch
        self.cfg = cfg
        self.tunings = (None if tunings is None
                        else [float(t) for t in tunings])
        self.n = 1 if tunings is None else len(self.tunings)
        self.n_real = self.n            # instances the user asked for
        self.dofft = None if dofft is None else [bool(v) for v in dofft]
        self.track_high = (None if track_high is None
                           else [bool(v) for v in track_high])
        self.sync_every = max(1, int(sync_every))
        self.device = require_device(device)
        self.mesh = mesh
        self._pending = []              # un-synced device block outputs
        self._n_blocks = 0
        self._decided = (None, ())      # _step_counters' (key, names)
        if mesh is None:
            # a pending block's outputs each in a graph of their own
            self._step = GraphStep(
                self.sync_every, graphable=(self.device.type == "cuda"
                                            and not cfg.compat_scan))
            self.state = bpsk_init_batch(cfg, self.n, self.device)
            return
        from ..parallel.sharded import sharded_telemetry_step
        if not _same_device(mesh.device, self.device):
            raise ValueError(f"the mesh's shards are on {mesh.device}, the "
                             f"stage's device is {self.device}")
        if mesh.spans_processes():
            raise ValueError("TelemetryStage takes a mesh of one process: "
                             "its Session feeds every instance the whole "
                             "block")
        dp = mesh.shape["dp"]
        pad = (-self.n) % dp
        if pad:                          # dp wants S % dp == 0
            self.tunings = ((self.tunings or [cfg.tuning])
                            + [self.tunings[-1] if self.tunings
                               else cfg.tuning] * pad)
            if self.dofft is not None:
                self.dofft = self.dofft + [self.dofft[-1]] * pad
            if self.track_high is not None:
                self.track_high = self.track_high + [self.track_high[-1]] * pad
            self.n += pad
        self._sharded = sharded_telemetry_step(mesh, rate=cfg.rate,
                                               max_hits=max_hits)
        self.state = bpsk_init_batch(cfg, self.n, self.device)

    @staticmethod
    def block_samples_for(cfg, mesh=None, dofft=None,
                          target_seconds: float = 1.0) -> int:
        """Session block size valid for this stage's execution path."""
        if mesh is None:
            return int(cfg.rate * target_seconds)
        from ..parallel.sharded import valid_block_samples
        any_dofft = bool(np.any(dofft)) if dofft is not None else False
        return valid_block_samples(cfg.rate, mesh.shape["sp"], any_dofft,
                                   target_seconds)

    def process(self, block, session: Session):
        from ..demod.bpsk import bpsk_block_batch
        self._run_step(session, "telemetry.step", bpsk_block_batch, block,
                       dofft=self.dofft, track_high=self.track_high)

    def _step_counters(self, t_len: int) -> tuple:
        """The counters of a step over ``t_len`` samples besides the
        graph step's, decided once a tuning set and block length
        (:meth:`_decide_counters`)."""
        key = (tuple(self.tunings or ()), tuple(self.dofft or ()), t_len)
        if key != self._decided[0]:
            self._decided = (key, self._decide_counters(t_len))
        return self._decided[1]

    def _decide_counters(self, t_len: int) -> tuple:
        """``telemetry.front.<mode>``: the front end the step runs, the
        mode :func:`~jsdr_tpu_torch.demod.bpsk.front_mode` names with ':'
        written '_'. On a mesh the sharded step mixes every manual stream
        by exact numerators: "general" in place of "pattern"."""
        from ..demod.bpsk import front_mode
        mode = front_mode(tuple(self.tunings or [self.cfg.tuning] * self.n),
                          self.cfg.rate,
                          tuple(self.dofft or [self.cfg.dofft] * self.n))
        if self.mesh is not None:
            mode = mode.replace("pattern", "general")
        return ("telemetry.front." + mode.replace(":", "_"),)

    def _run_step(self, session: Session, span: str, fn, block, **kw):
        """The step ``fn`` on the block's rows (one an instance) in the
        tracer's ``span``, through the graph step (on a mesh, the sharded
        step, eager, in its place): keeps the new state, counts what the
        step did (:meth:`_step_counters` too) and queues its outputs."""
        rows = _broadcast(block, self.n)
        with session.tracer.span(span):
            if self.mesh is None:
                *out, self.state = self._step(
                    fn, rows, self.state, slot=len(self._pending),
                    cfg=self.cfg, tunings=self.tunings, **kw)
                ran = self._step.last
            else:
                *out, self.state = self._sharded(rows, self.state,
                                                 self.tunings, **kw)
                ran = "eager"
        session.tracer.count(STEP_COUNTERS[ran])
        for name in self._step_counters(block.shape[-1]):
            session.tracer.count(name)
        self._queue(out, session)

    def _queue(self, out, session: Session):
        """Keep a block's telemetry outputs (the last of the step's
        ``out``); drain every ``sync_every`` blocks."""
        self._pending.append(out[-1])
        self._n_blocks += 1
        if self._n_blocks % self.sync_every == 0:
            self.finish(session)

    def finish(self, session: Session):
        with session.tracer.span("telemetry.drain"):
            self._drain(session)

    def _drain(self, session: Session):
        """Publish what the pending blocks found, with at most two host
        waits on the card (:func:`_wait`). One copy reads back, into host
        memory of this drain's own, every pending block's ``n_hits`` and
        ``hit_corr``, the counters and what :meth:`_shown` adds; the
        (block, instance, hit) list comes from ``n_hits`` on the host.
        Only where it holds a hit, one ``index_select`` takes those
        windows from the stacked pending windows, :func:`~jsdr_tpu_torch.
        fec.decoder.fec_decode` decodes them alone, and a second copy
        reads back ``ok``, ``rc`` and ``payload``: the card decodes while
        the first copy's topics are published."""
        pending, self._pending = self._pending, []
        shown = self._shown()
        if not pending:
            return
        tr = session.tracer
        tr.count("drain.runs")
        n_p, n_s = len(pending), len(shown)
        parts = [self.state.counters, *shown,
                 *(o.n_hits for o in pending), *(o.hit_corr for o in pending)]
        dev = self.state.counters.device
        host = _to_host(_pack(parts))
        _wait(dev, tr)
        counters, *got = _unpack(host, parts)
        n_hits = np.stack(got[n_s:n_s + n_p])           # [P, S]
        hit_corr = np.stack(got[n_s + n_p:])             # [P, S, max_hits]
        # every hit of every pending block, in (block, instance, hit)
        # order; mesh padding instances publish nothing
        _, n, max_hits = hit_corr.shape
        flat = np.flatnonzero((np.arange(max_hits) < n_hits[..., None])
                              & (np.arange(n) < self.n_real)[:, None])
        tr.count("drain.hits", len(flat))
        if len(flat):
            decoded = self._decode(pending, flat, tr)
        self._publish_shown(session, *got[:n_s])
        tunings = self.tunings or [self.cfg.tuning]
        # live raw/ds/bit/sync counters, the reference's on-screen
        # instrumentation (FUNcubeBPSKDemod.java:219-228)
        session.publish(
            "telemetry-counters",
            {s: tuple(int(v) for v in counters[s])
             for s in range(self.n_real)})
        for s in range(self.n_real):
            session.publish(f"FUNcube{s}-bpsk-tune", tunings[s])
        if not len(flat):
            return
        _wait(dev, tr)
        rc, payload, ok = _unpack(*decoded)
        payload = payload.copy()          # the frames' own, the block freed
        good = int(ok.sum())
        tr.count("drain.good", good)
        tr.count("drain.failed", len(ok) - good)
        corr = hit_corr.reshape(-1)[flat]
        for j, s in enumerate(flat // max_hits % n):
            session.publish("telemetry-frame", {
                "demod": int(s),
                "tuning": tunings[s],
                "ok": bool(ok[j]),
                "corr": int(corr[j]),
                "channel_errors": int(rc[j]),
                "payload": payload[j],
            })

    @staticmethod
    def _decode(pending: list, flat: np.ndarray, tr) -> tuple:
        """Enqueue the decode of the pending blocks' windows at the flat
        (block, instance, hit) indices ``flat`` and the copy of its
        ``rc``, ``payload`` and ``ok`` to the host, without a wait:
        (host tensor, parts) for :func:`_unpack`."""
        from ..fec.decoder import fec_decode
        windows = torch.stack([o.windows for o in pending]).flatten(0, 2)
        idx = torch.empty(len(flat), dtype=torch.int64,
                          pin_memory=windows.is_cuda)
        idx.numpy()[:] = flat
        hit = windows.index_select(0, idx.to(windows.device,
                                              non_blocking=True))
        with tr.span("drain.fec"):
            res = fec_decode(hit)
        parts = [res.rc, res.payload, res.ok]
        return _to_host(_pack(parts)), parts

    def _shown(self) -> list:
        """Device tensors a drain reads back with the pending blocks'
        hits and publishes first (:meth:`_publish_shown`); none here."""
        return []

    def _publish_shown(self, session: Session, *arrays) -> None:
        """Publish :meth:`_shown`'s tensors, read back as numpy views of
        the drain's host block (copy what a listener may keep)."""


def _pack(parts: list) -> torch.Tensor:
    """Tensors of one device as one flat uint8 tensor, each part's bytes
    in turn (one launch on a card): what one host copy reads back."""
    return torch.cat([p.reshape(-1).view(torch.uint8) for p in parts])


_NUMPY = {torch.bool: np.bool_, torch.uint8: np.uint8,
          torch.int32: np.int32, torch.int64: np.int64,
          torch.float32: np.float32}


def _unpack(host: torch.Tensor, parts: list) -> list:
    """:func:`_pack`'s bytes, copied to ``host``, as one numpy view a
    part with the part's dtype and shape (4-byte parts first keeps each
    view aligned)."""
    buf, out, at = host.numpy(), [], 0
    for p in parts:
        n = p.numel() * p.element_size()
        out.append(buf[at:at + n].view(_NUMPY[p.dtype]).reshape(p.shape))
        at += n
    return out


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied, without a wait, into a new block of torch's caching
    host allocator: pinned on a card, plain host memory on the CPU. A
    card's copy records an event on the block, so the allocator hands it
    out again only once the copy is done and no reference to it is
    left."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    return host.copy_(t, non_blocking=True)


def _wait(device: torch.device, tr: StageTimers) -> None:
    """The drain's one kind of host wait on the card: until everything
    enqueued on ``device``'s current stream has run (an event's
    synchronise; on the CPU every copy has run already). Timed in
    ``drain.readback``, counted in ``drain.waits``."""
    with tr.span("drain.readback"):
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            done.synchronize()
    tr.count("drain.waits")


class SpectrumTelemetryStage(TelemetryStage):
    """Spectrum + telemetry in ONE device step
    (:func:`jsdr_tpu_torch.demod.bpsk.bpsk_block_batch_spectrum`: the
    merged kernel reads the input once where the device's rule allows,
    else the staged pair runs): the fft.java + FUNcubeBPSKDemod.java pair
    of every reference block, as a single production stage. Publishes
    'waterfall-line' (dB-decimated natural-order lines of instance 0) and
    'fft-peak' at each drain, alongside the telemetry topics. Auto-tune
    follows ``cfg.dofft`` / ``cfg.track_high`` (the staged branch), as the
    reference's stage does. The step is its ``GraphStep`` with
    :func:`~jsdr_tpu_torch.demod.bpsk.bpsk_block_batch_spectrum` as its
    body: on a card, without ``compat_scan``, blocks replay captured CUDA
    graphs on either branch, a pending block's outputs and waterfall in
    its own graph's memory, which the drain reads before that graph runs
    again. Its span is ``spectrum_telemetry.step``, and each block counts
    ``telemetry.graph_replays``, ``telemetry.graph_captures`` or
    ``telemetry.graph_eager`` (what the step did), the front end's
    ``telemetry.front.<mode>``, and ``spectrum_telemetry.merged`` or
    ``spectrum_telemetry.staged`` (as :func:`~jsdr_tpu_torch.demod.bpsk.
    spectrum_step_merged` rules on the stage's device), with
    ``spectrum_telemetry.merged_card`` beside ``.merged`` where only the
    card's rule admits the block length, decided once a tuning set and
    block length."""

    name = "spectrum-telemetry"

    def __init__(self, cfg, tunings=None, window: bool = True,
                 sync_every: int = 4, mesh=None, device: Any = "cuda"):
        if mesh is not None:
            raise ValueError(
                "SpectrumTelemetryStage runs the single-device merged "
                "kernel; for a device mesh use TelemetryStage(mesh=...) "
                "plus a SpectrumStage (the staged pair)")
        super().__init__(cfg, tunings, sync_every=sync_every, device=device)
        self.window = window
        self._spec = None

    def process(self, block, session: Session):
        from ..demod.bpsk import bpsk_block_batch_spectrum
        self._run_step(session, "spectrum_telemetry.step",
                       bpsk_block_batch_spectrum, block, window=self.window)

    def _decide_counters(self, t_len: int) -> tuple:
        """The front end's counter, and ``spectrum_telemetry.merged`` or
        ``spectrum_telemetry.staged`` as :func:`~jsdr_tpu_torch.demod.
        bpsk.spectrum_step_merged` rules on the stage's device (the merged
        kernel's front end is the pattern mode's); beside ``.merged``,
        ``spectrum_telemetry.merged_card`` where only the card's rule
        admits the block length (the reference's rule would stage it)."""
        from ..demod.bpsk import spectrum_step_merged
        tun = self.tunings or [self.cfg.tuning] * self.n
        merged = spectrum_step_merged(self.cfg, t_len, tun, self.device)
        card_only = merged and not spectrum_step_merged(self.cfg, t_len, tun)
        return (*super()._decide_counters(t_len),
                "spectrum_telemetry.merged" if merged
                else "spectrum_telemetry.staged",
                *(("spectrum_telemetry.merged_card",) if card_only else ()))

    def _queue(self, out, session: Session):
        self._spec = out[0]          # the waterfall the next drain shows
        super()._queue(out, session)

    def _shown(self) -> list:
        """Stream 0's natural-order waterfall lines and last peak, Hz and
        dB, of the latest block (instances share the input stream)."""
        from ..ops.spectrum_fused import waterfall_natural_order
        spec, self._spec = self._spec, None
        if spec is None:
            return []
        return [waterfall_natural_order(spec.wf)[0], spec.peak_freq[0, -1],
                spec.peak_db[0, -1]]

    def _publish_shown(self, session: Session, *arrays) -> None:
        if arrays:
            lines, freq, db = arrays
            session.publish("waterfall-line", lines.copy())
            session.publish("fft-peak", (int(freq), float(db)))


def _broadcast(block: CF, n: int) -> CF:
    """[T] block -> [n, T] rows (one per demodulator instance)."""
    return CF(block.re.expand(n, -1), block.im.expand(n, -1))


class DemodStage(Stage):
    """demod.java analog: AM/NFM/WFM demodulation of each block
    (:func:`jsdr_tpu_torch.demod.am_fm.demod_block`); publishes the float
    audio as a host array on 'audio-out'. ``state`` is an
    :class:`~jsdr_tpu_torch.demod.am_fm.AmFmState` on ``device`` (default
    ``"cuda"``), so checkpoints hold the reference's leaves."""

    name = "demod"

    def __init__(self, cfg, device: Any = "cuda"):
        from ..demod.am_fm import AmFmState
        self.cfg = cfg
        self.device = require_device(device)
        self.state = AmFmState.init(cfg, self.device)

    def process(self, block, session: Session):
        from ..demod.am_fm import demod_block
        audio, _, _, self.state = demod_block(block, self.cfg, self.state)
        session.publish("audio-out", audio.cpu().numpy())


class AudioSinkStage(Stage):
    """Real-time audio output stage: subscribes to the demod stage's
    'audio-out' blocks and feeds them to a live sink (demod.java:489-506
    analog — the writer thread lives in :class:`~jsdr_tpu_torch.io.live.
    AudioSink`).

    Place it AFTER the DemodStage in the stage list; it consumes the
    block published during this executor iteration.
    """

    name = "audio-sink"

    def __init__(self, sink):
        self.sink = sink                 # an io.live.AudioSink
        self._last = None

    def process(self, block, session: Session):
        audio = session.pubsub.get("audio-out")
        # identity check: if the demod stage dropped this block, don't
        # replay the previous block's audio
        if audio is not None and audio is not self._last:
            self.sink.write(audio)
            self._last = audio

    def close(self):
        self.sink.close()


class RecorderStage(Stage):
    """recorder.java analog: append capture data to a raw S16LE file
    while enabled; produces replayable fixtures.

    In a raw-mode session (int16 source) the stage taps the
    'raw-block' topic — the PRE-conversion values, so the recorded file
    is byte-identical to the capture even with audio-ic/qc corrections
    set (recorder.java is an IRawHandler fed before the short->float
    convert, JavaAudio.java:261-265). In a complex-source session it
    re-encodes the converted block (a lossy round trip when corrections
    are nonzero)."""

    name = "recorder"

    def __init__(self, path, enabled: bool = True):
        from ..io.recorder import RawRecorder
        self.rec = RawRecorder(path).open()
        self.enabled = enabled
        self._last_raw = None

    def process(self, block, session: Session):
        if not self.enabled:
            return
        raw = session.pubsub.get("raw-block")
        if raw is not None and raw is not self._last_raw:
            self.rec.write_raw(np.asarray(raw).astype("<i2").tobytes())
            self._last_raw = raw
        elif raw is None:
            iq = (block.re.cpu().numpy() + 1j * block.im.cpu().numpy()
                  ).astype(np.complex64)
            self.rec.write_iq(iq)

    def close(self):
        self.rec.close()
