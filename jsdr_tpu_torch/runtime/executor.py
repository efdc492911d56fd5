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
uploads go through pinned memory without a synchronise
(:mod:`jsdr_tpu_torch.io.convert_device`), and the telemetry stages read
device values back only every ``sync_every`` blocks. So ``StageTimers``
time the host's enqueue of each stage, not the device's work, as the
reference's timers did under JAX's asynchronous dispatch. A stage that
publishes host arrays every block (``SpectrumStage``) synchronises there,
as the reference's does.

The stages: ``SpectrumStage``, ``TelemetryStage``,
``SpectrumTelemetryStage``, ``DemodStage`` (AM/NFM/WFM audio, published
as host arrays every block), ``AudioSinkStage`` and ``RecorderStage``
(the interactive shell, :mod:`jsdr_tpu_torch.app.tui`, swaps them live).
The one part not ported yet is ``parallel/`` (ROADMAP.md, queue 1): the
device mesh of ``TelemetryStage(mesh=...)`` raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..ops.cplx import CF
from ..runtime.device import require_device
from .log import Logger, StageTimers
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


@dataclass
class Session:
    """One streaming processing session.

    Sources may yield either complex64 chunks (host-converted) or
    interleaved int16 chunks (raw mode): raw chunks are published
    verbatim on the 'raw-block' topic BEFORE conversion (the IRawHandler
    fan-out, JavaAudio.java:261-265), uploaded as int16 (half the bytes
    of a float pair) and converted on the device
    (:func:`jsdr_tpu_torch.io.convert_device.s16_to_cf`), with ``i_corr``
    / ``q_corr`` applied there (JavaAudio.java:275-293 semantics).

    ``device`` (default ``"cuda"``, through
    :func:`~jsdr_tpu_torch.runtime.device.require_device`) is where blocks
    go; every stage that carries state must hold it on the same device
    (the stages take the same ``device`` argument).
    """

    source: Iterator[np.ndarray]          # complex64 or int16 chunks
    block_samples: int
    pubsub: PubSub = field(default_factory=PubSub)
    logger: Logger = field(default_factory=Logger)
    timers: StageTimers = field(default_factory=StageTimers)
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

    def run(self, stages: list["Stage"], max_blocks: Optional[int] = None):
        """Drive blocks through the stages until the source ends."""
        from ..io.convert_device import s16_to_cf, upload_cf, upload_raw
        from ..io.framer import BlockFramer, RawBlockFramer

        for stage in stages:
            dev = getattr(stage, "device", None)
            if dev is not None and not _same_device(dev, self.device):
                raise ValueError(
                    f"stage {stage.name} holds its state on {dev}, the "
                    f"session runs on {self.device}")
        framer = None
        n = 0
        for chunk in self.source:
            if framer is None:
                raw = np.asarray(chunk).dtype == np.int16
                framer = (RawBlockFramer(self.block_samples, self.channels)
                          if raw else BlockFramer(self.block_samples))
            for block in framer.push(chunk):
                with self.timers.stage("h2d", samples=self.block_samples):
                    if raw:
                        # raw fan-out precedes conversion — recorder taps
                        # see the exact capture bytes (recorder.java:66-74)
                        self.pubsub.publish("raw-block", block)
                        dev = s16_to_cf(upload_raw(block, self.device),
                                        self.i_corr, self.q_corr,
                                        channels=self.channels)
                    else:
                        dev = upload_cf(block, self.device)
                for stage in stages:
                    with self.timers.stage(stage.name, samples=len(block)):
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
                                self.pubsub.publish(
                                    "dropped-block",
                                    {"stage": stage.name, "block": n,
                                     "total": self.dropped_blocks[stage.name]})
                self.pubsub.publish("audio-frame", n)
                n += 1
                if (self.checkpoint_path and self.checkpoint_every_blocks
                        and n % self.checkpoint_every_blocks == 0):
                    self.save_checkpoint(stages)
                if max_blocks is not None and n >= max_blocks:
                    self._finish(stages)
                    return n
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
    device."""

    name = "spectrum"

    def __init__(self, rate: int, fft_n: Optional[int] = None,
                 window: bool = True, waterfall_width: Optional[int] = None):
        self.rate = rate
        self.fft_n = fft_n or rate // 10
        self.window = window
        self.waterfall_width = waterfall_width

    def process(self, block, session: Session):
        from ..ops.spectrum import spectrum_block
        n = (block.shape[-1] // self.fft_n) * self.fft_n
        blocks = CF(block.re[:n].reshape(-1, self.fft_n),
                    block.im[:n].reshape(-1, self.fft_n))
        if self.waterfall_width:
            from ..ops.mxu_fft import fft_cf
            from ..ops.psd_waterfall import psd_waterfall
            from ..ops.windows import hamming
            if self.window:
                w = hamming(self.fft_n, device=blocks.re.device)
                blocks = CF(blocks.re * w, blocks.im * w)
            db, lines = psd_waterfall(fft_cf(blocks),
                                      width=self.waterfall_width)
            session.pubsub.publish("waterfall-line", lines.cpu().numpy())
            session.pubsub.publish("fft-psd", db.cpu().numpy())
        else:
            res = spectrum_block(blocks, rate=float(self.rate),
                                 window=self.window)
            session.pubsub.publish("fft-psd", res.psd.cpu().numpy())
            session.pubsub.publish(
                "fft-peak",
                (int(res.peak_freq[-1]), float(res.peak_db[-1])))


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

    ``mesh`` is not ported yet: a mesh raises NotImplementedError.
    ``device`` (default ``"cuda"``) holds the state; the session must run
    on it.
    """

    name = "telemetry"

    def __init__(self, cfg, tunings=None, dofft=None, track_high=None,
                 sync_every: int = 4, mesh=None, max_hits: int = 4,
                 device: Any = "cuda"):
        from ..demod.bpsk import bpsk_init_batch
        if mesh is not None:
            raise NotImplementedError(
                "TelemetryStage(mesh=...) needs parallel/, which is not "
                "ported to jsdr_tpu_torch yet (ROADMAP.md, queue 1)")
        self.cfg = cfg
        self.tunings = (None if tunings is None
                        else [float(t) for t in tunings])
        self.n = 1 if tunings is None else len(self.tunings)
        self.dofft = None if dofft is None else [bool(v) for v in dofft]
        self.track_high = (None if track_high is None
                           else [bool(v) for v in track_high])
        self.sync_every = max(1, int(sync_every))
        self.device = require_device(device)
        self._pending = []              # un-synced device block outputs
        self._n_blocks = 0
        self.state = bpsk_init_batch(cfg, self.n, self.device)

    @staticmethod
    def block_samples_for(cfg, mesh=None, dofft=None,
                          target_seconds: float = 1.0) -> int:
        """Session block size valid for this stage's execution path."""
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh needs parallel/, which is not ported to "
                "jsdr_tpu_torch yet (ROADMAP.md, queue 1)")
        return int(cfg.rate * target_seconds)

    def process(self, block, session: Session):
        from ..demod.bpsk import bpsk_block_batch
        out, self.state = bpsk_block_batch(
            _broadcast(block, self.n), self.cfg, self.state, self.tunings,
            dofft=self.dofft, track_high=self.track_high)
        self._pending.append(out)
        self._n_blocks += 1
        if self._n_blocks % self.sync_every == 0:
            self._drain(session)

    def finish(self, session: Session):
        self._drain(session)

    def _drain(self, session: Session):
        from ..fec.decoder import fec_decode
        pending, self._pending = self._pending, []
        if not pending:
            return
        tunings = self.tunings or [self.cfg.tuning]
        # live raw/ds/bit/sync counters, the reference's on-screen
        # instrumentation (FUNcubeBPSKDemod.java:219-228)
        c = self.state.counters.cpu().numpy()
        session.pubsub.publish(
            "telemetry-counters",
            {s: tuple(int(v) for v in c[s]) for s in range(self.n)})
        for s in range(self.n):
            session.pubsub.publish(f"FUNcube{s}-bpsk-tune", tunings[s])
        # every hit of every pending block, in (block, instance, hit) order
        where, windows, corrs = [], [], []
        for out in pending:
            hit = (torch.arange(out.windows.shape[1],
                                device=out.n_hits.device)[None, :]
                   < out.n_hits[:, None])
            windows.append(out.windows[hit])
            corrs.append(out.hit_corr[hit])
            where.append(torch.nonzero(hit)[:, 0])
        windows = torch.cat(windows)
        if not len(windows):
            return
        res = fec_decode(windows)
        demod = torch.cat(where).cpu().numpy()
        corr = torch.cat(corrs).cpu().numpy()
        ok, rc = res.ok.cpu().numpy(), res.rc.cpu().numpy()
        payload = res.payload.cpu().numpy()
        for j, s in enumerate(demod):
            session.pubsub.publish("telemetry-frame", {
                "demod": int(s),
                "tuning": tunings[s],
                "ok": bool(ok[j]),
                "corr": int(corr[j]),
                "channel_errors": int(rc[j]),
                "payload": payload[j],
            })


class SpectrumTelemetryStage(TelemetryStage):
    """Spectrum + telemetry in ONE device step
    (:func:`jsdr_tpu_torch.demod.bpsk.bpsk_block_batch_spectrum`: the
    merged kernel reads the input once where the reference's rule allows,
    else the staged pair runs): the fft.java + FUNcubeBPSKDemod.java pair
    of every reference block, as a single production stage. Publishes
    'waterfall-line' (dB-decimated natural-order lines of instance 0) and
    'fft-peak' at each drain, alongside the telemetry topics. Auto-tune
    follows ``cfg.dofft`` / ``cfg.track_high`` (the staged branch), as the
    reference's stage does."""

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
        spec, out, self.state = bpsk_block_batch_spectrum(
            _broadcast(block, self.n), self.cfg, self.state, self.tunings,
            window=self.window)
        self._pending.append(out)
        self._spec = spec
        self._n_blocks += 1
        if self._n_blocks % self.sync_every == 0:
            self._drain(session)

    def _drain(self, session: Session):
        from ..ops.spectrum_fused import waterfall_natural_order
        spec, self._spec = self._spec, None
        if spec is not None:
            # stream 0's lines/peak (instances share the input stream)
            lines = waterfall_natural_order(spec.wf)[0].cpu().numpy()
            session.pubsub.publish("waterfall-line", lines)
            session.pubsub.publish(
                "fft-peak", (int(spec.peak_freq[0, -1]),
                             float(spec.peak_db[0, -1])))
        super()._drain(session)


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
        session.pubsub.publish("audio-out", audio.cpu().numpy())


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
