"""jsdr-tpu-torch CLI — the port's command-line entry point, the
counterpart of ``jsdr-tpu`` (:mod:`jsdr_tpu.app.main`), headless.

Subcommands mirror the reference's tabs:

- ``spectrum``: the dBFS PSD and peak of every 0.1 s block (the fused
  spectrum kernel where the block size fits it), with the same
  print-out, ASCII plot and PNG renderings (fft.java + waterfall.java);
- ``demod``: AM/NFM/WFM to a raw S16LE stereo audio file in 1 s blocks,
  or, from a live source or with ``--pace``, 0.1 s blocks through the
  port's :class:`~jsdr_tpu_torch.runtime.executor.Session` into a
  real-time audio sink (``--audio-out``, ``--loop``, ``--blocks``,
  ``--device-convert``; demod.java);
- ``telemetry``: FUNcube BPSK demodulation in 1 s blocks, N demodulator
  instances (a comma list of tunings, in any tuning mode; ``--fft-tune``
  auto-tunes with the FFT tuner, ``--track-high`` searches its upper
  half-band) batched into one call per block, AO-40 FEC decode of every
  sync hit, and the same frame and counter print-out; a live source
  (``pipe:-``, ``pipe:<path>``, ``capture:<cmd>``, ``fcd``) or ``--pace``
  runs the Session, and ``--checkpoint``/``--resume`` save and load the
  stream state in the reference's format on either path
  (FUNcubeBPSKDemod.java + FECDecoder.java);
- ``synth``: test fixtures (sine, ``--real`` tone, noise, telemetry);
- ``record``: re-write a source as raw S16LE IQ or FLAC (recorder.java);
- ``phase``: constellation + I/Q trace scope (phase.java);
- ``fir``: FIR design/testbench (the standalone fir.java console tool);
- ``fcd``: FUNcube Dongle control/self-test (FCD.java main());
- ``ui``: the interactive curses shell (tabs over a live waterfall, the
  reference's hotkey map, live re-tuning and stage swaps;
  :mod:`jsdr_tpu_torch.app.tui`), ``--no-pace`` replays files at full
  speed.

``--device`` picks where ``spectrum``, ``demod``, ``telemetry``, ``fir``
and ``ui`` run: ``cuda`` (the default) launches the port's CUDA kernels
and torch ops on the card, ``cpu`` runs their plain PyTorch versions; the
other subcommands touch no tensor.

Config: ``--config jsdr.properties`` loads a java-properties-style file
using the REFERENCE's key schema (audio-rate, audio-ic/qc, fft-hamming,
demod-*, FUNcube<n>-bpsk-*, jsdr-funcube-demods — jsdr.java:49-57,
JavaAudio.java:18-23, demod.java:32-37, FUNcubeBPSKDemod.java:97-99);
explicit CLI flags override it, like the reference's key=val overrides
(jsdr.java:256-265). ``--mesh`` (``telemetry``, ``ui``) raises
NotImplementedError until ``parallel/`` is ported (ROADMAP.md).
"""

from __future__ import annotations

import argparse

import numpy as np


def _apply_config(args):
    """Fold a reference-schema properties file into the parsed args."""
    if not getattr(args, "config", None):
        return args
    from ..runtime.config import Config
    c = Config(args.config)
    if args.rate == 96000:
        args.rate = c.get_int("audio-rate", args.rate)
    if args.icorr == 0:
        args.icorr = c.get_int("audio-ic", 0)
    if args.qcorr == 0:
        args.qcorr = c.get_int("audio-qc", 0)
    if getattr(args, "cmd", "") == "spectrum" and not args.no_window:
        args.no_window = c.get_int("fft-hamming", 1) == 0
    if getattr(args, "cmd", "") == "demod":
        modes = {0: "off", 1: "raw", 2: "am", 3: "nfm", 4: "wfm"}
        if args.mode == "nfm":
            args.mode = modes.get(c.get_int("demod-mode", 3), "nfm")
        if args.flo is None and c.get_int("demod-fir-enable", 0):
            args.flo = c.get_int("demod-filter-low", -3000)
            args.fhi = c.get_int("demod-filter-high", 3000)
        if not args.agc:
            args.agc = c.get_int("demod-agc-enable", 0) != 0
    if getattr(args, "cmd", "") == "telemetry" and args.tuning == "12000":
        n = c.get_int("jsdr-funcube-demods", 1)
        tunings = [c.get_int(f"FUNcube{i}-bpsk-tuning", 12000)
                   for i in range(n)]
        args.tuning = ",".join(str(t) for t in tunings)
        # per-instance dofft/upper (FUNcube<n>-bpsk-*, jsdr.java:479-484):
        # a mixed set still runs as ONE batched call
        if not args.fft_tune:
            args.fft_tune_list = [
                c.get_int(f"FUNcube{i}-bpsk-dofft", 0) != 0 for i in range(n)]
        if not args.track_high:
            args.track_high_list = [
                c.get_int(f"FUNcube{i}-bpsk-upper", 0) != 0 for i in range(n)]
    return args


def _telem_flags(args, n: int):
    """Per-instance (dofft, track_high) lists for N demod instances."""
    dofft = getattr(args, "fft_tune_list", None) or [args.fft_tune] * n
    th = getattr(args, "track_high_list", None) or [args.track_high] * n
    assert len(dofft) == n and len(th) == n, (
        "per-instance dofft/upper lists must match the tuning count")
    return dofft, th


def _load_iq(args, rate):
    from ..io.sources import open_source, synth_noise, synth_sine
    name = args.source
    if name.startswith("file:"):
        src = open_source(name, rate=rate, channels=2,
                          i_corr=args.icorr, q_corr=args.qcorr)
        iq = src.all()
        want = args.seconds * src.rate
        if len(iq) < want:   # loop-at-EOF semantics (JavaAudio.java:252-256)
            iq = np.tile(iq, int(np.ceil(want / len(iq))))
        return iq[:want], src.rate
    if name.startswith("sine:"):
        f = float(name[5:])
        return synth_sine(rate * args.seconds, f, rate, analytic=False), rate
    if name.startswith("noise"):
        return synth_noise(rate * args.seconds), rate
    raise SystemExit(f"unknown source {name!r} (use file:<path>, sine:<hz>, noise)")


def cmd_spectrum(args) -> int:
    from ..display import Waterfall, render_psd_ascii, render_waterfall_png
    from ..ops.cplx import from_complex
    from ..ops.spectrum import spectrum_wide
    from ..runtime.device import require_device

    dev = require_device(args.device)
    iq, rate = _load_iq(args, args.rate)
    n = rate // 10
    nblocks = len(iq) // n
    res = spectrum_wide(from_complex(iq[None, :nblocks * n], dev), n,
                        rate=float(rate), window=not args.no_window)
    psd = res.psd[0].cpu().numpy()
    peak_db = res.peak_db[0].cpu().numpy()
    peak_freq = res.peak_freq[0].cpu().numpy()
    print(f"{nblocks} blocks of {n} samples at {rate} S/s")
    for b in range(min(nblocks, args.show)):
        print(f"block {b}: peak {float(peak_db[b]):.1f} dBFS @ "
              f"{int(peak_freq[b])} Hz")
    if args.ascii:
        print(render_psd_ascii(psd[0]))
    if args.png:
        wf = Waterfall(width=1024, height=max(nblocks, 16))
        wf.push_many(psd)
        render_waterfall_png(args.png, wf.buf)
        print(f"waterfall -> {args.png}")
    if args.psd_png:
        from ..display import render_spectrum_png
        band = None
        if args.overlay_filter:
            band = tuple(int(v) for v in args.overlay_filter.split(":"))
        tunings = ([int(v) for v in args.overlay_tuning.split(",")]
                   if args.overlay_tuning else ())
        render_spectrum_png(args.psd_png, psd[0], rate,
                            filter_band=band, tunings=tunings)
        print(f"spectrum -> {args.psd_png}")
    return 0


def _demod_cfg(args, rate):
    from ..demod.am_fm import AmFmConfig, Mode
    mode = {"off": Mode.OFF, "raw": Mode.RAW, "am": Mode.AM,
            "nfm": Mode.NFM, "wfm": Mode.WFM}[args.mode]
    return AmFmConfig(rate=rate, mode=int(mode), dofir=args.flo is not None,
                      dodwn=args.downshift, doagc=args.agc,
                      flo=args.flo, fhi=args.fhi)


def _is_live(name: str) -> bool:
    return name.startswith(("pipe:", "capture:")) or name in ("-", "fcd")


def _live_spec(name: str, rate: int) -> str:
    """Resolve 'fcd' to the dongle's capture device (FCD.java:235-259)."""
    if name == "fcd":
        from ..io.fcd import FCD
        spec = FCD().capture_source(rate)
        if spec is None:
            raise SystemExit("no FUNcube Dongle capture device found")
        return spec
    return name


def cmd_demod_stream(args) -> int:
    """Streaming demod: live pipe/capture ingest (or real-time paced file
    replay) -> demod -> real-time audio sink. This is the application
    loop of the reference (JavaAudio capture thread -> demod tab ->
    SourceDataLine), on the port's Session executor."""
    from ..io.live import AudioSink, PacedSource, StreamSource
    from ..io.sources import FileSource
    from ..runtime.executor import AudioSinkStage, DemodStage, Session

    rate = args.rate
    dev_conv = args.device_convert
    if _is_live(args.source):
        src = StreamSource(_live_spec(args.source, rate), rate=rate,
                           i_corr=args.icorr, q_corr=args.qcorr,
                           raw=dev_conv)
        chunks = iter(src)
    else:
        fsrc = FileSource(args.source.removeprefix("file:"), rate=rate,
                          channels=2, i_corr=args.icorr, q_corr=args.qcorr,
                          loop=args.loop)
        rate = fsrc.rate
        blocks = (fsrc.raw_blocks(rate // 10) if dev_conv
                  else fsrc.blocks(rate // 10))
        chunks = PacedSource(blocks, rate)
    session = Session(source=chunks, block_samples=rate // 10,
                      i_corr=args.icorr, q_corr=args.qcorr,
                      device=args.device)
    stages = [DemodStage(_demod_cfg(args, rate), device=args.device)]
    sink = AudioSink(args.audio_out or args.out)
    stages.append(AudioSinkStage(sink))
    try:
        n = session.run(stages, max_blocks=args.blocks)
    finally:
        sink.close()
    rep = session.timers.report()
    d = rep.get("demod", {})
    print(f"{n} blocks ({n * 0.1:.1f}s) demodulated ({args.mode}) -> "
          f"{args.audio_out or args.out}; sink wrote {sink.blocks_written} "
          f"blocks, {sink.overruns} overruns, "
          f"{session.dropped_blocks or 'no'} dropped")
    if d:
        print(f"demod stage: "
              f"{d['samples'] / max(d['wall_s'], 1e-9) / 1e6:.1f} MS/s "
              f"({d['wall_s'] / max(d['calls'], 1):.4f} s/block)")
    return 0


def cmd_demod(args) -> int:
    """AM/NFM/WFM demodulation of a file or synthetic source in 1 s
    blocks (the remainder dropped) to S16LE stereo; a live source or
    ``--pace`` takes :func:`cmd_demod_stream`."""
    import torch

    from ..demod.am_fm import AmFmState, audio_to_s16_stereo, demod_block
    from ..io.convert_device import upload_cf
    from ..runtime.device import require_device

    if _is_live(args.source) or args.pace:
        return cmd_demod_stream(args)
    dev = require_device(args.device)
    iq, rate = _load_iq(args, args.rate)
    cfg = _demod_cfg(args, rate)
    state = AmFmState.init(cfg, dev)
    block = rate
    out = []
    n_blocks = len(iq) // block
    for b in range(n_blocks):
        audio, _, _, state = demod_block(
            upload_cf(iq[b * block:(b + 1) * block], dev), cfg, state)
        out.append(audio_to_s16_stereo(audio))
    data = (torch.cat(out).cpu().numpy() if out
            else np.zeros(0, np.int16))
    with open(args.out, "wb") as fh:
        fh.write(data.astype("<i2").tobytes())
    print(f"{n_blocks} blocks demodulated ({args.mode}) -> {args.out} "
          f"(S16LE stereo @ {rate})")
    return 0


def cmd_telemetry_stream(args) -> int:
    """Streaming telemetry: live pipe/capture ingest (or paced replay)
    -> N batched demod instances -> decoded frames printed as they
    arrive — the running application loop of the reference's FUNcube
    tabs, on the port's Session executor."""
    from pathlib import Path

    from ..demod.bpsk import BpskConfig
    from ..io.live import PacedSource, StreamSource
    from ..io.sources import FileSource
    from ..runtime.executor import Session, TelemetryStage

    rate = args.rate
    dev_conv = args.device_convert
    if _is_live(args.source):
        src = StreamSource(_live_spec(args.source, rate), rate=rate,
                           i_corr=args.icorr, q_corr=args.qcorr,
                           raw=dev_conv)
        chunks = iter(src)
    else:
        fsrc = FileSource(args.source.removeprefix("file:"), rate=rate,
                          channels=2, i_corr=args.icorr, q_corr=args.qcorr,
                          loop=args.loop)
        rate = fsrc.rate
        blocks = (fsrc.raw_blocks(rate // 10) if dev_conv
                  else fsrc.blocks(rate // 10))
        chunks = PacedSource(blocks, rate) if args.pace else blocks
    tunings = [float(t) for t in str(args.tuning).split(",")]
    dofft, track_high = _telem_flags(args, len(tunings))
    cfg = BpskConfig(rate=rate, tuning=tunings[0])
    frames = [0]

    def on_frame(topic, v):
        if topic != "telemetry-frame":
            return
        frames[0] += 1
        print(f"demod{v['demod']}@{v['tuning']:.0f}Hz "
              f"corr={v['corr']} ok={v['ok']} "
              f"channel_errors={v['channel_errors']}")
        payload = v["payload"]
        for off in range(0, 256, 16):
            row = " ".join(f"{b:02x}" for b in payload[off:off + 16])
            print(f"  {off:3d}: {row}")

    stage = TelemetryStage(cfg, tunings, dofft=dofft, track_high=track_high,
                           device=args.device)
    block_samples = TelemetryStage.block_samples_for(cfg, dofft=dofft)
    session = Session(source=chunks, block_samples=block_samples,
                      i_corr=args.icorr, q_corr=args.qcorr,
                      device=args.device)
    session.pubsub.listen(on_frame)
    if args.checkpoint:
        session.checkpoint_path = Path(args.checkpoint)
        session.checkpoint_meta = {"rate": int(rate),
                                   "n_demods": len(tunings),
                                   "mesh": None}
        if args.resume and session.checkpoint_path.exists():
            session.load_checkpoint([stage])
            print(f"resumed stream state from {args.checkpoint}")
    n = session.run([stage], max_blocks=args.blocks)
    if args.checkpoint:
        session.save_checkpoint([stage])
        print(f"stream state -> {args.checkpoint}")
    print(f"{n} blocks streamed, frames={frames[0]}, "
          f"dropped={session.dropped_blocks or 'none'}")
    return 0


def cmd_telemetry(args) -> int:
    from ..demod.bpsk import BpskConfig, bpsk_block_batch, bpsk_init_batch
    from ..fec.decoder import fec_decode
    from ..ops.cplx import from_complex
    from ..runtime.device import require_device

    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: the multi-device path (parallel/) is not "
            "ported to jsdr_tpu_torch yet (ROADMAP.md, queue 1); use "
            "jsdr-tpu for it")
    if _is_live(args.source) or args.pace:
        return cmd_telemetry_stream(args)
    dev = require_device(args.device)
    iq, rate = _load_iq(args, args.rate)
    tunings = np.asarray([float(t) for t in str(args.tuning).split(",")])
    n_demods = len(tunings)
    dofft, track_high = _telem_flags(args, n_demods)
    cfg = BpskConfig(rate=rate, tuning=float(tunings[0]))
    st = bpsk_init_batch(cfg, n_demods, dev)
    ck_meta = {"rate": int(rate), "n_demods": int(n_demods)}
    if args.resume and args.checkpoint:
        from pathlib import Path
        from ..runtime.state import load_state
        if Path(args.checkpoint).exists():
            st = load_state(args.checkpoint, st, expect_meta=ck_meta)
            print(f"resumed stream state from {args.checkpoint}")
    block = rate
    iq = np.concatenate([iq, np.zeros((-len(iq)) % block, np.complex64)])
    frames = 0
    for b in range(len(iq) // block):
        blk = from_complex(np.broadcast_to(iq[b * block:(b + 1) * block],
                                           (n_demods, block)), dev)
        out, st = bpsk_block_batch(blk, cfg, st, tunings, dofft=dofft,
                                   track_high=track_high)
        n_hits = out.n_hits.cpu().numpy()
        for s in range(n_demods):
            nh = int(n_hits[s])
            if not nh:
                continue
            tag = f"demod{s}@{tunings[s]:.0f}Hz " if n_demods > 1 else ""
            res = fec_decode(out.windows[s, :nh])
            ok = res.ok.cpu().numpy()
            rc = res.rc.cpu().numpy()
            payloads = res.payload.cpu().numpy()
            corr = out.hit_corr[s].cpu().numpy()
            for i in range(nh):
                if not ok[i]:
                    print(f"{tag}t={b}s sync corr={int(corr[i])}: "
                          "FEC decode failed")
                    continue
                frames += 1
                print(f"{tag}t={b}s corr={int(corr[i])} "
                      f"channel_errors={int(rc[i])}:")
                for off in range(0, 256, 16):
                    row = " ".join(f"{v:02x}"
                                   for v in payloads[i, off:off + 16])
                    print(f"  {off:3d}: {row}")
    if args.checkpoint:
        from ..runtime.state import save_state
        save_state(args.checkpoint, st, meta=ck_meta)
        print(f"stream state -> {args.checkpoint}")
    c = st.counters.cpu().numpy()
    for s in range(n_demods):
        print(f"demod{s} @ {tunings[s]:.0f} Hz counters: raw={c[s, 0]} "
              f"ds={c[s, 1]} bits={c[s, 2]} syncs={c[s, 3]}")
    print(f"frames={frames}")
    return 0


def cmd_synth(args) -> int:
    """Generate test fixtures (the fir.java testbench roles: noise, sine,
    NCO-mixed carriers, and full BPSK telemetry bursts)."""
    from ..io.sources import synth_bpsk_stream, synth_noise, synth_sine
    rate = args.rate
    if args.kind == "sine":
        iq = synth_sine(rate * args.seconds, args.freq, rate,
                        amplitude=args.amplitude, analytic=not args.real)
    elif args.kind == "noise":
        iq = synth_noise(rate * args.seconds, args.amplitude, args.seed)
    else:  # telemetry
        rng = np.random.default_rng(args.seed)
        n_frames = max(1, int(args.seconds / 4.4))
        payloads = rng.integers(0, 256, (n_frames, 256), dtype=np.uint8)
        iq = synth_bpsk_stream(payloads, rate=rate,
                               carrier_offset=args.freq,
                               amplitude=args.amplitude,
                               noise_rms=args.noise)
        np.save(args.out + ".payloads.npy", payloads)
        print(f"{n_frames} frame payloads -> {args.out}.payloads.npy")
    _write_iq_file(args.out, iq, rate)
    print(f"{len(iq)} samples ({len(iq)/rate:.2f}s) -> {args.out}")
    return 0


def _write_iq_file(path: str, iq: np.ndarray, rate: int) -> None:
    """Write complex IQ as raw S16LE, or FLAC when the name ends .flac."""
    from ..io.convert import complex_to_s16le
    data = complex_to_s16le(iq)
    if str(path).lower().endswith(".flac"):
        from ..io.flac import write_flac
        write_flac(path, np.frombuffer(data, "<i2").reshape(-1, 2), rate)
        return
    with open(path, "wb") as fh:
        fh.write(data)


def cmd_phase(args) -> int:
    """Phase-scope: constellation + I/Q traces (phase.java analog)."""
    from ..display import (phase_scope_data, render_phase_png,
                           render_trace_ascii)

    iq, rate = _load_iq(args, args.rate)
    block = rate // 10                     # one reference display block
    data = phase_scope_data(iq[:block], width=args.width)
    print(f"block of {block} samples at {rate} S/s; "
          f"autoscale max |I/Q| = {data.max_abs:.4f}")
    if args.ascii:
        print("I trace:")
        print(render_trace_ascii(data.i_trace))
        print("Q trace:")
        print(render_trace_ascii(data.q_trace))
    if args.png:
        render_phase_png(args.png, data.points, data.i_trace, data.q_trace)
        print(f"phase scope -> {args.png}")
    return 0


def cmd_fir(args) -> int:
    """FIR-design testbench — the fir.java console tool's roles, headless:
    design a windowed-sinc band-pass (fir.java:166-195), push a noise or
    sine source through it (fir.java:198-211, 230-238), optionally mix
    with a complex NCO (fir.java:214-228), and write/inspect the result.
    Band edges support the demod tab's move/widen steps
    (demod.java:305-317)."""
    import torch

    from ..io.convert import complex_to_s16le
    from ..ops.fir import bandpass_weights, fir_apply
    from ..ops.nco import mix_complex, phase_ramp
    from ..runtime.device import require_device

    dev = require_device(args.device)
    flo, fhi = float(args.flo), float(args.fhi)
    flo += args.move * 250.0
    fhi += args.move * 250.0
    flo -= args.widen * 250.0
    fhi += args.widen * 250.0
    taps = bandpass_weights(args.taps, flo, fhi, float(args.rate),
                            device=dev)
    if args.print_taps:
        print(f"{args.taps}-tap band-pass [{flo:.0f}, {fhi:.0f}] Hz "
              f"@ {args.rate} S/s:")
        for i, t in enumerate(taps.cpu().numpy()):
            print(f"  w[{i:2d}] = {t:+.8f}")
    iq, rate = _load_iq(args, args.rate)
    sig = torch.as_tensor(np.ascontiguousarray(iq, np.complex64),
                          device=dev)
    if args.mix is not None:
        phases, _ = phase_ramp(len(iq), torch.zeros((), device=dev),
                               2 * np.pi * args.mix / rate)
        sig = mix_complex(sig, phases)
    if not args.no_filter:
        sig = fir_apply(sig, taps)
    out_np = sig.cpu().numpy()
    rms = float(np.sqrt(np.mean(np.abs(out_np) ** 2)))
    print(f"{len(out_np)} samples out; rms={rms:.5f}")
    if args.out:
        with open(args.out, "wb") as fh:
            fh.write(complex_to_s16le(out_np))
        print(f"-> {args.out} (raw S16LE IQ)")
    return 0


def cmd_fcd(args) -> int:
    """FUNcube Dongle control / self-test (FCD.java:262-313 analog).
    Degrades to a clear 'no FCD' report when fcdctl/hardware is absent."""
    from ..io.fcd import FCD
    fcd = FCD(binary=args.fcdctl)
    if not fcd.available():
        print("no FCD detected (fcdctl missing or no dongle)")
        return 1
    st = fcd.status()
    print(f"FCD {st.version}, freq = "
          f"{st.freq_khz if st.freq_khz is not None else '?'} kHz, "
          f"default rate = {fcd.default_rate()} S/s")
    if args.action == "tune":
        ok = fcd.set_freq_khz(int(args.khz))
        print(f"tune {args.khz} kHz: {'ok' if ok else 'FAILED'}")
    elif args.action == "reset":
        print(f"reset: {'ok' if fcd.reset() else 'FAILED'}")
    elif args.action == "selftest":
        # the reference's main(): probe, tune 100 MHz then 107.5 MHz
        for khz in (100000, 107500):
            ok = fcd.set_freq_khz(khz)
            st = fcd.status(refresh=True)
            print(f"tune {khz} kHz: {'ok' if ok else 'FAILED'} "
                  f"(readback {st.freq_khz if st else '?'} kHz)")
    return 0


def cmd_ui(args) -> int:
    """Interactive terminal shell (jsdr.java Swing UI analog): tabs over
    a live waterfall, driven by the reference's accelerator map."""
    from .tui import run_tui
    return run_tui(args)


def cmd_record(args) -> int:
    from ..io.recorder import RawRecorder
    iq, rate = _load_iq(args, args.rate)
    if str(args.out).lower().endswith(".flac"):
        _write_iq_file(args.out, iq, rate)
    else:
        with RawRecorder(args.out) as rec:
            rec.write_iq(iq)
    print(f"{len(iq)} samples -> {args.out}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="jsdr-tpu-torch",
        description="jsdr-tpu's SDR framework on PyTorch/CUDA")
    p.add_argument("--rate", type=int, default=96000)
    p.add_argument("--seconds", type=int, default=5,
                   help="duration for synthetic sources")
    p.add_argument("--icorr", type=int, default=0, help="I DC correction")
    p.add_argument("--qcorr", type=int, default=0, help="Q DC correction")
    p.add_argument("--config", help="jsdr.properties-style config file "
                   "(reference key schema; CLI flags override)")
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = ("torch device: cuda runs the CUDA kernels, cpu their "
                   "plain PyTorch versions")

    sp = sub.add_parser("spectrum", help="FFT/PSD + waterfall")
    sp.add_argument("source", help="file:<path>, sine:<hz> or noise")
    sp.add_argument("--no-window", action="store_true",
                    help="skip the Hamming window (reference quirk parity)")
    sp.add_argument("--show", type=int, default=5)
    sp.add_argument("--ascii", action="store_true")
    sp.add_argument("--png")
    sp.add_argument("--psd-png",
                    help="spectrum display with reference overlays "
                    "(reticle, filter band, tuning bars; fft.java paint)")
    sp.add_argument("--overlay-filter", metavar="LO:HI",
                    help="demod filter band overlay in Hz "
                    "(fft.java:98-106)")
    sp.add_argument("--overlay-tuning", metavar="HZ[,HZ...]",
                    help="BPSK tuning bar overlays (fft.java:152-173)")
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.set_defaults(fn=cmd_spectrum)

    dm = sub.add_parser("demod", help="AM/FM audio demodulation")
    dm.add_argument("source", help="file:<path>, sine:<hz>, noise, or a "
                    "live source: pipe:-, pipe:<path>, capture:<cmd>, fcd")
    dm.add_argument("--mode", choices=["off", "raw", "am", "nfm", "wfm"],
                    default="nfm")
    dm.add_argument("--flo", type=int, default=None)
    dm.add_argument("--fhi", type=int, default=None)
    dm.add_argument("--downshift", action="store_true")
    dm.add_argument("--agc", action="store_true")
    dm.add_argument("--out", default="audio.raw")
    dm.add_argument("--audio-out", default=None,
                    help="live audio sink: 'cmd:aplay -f S16_LE -r 96000 "
                    "-c 2 -t raw', '-' (stdout), or a file/FIFO path "
                    "(demod.java:489-506 analog)")
    dm.add_argument("--pace", action="store_true",
                    help="replay a file source at real-time rate "
                    "(JavaAudio.java:231-233 pacing)")
    dm.add_argument("--loop", action="store_true",
                    help="loop the file source at EOF")
    dm.add_argument("--blocks", type=int, default=None,
                    help="stop streaming after N 0.1s blocks")
    dm.add_argument("--device-convert", action="store_true",
                    help="stream raw int16 and convert on the device "
                    "(half the upload bytes; JavaAudio.java:275-293 "
                    "semantics on-device)")
    dm.add_argument("--device", default="cuda", help=device_help)
    dm.set_defaults(fn=cmd_demod)

    tl = sub.add_parser("telemetry", help="FUNcube BPSK + AO-40 FEC")
    tl.add_argument("source", help="file:<path>, sine:<hz>, noise, or a "
                    "live source: pipe:-, pipe:<path>, capture:<cmd>, fcd")
    tl.add_argument("--tuning", default="12000",
                    help="NCO Hz; comma list runs N demod instances")
    tl.add_argument("--fft-tune", action="store_true",
                    help="FFT auto-tune (doBufferFFT)")
    tl.add_argument("--track-high", action="store_true",
                    help="auto-tune searches the upper half-band")
    tl.add_argument("--checkpoint", help="save stream state here")
    tl.add_argument("--resume", action="store_true",
                    help="resume stream state from --checkpoint")
    tl.add_argument("--pace", action="store_true",
                    help="replay a file source at real-time rate")
    tl.add_argument("--loop", action="store_true",
                    help="loop the file source at EOF (streaming path)")
    tl.add_argument("--blocks", type=int, default=None,
                    help="stop streaming after N 1s blocks")
    tl.add_argument("--device-convert", action="store_true",
                    help="stream raw int16 and convert on the device "
                    "(half the upload bytes; JavaAudio.java:275-293 "
                    "semantics on-device)")
    tl.add_argument("--mesh", metavar="DPxSP",
                    help="multi-device sharded step (not ported yet: "
                    "raises)")
    tl.add_argument("--device", default="cuda", help=device_help)
    tl.set_defaults(fn=cmd_telemetry)

    sy = sub.add_parser("synth", help="generate test fixtures")
    sy.add_argument("kind", choices=["sine", "noise", "telemetry"])
    sy.add_argument("--freq", type=float, default=12000.0,
                    help="sine freq / telemetry carrier offset")
    sy.add_argument("--amplitude", type=float, default=0.5)
    sy.add_argument("--noise", type=float, default=0.0)
    sy.add_argument("--real", action="store_true",
                    help="real tone in I with Q=0 (sine4410 style)")
    sy.add_argument("--seed", type=int, default=0)
    sy.add_argument("--out", default="synth.raw")
    sy.set_defaults(fn=cmd_synth)

    ph = sub.add_parser("phase",
                        help="phase scope: constellation + I/Q traces")
    ph.add_argument("source")
    ph.add_argument("--width", type=int, default=512)
    ph.add_argument("--ascii", action="store_true")
    ph.add_argument("--png")
    ph.set_defaults(fn=cmd_phase)

    fr = sub.add_parser("fir", help="FIR design/testbench (fir.java analog)")
    fr.add_argument("source", nargs="?", default="noise")
    fr.add_argument("--taps", type=int, default=21)
    fr.add_argument("--flo", type=float, default=-3000.0)
    fr.add_argument("--fhi", type=float, default=3000.0)
    fr.add_argument("--move", type=int, default=0,
                    help="shift band by N x 250 Hz (demod.java:305-311)")
    fr.add_argument("--widen", type=int, default=0,
                    help="widen band by N x 250 Hz each side")
    fr.add_argument("--mix", type=float, default=None,
                    help="complex NCO mix frequency before filtering")
    fr.add_argument("--no-filter", action="store_true",
                    help="bypass the FIR (the testbench's disable command)")
    fr.add_argument("--print-taps", action="store_true")
    fr.add_argument("--out", default=None)
    fr.add_argument("--device", default="cuda", help=device_help)
    fr.set_defaults(fn=cmd_fir)

    fc = sub.add_parser("fcd", help="FUNcube Dongle control/self-test")
    fc.add_argument("action", choices=["status", "tune", "reset", "selftest"],
                    nargs="?", default="status")
    fc.add_argument("--khz", type=int, default=100000)
    fc.add_argument("--fcdctl", help="path to the fcdctl binary")
    fc.set_defaults(fn=cmd_fcd)

    rc = sub.add_parser("record", help="write source as raw S16LE IQ")
    rc.add_argument("source")
    rc.add_argument("--out", default="capture.raw")
    rc.set_defaults(fn=cmd_record)

    ui = sub.add_parser("ui", help="interactive terminal UI: tabs + "
                        "waterfall + the reference's hotkey map "
                        "(jsdr.java shell + accelerator-map.txt analog)")
    ui.add_argument("source", nargs="?", default=None,
                    help="file:<path>, pipe:<path>, capture:<cmd>, or fcd; "
                    "omit to open one later with Ctrl-O/Ctrl-D")
    ui.add_argument("--no-pace", action="store_true",
                    help="replay files at full speed instead of real-time")
    ui.add_argument("--mesh", metavar="DPxSP",
                    help="multi-device telemetry tabs (not ported yet: "
                    "raises)")
    ui.add_argument("--device", default="cuda", help=device_help)
    ui.set_defaults(fn=cmd_ui)

    args = p.parse_args(argv)
    _apply_config(args)
    return args.fn(args)


if __name__ == "__main__":
    main()
