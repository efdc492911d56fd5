"""jsdr-tpu-torch CLI — the port's command-line entry point.

``telemetry`` is the counterpart of ``jsdr-tpu telemetry``
(``jsdr_tpu.app.main.cmd_telemetry``): FUNcube BPSK demodulation of a
file (or synthetic) source in 1 s blocks, N demodulator instances (a comma
list of tunings, in any tuning mode; ``--fft-tune`` auto-tunes with the
FFT tuner, ``--track-high`` searches its upper half-band) batched into
one call per block, AO-40 FEC decode of every sync hit, and the same
frame and counter print-out. ``spectrum`` is
the counterpart of ``jsdr-tpu spectrum`` (``cmd_spectrum``): the dBFS PSD
and peak of every 0.1 s block (the fused spectrum kernel where the block
size fits it), with the same print-out, ASCII plot and PNG renderings.
``--device`` picks where each runs: ``cuda`` (the default) launches the
port's CUDA kernels, ``cpu`` runs their plain PyTorch versions.

``telemetry`` takes the reference's streaming flags: a live source
(``pipe:-``, ``pipe:<path>``, ``capture:<cmd>``, ``fcd``) or ``--pace``
runs ``cmd_telemetry_stream``, the port's :class:`~jsdr_tpu_torch.
runtime.executor.Session` (``--loop``, ``--blocks``,
``--device-convert``), and ``--checkpoint``/``--resume`` save and load the
stream state in the reference's format on either path. ``--mesh``,
``--config`` and the other subcommands are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse

import numpy as np


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


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="jsdr-tpu-torch",
        description="jsdr-tpu's spectrum and telemetry paths on "
        "PyTorch/CUDA")
    p.add_argument("--rate", type=int, default=96000)
    p.add_argument("--seconds", type=int, default=5,
                   help="duration for synthetic sources")
    p.add_argument("--icorr", type=int, default=0, help="I DC correction")
    p.add_argument("--qcorr", type=int, default=0, help="Q DC correction")
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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
