"""jsdr-tpu-torch CLI — the port's command-line entry point.

``telemetry`` is the counterpart of ``jsdr-tpu telemetry``
(``jsdr_tpu.app.main.cmd_telemetry``): FUNcube BPSK demodulation of a
file (or synthetic) source in 1 s blocks, N demodulator instances (a comma
list of tunings) batched into one call per block, AO-40 FEC decode of
every sync hit, and the same frame and counter print-out. ``spectrum`` is
the counterpart of ``jsdr-tpu spectrum`` (``cmd_spectrum``): the dBFS PSD
and peak of every 0.1 s block (the fused spectrum kernel where the block
size fits it), with the same print-out, ASCII plot and PNG renderings.
``--device`` picks where each runs: ``cuda`` (the default) launches the
port's CUDA kernels, ``cpu`` runs their plain PyTorch versions. Live
sources, pacing, meshes, checkpoints, ``--config`` and the other
subcommands are not ported yet (ROADMAP.md).
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


def cmd_telemetry(args) -> int:
    from ..demod.bpsk import BpskConfig, bpsk_block_batch, bpsk_init_batch
    from ..fec.decoder import fec_decode
    from ..ops.cplx import from_complex
    from ..runtime.device import require_device

    dev = require_device(args.device)
    iq, rate = _load_iq(args, args.rate)
    tunings = np.asarray([float(t) for t in str(args.tuning).split(",")])
    n_demods = len(tunings)
    dofft, _track_high = _telem_flags(args, n_demods)
    cfg = BpskConfig(rate=rate, tuning=float(tunings[0]))
    st = bpsk_init_batch(cfg, n_demods, dev)
    block = rate
    iq = np.concatenate([iq, np.zeros((-len(iq)) % block, np.complex64)])
    frames = 0
    for b in range(len(iq) // block):
        blk = from_complex(np.broadcast_to(iq[b * block:(b + 1) * block],
                                           (n_demods, block)), dev)
        out, st = bpsk_block_batch(blk, cfg, st, tunings, dofft=dofft)
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
    tl.add_argument("source", help="file:<path>, sine:<hz> or noise")
    tl.add_argument("--tuning", default="12000",
                    help="NCO Hz; comma list runs N demod instances")
    tl.add_argument("--fft-tune", action="store_true",
                    help="FFT auto-tune (not ported yet: raises)")
    tl.add_argument("--track-high", action="store_true",
                    help="auto-tune searches the upper half-band")
    tl.add_argument("--device", default="cuda", help=device_help)
    tl.set_defaults(fn=cmd_telemetry)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
