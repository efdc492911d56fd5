"""jsdr-tpu-torch CLI — the port's command-line entry point.

``telemetry`` is the counterpart of ``jsdr-tpu telemetry``
(``jsdr_tpu.app.main.cmd_telemetry``): FUNcube BPSK demodulation of a
file (or synthetic) source in 1 s blocks, N demodulator instances (a comma
list of tunings) batched into one call per block, AO-40 FEC decode of
every sync hit, and the same frame and counter print-out. ``--device``
picks where it runs: ``cuda`` (the default) launches the port's CUDA
kernels, ``cpu`` runs their plain PyTorch versions. Live sources, pacing,
meshes, checkpoints and the other subcommands are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import argparse

import numpy as np

from jsdr_tpu.app.main import _load_iq, _telem_flags


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
        description="jsdr-tpu's telemetry path on PyTorch/CUDA")
    p.add_argument("--rate", type=int, default=96000)
    p.add_argument("--seconds", type=int, default=5,
                   help="duration for synthetic sources")
    p.add_argument("--icorr", type=int, default=0, help="I DC correction")
    p.add_argument("--qcorr", type=int, default=0, help="Q DC correction")
    sub = p.add_subparsers(dest="cmd", required=True)

    tl = sub.add_parser("telemetry", help="FUNcube BPSK + AO-40 FEC")
    tl.add_argument("source", help="file:<path>, sine:<hz> or noise")
    tl.add_argument("--tuning", default="12000",
                    help="NCO Hz; comma list runs N demod instances")
    tl.add_argument("--fft-tune", action="store_true",
                    help="FFT auto-tune (not ported yet: raises)")
    tl.add_argument("--track-high", action="store_true",
                    help="auto-tune searches the upper half-band")
    tl.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the CUDA kernels, cpu "
                    "their plain PyTorch versions")
    tl.set_defaults(fn=cmd_telemetry)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
