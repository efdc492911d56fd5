#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``jsdr_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version on the card, drives the main path (the
FUNcube telemetry decode: ``bpsk_block_batch`` + ``fec_decode``) over the
committed goldens and over 128 concurrent demodulator streams at 96 kS/s,
and checks that the main path went through both kernels. Every phase
asserts; any failure ends the run with a non-zero exit code and no result
line. Each measured number is printed beside the card's name and power
limit. The output ends with a JSON line per kernel, the card line from
nvidia-smi, and ``{"ok": true, "device": {...}}`` as the last line.

It needs a CUDA card and the checkout (``jsdr_tpu_torch/`` and the JAX-free
host modules of ``jsdr_tpu/`` beside this file); it imports no jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_SHAPE = (128, 96000)           # streams x samples per 1 s block
# kernel 1 checks: (streams, samples, rate) at 96 k, 192 k, and a ragged
# last tile (9544 outputs = 74 tiles of 128 + 72)
MIX_CASES = ((128, 96000, 96000), (64, 192000, 192000), (13, 95440, 96000))
SEED = 2026


def need(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    if not (ROOT / "jsdr_tpu_torch").is_dir():
        print("chip_smoke: no jsdr_tpu_torch/ beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1

    import numpy as np

    import jsdr_tpu_torch
    from jsdr_tpu_torch.ops import _build
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.timing_kernel import timing_recover_batch
    from jsdr_tpu_torch.runtime.device import require_device

    need(Path(jsdr_tpu_torch.__file__).resolve().parent
         == ROOT / "jsdr_tpu_torch", "imported another jsdr_tpu_torch")
    need("jax" not in sys.modules, "jax was imported")

    # ---- phase 1: device -------------------------------------------------
    dev = require_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    tag = f"[{card}]"
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # ---- phase 2: build --------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {so.name}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())

    rng = np.random.default_rng(SEED)
    k1 = phase_mix_decimate(torch, np, dev, rng, tag)
    k2 = phase_timing(torch, np, dev, rng, tag)

    # ---- phase 5: goldens through the port -------------------------------
    mix_decimate.launches = timing_recover_batch.launches = 0
    phase_goldens(torch, np, dev, tag)
    need(mix_decimate.launches > 0 and timing_recover_batch.launches > 0,
         "the golden decode did not launch both kernels")

    # ---- phase 6: a deployment's size (the counted main-path run) ---------
    launches = phase_deployment(torch, np, dev, rng, tag, k1, k2)

    print(json.dumps({"kernels": [
        dict(name="mix_decimate", route="cuda",
             source="jsdr_tpu_torch/ops/csrc/mix_decimate.cu",
             replaces="jsdr_tpu/ops/pallas_kernels.py:523",
             launches=launches[0], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"]),
        dict(name="timing_recover_batch", route="cuda",
             source="jsdr_tpu_torch/ops/csrc/timing.cu",
             replaces="jsdr_tpu/ops/timing_kernel.py:46",
             launches=launches[1], max_abs_err=k2["max_abs_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def time_ms(torch, fn, inputs, iters: int) -> float:
    """Mean device ms per call over ``iters`` calls, cycling through
    ``inputs`` (so no call repeats its predecessor's input), timed with
    CUDA events after one warm-up call; the last output is read back."""
    fn(*inputs[-1])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        out = fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    first = out[0] if isinstance(out, tuple) else out
    first = first.re if hasattr(first, "re") else first
    need(bool(torch.isfinite(first.float()).all()), "non-finite output")
    return start.elapsed_time(end) / iters


def phase_mix_decimate(torch, np, dev, rng, tag):
    """Phase 3: kernel 1 against its plain version at the main path's
    shapes (96 k and 192 k) and at a ragged one."""
    from jsdr_tpu_torch.demod.bpsk import (DS_FILTER, HOWARD_FUDGE_FACTOR,
                                           NU_SCALE, _nco_pattern,
                                           tunings_to_nu)
    from jsdr_tpu_torch.ops.cplx import CF
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate, mix_decimate_ref

    taps = torch.as_tensor(DS_FILTER, dtype=torch.float32, device=dev)
    res = {}
    worst = 0.0
    for s, t_len, rate in MIX_CASES:
        m = rate // 9600

        def rand(*shape):
            return torch.as_tensor(rng.standard_normal(shape, np.float32),
                                   device=dev)

        tun = np.where(np.arange(s) % 2 == 0, 12000.0, 9000.0)
        tu = torch.as_tensor(tunings_to_nu(tun), dtype=torch.int64,
                             device=dev)
        nu0 = torch.as_tensor(rng.integers(0, NU_SCALE * rate, s),
                              dtype=torch.float32, device=dev)
        cos_pat, sin_pat = _nco_pattern(nu0, tu, rate)
        inputs = [(CF(rand(s, t_len), rand(s, t_len)), cos_pat, sin_pat,
                   taps, m, CF(rand(s, 26), rand(s, 26)),
                   HOWARD_FUDGE_FACTOR) for _ in range(3)]
        y, tl = mix_decimate(*inputs[0])
        yp, tlp = mix_decimate_ref(*inputs[0])
        torch.cuda.synchronize()
        scale = max(float(yp.re.abs().max()), float(yp.im.abs().max()))
        err = max(float((y.re - yp.re).abs().max()),
                  float((y.im - yp.im).abs().max()))
        need(err <= 1e-5 * scale,
             f"mix_decimate S={s} T={t_len}: max|kernel-plain| {err} > "
             f"1e-5 * {scale}")
        need(torch.equal(tl.re, tlp.re) and torch.equal(tl.im, tlp.im),
             f"mix_decimate S={s} T={t_len}: tails differ")
        worst = max(worst, err)
        ms = time_ms(torch, mix_decimate, inputs, 20)
        plain_ms = time_ms(torch, mix_decimate_ref, inputs, 5)
        gbs = (s * t_len * 8 + s * (t_len // m) * 8) / ms / 1e6
        print(f"{tag} mix_decimate S={s} T={t_len} m={m}: max|k-p| {err:.3e}"
              f" (<= 1e-5 x {scale:.3e}), tails equal; kernel {ms:.4f} ms "
              f"({gbs:.0f} GB/s), plain {plain_ms:.4f} ms")
        if (s, t_len) == MAIN_SHAPE:
            res = dict(ms=ms, plain_ms=plain_ms)
    res["max_abs_err"] = worst
    return res


def phase_timing(torch, np, dev, rng, tag):
    """Phase 4: kernel 2 against its plain version at the main path's
    shape (S=128, T_ds=9600), two chained blocks of BPSK-like input."""
    from jsdr_tpu_torch.demod.bpsk import BIT_SMOOTH1, BIT_SMOOTH2, ENERGY_GATE
    from jsdr_tpu_torch.ops.timing_kernel import (timing_recover_batch,
                                                  timing_recover_ref)

    s, t_ds = MAIN_SHAPE[0], MAIN_SHAPE[1] // 10
    kw = dict(smooth1=BIT_SMOOTH1, smooth2=BIT_SMOOTH2, gate=ENERGY_GATE)

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    def bpsk_like():
        mfr = (rng.standard_normal((s, t_ds)) * 30
               + 150 * np.sign(rng.standard_normal((s, t_ds // 8)))
               .repeat(8, axis=1)).astype(np.float32)
        mfi = (rng.standard_normal((s, t_ds)) * 30).astype(np.float32)
        return on_dev(mfr), on_dev(mfi)

    state = (on_dev(rng.random((s, 8)).astype(np.float32) * 2e4),
             on_dev(rng.integers(0, 8, s).astype(np.int32)),
             on_dev(rng.integers(0, 8, s).astype(np.int32)),
             on_dev(rng.random(s).astype(np.float32) * 100),
             on_dev(rng.standard_normal((s, 2)).astype(np.float32) * 50))
    blocks = [bpsk_like() for _ in range(3)]
    sk, sp = state, state
    worst = 0.0
    for b in range(2):
        k = timing_recover_batch(*blocks[b], *sk, **kw)
        p = timing_recover_ref(*blocks[b], *sp, **kw)
        torch.cuda.synchronize()
        need(torch.equal(k[0], p[0]), f"timing block {b}: valid differs")
        need(torch.equal(k[1][p[0]], p[1][p[0]]),
             f"timing block {b}: bit differs where valid")
        need(torch.equal(k[3], p[3]) and torch.equal(k[4], p[4]),
             f"timing block {b}: peak/new_peak differ")
        for i, name, rtol, atol in ((2, "e_ema", 1e-5, 1e-2),
                                    (5, "e_out", 1e-4, 1e-2),
                                    (6, "last_iq", 1e-6, 1e-4)):
            need(torch.allclose(k[i], p[i], rtol=rtol, atol=atol),
                 f"timing block {b}: {name} differs")
            worst = max(worst, float((k[i] - p[i]).abs().max()))
        sk, sp = k[2:], p[2:]
    n_valid = int(p[0].sum())
    inputs = [(*blk, *state) for blk in blocks]
    ms = time_ms(torch, lambda *a: timing_recover_batch(*a, **kw), inputs, 20)
    plain_ms = time_ms(torch, lambda *a: timing_recover_ref(*a, **kw),
                       inputs, 3)
    print(f"{tag} timing_recover_batch S={s} T_ds={t_ds}: 2 chained blocks "
          f"equal (valid, bit where valid, peaks; {n_valid} valid slots in "
          f"block 1), max state err {worst:.3e}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=worst)


def phase_goldens(torch, np, dev, tag):
    """Phase 5: the committed goldens through the port, 1 s blocks."""
    from jsdr_tpu.io.convert import s16le_to_complex
    from jsdr_tpu_torch.demod.bpsk import BpskConfig, bpsk_block, bpsk_init
    from jsdr_tpu_torch.fec.decoder import fec_decode
    from jsdr_tpu_torch.ops.cplx import from_complex

    for name in ("golden_96k.npz", "golden_192k.npz"):
        g = np.load(ROOT / "tests" / "golden" / name)
        rate = int(g["rate"])
        sig = s16le_to_complex(np.asarray(g["raw_s16le"]))
        sig = np.concatenate([sig, np.zeros((-len(sig)) % rate,
                                            np.complex64)])
        cfg = BpskConfig(rate=rate, tuning=float(g["tuning"]))
        st = bpsk_init(cfg, dev)
        payloads, rcs, corrs = [], [], []
        t0 = time.perf_counter()
        for b in range(len(sig) // rate):
            out, st = bpsk_block(
                from_complex(sig[b * rate:(b + 1) * rate], dev), cfg, st)
            nh = int(out.n_hits)
            if nh:
                res = fec_decode(out.windows[:nh])
                need(bool(res.ok.all()), f"{name}: FEC failed at t={b}s")
                payloads += list(res.payload.cpu().numpy())
                rcs += res.rc.cpu().tolist()
                corrs += out.hit_corr[:nh].cpu().tolist()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        need(len(payloads) == len(g["payloads"])
             and np.array_equal(np.stack(payloads), g["payloads"]),
             f"{name}: payloads differ")
        need(rcs == list(g["rc"]), f"{name}: rc {rcs} != {list(g['rc'])}")
        need(corrs == list(g["hit_corr"]),
             f"{name}: hit_corr {corrs} != {list(g['hit_corr'])}")
        print(f"{tag} golden {name}: {len(payloads)} frames bit-exact, rc "
              f"{rcs}, hit_corr {corrs}; {len(sig) // rate} blocks in "
              f"{wall:.3f} s wall (S=1, host-synchronised)")


def phase_deployment(torch, np, dev, rng, tag, k1, k2):
    """Phase 6: 128 concurrent demodulator instances at 96 kS/s, one
    AO-40 frame each, 5 chained 1 s blocks; every payload must decode
    bit-exact. Returns the kernels' launch counts in this run."""
    from jsdr_tpu.io.sources import synth_bpsk_stream
    from jsdr_tpu_torch.demod.bpsk import (BpskConfig, bpsk_block_batch,
                                           bpsk_init_batch)
    from jsdr_tpu_torch.fec.decoder import fec_decode
    from jsdr_tpu_torch.ops.cplx import from_complex
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.timing_kernel import timing_recover_batch

    s, block = MAIN_SHAPE
    n_blocks = 5
    rate = block
    tunings = 6000.0 + 750.0 * (np.arange(s) % 21)     # 6000 .. 21000 Hz
    payloads = rng.integers(0, 256, (s, 256), dtype=np.uint8)
    t0 = time.perf_counter()
    iq = np.zeros((s, n_blocks * block), np.complex64)
    for i in range(s):
        sig = synth_bpsk_stream(payloads[i:i + 1], rate=rate,
                                carrier_offset=float(tunings[i]),
                                preamble_bits=200, noise_rms=0.25, seed=i)
        need(len(sig) <= iq.shape[1], "frame longer than the run")
        iq[i, :len(sig)] = sig
    blocks = [from_complex(iq[:, b * block:(b + 1) * block], dev)
              for b in range(n_blocks)]
    torch.cuda.synchronize()
    print(f"deployment: {s} streams x {n_blocks} s at {rate} S/s "
          f"synthesised and uploaded in {time.perf_counter() - t0:.2f} s "
          f"({s * block * 8 / 1e6:.1f} MB per block on the device)")

    cfg = BpskConfig(rate=rate)
    bpsk_block_batch(blocks[0], cfg, bpsk_init_batch(cfg, s, dev), tunings)
    torch.cuda.synchronize()                           # warm-up, discarded

    st = bpsk_init_batch(cfg, s, dev)
    step_ms, fec_ms = [], []
    decoded = [[] for _ in range(s)]
    failed = 0
    mix_decimate.launches = timing_recover_batch.launches = 0
    for b in range(n_blocks):
        t0 = time.perf_counter()
        out, st = bpsk_block_batch(blocks[b], cfg, st, tunings)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step_ms.append((t1 - t0) * 1e3)
        need(bool(torch.isfinite(out.energies).all()), "non-finite energies")
        n_hits = out.n_hits
        hit = (torch.arange(out.windows.shape[1], device=dev)[None, :]
               < n_hits[:, None])
        stream_of = torch.nonzero(hit)[:, 0].cpu().numpy()
        if len(stream_of):
            res = fec_decode(out.windows[hit])
            ok = res.ok.cpu().numpy()
            pay = res.payload.cpu().numpy()
            for j, si in enumerate(stream_of):
                if ok[j]:
                    decoded[si].append(pay[j])
                else:
                    failed += 1
        fec_ms.append((time.perf_counter() - t1) * 1e3)
    launches = (mix_decimate.launches, timing_recover_batch.launches)
    bad = [i for i in range(s) if len(decoded[i]) != 1
           or not np.array_equal(decoded[i][0], payloads[i])]
    need(not bad, f"streams {bad[:10]} did not decode their payload "
         "exactly once")
    counters = st.counters.cpu().numpy()
    need((counters[:, 0] == n_blocks * block).all(), "raw counters wrong")
    need(launches[0] == n_blocks and launches[1] == n_blocks,
         f"main path launches {launches}, want {n_blocks} of each")

    mean = float(np.mean(step_ms))
    kern = k1["ms"] + k2["ms"]
    print(f"{tag} deployment: all {s} payloads decoded bit-exact "
          f"({failed} failed sync hits); bpsk_block_batch "
          f"{mean:.3f} ms/block mean over {n_blocks} blocks "
          f"(each {', '.join(f'{v:.3f}' for v in step_ms)}), "
          f"{s * block / mean / 1e3:.1f} MS/s; FEC drain "
          f"{', '.join(f'{v:.1f}' for v in fec_ms)} ms per block")
    print(f"{tag} deployment split: kernels {kern:.3f} ms/block "
          f"(mix_decimate {k1['ms']:.3f} + timing {k2['ms']:.3f}, event-"
          f"timed at these shapes), the rest {mean - kern:.3f} ms/block")
    return launches


if __name__ == "__main__":
    sys.exit(main())
