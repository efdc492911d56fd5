#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``jsdr_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version on the card, and drives the port's
main paths: the FUNcube telemetry decode (``bpsk_block_batch`` +
``fec_decode``) over the committed goldens and over 128 concurrent
demodulator streams at 96 kS/s (phases 5-6); the flagship spectrum +
telemetry step (``bpsk_block_batch_spectrum``) over 128 streams in 4.8 s
blocks at 96 kS/s, then one 1 s block that takes its staged branch
(phase 8); and the streaming Session (``runtime.executor``: 128
demodulator instances with the fused matched filter on one 96 kS/s
stream of raw int16 chunks, beside the PSD + waterfall stage, with a
checkpoint and resume; phase 11); and every tuning mode of the front end
(``bpsk_block_batch`` in the general, static, FFT auto-tune and mixed
modes, and the auto-tuned deployment's staged spectrum step; phase 12);
and the audio demodulator (``demod/am_fm.py``, which has no kernel of its
own) at the JAX package's bench deployment, with its known answers, the
streaming demod Session and the ``demod`` and ``fir`` commands (phase
13); the interactive shell's pipeline (``app/tui.py``: ``StageManager`` +
``PipelineThread`` on the card, headless, with live key presses; phase
14), the ``compat_scan`` per-sample timing path (phase 15) and the native
IO library (``io/native.py``, built with g++; phase 16). It checks that
each path went through its kernels (and that phase 13 launched none of
them), then times more steps of each on the host
clock and profiles a few with torch.profiler for the device-busy share. Every
phase asserts; any failure ends the run with a non-zero exit code and no
result line. Each measured number is printed beside the card's name and power
limit. The output ends with a JSON line of the kernels (launches on the
main paths, errors against the plain versions, times, bounds), the card
line from nvidia-smi, and ``{"ok": true, "device": {...}}`` as the last
line.

It needs a CUDA card and the checkout (``jsdr_tpu_torch/`` and
``tests/golden/`` beside this file); it imports no jax and nothing of the
JAX package ``jsdr_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MAIN_SHAPE = (128, 96000)           # streams x samples per 1 s block
# kernels 1 and 6: (streams, samples, rate) at 96 k and 192 k (m = 10 and
# 20, compiled with m fixed), a ragged stream and output count (9544
# outputs), then two rates whose m (14 at 134.4 k; 40 at 384 k, where a
# sub-chunk shrinks to 128 outputs) the kernels take at run time
MIX_CASES = ((128, 96000, 96000), (64, 192000, 192000), (13, 95440, 96000),
             (64, 134400, 134400), (32, 384000, 384000))
# kernels 3 and 4: (streams, samples, rate): the flagship shape (4.8 s
# blocks at 96 k, bench.py's), 192 k, a ragged stream count, the 1 s
# block that takes the staged branch, 134.4 k (n1 = 105 = 3*5*7: the
# FFT's generic radix), and the 4-CTA cluster's rates: 384 k (n1 = 300),
# 313.6 k (n1 = 245 = 5*7^2: generic radix 49) and 655.36 k (n1 = 512,
# the reference's largest)
SPEC_CASES = ((128, 460800, 96000), (256, 460800, 192000), (13, 96000, 96000),
              (128, 96000, 96000), (64, 134400, 134400), (32, 384000, 384000),
              (32, 313600, 313600), (32, 655360, 655360))
# kernel 4 alone at one CTA's largest n1 (ONE_CTA_MAX_N1 = 225: n = 28800 at
# 288 kS/s; above it a block takes a 4-CTA cluster): streams, each 1 s
K4_STREAMS = 32
# the forced cluster launch against the one-CTA kernels, bit for bit
CLUSTER_CHECK_N1 = (75, 150)
FLAGSHIP_SHAPE = (128, 460800)      # streams x samples per 4.8 s block
# kernel 2: (streams, matched-filter samples): the 1 s block's and the
# flagship's (1/10 of the input rate), and twice the flagship's streams
TIMING_CASES = ((128, 9600), (128, 46080), (256, 46080))
# kernel 5: (rows, bins, width): the Session's 1 s block of 0.1 s spectra
# at 96 k and 192 k (tiles of 20 and 19 groups: the last of 19 ragged),
# 128 streams' 1 s of blocks, an odd width (tiles of 2 groups, the last
# holding 1), rows that start off 16-byte alignment (n = 9590, step 137),
# and groups larger than a CTA's slab of dB (width 3, step 3200)
PSD_CASES = ((10, 9600, 960), (10, 19200, 960), (1280, 9600, 960),
             (10, 9600, 75), (6, 9590, 70), (10, 9600, 3))
# the Session's stream: frames at 3 of the 21 tunings, 7 s of 1 s blocks
SESSION_CARRIERS = (7500.0, 13500.0, 19500.0)
SESSION_BLOCKS = 7
SEED = 2026
# phase 12's auto-tuned (dofft) streams: (carrier Hz, seed) pairs, one
# AO-40 frame each (payload from default_rng(500 + seed), noise rms 0.25
# from the seed), built as tests/test_demod.py:89 builds its own. The
# reference's auto-tuner is marginal by design (some payload draws lock
# it ~300 Hz off, tests/test_bpsk_chain.py:241-245): pair 9 takes seed 16
# because seed 9 is such a draw at 13650 Hz, in the JAX package too.
# tests/test_torch_tuner.py shows the JAX package decodes every pair.
# phase 13: the JAX package's audio demod bench deployment (bench.py:
# 409-412): 64 WFM streams x 10 s at 96 kS/s, 21-tap band-pass at
# +-20 kHz, down-shift, discriminator, AGC; 3 chained blocks
DEMOD_SHAPE = (64, 960_000)
DEMOD_BLOCKS = 3
DOFFT_STREAMS = tuple((3300.0 + 1150.0 * k, 16 if k == 9 else k)
                      for k in range(16))
# H100 SXM peaks (NVIDIA data sheet, at 700 W): fp32 outside the tensor
# cores, and device memory
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the full PSD against its plain version (psd_errors): dB error on bins
# at or above the row's median, and amplitude error over the row's RMS
# amplitude (fp32 DFTs in two summation orders; read on an H100: 8.0e-5
# at n = 9600, 1.07e-4 at n = 19200)
PSD_DB_TOL = 2e-3
PSD_AMP_TOL = 3e-4


def need(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for this work (ms), and which
    of its operations and its bytes bounds it."""
    ops_ms, bytes_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def spec_work(s: int, t_len: int, n: int, q: int) -> tuple[float, float]:
    """(flops, bytes) of the waterfall spectrum over [S, T]: per block of
    n, the window (2n), a factored FFT's 5*n*log2(n) and the power, scale
    and dB (6n); the two input planes read and wf/peaks written once (the
    window is read too). The kernels compute a factored FFT
    (csrc/spectrum_body.cuh): radix 2, 3, 4 and 5 passes down the columns
    and a 128-point FFT along the rows, near this count (a generic radix
    above 5, which no FUNcube rate has, costs more)."""
    nblk = t_len // n
    flops = s * nblk * (5.0 * n * np.log2(n) + 8.0 * n)
    nbytes = (8.0 * s * t_len + 4.0 * s * nblk * (n // 128 // q) * 128
              + 8.0 * s * nblk + 4.0 * n)
    return flops, nbytes


def psd_errors(torch, k, p) -> tuple[float, float, float]:
    """A full PSD ``k`` [nblk, S, n1, 128] (dB) against ``p``, by (block,
    stream) row: the largest dB difference on bins at or above the row's
    median (the noise floor), the largest amplitude difference over the
    row's RMS amplitude, and the largest dB difference anywhere. An fp32
    DFT's error in a bin scales with the block's energy, not the bin's,
    so bins deep below the floor differ by more dB under another
    summation order; their amplitudes do not."""
    d = (k - p).abs()
    med = p.flatten(2).median(dim=2).values[..., None, None]
    ak, ap = torch.pow(10.0, k.double() / 20), torch.pow(10.0, p.double() / 20)
    rms = ap.square().mean(dim=(2, 3), keepdim=True).sqrt()
    return (float(d[p >= med].max()), float(((ak - ap).abs() / rms).max()),
            float(d.max()))


def front_work(s: int, t_len: int, m: int) -> tuple[float, float]:
    """(flops, bytes) of the tuner mix + 27-tap decimating FIR: a multiply
    per input sample and plane, 27 FMAs per output and plane; the input,
    patterns, taps and tail read, the output and new tail written."""
    flops = 2.0 * s * t_len + 2 * 27 * 2.0 * s * (t_len // m)
    nbytes = (8.0 * s * t_len + 8.0 * s * 128 + 4 * 27 + 2 * 8.0 * s * 26
              + 8.0 * s * (t_len // m))
    return flops, nbytes


def dofft_signals(rate: int, n_blocks: int = 5):
    """The DOFFT_STREAMS signals at ``rate``: complex64 [16, n_blocks *
    rate] (zero after each frame) and their payloads [16, 256]."""
    from jsdr_tpu_torch.io.sources import synth_bpsk_stream

    iq = np.zeros((len(DOFFT_STREAMS), n_blocks * rate), np.complex64)
    payloads = []
    for i, (carrier, seed) in enumerate(DOFFT_STREAMS):
        pay = np.random.default_rng(500 + seed).integers(0, 256, (1, 256),
                                                         dtype=np.uint8)
        sig = synth_bpsk_stream(pay, rate=rate, carrier_offset=carrier,
                                preamble_bits=400, noise_rms=0.25,
                                seed=seed)
        need(len(sig) <= iq.shape[1], "frame longer than the run")
        iq[i, :len(sig)] = sig
        payloads.append(pay[0])
    return iq, np.stack(payloads)


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

    import jsdr_tpu_torch
    from jsdr_tpu_torch.ops import _build
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.timing_kernel import timing_recover_batch
    from jsdr_tpu_torch.runtime.device import require_device

    need(Path(jsdr_tpu_torch.__file__).resolve().parent
         == ROOT / "jsdr_tpu_torch", "imported another jsdr_tpu_torch")
    need("jax" not in sys.modules and "jsdr_tpu" not in sys.modules,
         "jax or the JAX package was imported")

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
    from jsdr_tpu_torch.io import native
    fresh = not native.library_path().exists()
    t0 = time.perf_counter()
    lib = native.build()
    print(f"native IO library: g++ {'built' if fresh else 'found'} "
          f"{lib.name} in {time.perf_counter() - t0:.2f} s")

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

    # ---- phase 7: kernels 3 and 4 against their plain versions -----------
    k3, k4 = phase_spectrum_kernels(torch, np, dev, tag)

    # ---- phase 8: the flagship step at a deployment's size -----------------
    flagship = phase_flagship(torch, np, dev, rng, tag, k3)

    # ---- phases 9-10: kernels 5 and 6 against their plain versions -------
    k5 = phase_psd_waterfall(torch, np, dev, tag)
    k6 = phase_mix_decimate_mf(torch, np, dev, rng, tag)

    # ---- phase 11: the streaming Session at a deployment's size -----------
    session = phase_session(torch, np, dev, rng, tag)

    # ---- phase 12: every tuning mode at a deployment's size ---------------
    phase_tuning_modes(torch, np, dev, rng, tag)

    # ---- phase 13: AM/NFM/WFM audio demod at a deployment's size ----------
    phase_audio_demod(torch, np, dev, tag)

    # ---- phase 14: the ui shell's pipeline on the card, headless ---------
    phase_ui(torch, np, dev, tag)

    # ---- phase 15: compat_scan (the per-sample timing scan) -------------
    phase_compat_scan(torch, np, dev, rng, tag)

    # ---- phase 16: the native IO library ---------------------------------
    phase_native_io(np, tag)

    need("jax" not in sys.modules and "jsdr_tpu" not in sys.modules,
         "jax or the JAX package was imported")
    print(json.dumps({"kernels": [
        dict(name="mix_decimate", route="cuda",
             source="jsdr_tpu_torch/ops/csrc/mix_decimate.cu",
             replaces="jsdr_tpu/ops/pallas_kernels.py:523",
             launches=launches[0], **k1),
        dict(name="timing_recover_batch", route="cuda",
             source="jsdr_tpu_torch/ops/csrc/timing.cu",
             replaces="jsdr_tpu/ops/timing_kernel.py:46",
             launches=launches[1], **k2),
        dict(name="spectrum_front_fused", route="cuda",
             source="jsdr_tpu_torch/ops/csrc/spec_front.cu",
             replaces="jsdr_tpu/ops/pallas_kernels.py:700",
             launches=flagship["spectrum_front_fused"], **k3),
        dict(name="spectrum_waterfall", route="cuda",
             source="jsdr_tpu_torch/ops/csrc/spectrum_wf.cu",
             replaces="jsdr_tpu/ops/pallas_kernels.py:275",
             launches=flagship["spectrum_fused"], **k4),
        dict(name="psd_waterfall", route="cuda",
             source="jsdr_tpu_torch/ops/csrc/psd_waterfall.cu",
             replaces="jsdr_tpu/ops/pallas_kernels.py:44",
             launches=session["psd_waterfall"], **k5),
        dict(name="mix_decimate_mf", route="cuda",
             source="jsdr_tpu_torch/ops/csrc/mix_dec_mf.cu",
             replaces="jsdr_tpu/ops/pallas_kernels.py:955",
             launches=session["mix_decimate_mf"],
             **{k: v for k, v in k6.items() if k != "chain_ms"}),
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


def device_ms(torch, fn, inputs, iters: int) -> float:
    """Mean device ms per call, as :func:`time_ms`, without the host's
    time between calls: the calls are enqueued behind a sleep kernel that
    is still running when the last one is enqueued (checked), so the
    events bracket the device's work alone."""
    fn(*inputs[-1])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)                  # ~25 ms at 1980 MHz
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    need(not start.query(), "device_ms: the sleep ended before the calls "
         "were enqueued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def step_times(torch, step, steps: int, profiled: int, tag: str,
               what: str) -> float:
    """Time ``step`` (one call of a main-path entry point on the next
    input, carrying its state) ``steps`` times on the host clock, each
    ending in a synchronise; then ``profiled`` more under torch.profiler
    for the device-busy time per step (the kernels' device time; one
    stream, so they do not overlap) and the largest kernels. Prints the
    mean, spread and split; returns the mean ms per step."""
    wall = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with profiler(torch) as prof:
        for _ in range(profiled):
            step()
            torch.cuda.synchronize()
    return report_steps(torch, wall, prof, profiled, tag, what)


def profiler(torch):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def report_steps(torch, wall, prof, profiled: int, tag: str,
                 what: str) -> float:
    """Print the mean and spread of the host-clock step times ``wall``
    (ms) and the device-busy time per step, idle share, largest kernels
    and the timing kernel's time of ``profiled`` steps traced by ``prof``;
    returns the mean."""
    steps = len(wall)
    rows = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us, cnt = rows.get(evt.name, (0.0, 0))
            rows[evt.name] = (us + evt.time_range.elapsed_us(), cnt + 1)
    busy = sum(us for us, _ in rows.values()) / 1e3 / profiled
    need(busy > 0, f"{what}: the profiler saw no device time")
    mean = float(np.mean(wall))
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:5]
    timing = sum(us for k, (us, _) in rows.items() if "timing_kernel" in k)
    print(f"{tag} {what}: {mean:.3f} ms/step mean over {steps} steps (min "
          f"{min(wall):.3f}, max {max(wall):.3f}); device busy {busy:.3f} "
          f"ms/step over {profiled} profiled steps, so the device idles "
          f"{1 - busy / mean:.1%} of the step ({mean - busy:.3f} ms); "
          f"{sum(c for _, c in rows.values()) / profiled:.0f} kernel "
          f"launches per step; timing kernel {timing / 1e3 / profiled:.4f} "
          f"ms; largest: " + ", ".join(
              f"{k[:40]} {us / 1e3 / profiled:.3f} ms" for k, (us, _) in top))
    return mean


def phase_mix_decimate(torch, np, dev, rng, tag):
    """Phase 3: kernel 1 against its plain version (within 1e-5 of
    max|y|: conv1d sums in another order; tails bit for bit) at
    MIX_CASES, and one call of it, profiled, launching one device kernel.
    Times it (event time back to back, and its device time alone,
    :func:`device_ms`) beside the plain version and the bound. Returns the
    row at the main path's shape (128 x 96,000)."""
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
        if (s, t_len) == MAIN_SHAPE:
            with profiler(torch) as prof:
                mix_decimate(*inputs[1])
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type
                     == torch.autograd.DeviceType.CUDA]
            need(len(names) == 1, f"mix_decimate: one call launched {names}, "
                 "want one device kernel")
        ms = time_ms(torch, mix_decimate, inputs, 20)
        dev_ms = device_ms(torch, mix_decimate, inputs, 20)
        plain_ms = time_ms(torch, mix_decimate_ref, inputs, 5)
        flops, nbytes = front_work(s, t_len, m)
        b_ms, b_by = bound(flops, nbytes)
        print(f"{tag} mix_decimate S={s} T={t_len} m={m}: max|k-p| {err:.3e}"
              f" (<= 1e-5 x {scale:.3e}), tails equal; kernel {ms:.4f} ms "
              f"(device time {dev_ms:.4f} ms, {nbytes / dev_ms / 1e6:.0f} "
              f"GB/s), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by "
              f"{b_by}")
        if (s, t_len) == MAIN_SHAPE:
            res = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del inputs, y, yp
        torch.cuda.empty_cache()
    res["max_abs_err"] = worst
    return res


def phase_timing(torch, np, dev, rng, tag):
    """Phase 4: kernel 2 against its plain version, bit for bit on all
    seven outputs over two chained blocks of BPSK-like input, at
    TIMING_CASES and a ragged shape (5 streams, CHUNK_GROUPS + 3 groups:
    a last chunk of 3). Times the kernel (and its device time alone,
    :func:`device_ms`) and the plain version at the 1 s and flagship
    shapes (CUDA events, cycling 3 inputs) beside the bound and the EMA
    chain's floor. Returns the row at the 1 s shape."""
    from jsdr_tpu_torch.demod.bpsk import BIT_SMOOTH1, BIT_SMOOTH2, ENERGY_GATE
    from jsdr_tpu_torch.ops.timing_kernel import (CHUNK_GROUPS,
                                                  timing_recover_batch,
                                                  timing_recover_ref)

    kw = dict(smooth1=BIT_SMOOTH1, smooth2=BIT_SMOOTH2, gate=ENERGY_GATE)
    names = ("valid", "bit", "e_ema", "peak", "new_peak", "e_out", "last_iq")
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    row, worst = None, 0.0
    for s, t_ds in TIMING_CASES + ((5, 8 * (CHUNK_GROUPS + 3)),):
        def bpsk_like():
            mfr = (rng.standard_normal((s, t_ds), np.float32) * 30
                   + 150 * np.sign(rng.standard_normal((s, t_ds // 8),
                                                       np.float32))
                   .repeat(8, axis=1))
            mfi = rng.standard_normal((s, t_ds), np.float32) * 30
            return on_dev(mfr), on_dev(mfi)

        state = (on_dev(rng.random((s, 8), np.float32) * 2e4),
                 on_dev(rng.integers(0, 8, s).astype(np.int32)),
                 on_dev(rng.integers(0, 8, s).astype(np.int32)),
                 on_dev(rng.random(s, np.float32) * 100),
                 on_dev(rng.standard_normal((s, 2), np.float32) * 50))
        blocks = [bpsk_like() for _ in range(3)]
        sk, sp = state, state
        for b in range(2):
            k = timing_recover_batch(*blocks[b], *sk, **kw)
            p = timing_recover_ref(*blocks[b], *sp, **kw)
            torch.cuda.synchronize()
            worst = max([worst] + [float((k[i] - p[i]).abs().max())
                                   for i in (2, 5, 6)])
            bad = [n for n, x, y in zip(names, k, p) if not torch.equal(x, y)]
            need(not bad, f"timing S={s} T_ds={t_ds} block {b}: {bad} differ "
                 "from the plain version")
            sk, sp = k[2:], p[2:]
        n_groups = t_ds // 8
        line = (f"{tag} timing_recover_batch S={s} T_ds={t_ds} ({n_groups} "
                f"groups, chunks of {CHUNK_GROUPS}): 2 chained blocks, all "
                f"seven outputs equal to plain (bit for bit; "
                f"{int(p[0].sum())} valid slots in block 1)")
        if (s, t_ds) not in TIMING_CASES[:2]:
            print(line)
            continue
        inputs = [(*blk, *state) for blk in blocks]
        ms = time_ms(torch, lambda *a: timing_recover_batch(*a, **kw),
                     inputs, 20)
        plain_ms = time_ms(torch, lambda *a: timing_recover_ref(*a, **kw),
                           inputs, 2)
        # back to back, the event time above can be the wrapper's host time
        dev_ms = device_ms(torch, lambda *a: timing_recover_batch(*a, **kw),
                           inputs, 20)
        # per 8-sample group: |v|^2 and the EMA of 8 phases (48 flops), the
        # argmax (8), two slot decisions (~20); bytes: the two planes in,
        # the valid/bit bytes and the state in and out
        b_ms, b_by = bound(76.0 * s * n_groups,
                           8.0 * s * t_ds + 2.0 * s * 2 * n_groups
                           + 2 * 52.0 * s)
        # the EMA chain alone: a dependent multiply and add a group,
        # taken as 8 cycles at the card's highest SM clock
        chain_ms = n_groups * 8 / (clock_mhz * 1e3)
        print(f"{line}; kernel {ms:.4f} ms (device time {dev_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by}, EMA "
              f"chain floor {chain_ms:.5f} ms ({n_groups} x 8 cycles at "
              f"{clock_mhz:.0f} MHz)")
        if (s, t_ds) == TIMING_CASES[0]:
            row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del inputs, blocks, state, sk, sp, k, p
        torch.cuda.empty_cache()
    row["max_abs_err"] = worst
    return row


def phase_goldens(torch, np, dev, tag):
    """Phase 5: the committed goldens through the port, 1 s blocks."""
    from jsdr_tpu_torch.demod.bpsk import BpskConfig, bpsk_block, bpsk_init
    from jsdr_tpu_torch.fec.decoder import fec_decode
    from jsdr_tpu_torch.io.convert import s16le_to_complex
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
    from jsdr_tpu_torch.demod.bpsk import (BpskConfig, bpsk_block_batch,
                                           bpsk_init_batch)
    from jsdr_tpu_torch.fec.decoder import fec_decode
    from jsdr_tpu_torch.io.sources import synth_bpsk_stream
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
          f"{', '.join(f'{v:.1f}' for v in fec_ms)} ms per block; kernels "
          f"1 + 2 {kern:.3f} ms/block (event-timed in phases 3-4)")
    state = [st, 0]

    def step():
        state[0] = bpsk_block_batch(blocks[state[1] % n_blocks], cfg,
                                    state[0], tunings)[1]
        state[1] += 1

    step_times(torch, step, 10, 3, tag,
               f"telemetry step bpsk_block_batch S={s} T={block}")
    return launches


def spec_inputs(torch, np, dev, gen, s: int, t_len: int, rate: int):
    """Three inputs [S, T] for the spectrum kernels at ``rate`` (n = rate /
    10, one bin = 10 Hz): a tone per stream at its own whole bin, 1.5 over
    a 0.3 noise floor; the tones' Hz [S] (float64)."""
    from jsdr_tpu_torch.ops.cplx import CF

    n = rate // 10
    tone_hz = torch.as_tensor(10.0 * ((np.arange(s) * 397) % (n // 2))
                              - rate / 4, dtype=torch.float64, device=dev)
    ang = (2 * np.pi / rate) * tone_hz[:, None] * torch.arange(
        t_len, dtype=torch.float64, device=dev)[None, :]

    def rand():
        return 0.3 * torch.randn((s, t_len), generator=gen, device=dev)

    return [CF((rand() + 1.5 * torch.cos(ang)).float(),
               (rand() + 1.5 * torch.sin(ang)).float())
            for _ in range(3)], tone_hz


def check_k4(torch, dev, x, n: int, rate: int, tone_hz, label: str,
             exact_ref: bool):
    """Kernel 4 on ``x``: the waterfall (q = wf_group_for(n)), its peaks
    and argmax, and the full PSD (q = 1, through ``spectrum_wide`` as the
    CLI runs it) with its peak at the tone. The limits: waterfall within
    2e-3 dB, peaks within 1e-3 dB, the full PSD within PSD_DB_TOL at or
    above the floor and PSD_AMP_TOL of the RMS amplitude (see
    :func:`psd_errors`); held against the plain version, or with
    ``exact_ref`` (above one CTA's n1, where the plain version's dense
    DFT strays further from the truth than the kernel's FFT) against a
    float64 FFT of the same windowed blocks. The argmax equals the plain
    version's either way. Returns (k4 = (wf, mx, idx), errors: "plain"
    (wf, peak, full-PSD triple) against the plain version, "k64" and
    "p64" (wf, peak, full-PSD triple) of the kernel and of the plain
    version against float64)."""
    from jsdr_tpu_torch.ops.spectrum import spectrum_wide
    from jsdr_tpu_torch.ops.spectrum_fused import (spectrum_waterfall,
                                                   spectrum_wf_ref,
                                                   wf_group_for)
    from jsdr_tpu_torch.ops.windows import hamming

    s, q = x.shape[0], wf_group_for(n)
    k4 = spectrum_waterfall(x, n)
    p4 = spectrum_wf_ref(x, n, True, q)
    full = spectrum_wide(x, n, rate, natural=False)
    pf = spectrum_wf_ref(x, n, True, 1)
    need(torch.equal(k4[2], p4[2]), f"spectrum_waterfall {label}: argmax "
         "differs from plain")
    need(torch.equal(full.peak_freq, tone_hz.round().int()[:, None]
                     .expand_as(full.peak_freq)),
         f"spectrum_wide {label}: peaks are not at the tones")
    z = torch.complex(x.re.double(), x.im.double()).view(s, -1, n)
    truth = 10.0 * torch.log10(torch.clamp_min(torch.fft.fft(
        z * hamming(n, device=dev).double()).abs().square()
        * (2.0 / n) ** 2, 1e-30))
    del z
    truth = truth.view(s, -1, 128, n // 128).permute(1, 0, 3, 2)
    t_wf = truth.reshape(*truth.shape[:2], n // 128 // q, q, 128).amax(dim=3)
    t_mx = truth.flatten(2).amax(dim=2)

    def errs(wf, mx, psd, wf_ref, mx_ref, psd_ref):
        return (float((wf - wf_ref).abs().max()),
                float((mx - mx_ref).abs().max()),
                psd_errors(torch, psd, psd_ref))

    e = {"plain": errs(k4[0], k4[1], full.psd, p4[0], p4[1], pf[0]),
         "k64": errs(k4[0].double(), k4[1].double(), full.psd, t_wf, t_mx,
                     truth),
         "p64": errs(p4[0].double(), p4[1].double(), pf[0], t_wf, t_mx,
                     truth)}
    held = e["k64" if exact_ref else "plain"]
    against = "a float64 FFT" if exact_ref else "plain"
    need(held[0] <= 2e-3 and held[1] <= 1e-3,
         f"spectrum_waterfall {label}: wf {held[0]} dB (limit 2e-3), peak "
         f"{held[1]} dB (limit 1e-3) against {against}")
    need(held[2][0] <= PSD_DB_TOL and held[2][1] <= PSD_AMP_TOL,
         f"spectrum_wide {label}: full PSD {held[2][0]} dB at or above the "
         f"floor (limit {PSD_DB_TOL}), amplitude {held[2][1]} of the "
         f"block's RMS (limit {PSD_AMP_TOL}) against {against}")
    need(float((full.peak_db.T - k4[1]).abs().max()) == 0.0,
         f"spectrum_wide {label}: q = 1 and q = {q} peaks differ")
    return k4, e


def time_spectrum(torch, dev, inputs, n: int, q: int, with_k3: bool):
    """Device ms of kernel 4, its plain version, torch.fft.fft over the
    same windowed blocks (the library call for the DFT part) and, with
    ``with_k3``, kernel 3 and its plain version (None without)."""
    from jsdr_tpu_torch.ops.spectrum_front import (spectrum_front_fused,
                                                   spectrum_front_ref)
    from jsdr_tpu_torch.ops.spectrum_fused import (spectrum_waterfall,
                                                   spectrum_wf_ref)
    from jsdr_tpu_torch.ops.windows import hamming

    ms3 = plain3 = None
    if with_k3:
        ms3 = time_ms(torch, spectrum_front_fused, inputs, 10)
        plain3 = time_ms(torch, spectrum_front_ref, inputs, 3)
    xs = [(i[0], n) for i in inputs]
    ms4 = time_ms(torch, lambda x_, n_: spectrum_waterfall(x_, n_), xs, 10)
    plain4 = time_ms(torch, lambda x_, n_: spectrum_wf_ref(x_, n_, True, q),
                     xs, 3)
    win = hamming(n, device=dev)
    s = inputs[0][0].shape[0]
    blocks = [(torch.complex(x.re.view(s, -1, n) * win,
                             x.im.view(s, -1, n) * win),) for x, _ in xs]
    fft_ms = time_ms(torch, lambda z: torch.fft.fft(z).real, blocks, 10)
    return ms3, plain3, ms4, plain4, fft_ms


def decimation_for(n: int, rate: int) -> int:
    """The front end's decimation m for kernel 3 at ``rate``: rate // 9600
    (the telemetry chain's rule), or the largest divisor of n below it
    where n is not a multiple (kernel 3 decimates whole FFT blocks)."""
    return max(d for d in range(1, rate // 9600 + 1) if n % d == 0)


def phase_spectrum_kernels(torch, np, dev, tag):
    """Phase 7: kernels 3 (merged spectrum + front end) and 4 (waterfall
    spectrum) on tones over a noise floor (SPEC_CASES), and kernel 4 alone
    at one CTA's largest n1 (K4_STREAMS x 1 s at n1 = ONE_CTA_MAX_N1):
    against their plain versions, or above one CTA's n1 (the 4-CTA
    cluster: n1 = 245, 300, 512) against a float64 FFT with the plain
    version's own error beside (see :func:`check_k4`); kernel 3 against
    kernel 4 (wf, mx, idx) and kernel 1 (ds, tail), bit for bit, at every
    shape. At n1 = 75 and 150 the cluster path, forced, must equal the
    one-CTA kernels bit for bit. The merged kernel's static shared memory
    must be what ``ONE_CTA_MAX_N1`` was derived from. Times of both
    kernels, their plain versions, and torch.fft.fft over the same
    windowed blocks. Returns the kernels' rows at the main paths' shapes."""
    from jsdr_tpu_torch.demod.bpsk import (DS_FILTER, HOWARD_FUDGE_FACTOR,
                                           NU_SCALE, _nco_pattern,
                                           tunings_to_nu)
    from jsdr_tpu_torch.ops.cplx import CF
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.spectrum_front import (spectrum_front_fused,
                                                   spectrum_front_ref,
                                                   static_smem_bytes)
    from jsdr_tpu_torch.ops.spectrum_fused import (CLUSTER, ONE_CTA_MAX_N1,
                                                   STATIC_SMEM, cuda_ranks,
                                                   spectrum_fused,
                                                   spectrum_waterfall,
                                                   wf_group_for)

    for ranks in (1, CLUSTER):
        static = static_smem_bytes(ranks)
        need(static <= STATIC_SMEM, f"spec_front_kernel<{ranks}> has {static} "
             f"bytes of static shared memory; ONE_CTA_MAX_N1 = "
             f"{ONE_CTA_MAX_N1} assumed {STATIC_SMEM}")
        print(f"spectrum kernels: {static} bytes of static shared memory in "
              f"the merged kernel at {ranks} CTA(s) a block (<= "
              f"{STATIC_SMEM}); ONE_CTA_MAX_N1 = {ONE_CTA_MAX_N1}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    taps = torch.as_tensor(DS_FILTER, dtype=torch.float32, device=dev)
    worst = {"k3": 0.0, "k4": 0.0}
    rows = {}
    cluster_done = set()
    k4_rate = ONE_CTA_MAX_N1 * 1280                     # n = rate / 10
    cases = [(c, True) for c in SPEC_CASES] + [
        ((K4_STREAMS, k4_rate, k4_rate), False)]
    for (s, t_len, rate), with_k3 in cases:
        n = rate // 10
        n1, m, q = n // 128, decimation_for(n, rate), wf_group_for(n)
        ranks = cuda_ranks(n)
        exact_ref = ranks > 1
        tun = (rate // 128) * (8 + np.arange(s) % 21)   # 128-periodic mixes
        tu = torch.as_tensor(tunings_to_nu(tun), dtype=torch.int64,
                             device=dev)
        nu0 = torch.randint(0, NU_SCALE * rate, (s,), generator=gen,
                            device=dev).float()
        cos_pat, sin_pat = _nco_pattern(nu0, tu, rate)
        xs, tone_hz = spec_inputs(torch, np, dev, gen, s, t_len, rate)
        inputs = [(x, n, cos_pat, sin_pat, taps, m,
                   CF(torch.randn((s, 26), generator=gen, device=dev),
                      torch.randn((s, 26), generator=gen, device=dev)),
                   HOWARD_FUDGE_FACTOR) for x in xs]
        x, tail = inputs[0][0], inputs[0][6]
        label = (f"S={s} T={t_len} rate={rate} (n={n}, n1={n1}, q={q}, "
                 f"{ranks} CTA(s) a block")
        label += f", m={m})" if with_k3 else ", kernel 4 alone)"
        k4, e = check_k4(torch, dev, x, n, rate, tone_hz, label, exact_ref)
        # the argmax is the tone: natural bin of idx at the tone's bin
        k_nat = n1 * (k4[2].long() % 128) + k4[2].long() // 128
        want_bin = (torch.round(tone_hz * n / rate).long() % n)[None, :]
        need(torch.equal(k_nat, want_bin.expand_as(k_nat)),
             f"{label}: the peak is not at the tone")
        held = "float64" if exact_ref else "plain"
        line = (f"[limits held against {held}] kernel 4 against plain: wf "
                f"{e['plain'][0]:.3e} dB, peak {e['plain'][1]:.3e} dB, full "
                f"PSD (q=1) {e['plain'][2][0]:.3e} dB at or above the floor, "
                f"{e['plain'][2][2]:.3e} dB anywhere, amplitude "
                f"{e['plain'][2][1]:.3e} of the block's RMS; against float64, "
                f"kernel wf {e['k64'][0]:.3e} dB, peak {e['k64'][1]:.3e} dB, "
                f"PSD {e['k64'][2][0]:.3e}/{e['k64'][2][2]:.3e} dB, "
                f"{e['k64'][2][1]:.3e} amp.; plain wf {e['p64'][0]:.3e} dB, "
                f"peak {e['p64'][1]:.3e} dB, PSD {e['p64'][2][0]:.3e}/"
                f"{e['p64'][2][2]:.3e} dB, {e['p64'][2][1]:.3e} amp.")
        worst["k4"] = max(worst["k4"], e[("k64" if exact_ref else "plain")][0],
                          e["plain"][2][2] if not exact_ref else 0.0)
        if with_k3:
            k3 = spectrum_front_fused(*inputs[0])
            p3 = spectrum_front_ref(*inputs[0])
            k1 = mix_decimate(x, cos_pat, sin_pat, taps, m, tail,
                              HOWARD_FUDGE_FACTOR)
            torch.cuda.synchronize()
            wf_err = float((k3[0] - p3[0]).abs().max())
            mx_err = float((k3[1] - p3[1]).abs().max())
            if not exact_ref:   # above, kernel 4's float64 check holds it
                need(wf_err <= 2e-3, f"spectrum_front_fused {label}: wf "
                     f"|kernel-plain| {wf_err} dB > 2e-3")
                need(mx_err <= 1e-3, f"spectrum_front_fused {label}: peak "
                     f"|kernel-plain| {mx_err} dB > 1e-3")
            need(torch.equal(k3[2], p3[2]),
                 f"spectrum_front_fused {label}: argmax differs from plain")
            scale = max(float(p3[3].re.abs().max()),
                        float(p3[3].im.abs().max()))
            ds_err = max(float((k3[3].re - p3[3].re).abs().max()),
                         float((k3[3].im - p3[3].im).abs().max()))
            need(ds_err <= 1e-5 * scale, f"spectrum_front_fused {label}: ds "
                 f"|kernel-plain| {ds_err} > 1e-5 * {scale}")
            need(torch.equal(k3[4].re, p3[4].re)
                 and torch.equal(k3[4].im, p3[4].im),
                 f"spectrum_front_fused {label}: tails differ from plain")
            need(all(torch.equal(a, b) for a, b in zip(k3[:3], k4)),
                 f"{label}: kernel 3's wf/mx/idx are not kernel 4's")
            need(torch.equal(k3[3].re, k1[0].re)
                 and torch.equal(k3[3].im, k1[0].im)
                 and torch.equal(k3[4].re, k1[1].re)
                 and torch.equal(k3[4].im, k1[1].im),
                 f"{label}: kernel 3's ds/tail are not kernel 1's")
            worst["k3"] = max(worst["k3"],
                              e["k64"][0] if exact_ref else wf_err)
            line = (f"kernel 3: wf |k-p| {wf_err:.3e} dB, peak {mx_err:.3e} "
                    f"dB, argmax equal (the tones), ds |k-p| {ds_err:.3e} "
                    f"(<= 1e-5 x {scale:.3e}); kernel 3 == kernel 4 (wf, mx, "
                    f"idx) and == kernel 1 (ds, tail), bit for bit; " + line)
            if n1 in CLUSTER_CHECK_N1 and n1 not in cluster_done:
                cluster_done.add(n1)
                c4 = spectrum_waterfall(x, n, cluster=True)
                cf = spectrum_fused(x, n, with_peaks=True, cluster=True)
                of = spectrum_fused(x, n, with_peaks=True)
                c3 = spectrum_front_fused(*inputs[0], cluster=True)
                torch.cuda.synchronize()
                need(all(torch.equal(a, b) for a, b in zip(c4, k4))
                     and all(torch.equal(a, b) for a, b in zip(cf, of))
                     and all(torch.equal(a, b) for a, b in zip(c3[:3], k3[:3]))
                     and all(torch.equal(a.re, b.re) and torch.equal(a.im, b.im)
                             for a, b in zip(c3[3:], k3[3:])),
                     f"{label}: the forced 4-CTA cluster differs from one CTA")
                xs1 = [(i[0], n) for i in inputs]
                ms_c = time_ms(torch, lambda x_, n_: spectrum_waterfall(
                    x_, n_, cluster=True), xs1, 10)
                ms_1 = time_ms(torch, lambda x_, n_: spectrum_waterfall(
                    x_, n_), xs1, 10)
                line += (f"; forced 4-CTA cluster == one CTA (kernels 3 and "
                         f"4, q = 1 and q = {q}), bit for bit: kernel 4 "
                         f"{ms_c:.4f} ms as a cluster, {ms_1:.4f} ms in one "
                         "CTA")
                del c4, cf, of, c3
            del k3, p3, k1
        print(f"{tag} spectrum kernels {label}: {line}")
        del k4
        ms3, plain3, ms4, plain4, fft_ms = time_spectrum(
            torch, dev, inputs, n, q, with_k3)
        f4, b4 = spec_work(s, t_len, n, q)
        f1, b1 = front_work(s, t_len, m)
        bound4 = bound(f4, b4)
        bound3 = bound(f4 + f1, b4 + b1 - 8.0 * s * t_len)
        k3_text = (f"kernel 3 spectrum_front_fused {ms3:.4f} ms (plain "
                   f"{plain3:.4f}, bound {bound3[0]:.4f} by {bound3[1]}); "
                   if with_k3 else "")
        print(f"{tag}   {k3_text}kernel 4 spectrum_waterfall {ms4:.4f} ms "
              f"(plain {plain4:.4f}, bound {bound4[0]:.4f} by {bound4[1]}); "
              f"torch.fft.fft over the windowed blocks {fft_ms:.4f} ms; "
              f"{f4 / ms4 / 1e9:.2f} TFLOP/s in kernel 4 at the FFT's "
              f"5 n log2 n count")
        if (s, t_len) == FLAGSHIP_SHAPE and rate == 96000:
            rows["k3"] = dict(ms=ms3, plain_ms=plain3, bound_ms=bound3[0],
                              bound_by=bound3[1], library_ms=fft_ms)
        if (s, t_len) == MAIN_SHAPE and rate == 96000:
            rows["k4"] = dict(ms=ms4, plain_ms=plain4, bound_ms=bound4[0],
                              bound_by=bound4[1], library_ms=fft_ms)
        del inputs, xs, x, tail
        torch.cuda.empty_cache()
    need(cluster_done == set(CLUSTER_CHECK_N1),
         f"the forced cluster ran at n1 = {sorted(cluster_done)} only")
    rows["k3"]["max_abs_err"] = worst["k3"]
    rows["k4"]["max_abs_err"] = worst["k4"]
    return rows["k3"], rows["k4"]


def phase_flagship(torch, np, dev, rng, tag, k3):
    """Phase 8: the flagship step, ``bpsk_block_batch_spectrum``, over 128
    concurrent demodulator streams at 96 kS/s (tunings 6000..21000 Hz in
    750 Hz steps), one AO-40 frame each at its own offset, 2 chained
    4.8 s blocks (the merged branch: kernel 3 once per step, kernels 4 and
    1 never), one FEC drain per block; every payload must decode exactly
    once, bit-exact. Then one 1 s block through the same entry point (the
    staged branch: kernels 4, 1 and 2 once each), whose waterfall must
    equal the merged kernel's on the same samples. Last, 10 timed and 3
    profiled steps of each branch (:func:`step_times`). Returns the launch
    counts of both counted runs."""
    from jsdr_tpu_torch.demod.bpsk import (BpskConfig,
                                           bpsk_block_batch_spectrum,
                                           bpsk_init_batch)
    from jsdr_tpu_torch.fec.decoder import fec_decode
    from jsdr_tpu_torch.io.sources import synth_bpsk_stream
    from jsdr_tpu_torch.ops.cplx import CF, from_complex
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.spectrum_front import spectrum_front_fused
    from jsdr_tpu_torch.ops.spectrum_fused import spectrum_fused
    from jsdr_tpu_torch.ops.timing_kernel import timing_recover_batch

    counted = (spectrum_front_fused, spectrum_fused, mix_decimate,
               timing_recover_batch)

    def reset():
        for fn in counted:
            fn.launches = 0

    def read():
        return {fn.__name__: fn.launches for fn in counted}

    s, block = FLAGSHIP_SHAPE
    rate, n_blocks, n = 96000, 2, 9600
    tunings = 6000.0 + 750.0 * (np.arange(s) % 21)
    payloads = rng.integers(0, 256, (s, 256), dtype=np.uint8)
    t0 = time.perf_counter()
    iq = np.zeros((s, n_blocks * block), np.complex64)
    frames = []
    for i in range(s):
        sig = synth_bpsk_stream(payloads[i:i + 1], rate=rate,
                                carrier_offset=float(tunings[i]),
                                preamble_bits=200, noise_rms=0.25,
                                seed=1000 + i)
        room = iq.shape[1] - len(sig)
        need(room >= 0, "frame longer than the run")
        off = (i * 7919) % (room + 1)
        iq[i, off:off + len(sig)] = sig
        frames.append((off, off + len(sig)))
    blocks = [from_complex(iq[:, b * block:(b + 1) * block], dev)
              for b in range(n_blocks)]
    torch.cuda.synchronize()
    print(f"flagship: {s} streams x {n_blocks} x {block / rate} s at {rate} "
          f"S/s synthesised and uploaded in {time.perf_counter() - t0:.2f} s")

    cfg = BpskConfig(rate=rate)
    bpsk_block_batch_spectrum(blocks[0], cfg, bpsk_init_batch(cfg, s, dev),
                              tunings)
    torch.cuda.synchronize()                           # warm-up, discarded

    st = bpsk_init_batch(cfg, s, dev)
    step_ms, fec_ms, specs = [], [], []
    decoded = [[] for _ in range(s)]
    failed = 0
    reset()
    for b in range(n_blocks):
        t0 = time.perf_counter()
        spec, out, st = bpsk_block_batch_spectrum(blocks[b], cfg, st,
                                                  tunings)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step_ms.append((t1 - t0) * 1e3)
        specs.append(spec)
        need(tuple(spec.wf.shape) == (block // n, s, 15, 128)
             and bool(torch.isfinite(spec.wf).all())
             and bool(torch.isfinite(out.energies).all()),
             "flagship: non-finite or misshapen output")
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
    merged = read()
    need(merged == {"spectrum_front_fused": n_blocks, "spectrum_fused": 0,
                    "mix_decimate": 0, "timing_recover_batch": n_blocks},
         f"flagship launches {merged}: want kernel 3 and the timing kernel "
         f"once per step, kernels 4 and 1 never")
    bad = [i for i in range(s) if len(decoded[i]) != 1
           or not np.array_equal(decoded[i][0], payloads[i])]
    need(not bad, f"flagship: streams {bad[:10]} did not decode their "
         "payload exactly once")
    need((st.counters.cpu().numpy()[:, 0] == n_blocks * block).all(),
         "flagship: raw counters wrong")
    # the display spectrum sees each frame: FFT blocks wholly inside a
    # frame peak within 700 Hz of its carrier (tuning + 1200 Hz)
    freq = torch.cat([sp.peak_freq for sp in specs], dim=1).cpu().numpy()
    starts = np.arange(freq.shape[1]) * n
    far = 0
    for i, (a, e) in enumerate(frames):
        inside = (starts >= a) & (starts + n <= e)
        far += int((np.abs(freq[i, inside] - (tunings[i] + 1200)) > 700)
                   .sum())
    need(far == 0, f"flagship: {far} FFT blocks inside frames peak away "
         "from the carrier")

    # one 1 s block through the same entry point: the staged branch
    x1 = CF(blocks[0].re[:, :rate].contiguous(),
            blocks[0].im[:, :rate].contiguous())
    reset()
    t0 = time.perf_counter()
    spec1, _out1, st1 = bpsk_block_batch_spectrum(
        x1, cfg, bpsk_init_batch(cfg, s, dev), tunings)
    torch.cuda.synchronize()
    staged_ms = (time.perf_counter() - t0) * 1e3
    staged = read()
    need(staged == {"spectrum_front_fused": 0, "spectrum_fused": 1,
                    "mix_decimate": 1, "timing_recover_batch": 1},
         f"staged 1 s block launches {staged}: want kernels 4, 1 and the "
         "timing kernel once each, kernel 3 never")
    need(torch.equal(spec1.wf, specs[0].wf[:rate // n])
         and torch.equal(spec1.peak_db, specs[0].peak_db[:, :rate // n])
         and torch.equal(spec1.peak_freq, specs[0].peak_freq[:, :rate // n]),
         "staged 1 s block: waterfall differs from the merged kernel's")

    print(f"{tag} flagship: all {s} payloads decoded bit-exact ({failed} "
          f"failed sync hits); bpsk_block_batch_spectrum "
          f"{', '.join(f'{v:.3f}' for v in step_ms)} ms for the {n_blocks} "
          f"decoded steps of {block} samples; FEC drain "
          f"{', '.join(f'{v:.1f}' for v in fec_ms)} ms per block; "
          f"launches {merged}; kernel 3 {k3['ms']:.3f} ms/step (event-timed "
          f"at this shape in phase 7)")
    print(f"{tag} staged 1 s block (S={s}, T={rate}): {staged_ms:.3f} ms, "
          f"launches {staged}; waterfall equal to the merged kernel's")

    # more steps of both branches for their time, spread and split
    state = [st, 0]

    def merged_step():
        state[0] = bpsk_block_batch_spectrum(
            blocks[state[1] % n_blocks], cfg, state[0], tunings)[2]
        state[1] += 1

    mean = step_times(torch, merged_step, 10, 3, tag,
                      f"flagship step bpsk_block_batch_spectrum S={s} "
                      f"T={block}")
    print(f"{tag} flagship: {s * block / mean / 1e3:.1f} MS/s at the mean")
    xs1 = [x1, CF(blocks[1].re[:, :rate].contiguous(),
                  blocks[1].im[:, :rate].contiguous())]
    state = [st1, 0]

    def staged_step():
        state[0] = bpsk_block_batch_spectrum(xs1[state[1] % 2], cfg,
                                             state[0], tunings)[2]
        state[1] += 1

    step_times(torch, staged_step, 10, 3, tag,
               f"staged step bpsk_block_batch_spectrum S={s} T={rate}")
    return {"spectrum_front_fused": merged["spectrum_front_fused"],
            "spectrum_fused": staged["spectrum_fused"]}


def phase_psd_waterfall(torch, np, dev, tag):
    """Phase 9: kernel 5 (PSD + 8-bit waterfall line) against its plain
    version, bit for bit (both round every product and sum in the same
    order and take log10f), at PSD_CASES: the Session's shapes (one 1 s
    block of 0.1 s spectra at 96 k and at 192 k), 128 streams' 1 s of
    blocks (for a time and a bound at scale), an odd width, unaligned rows
    and groups larger than a CTA's slab. Times it (event time back to
    back, and its device time alone, :func:`device_ms`). Returns the row
    at the Session's shape (10 x 9600, width 960)."""
    from jsdr_tpu_torch.ops.cplx import CF
    from jsdr_tpu_torch.ops.psd_waterfall import (psd_waterfall,
                                                  psd_waterfall_ref)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    row = None
    for b, n, width in PSD_CASES:
        # spectra of a noise floor with a strong bin per row, and some
        # bins far below the floor (clipped to intensity 0)
        def spectrum():
            x = CF(40.0 * torch.randn((b, n), generator=gen, device=dev),
                   40.0 * torch.randn((b, n), generator=gen, device=dev))
            x.re[:, n // 7] = 3e4
            x.re[:, 5::97] *= 1e-7
            x.im[:, 5::97] *= 1e-7
            return x
        inputs = [(spectrum(), width) for _ in range(3)]
        k = psd_waterfall(*inputs[0])
        p = psd_waterfall_ref(*inputs[0])
        torch.cuda.synchronize()
        label = f"B={b} N={n} width={width}"
        need(tuple(k[0].shape) == (b, n) and tuple(k[1].shape) == (b, width)
             and k[1].dtype == torch.uint8
             and bool(torch.isfinite(k[0]).all()),
             f"psd_waterfall {label}: misshapen or non-finite output")
        db_err = float((k[0] - p[0]).abs().max())
        line_diff = int((k[1].int() - p[1].int()).abs().max())
        need(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
             f"psd_waterfall {label}: kernel differs from plain (db "
             f"{db_err} dB, lines {line_diff} counts)")
        ms = time_ms(torch, psd_waterfall, inputs, 20)
        dev_ms = device_ms(torch, psd_waterfall, inputs, 20)
        plain_ms = time_ms(torch, psd_waterfall_ref, inputs, 5)
        # per bin: 2 squares, a sum, the scale, dB scale, max (+ log10f);
        # bytes: the two planes in, db and the line out
        b_ms, b_by = bound(6.0 * b * n, 12.0 * b * n + b * width)
        print(f"{tag} psd_waterfall {label}: db and lines equal to plain "
              f"(bit for bit); kernel {ms:.4f} ms (device time {dev_ms:.4f}"
              f" ms), plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms by "
              f"{b_by}")
        if (b, n, width) == PSD_CASES[0]:
            row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       max_abs_err=db_err)
    return row


def phase_mix_decimate_mf(torch, np, dev, rng, tag):
    """Phase 10: kernel 6 (mix + decimate + VCO mix + matched filter)
    against its plain version (the unfused chain: mf within 2e-5 of
    max|mf|, fp32 sums in other orders) and against kernel 1 on the same
    input: its ds tail equal to kernel 1's and its mf tail equal to the
    last 64 of [mf tail ++ _vco_mix(kernel 1's output)], bit for bit; and
    two chained half blocks (patterns rolled on by the first half, as the
    demodulator's state advances them) equal to one whole block, bit for
    bit, at MIX_CASES. Times it (event time back to back, and its device
    time alone, :func:`device_ms`) beside the plain version and the
    unfused device chain (kernel 1, the VCO mix, the cuDNN matched
    filter). Returns the row at the main path's shape (128 x 96,000)."""
    from jsdr_tpu_torch.demod.bpsk import (DM_FILTER, DS_FILTER,
                                           HOWARD_FUDGE_FACTOR, NU_SCALE,
                                           _nco_pattern, _vco_mix,
                                           _vco_pattern, tunings_to_nu)
    from jsdr_tpu_torch.ops.cplx import CF
    from jsdr_tpu_torch.ops.fir import fir_apply_streaming
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.mix_decimate_mf import (mix_decimate_mf,
                                                    mix_decimate_mf_ref)

    taps = torch.as_tensor(DS_FILTER, dtype=torch.float32, device=dev)
    mf_taps = torch.as_tensor(DM_FILTER, dtype=torch.float32, device=dev)
    row, worst = None, 0.0
    for s, t_len, rate in MIX_CASES:
        m = rate // 9600

        def rand(*shape):
            return torch.as_tensor(rng.standard_normal(shape, np.float32),
                                   device=dev)

        step = rate // 128                 # pattern mode's tuning step
        tu = torch.as_tensor(tunings_to_nu(step * (8 + np.arange(s) % 21)),
                             dtype=torch.int64, device=dev)
        nu0 = torch.as_tensor(rng.integers(0, NU_SCALE * rate, s),
                              dtype=torch.float32, device=dev)
        cos_pat, sin_pat = _nco_pattern(nu0, tu, rate)
        vco_idx = torch.as_tensor(rng.integers(0, 8, s), dtype=torch.int32,
                                  device=dev)
        vco_cos, vco_sin = _vco_pattern(vco_idx)
        inputs = [(CF(rand(s, t_len), rand(s, t_len)), cos_pat, sin_pat, taps,
                   m, CF(rand(s, 26), rand(s, 26)), vco_cos, vco_sin,
                   mf_taps, CF(rand(s, 64), rand(s, 64)),
                   HOWARD_FUDGE_FACTOR) for _ in range(3)]

        def unfused(x, cp, sp, tp, m_, tail, _vc, _vs, mt, mtail, gain):
            ds, ntail = mix_decimate(x, cp, sp, tp, m_, tail, gain)
            bb, _ = _vco_mix(ds, vco_idx)
            mf, nmtail = fir_apply_streaming(bb, mt, mtail)
            return mf, ntail, nmtail

        a = inputs[0]
        k = mix_decimate_mf(*a)
        p = mix_decimate_mf_ref(*a)
        ds1, tail1 = mix_decimate(*a[:6], HOWARD_FUDGE_FACTOR)
        bb1, _ = _vco_mix(ds1, vco_idx)
        torch.cuda.synchronize()
        label = f"S={s} T={t_len} m={m}"
        need(tuple(k[0].re.shape) == (s, t_len // m)
             and bool(torch.isfinite(k[0].re).all()),
             f"mix_decimate_mf {label}: misshapen or non-finite output")
        scale = max(float(p[0].re.abs().max()), float(p[0].im.abs().max()))
        err = max(float((k[0].re - p[0].re).abs().max()),
                  float((k[0].im - p[0].im).abs().max()))
        need(err <= 2e-5 * scale, f"mix_decimate_mf {label}: max|kernel-"
             f"plain| {err} > 2e-5 * {scale}")
        mt_err = max(float((k[2].re - p[2].re).abs().max()),
                     float((k[2].im - p[2].im).abs().max()))
        need(mt_err <= 2e-5 * scale, f"mix_decimate_mf {label}: mf tail "
             f"|kernel-plain| {mt_err} > 2e-5 * {scale}")
        need(torch.equal(k[1].re, tail1.re) and torch.equal(k[1].im,
                                                            tail1.im),
             f"mix_decimate_mf {label}: ds tail is not kernel 1's")
        want = [torch.cat([a[9].re, bb1.re], dim=1)[:, -64:],
                torch.cat([a[9].im, bb1.im], dim=1)[:, -64:]]
        need(torch.equal(k[2].re, want[0]) and torch.equal(k[2].im, want[1]),
             f"mix_decimate_mf {label}: mf tail is not the VCO mix of "
             "kernel 1's output")
        # two chained half blocks against the whole block
        half, hd = t_len // 2, t_len // 2 // m
        x = a[0]

        def roll(pat, by):
            return torch.roll(pat, -(by % 128), dims=1).contiguous()

        ka = mix_decimate_mf(CF(x.re[:, :half].contiguous(),
                                x.im[:, :half].contiguous()), *a[1:])
        kb = mix_decimate_mf(CF(x.re[:, half:].contiguous(),
                                x.im[:, half:].contiguous()),
                             roll(a[1], half), roll(a[2], half), a[3], m,
                             ka[1], roll(a[6], hd), roll(a[7], hd), a[8],
                             ka[2], a[10])
        torch.cuda.synchronize()
        need(all(torch.equal(torch.cat([getattr(ka[0], c),
                                        getattr(kb[0], c)], dim=1),
                             getattr(k[0], c))
                 and torch.equal(getattr(kb[1], c), getattr(k[1], c))
                 and torch.equal(getattr(kb[2], c), getattr(k[2], c))
                 for c in ("re", "im")),
             f"mix_decimate_mf {label}: two chained half blocks differ from "
             "one whole block")
        del ka, kb
        worst = max(worst, err)
        ms = time_ms(torch, mix_decimate_mf, inputs, 20)
        dev_ms = device_ms(torch, mix_decimate_mf, inputs, 20)
        plain_ms = time_ms(torch, mix_decimate_mf_ref, inputs, 5)
        chain_ms = time_ms(torch, unfused, inputs, 10)
        flops = (2.0 * s * t_len
                 + (2 * 27 * 2 + 2 + 2 * 65 * 2) * s * (t_len / m))
        nbytes = (8.0 * s * t_len + 8.0 * s * (t_len // m)
                  + 4 * 4.0 * s * 128 + 4 * (27 + 65)
                  + 2 * 8.0 * s * (26 + 64))
        b_ms, b_by = bound(flops, nbytes)
        gbs = nbytes / ms / 1e6
        print(f"{tag} mix_decimate_mf {label}: max|k-p| {err:.3e} (<= 2e-5 x "
              f"{scale:.3e}), mf tail {mt_err:.3e}; ds tail == kernel 1's "
              f"and mf tail == VCO mix of kernel 1's output, bit for bit; "
              f"two chained half blocks == one block, bit for bit; kernel "
              f"{ms:.4f} ms ({gbs:.0f} GB/s; device time {dev_ms:.4f} ms, "
              f"{nbytes / dev_ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} "
              f"ms, unfused device chain {chain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}")
        if (s, t_len) == MAIN_SHAPE:
            row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       chain_ms=chain_ms)
        del inputs, k, p, ds1, bb1
        torch.cuda.empty_cache()
    row["max_abs_err"] = worst
    return row


def session_signal(rng, rate: int):
    """One 96 kS/s stream carrying AO-40 frames at SESSION_CARRIERS (each
    from its own payload, starting 0.5 s after the previous one, noise rms
    0.05), as raw S16LE int16 values in 0.1 s chunks (a capture device's
    reads). Returns (chunks, payloads by carrier, blocks)."""
    from jsdr_tpu_torch.io.convert import complex_to_s16le
    from jsdr_tpu_torch.io.sources import synth_bpsk_stream

    payloads = rng.integers(0, 256, (len(SESSION_CARRIERS), 256),
                            dtype=np.uint8)
    sig = np.zeros(SESSION_BLOCKS * rate, np.complex64)
    for i, c in enumerate(SESSION_CARRIERS):
        one = synth_bpsk_stream(payloads[i:i + 1], rate=rate,
                                carrier_offset=c, amplitude=0.25,
                                preamble_bits=200, noise_rms=0.0, seed=i)
        at = i * rate // 2
        need(at + len(one) <= len(sig), "session frames longer than the run")
        sig[at:at + len(one)] += one
    noise = np.random.default_rng(SEED).standard_normal((2, len(sig))) * 0.05
    sig = (sig + noise[0] + 1j * noise[1]).astype(np.complex64)
    raw = np.frombuffer(complex_to_s16le(sig), "<i2")
    chunk = 2 * rate // 10
    return ([raw[i:i + chunk].copy() for i in range(0, len(raw), chunk)],
            dict(zip(SESSION_CARRIERS, payloads)))


def phase_session(torch, np, dev, rng, tag):
    """Phase 11: the streaming Session at a deployment's size: 128
    FUNcube demodulator instances (tunings over the 21 multiples of
    750 Hz from 6000 to 21000 Hz, BpskConfig(fuse_mf=True)) on one
    96 kS/s stream of raw int16 chunks converted on the device, in 1 s
    blocks, beside SpectrumStage(waterfall_width=960); sync_every=4.
    Every instance tuned to a carrier decodes its payload exactly once,
    bit-exact; every good frame carries a sent payload (an instance tuned
    2250 Hz from a carrier may decode it too: the reference's
    non-complex VCO mix answers its image); instances on one tuning
    publish the same frames; no block is dropped and no stage fails; kernels 5, 6 and 2 launch once per block (kernel 1
    never). A checkpoint written after 3 blocks and resumed in a new
    Session ends with the frames, counters and state of the uninterrupted
    run. Then 10 timed and 3 profiled Session blocks of this
    configuration and of the same Session unfused (no fuse_mf, no
    waterfall width). Returns the launch counts of the counted run."""
    import io
    import itertools

    from jsdr_tpu_torch.demod.bpsk import BpskConfig
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.mix_decimate_mf import mix_decimate_mf
    from jsdr_tpu_torch.ops.psd_waterfall import psd_waterfall
    from jsdr_tpu_torch.ops.timing_kernel import timing_recover_batch
    from jsdr_tpu_torch.runtime.executor import (Session, SpectrumStage,
                                                 TelemetryStage)
    from jsdr_tpu_torch.runtime.log import Logger
    from jsdr_tpu_torch.runtime.state import tree_leaves

    rate, s = 96000, MAIN_SHAPE[0]
    tunings = 6000.0 + 750.0 * (np.arange(s) % 21)
    t0 = time.perf_counter()
    chunks, payloads = session_signal(rng, rate)
    print(f"session: one {rate} S/s stream, {SESSION_BLOCKS} s, frames at "
          f"{SESSION_CARRIERS} Hz, {len(chunks)} raw chunks synthesised in "
          f"{time.perf_counter() - t0:.2f} s")
    counted = (psd_waterfall, mix_decimate_mf, timing_recover_batch,
               mix_decimate)
    ck_path = ROOT / "build" / "chip_smoke_session.npz"
    ck_path.parent.mkdir(exist_ok=True)

    def stages(fused=True, sync_every=4):
        cfg = BpskConfig(rate=rate, fuse_mf=fused)
        return [SpectrumStage(rate, waterfall_width=960 if fused else None),
                TelemetryStage(cfg, tunings, sync_every=sync_every,
                               device=dev)]

    def run(source, stg, resume=False, every=0):
        log = io.StringIO()
        session = Session(source=iter(source), block_samples=rate,
                          logger=Logger(stream=log), device=dev,
                          checkpoint_path=ck_path,
                          checkpoint_every_blocks=every,
                          checkpoint_meta={"rate": rate, "n_demods": s,
                                           "mesh": None})
        if resume:
            session.load_checkpoint(stg)
        got = {"telemetry-frame": [], "waterfall-line": [], "fft-psd": []}
        session.pubsub.listen(lambda t, v: got[t].append(v) if t in got
                              else None)
        n = session.run(stg)
        need(session.dropped_blocks == {},
             f"session dropped blocks: {session.dropped_blocks}")
        need("failed" not in log.getvalue(),
             f"a session stage failed: {log.getvalue()[:400]}")
        frames = [(f["demod"], f["ok"], f["corr"], f["channel_errors"],
                   f["payload"].tobytes()) for f in got["telemetry-frame"]]
        return n, frames, got

    # the counted main-path run
    stg = stages()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    n, frames, got = run(chunks, stg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    need(n == SESSION_BLOCKS, f"session ran {n} blocks")
    need(launches == {"psd_waterfall": n, "mix_decimate_mf": n,
                      "timing_recover_batch": n, "mix_decimate": 0},
         f"session launches {launches}: want kernels 5, 6 and 2 once per "
         "block, kernel 1 never")
    ok = [f for f in frames if f[1]]
    tuned = [i for i in range(s) if tunings[i] in payloads]
    by_inst = {i: [f[1:] for f in frames if f[0] == i] for i in range(s)}
    need(all([g[0] for g in by_inst[i] if g[0]] == [True]
             and [g[3] for g in by_inst[i] if g[0]]
             == [payloads[tunings[i]].tobytes()] for i in tuned),
         "an instance tuned to a carrier did not decode its payload exactly "
         "once")
    sent = {p.tobytes() for p in payloads.values()}
    need(all(f[4] in sent for f in ok), "a good frame carries a payload "
         "that was not sent")
    # instances on one tuning see the same input from the same state
    need(all(by_inst[i] == by_inst[i % 21] for i in range(s)),
         "instances with the same tuning published different frames")
    images = sorted({float(tunings[f[0]]) for f in ok} - set(payloads))
    lines, psd = got["waterfall-line"], got["fft-psd"]
    need(len(lines) == n and all(x.shape == (10, 960) and x.dtype == np.uint8
                                 for x in lines)
         and all(x.shape == (10, 9600) and np.isfinite(x).all()
                 for x in psd), "session: waterfall lines or PSDs misshapen")
    counters = stg[1].state.counters.cpu().numpy()
    need((counters[:, 0] == n * rate).all() and (counters[:, 1] == n * rate
                                                 // 10).all(),
         "session: raw/ds counters wrong")
    print(f"{tag} session: {n} blocks, {len(tuned)} instances tuned to a "
          f"carrier each decoded its payload bit-exact ({len(frames)} frames "
          f"published, {len(ok)} good; instances at {images} Hz also "
          f"decoded a sent payload); launches {launches}; no block "
          f"dropped; {wall:.2f} s wall with FEC drains")

    # checkpoint after 3 blocks, resume in a new Session
    k = 3 * 10
    ck_path.unlink(missing_ok=True)
    n1, frames1, _ = run(chunks[:k], stages(), every=3)
    need(n1 == 3 and ck_path.exists(), "session: no checkpoint written")
    resumed = stages()
    n2, frames2, _ = run(chunks[k:], resumed, resume=True)
    need(frames1 + frames2 == frames,
         "resumed session: frames differ from the uninterrupted run")
    need(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(resumed[1].state), tree_leaves(stg[1].state))),
         "resumed session: state differs from the uninterrupted run")
    print(f"{tag} session checkpoint: written after {n1} blocks, resumed for "
          f"{n2} more; frames, counters and state equal to the "
          "uninterrupted run")

    # Session blocks timed on the host clock (each ends in a synchronise,
    # at the 'audio-frame' mark the Session publishes after every block)
    # and profiled; no drain inside the window
    means = {}
    for fused in (True, False):
        stg = stages(fused, sync_every=10 ** 6)
        marks = []
        prof = profiler(torch)

        def on_block(topic, _n):
            if topic != "audio-frame":
                return
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if len(marks) == 11:
                prof.start()
            elif len(marks) == 14:
                prof.stop()

        session = Session(source=itertools.cycle(chunks), block_samples=rate,
                          device=dev)
        session.pubsub.listen(on_block)
        session.run(stg, max_blocks=14)
        wall = list(np.diff(marks[:11]) * 1e3)
        what = ("session block, fused (SpectrumStage waterfall 960 + "
                "TelemetryStage fuse_mf)" if fused else
                "session block, unfused (SpectrumStage + TelemetryStage)")
        means[fused] = report_steps(torch, wall, prof, 3, tag,
                                    f"{what}, {s} instances, T={rate}")
    print(f"{tag} session: fused {means[True]:.3f} ms/block, unfused "
          f"{means[False]:.3f} ms/block (host clock, same call)")
    return launches


def decode_run(torch, np, dev, step, blocks, payloads, what: str):
    """Run ``step(block)`` -> (out, ...) over ``blocks`` with one batched
    FEC drain per block; every stream must decode its payload exactly once,
    bit-exact. Returns (host step ms, drain ms, the outputs)."""
    from jsdr_tpu_torch.fec.decoder import fec_decode

    s = len(payloads)
    decoded = [[] for _ in range(s)]
    step_ms, fec_ms, outs = [], [], []
    for x in blocks:
        t0 = time.perf_counter()
        out = step(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step_ms.append((t1 - t0) * 1e3)
        need(bool(torch.isfinite(out.energies).all()),
             f"{what}: non-finite energies")
        hit = (torch.arange(out.windows.shape[1], device=dev)[None, :]
               < out.n_hits[:, None])
        stream_of = torch.nonzero(hit)[:, 0].cpu().numpy()
        if len(stream_of):
            res = fec_decode(out.windows[hit])
            ok = res.ok.cpu().numpy()
            pay = res.payload.cpu().numpy()
            for j, si in enumerate(stream_of):
                if ok[j]:
                    decoded[si].append(pay[j])
        fec_ms.append((time.perf_counter() - t1) * 1e3)
        outs.append(out)
    bad = [i for i in range(s) if len(decoded[i]) != 1
           or not np.array_equal(decoded[i][0], payloads[i])]
    need(not bad, f"{what}: streams {bad[:10]} did not decode their payload "
         "exactly once")
    return step_ms, fec_ms, outs


def phase_tuning_modes(torch, np, dev, rng, tag):
    """Phase 12: every tuning mode of the front end at a deployment's size
    (96 kS/s, 1 s blocks, 5 chained, one batched FEC drain per block; every
    payload bit-exact): the general mode (128 streams at 21 tunings that
    are multiples of 0.1 Hz but not of 750 Hz: no kernel 1, the timing
    kernel once a block), the static mode (8 streams at sub-0.1 Hz
    tunings), the FFT auto-tuner (128 streams, DOFFT_STREAMS 8 times:
    kernel 1, then with ``fuse_mf`` kernel 6, once a block; centre bins
    near each carrier; the first 8 streams through the port on the CPU
    give the same decisions and centre bins), mixed (64 pattern + 64
    auto-tuned streams in one call), and one staged spectrum step of the
    auto-tuned deployment (kernel 4; its waterfall the pattern-mode
    step's, bit for bit). Then 10 timed and 3 profiled steps each of the
    general and the auto-tuned step, and the device busy, launches and
    event times of the general and auto-tuned front ends and of the tuner
    alone, and whether each (and a pattern-mode step) makes the host wait
    for the card."""
    from jsdr_tpu_torch.demod.bpsk import (DS_FILTER as DS_TAPS,
                                           HOWARD_FUDGE_FACTOR as GAIN,
                                           BpskConfig, _tuner_full_mix,
                                           bpsk_block_batch,
                                           bpsk_block_batch_spectrum,
                                           bpsk_init_batch, mix_mode_for)
    from jsdr_tpu_torch.demod.fft_tuner import fft_tuner_blocks
    from jsdr_tpu_torch.ops.fir import polyphase_decimate
    from jsdr_tpu_torch.io.sources import synth_bpsk_stream
    from jsdr_tpu_torch.ops.cplx import CF, from_complex
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.mix_decimate_mf import mix_decimate_mf
    from jsdr_tpu_torch.ops.spectrum_front import spectrum_front_fused
    from jsdr_tpu_torch.ops.spectrum_fused import spectrum_fused
    from jsdr_tpu_torch.ops.timing_kernel import timing_recover_batch

    counted = (mix_decimate, mix_decimate_mf, timing_recover_batch,
               spectrum_fused, spectrum_front_fused)

    def reset():
        for fn in counted:
            fn.launches = 0

    def read():
        return {fn.__name__: fn.launches for fn in counted}

    def want(**k):
        return {fn.__name__: k.get(fn.__name__, 0) for fn in counted}

    s, rate = MAIN_SHAPE
    n_blocks = 5

    def manual_signals(tunings, seed0):
        pays = rng.integers(0, 256, (len(tunings), 256), dtype=np.uint8)
        iq = np.zeros((len(tunings), n_blocks * rate), np.complex64)
        for i, tu in enumerate(tunings):
            sig = synth_bpsk_stream(pays[i:i + 1], rate=rate,
                                    carrier_offset=float(tu),
                                    preamble_bits=200, noise_rms=0.25,
                                    seed=seed0 + i)
            need(len(sig) <= iq.shape[1], "frame longer than the run")
            iq[i, :len(sig)] = sig
        return iq, pays

    def upload(iq):
        return [from_complex(iq[:, b * rate:(b + 1) * rate], dev)
                for b in range(n_blocks)]

    def counted_run(cfg, iq, pays, tunings, what, **kw):
        """Warm up on block 0, then the counted, decoded run from a fresh
        state; returns (launches, step ms, drain ms, outs, state)."""
        blocks = upload(iq)
        bpsk_block_batch(blocks[0], cfg, bpsk_init_batch(cfg, len(iq), dev),
                         tunings, **kw)
        torch.cuda.synchronize()
        st = [bpsk_init_batch(cfg, len(iq), dev)]

        def step(x):
            out, st[0] = bpsk_block_batch(x, cfg, st[0], tunings, **kw)
            return out

        reset()
        step_ms, fec_ms, outs = decode_run(torch, np, dev, step, blocks,
                                           pays, what)
        launches = read()
        need((st[0].counters.cpu().numpy()[:, 0] == n_blocks * rate).all(),
             f"{what}: raw counters wrong")
        print(f"{tag} {what}: all {len(iq)} payloads decoded bit-exact; "
              f"bpsk_block_batch {', '.join(f'{v:.3f}' for v in step_ms)} ms "
              f"per block; FEC drain {', '.join(f'{v:.1f}' for v in fec_ms)} "
              f"ms per block; launches {launches}")
        return launches, outs, st[0], blocks

    # ---- general: 21 tunings, multiples of 0.1 Hz but not of 750 Hz
    tun_g = 6000.0 + 750.0 * (np.arange(s) % 21) + 123.4
    need(mix_mode_for(tun_g, rate, np.zeros(s, bool)) == "general",
         "general tunings classified as another mode")
    iq, pays = manual_signals(tun_g, 3000)
    cfg = BpskConfig(rate=rate)
    launches, _outs, st_g, blocks_g = counted_run(
        cfg, iq, pays, tun_g, f"general mode ({s} streams)")
    need(launches == want(timing_recover_batch=n_blocks),
         f"general launches {launches}: want the timing kernel once a "
         "block and no front-end kernel")

    # ---- static: sub-0.1 Hz tunings
    tun_s = 6000.05 + 1500.0 * np.arange(8) + 0.01 * np.arange(8)
    need(mix_mode_for(tun_s, rate, np.zeros(8, bool)) == "static",
         "static tunings classified as another mode")
    iq, pays = manual_signals(tun_s, 4000)
    launches, *_ = counted_run(cfg, iq, pays, tun_s, "static mode (8 streams)")
    need(launches == want(timing_recover_batch=n_blocks),
         f"static launches {launches}")

    # ---- dofft: DOFFT_STREAMS (each decoded by the JAX package in
    # tests/test_torch_tuner.py) 8 times over, unfused then fused
    iq16, pay16 = dofft_signals(rate, n_blocks)
    reps = s // len(iq16)
    iq_d, pays_d = np.tile(iq16, (reps, 1)), np.tile(pay16, (reps, 1))
    carriers = np.tile([c for c, _ in DOFFT_STREAMS], reps)
    tun_d = np.zeros(s)
    runs = {}
    for fuse in (False, True):
        cfg_d = BpskConfig(rate=rate, dofft=True, fuse_mf=fuse)
        what = f"dofft ({s} streams{', fuse_mf' if fuse else ''})"
        launches, outs, st_d, blocks_d = counted_run(cfg_d, iq_d, pays_d,
                                                     tun_d, what)
        kern = "mix_decimate_mf" if fuse else "mix_decimate"
        need(launches == want(timing_recover_batch=n_blocks,
                              **{kern: n_blocks}),
             f"{what} launches {launches}: want {kern} and the timing "
             "kernel once a block")
        centres = st_d.fft_tuner.centre_bin.cpu().numpy()
        off = np.abs(centres - (carriers + 1200) / 10)
        need((off <= 15).all(), f"{what}: centre bins {centres[off > 15]} "
             "more than 15 bins from their carrier")
        bits = [o.bits.cpu().numpy() for o in outs]
        need(all((b[:len(iq16)] == b[k * len(iq16):(k + 1) * len(iq16)])
                 .all() for b in bits for k in range(reps)),
             f"{what}: replicas of one input gave different bits")
        runs[fuse] = (outs, st_d)
        print(f"{tag} {what}: centre bins {centres[:len(iq16)].tolist()} "
              f"(carrier + 1200 Hz over 10 Hz: "
              f"{((carriers[:len(iq16)] + 1200) / 10).tolist()})")
    # the first 8 streams through the port on the CPU
    cfg_d = BpskConfig(rate=rate, dofft=True)
    st_c = bpsk_init_batch(cfg_d, 8, "cpu")
    outs_u, st_u = runs[False]
    for b in range(n_blocks):
        x = CF(blocks_d[b].re[:8].cpu(), blocks_d[b].im[:8].cpu())
        out_c, st_c = bpsk_block_batch(x, cfg_d, st_c, tun_d[:8])
        for name in ("bits", "n_bits", "n_hits", "hit_corr"):
            need(torch.equal(getattr(out_c, name),
                             getattr(outs_u[b], name)[:8].cpu()),
                 f"dofft: the CPU's {name} differ from the card's in block "
                 f"{b}")
    need(torch.equal(st_c.fft_tuner.centre_bin,
                     st_u.fft_tuner.centre_bin[:8].cpu()),
         "dofft: the CPU's centre bins differ from the card's")
    print(f"{tag} dofft: the first 8 streams on the CPU gave the card's "
          f"bits, hits and centre bins in all {n_blocks} blocks")

    # ---- mixed: 64 pattern-mode streams + 64 auto-tuned in one call
    half = s // 2
    tun_p = 6000.0 + 750.0 * (np.arange(half) % 21)
    iq_p, pays_p = manual_signals(tun_p, 5000)
    iq_m = np.concatenate([iq_p, iq_d[:half]])
    pays_m = np.concatenate([pays_p, pays_d[:half]])
    tun_m = np.concatenate([tun_p, np.zeros(half)])
    flags = np.arange(s) >= half
    need(mix_mode_for(tun_m, rate, flags) == "mixed:pattern",
         "mixed set classified as another mode")
    launches, _outs, st_m, _b = counted_run(
        cfg, iq_m, pays_m, tun_m, f"mixed:pattern ({half} + {half} streams)",
        dofft=flags)
    need(launches == want(timing_recover_batch=n_blocks,
                          mix_decimate=2 * n_blocks),
         f"mixed launches {launches}: want kernel 1 twice (both front ends) "
         "and the timing kernel once a block")
    need((st_m.fft_tuner.centre_bin[:half] == 0).all().item(),
         "mixed: a manual stream's tuner state advanced")

    # ---- the staged spectrum step of the auto-tuned deployment
    x1 = blocks_d[1]
    reset()
    spec_d, _o, _s = bpsk_block_batch_spectrum(
        x1, BpskConfig(rate=rate, dofft=True), bpsk_init_batch(cfg, s, dev),
        tun_d)
    torch.cuda.synchronize()
    staged = read()
    need(staged == want(spectrum_fused=1, mix_decimate=1,
                        timing_recover_batch=1),
         f"dofft staged spectrum step launches {staged}: want kernels 4, 1 "
         "and the timing kernel once each")
    spec_p, _o, _s = bpsk_block_batch_spectrum(
        x1, cfg, bpsk_init_batch(cfg, s, dev), np.full(s, 12000.0))
    need(all(torch.equal(getattr(spec_d, k), getattr(spec_p, k))
             for k in ("wf", "peak_db", "peak_freq")),
         "dofft staged spectrum step: waterfall differs from pattern mode's")
    print(f"{tag} dofft staged spectrum step (S={s}, T={rate}): launches "
          f"{staged}; waterfall equal to the pattern-mode step's")

    # ---- step times: general and dofft
    for what, cfg_t, st0, blocks, tunings in (
            ("general", cfg, st_g, blocks_g, tun_g),
            ("dofft", BpskConfig(rate=rate, dofft=True), runs[False][1],
             blocks_d, tun_d)):
        state = [st0, 0]

        def step():
            state[0] = bpsk_block_batch(blocks[state[1] % n_blocks], cfg_t,
                                        state[0], tunings)[1]
            state[1] += 1

        step_times(torch, step, 10, 3, tag,
                   f"{what} step bpsk_block_batch S={s} T={rate}")

    # the new front ends alone, on tensors already on the card: device busy
    # and launches a call from torch.profiler, event time back to back,
    # and whether a call makes the host wait for the card (a sleep kernel
    # enqueued before it has ended when it returns)
    high = torch.zeros(s, dtype=torch.bool, device=dev)
    samples = rate // 10
    m = rate // 9600
    st_d = runs[False][1]
    tu_g = torch.as_tensor(np.round(tun_g * 10).astype(np.int64), device=dev)
    taps = torch.as_tensor(DS_TAPS, dtype=torch.float32, device=dev)
    ones = torch.ones((s, 128), dtype=torch.float32, device=dev)

    def general_front(x):
        mixed, _nu = _tuner_full_mix(x, st_g.tu_phase, tu_g, rate)
        return polyphase_decimate(mixed, taps, m, st_g.ds_tail, gain=GAIN)

    def tuner(x):
        return fft_tuner_blocks(CF(x.re.reshape(s, -1, samples),
                                   x.im.reshape(s, -1, samples)),
                                st_d.fft_tuner, high)

    def dofft_front(x):
        return mix_decimate(tuner(x)[0], ones, ones, taps, m, st_d.ds_tail,
                            GAIN)

    fronts = (
        ("general front end (numerator mix + decimator)", general_front,
         blocks_g),
        ("FFT auto-tuner (fft_tuner_blocks)", tuner, blocks_d),
        ("dofft front end (tuner + kernel 1)", dofft_front, blocks_d))
    for what, fn, blocks in fronts:
        inputs = [(x,) for x in blocks[:3]]
        fn(*inputs[-1])
        torch.cuda.synchronize()
        with profiler(torch) as prof:
            for i in range(5):
                fn(*inputs[i % 3])
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / 5
        ev_ms = time_ms(torch, fn, inputs, 5)
        print(f"{tag} {what}, S={s} T={rate}: {busy:.4f} ms device busy "
              f"and {len(kern) / 5:.0f} launches a call (profiled), "
              f"{ev_ms:.4f} ms event-timed back to back; waits for the "
              f"card: {waits_for_card(torch, fn, inputs[0])}")
    state = [st_g]

    def pattern_step(x):
        state[0] = bpsk_block_batch(x, cfg, state[0], np.full(s, 12000.0))[1]
        return state[0].tu_phase

    print(f"{tag} a pattern-mode bpsk_block_batch step waits for the card: "
          f"{waits_for_card(torch, pattern_step, (blocks_g[0],))}")


def waits_for_card(torch, fn, args) -> bool:
    """Whether ``fn(*args)`` returns only after work enqueued before it has
    finished: a ~0.2 s sleep kernel, then an event, then the call; the
    event has completed when the call returns only if the call waited."""
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    mark = torch.cuda.Event()
    mark.record()
    fn(*args)
    waited = mark.query()
    torch.cuda.synchronize()
    return waited

def kernel_wrappers():
    """The six kernel wrappers of the port (each counts its launches)."""
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.mix_decimate_mf import mix_decimate_mf
    from jsdr_tpu_torch.ops.psd_waterfall import psd_waterfall
    from jsdr_tpu_torch.ops.spectrum_front import spectrum_front_fused
    from jsdr_tpu_torch.ops.spectrum_fused import spectrum_fused
    from jsdr_tpu_torch.ops.timing_kernel import timing_recover_batch

    return (mix_decimate, timing_recover_batch, spectrum_front_fused,
            spectrum_fused, psd_waterfall, mix_decimate_mf)


def check_demod_state(torch, got, want, what: str) -> None:
    """An AmFmState against another: the FIR tail bit for bit, the carried
    phase within 1e-5 rad (as an angle), last_iq within 1e-5."""
    need(torch.equal(got.fir_tail.re, want.fir_tail.re)
         and torch.equal(got.fir_tail.im, want.fir_tail.im),
         f"{what}: FIR tails differ")
    d = (got.car - want.car).abs()
    need(float(torch.minimum(d, 2 * np.pi - d).max()) <= 1e-5,
         f"{what}: carried phases differ by more than 1e-5 rad")
    need(float((got.last_iq - want.last_iq).abs().max()) <= 1e-5,
         f"{what}: last_iq differs by more than 1e-5")


def phase_audio_demod(torch, np, dev, tag):
    """Phase 13: the AM/NFM/WFM audio demodulator (``demod/am_fm.py``),
    which runs as torch ops and launches none of the six kernels:

    (a) the JAX package's bench deployment (bench.py:409-412): 64 WFM
    streams x 960,000 samples (10 s at 96 kS/s), 21-tap band-pass at
    +-20 kHz, down-shift, discriminator and AGC, on seeded noise made on
    the card; 3 chained blocks, the first 2 streams recomputed on the CPU
    by the same functions (audio within 2e-5 after AGC, max within 1e-5
    relative, state as ``check_demod_state``); 10 timed and 3 profiled
    steps on the next input each, event time back to back ending with a
    value read, MS/s, beside the byte bound (input read + audio written);
    whether a step makes the host wait for the card (it must not);
    (b) the known answers of tests/test_demod.py on the card: AM's 1 kHz
    envelope and mean 0.4, NFM's 800 Hz tone, FIR select + down-shift of
    10 kHz to 2 kHz, and ten chained 0.1 s blocks equal to one 1 s block;
    (c) the streaming loop on one stream: 0.1 s blocks through Session +
    DemodStage + AudioSinkStage into a file sink, with and without
    device conversion, ms per block, the sink's audio within 1 count of
    the ``demod`` file path's on the same input;
    (d) ``jsdr-tpu-torch demod`` and ``fir`` on a synthesised fixture on
    the card, each output within 1 count of the ``--device cpu`` run;
    (e) the six kernel wrappers' launch counts do not move in (a)-(d)."""
    from jsdr_tpu_torch.demod.am_fm import AmFmConfig, AmFmState, Mode, \
        demod_block

    wrappers = kernel_wrappers()
    for fn in wrappers:
        fn.launches = 0

    # ---- (a) the bench deployment
    s, t_len = DEMOD_SHAPE
    cfg = AmFmConfig(rate=96000, mode=int(Mode.WFM), dofir=True, dodwn=True,
                     doagc=True, flo=-20_000, fhi=20_000)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    blocks = []
    for _ in range(DEMOD_BLOCKS):
        z = torch.randn((2, s, t_len), generator=gen, device=dev) * 0.3
        blocks.append((z[0], z[1]))
    from jsdr_tpu_torch.ops.cplx import CF
    st = AmFmState.init(cfg, dev, s)
    cpu = "cpu"
    st_c = AmFmState.init(cfg, cpu, 2)
    for b, (re, im) in enumerate(blocks):
        audio, mx, _avg, st = demod_block(CF(re, im), cfg, st)
        a_c, mx_c, _a, st_c = demod_block(CF(re[:2].to(cpu), im[:2].to(cpu)),
                                          cfg, st_c)
        err = float((audio[:2].to(cpu) - a_c).abs().max())
        need(err <= 2e-5, f"demod block {b}: card audio differs from the "
             f"CPU's by {err:.3g} (> 2e-5)")
        rel = float(((mx[:2].to(cpu) - mx_c).abs() / mx_c.abs()).max())
        need(rel <= 1e-5, f"demod block {b}: block max differs by {rel:.3g} "
             "relative (> 1e-5)")
        need(bool(torch.isfinite(audio).all()) and audio.shape == (s, t_len),
             f"demod block {b}: audio not finite or of the wrong shape")
    part = AmFmState(CF(st.fir_tail.re[:2].to(cpu),
                        st.fir_tail.im[:2].to(cpu)),
                     st.car[:2].to(cpu), st.last_iq[:2].to(cpu))
    check_demod_state(torch, part, st_c, "demod deployment")
    print(f"{tag} audio demod WFM S={s} T={t_len}: {DEMOD_BLOCKS} chained "
          f"blocks on the card; the first 2 streams on the CPU agree (audio "
          f"<= 2e-5 after AGC, max <= 1e-5 relative, state)")

    nbytes = s * t_len * (8 + 4)
    flops = s * t_len * (2 * 2 * 21 + 12 + 8)
    bound_ms, bound_by = bound(flops, nbytes)
    state = [st, 0]

    def step():
        re, im = blocks[state[1] % DEMOD_BLOCKS]
        out = demod_block(CF(re, im), cfg, state[0])
        state[0] = out[3]
        state[1] += 1
        return out[1]

    wall = step_times(torch, step, 10, 3, tag,
                      f"audio demod step WFM S={s} T={t_len}")
    ev_ms = time_ms(torch, lambda i: step(), [(i,) for i in range(3)], 10)
    print(f"{tag} audio demod WFM S={s} T={t_len}: {wall:.3f} ms/step wall "
          f"mean ({s * t_len / wall / 1e3:.0f} MS/s), {ev_ms:.3f} ms/step "
          f"event-timed back to back ({s * t_len / ev_ms / 1e3:.0f} MS/s); "
          f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e9:.3f} GB: "
          f"input read + audio written)")
    need(not waits_for_card(torch, step, ()),
         "a demod_block step makes the host wait for the card")
    del blocks, audio
    torch.cuda.empty_cache()

    demod_known_answers(torch, dev, tag)
    demod_stream(dev, tag)
    demod_cli(dev, tag)

    moved = {fn.__name__: fn.launches for fn in wrappers if fn.launches}
    need(not moved, f"the audio demod path launched kernels: {moved}")
    print(f"{tag} audio demod: none of the six kernels launched in phase 13")


def demod_known_answers(torch, dev, tag):
    """Phase 13 (b): tests/test_demod.py's signals through the port on the
    card."""
    from jsdr_tpu_torch.demod.am_fm import AmFmConfig, AmFmState, Mode, \
        demod_block
    from jsdr_tpu_torch.io.sources import synth_sine
    from jsdr_tpu_torch.ops.cplx import from_complex

    rate = 96000
    t = np.arange(rate) / rate

    def run(iq, cfg):
        return demod_block(from_complex(np.asarray(iq, np.complex64), dev),
                           cfg, AmFmState.init(cfg, dev))

    def peak(audio, lo=100):
        spec = np.abs(np.fft.rfft(audio.cpu().numpy()))
        return int(np.argmax(spec[lo:]) + lo)

    am = 0.4 * (1 + 0.5 * np.sin(2 * np.pi * 1000 * t)) * np.exp(
        2j * np.pi * 5000 * t)
    audio, _mx, avg, _ = run(am, AmFmConfig(rate=rate, mode=int(Mode.AM)))
    need(peak(audio) == 1000 and abs(float(avg) - 0.4) < 0.01,
         f"AM: peak {peak(audio)} Hz, mean {float(avg):.4f}")
    fm = 0.5 * np.exp(1j * 2 * np.pi * np.cumsum(
        4000.0 * np.sin(2 * np.pi * 800 * t)) / rate)
    audio, *_ = run(fm, AmFmConfig(rate=rate, mode=int(Mode.NFM)))
    need(peak(audio) == 800, f"NFM: peak {peak(audio)} Hz")
    two = (synth_sine(rate, 10000.0, rate, amplitude=0.4)
           + synth_sine(rate, 30000.0, rate, amplitude=0.4))
    audio, *_ = run(two, AmFmConfig(rate=rate, mode=int(Mode.RAW),
                                    dofir=True, dodwn=True, flo=8000,
                                    fhi=12000))
    spec = np.abs(np.fft.fft(audio.cpu().numpy()))
    shifted = int(np.argmax(spec[:rate // 2]))
    need(abs(shifted - 2000) < 20, f"FIR select + down-shift: {shifted} Hz")
    cfg = AmFmConfig(rate=rate, mode=int(Mode.NFM), dofir=True, dodwn=True,
                     flo=-7333, fhi=9000)
    tone = synth_sine(rate, 2000.0, rate, amplitude=0.5)
    whole, _, _, wst = run(tone, cfg)
    st, parts = AmFmState.init(cfg, dev), []
    for part in np.split(tone, 10):
        a, _, _, st = demod_block(from_complex(part, dev), cfg, st)
        parts.append(a)
    err = float((torch.cat(parts) - whole).abs().max())
    need(err <= 2e-5 * float(whole.abs().max()),
         f"ten 0.1 s blocks differ from one 1 s block by {err:.3g}")
    check_demod_state(torch, st, wst, "ten chained blocks")
    print(f"{tag} audio demod known answers on the card: AM 1 kHz, mean "
          f"{float(avg):.4f}; NFM 800 Hz; 10 kHz shifted to {shifted} Hz; "
          f"ten 0.1 s blocks = one 1 s block (max diff {err:.3g})")


def demod_fixture(path, seconds: int):
    """A WFM-like fixture written by the port's ``synth``: seeded noise at
    amplitude 0.3, raw S16LE."""
    import contextlib
    import io

    from jsdr_tpu_torch.app.main import main as cli

    with contextlib.redirect_stdout(io.StringIO()):
        cli(["--seconds", str(seconds), "synth", "noise", "--amplitude",
             "0.3", "--seed", str(SEED), "--out", str(path)])
    return path


def close_s16(a, b, what: str, equal: float = 0.0) -> float:
    """S16 files within 1 count (and at least ``equal`` of the samples
    equal); returns the share equal."""
    a = np.fromfile(a, "<i2").astype(int)
    b = np.fromfile(b, "<i2").astype(int)
    need(a.shape == b.shape and len(a) > 0,
         f"{what}: {a.shape} against {b.shape} samples")
    d = np.abs(a - b)
    share = float((d == 0).mean())
    need(d.max() <= 1 and share >= equal,
         f"{what}: differ by up to {d.max()} counts, {share:.4%} equal")
    return share


def demod_stream(dev, tag):
    """Phase 13 (c): one stream in 0.1 s blocks through Session +
    DemodStage + AudioSinkStage into a file sink, host and device
    conversion; ms per block; the sink's audio against the file path's."""
    import contextlib
    import io

    from jsdr_tpu_torch.app.main import main as cli
    from jsdr_tpu_torch.demod.am_fm import AmFmConfig, Mode
    from jsdr_tpu_torch.io.live import AudioSink
    from jsdr_tpu_torch.io.sources import FileSource
    from jsdr_tpu_torch.runtime.executor import (AudioSinkStage, DemodStage,
                                                 Session)

    rate, seconds = 96000, 10
    out = ROOT / "build" / "chip_smoke_demod"
    out.mkdir(parents=True, exist_ok=True)
    src = demod_fixture(out / "wfm.raw", seconds)
    flags = ["--mode", "wfm", "--flo", "-20000", "--fhi", "20000",
             "--downshift"]
    with contextlib.redirect_stdout(io.StringIO()):
        cli(["--seconds", str(seconds), "demod", f"file:{src}", *flags,
             "--out", str(out / "file.raw"), "--device", str(dev)])
    cfg = AmFmConfig(rate=rate, mode=int(Mode.WFM), dofir=True, dodwn=True,
                     flo=-20000, fhi=20000)
    for raw in (False, True):
        fsrc = FileSource(str(src), rate=rate, channels=2)
        chunks = (fsrc.raw_blocks(rate // 10) if raw
                  else fsrc.blocks(rate // 10))
        sink_path = out / f"sink_{int(raw)}.raw"
        session = Session(source=chunks, block_samples=rate // 10,
                          device=dev)
        sink = AudioSink(str(sink_path), max_blocks=1024)
        stages = [DemodStage(cfg, device=dev), AudioSinkStage(sink)]
        t0 = time.perf_counter()
        try:
            n = session.run(stages)
        finally:
            sink.close()
        wall = (time.perf_counter() - t0) * 1e3
        rep = session.timers.report()
        need(n == 10 * seconds and session.dropped_blocks == {}
             and sink.blocks_written == n and sink.overruns == 0,
             f"demod stream: {n} blocks, dropped {session.dropped_blocks}, "
             f"sink {sink.blocks_written} written, {sink.overruns} overruns")
        share = close_s16(sink_path, out / "file.raw",
                          "demod stream sink against the file path")
        d = rep["demod"]
        print(f"{tag} demod stream ({'device' if raw else 'host'} "
              f"conversion): {n} blocks of 0.1 s, {wall / n:.3f} ms per "
              f"block end to end (real time needs < 100 ms); demod stage "
              f"{d['wall_s'] / d['calls'] * 1e3:.3f} ms per block; sink "
              f"audio within 1 count of the file path's ({share:.2%} equal: "
              f"the sink rounds, the file path truncates)")


def demod_cli(dev, tag):
    """Phase 13 (d): ``demod`` and ``fir`` on the card against
    ``--device cpu`` on a synthesised fixture."""
    import contextlib
    import io

    from jsdr_tpu_torch.app.main import main as cli

    out = ROOT / "build" / "chip_smoke_demod"
    src = demod_fixture(out / "cli.raw", 2)
    runs = (("demod", ["demod", f"file:{src}", "--mode", "wfm", "--flo",
                       "-20000", "--fhi", "20000", "--downshift", "--agc"]),
            ("demod am", ["demod", f"file:{src}", "--mode", "am"]),
            ("fir", ["fir", f"file:{src}", "--mix", "1000", "--widen",
                     "4"]))
    for what, args in runs:
        got = {}
        for d in (str(dev), "cpu"):
            path = out / f"cli_{what.replace(' ', '_')}_{d}.raw"
            with contextlib.redirect_stdout(io.StringIO()) as text:
                rc = cli(["--seconds", "2", *args, "--out", str(path),
                          "--device", d])
            need(rc == 0, f"{what} --device {d} exited {rc}")
            got[d] = (path, text.getvalue().replace(str(path), "OUT"))
        share = close_s16(got[str(dev)][0], got["cpu"][0],
                          f"jsdr-tpu-torch {what} card against cpu")
        print(f"{tag} jsdr-tpu-torch {' '.join(args[:1] + args[2:])}: card "
              f"output within 1 count of --device cpu ({share:.2%} equal)")


# ---- phases 14-16: the ui shell, compat_scan, the native IO library ------

UI_DEADLINE_S = 240.0        # phase 14's pipeline runs, all together
UI_TIMED_BLOCKS = 60         # phase 14 (b): 0.1 s blocks timed after warm-up
UI_WARMUP_BLOCKS = 10


def ui_model(path, lines: str, rate: int):
    """A TuiModel over a fresh config file of ``lines`` (reference keys),
    two FUNcube tabs; returns (model, pubsub, controls)."""
    from jsdr_tpu_torch.app.tui import Controls, TuiModel
    from jsdr_tpu_torch.runtime.config import Config
    from jsdr_tpu_torch.runtime.pubsub import PubSub

    path.write_text("jsdr-tpu-version=1\njsdr-funcube-demods=2\n" + lines)
    pubsub, controls = PubSub(), Controls()
    model = TuiModel(Config(path), pubsub, controls, rate=rate, n_funcube=2)
    return model, pubsub, controls


def ui_clean(pipe, drops: list) -> None:
    """Fail on a fault the ui's status line alone would hide: a pipeline
    error, or a stage's exception, which the Session alerts (retried, or
    its block dropped for that stage, or in a stage's finish) and streams
    on; ``drops`` holds what the 'dropped-block' topic published."""
    need(pipe.error is None, f"ui pipeline error: {pipe.error}")
    need(not pipe.alerts and not drops,
         f"ui pipeline stage faults: {pipe.alerts[:3]}, dropped {drops[:3]}")


def ui_drops(pubsub) -> list:
    """The list the pipeline's 'dropped-block' publications land in."""
    drops = []
    pubsub.listen(lambda t, v: drops.append(v) if t == "dropped-block"
                  else None)
    return drops


def ui_wait(pipe, drops, cond, what: str, deadline: float) -> None:
    """Poll ``cond`` until it holds; fail on the deadline or a fault."""
    while not cond():
        ui_clean(pipe, drops)
        need(pipe.is_alive(), f"ui pipeline thread ended: {what}")
        need(time.perf_counter() < deadline,
             f"ui pipeline stalled waiting for {what} (status: "
             f"{pipe.model.status})")
        time.sleep(0.01)


def ui_quit(pipe, drops, deadline: float) -> None:
    pipe.model.handle_key("ctrl-q")
    pipe.join(timeout=max(1.0, deadline - time.perf_counter()))
    need(not pipe.is_alive(), "ui pipeline thread did not stop on ctrl-q")
    ui_clean(pipe, drops)


def golden_raw(name: str):
    g = np.load(ROOT / "tests" / "golden" / name)
    return g, np.asarray(g["raw_s16le"]).astype("<i2")


def phase_ui(torch, np, dev, tag):
    """Phase 14: the ``ui`` shell's pipeline on the card, headless:
    ``TuiModel`` + ``StageManager`` + ``PipelineThread(device=cuda)``, no
    curses; config files under build/.

    (a) golden_96k as a looping ``file:`` source, two FUNcube tabs (one
        manual at the capture's tuning, one auto-tuned), keys while it runs
        (WFM demod swapped in, a recorder swapped in, pause and resume,
        quit): FUNcube0's frames of the first pass equal the golden's,
        the recording is a contiguous run of the input, kernels 1 and 2
        launched, and the thread recorded no error, no stage fault and
        no dropped block (:func:`ui_clean`, in every run of the phase);
    (b) golden_192k at the FUNcube Dongle Pro+ rate, unpaced, with two
        tabs, WFM demod, recorder, spectrum and phase tap: ms per 0.1 s
        block, whose mean must stay under 100 (real time);
    (c) the same stages driven synchronously on the card and on the CPU
        over the same blocks and keys, at 96 kS/s (golden_96k) and at
        9600 S/s (decim 1: kernel 1 at m = 1, the timing kernel on
        960-sample blocks): frames and counters equal, the PSD within the
        full-PSD tolerance, audio within 2e-5 of the block's largest.
    Returns the mean ms per block of (b)."""
    from jsdr_tpu_torch.app.tui import PipelineThread
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.timing_kernel import timing_recover_batch

    out = ROOT / "build" / "chip_smoke_ui"
    out.mkdir(parents=True, exist_ok=True)
    deadline = time.perf_counter() + UI_DEADLINE_S

    # (a) frames bit-exact through the live pipeline
    g, raw = golden_raw("golden_96k.npz")
    rate, tuning = int(g["rate"]), int(g["tuning"])
    block = rate // 10
    # zero-padded to whole 1 s blocks, as tests/test_golden.py decodes it
    # (the looping source drops a partial last block)
    raw = np.concatenate([raw, np.zeros((-len(raw)) % (2 * rate), "<i2")])
    cap = out / "golden_96k.raw"
    cap.write_bytes(raw.tobytes())
    rec = out / "rec_96k.raw"
    rec.unlink(missing_ok=True)
    model, pubsub, controls = ui_model(
        out / "a.properties",
        f"FUNcube0-bpsk-tuning={tuning}\nFUNcube1-bpsk-tuning={tuning}\n"
        f"FUNcube1-bpsk-dofft=1\nrecorder-path={rec}\n", rate)
    frames = []
    pubsub.listen(lambda t, v: frames.append(v) if t == "telemetry-frame"
                  else None)
    drops = ui_drops(pubsub)
    controls.new_source = f"file:{cap}"
    controls.source_epoch += 1
    first_pass = len(raw) // (2 * block)
    n_gold = len(g["payloads"])
    mix_decimate.launches = timing_recover_batch.launches = 0
    pipe = PipelineThread(model, rate, paced=False, device=dev)
    t0 = time.perf_counter()
    pipe.start()
    try:
        ui_wait(pipe, drops, lambda: model.blocks >= 5, "5 blocks",
                deadline)
        for k in ("3", "w"):
            model.handle_key(k)
        ui_wait(pipe, drops, lambda: pubsub.get("audio-out") is not None,
                "the WFM demod stage", deadline)
        for k in ("4", "e"):
            model.handle_key(k)
        ui_wait(pipe, drops,
                lambda: rec.exists() and rec.stat().st_size > 0,
                "the recorder", deadline)
        model.handle_key("p")
        time.sleep(0.3)
        b1 = model.blocks
        time.sleep(0.3)
        need(model.blocks <= b1 + 1, "ui: blocks flowed while paused")
        model.handle_key("p")
        ui_wait(pipe, drops, lambda: model.blocks >= first_pass + 8
                and sum(f["demod"] == 0 for f in frames) >= n_gold,
                "FUNcube0's frames of the first pass", deadline)
        blocks_a = model.blocks
        ui_quit(pipe, drops, deadline)
    finally:
        controls.quit = True
    wall = time.perf_counter() - t0
    f0 = [f for f in frames if f["demod"] == 0][:n_gold]
    need([f["payload"].tobytes() for f in f0]
         == [p.tobytes() for p in g["payloads"]]
         and all(f["ok"] for f in f0),
         "ui: FUNcube0's frames differ from golden_96k's payloads")
    need([f["channel_errors"] for f in f0] == list(g["rc"])
         and [f["corr"] for f in f0] == list(g["hit_corr"]),
         f"ui: rc/corr {[(f['channel_errors'], f['corr']) for f in f0]}")
    got = np.frombuffer(rec.read_bytes(), "<i2")
    loop = raw[:first_pass * 2 * block]
    reps = np.tile(loop, len(got) // len(loop) + 2)
    starts = [j for j in range(first_pass) if np.array_equal(
        reps[j * 2 * block:j * 2 * block + len(got)], got)]
    need(len(got) >= 2 * block and starts,
         f"ui: the recording ({len(got)} values) is not a contiguous run "
         "of the input")
    need(mix_decimate.launches > 0 and timing_recover_batch.launches > 0,
         "ui: kernels 1 and 2 did not launch")
    print(f"{tag} ui (a): {blocks_a} blocks of 0.1 s of golden_96k through "
          f"the live pipeline in {wall:.2f} s; FUNcube0's {len(f0)} frames "
          f"bit-exact (rc {[f['channel_errors'] for f in f0]}, corr "
          f"{[f['corr'] for f in f0]}); WFM and recorder swapped in, pause "
          f"held the blocks; recording of {len(got) // 2} samples is a "
          f"contiguous run of the input (from block {starts[0]}); launches "
          f"kernel 1 {mix_decimate.launches}, kernel 2 "
          f"{timing_recover_batch.launches}; no pipeline error, stage "
          "fault or dropped block")

    # (b) real time at the dongle's full rate
    g2, raw2 = golden_raw("golden_192k.npz")
    rate2, tuning2 = int(g2["rate"]), int(g2["tuning"])
    cap2 = out / "golden_192k.raw"
    cap2.write_bytes(raw2.tobytes())
    rec2 = out / "rec_192k.raw"
    model, pubsub, controls = ui_model(
        out / "b.properties",
        f"FUNcube0-bpsk-tuning={tuning2}\nFUNcube1-bpsk-tuning={tuning2}\n"
        f"FUNcube1-bpsk-dofft=1\ndemod-mode=4\nrecorder-path={rec2}\n",
        rate2)
    for k in ("4", "e"):
        model.handle_key(k)
    stamps, seen = [], set()

    def on_b(topic, value):
        seen.add(topic)
        if topic == "audio-frame":
            stamps.append(time.perf_counter())

    pubsub.listen(on_b)
    drops = ui_drops(pubsub)
    controls.new_source = f"file:{cap2}"
    controls.source_epoch += 1
    pipe = PipelineThread(model, rate2, paced=False, device=dev)
    pipe.start()
    want = UI_WARMUP_BLOCKS + UI_TIMED_BLOCKS + 1
    try:
        ui_wait(pipe, drops, lambda: len(stamps) >= want, f"{want} blocks",
                deadline)
        ui_quit(pipe, drops, deadline)
    finally:
        controls.quit = True
    topics = {"iq-block", "fft-psd", "telemetry-counters", "audio-out"}
    need(topics <= seen and rec2.stat().st_size > 0,
         f"ui (b): stages missing (topics {sorted(topics - seen)})")
    ms = np.diff(stamps[UI_WARMUP_BLOCKS:want]) * 1e3
    mean = float(ms.mean())
    need(mean < 100.0, f"ui (b): {mean:.1f} ms per 0.1 s block is slower "
         "than real time")
    print(f"{tag} ui (b): golden_192k at {rate2} S/s unpaced, 2 FUNcube "
          f"tabs (one auto-tuned), WFM, recorder, spectrum, phase tap: "
          f"{mean:.3f} ms per 0.1 s block mean over {len(ms)} blocks after "
          f"{UI_WARMUP_BLOCKS} warm-up (min {ms.min():.3f}, max "
          f"{ms.max():.3f}; real time needs < 100)")

    # (c) card against CPU, synchronously, same blocks and keys
    cases = (("96k", rate, raw, tuning, UI_SYNC_BLOCKS_96K),
             ("9600", 9600, ui_9600_signal(), 2400, UI_SYNC_BLOCKS_9600))
    for what, r, data, tun, n_blocks in cases:
        res = {}
        for d in (dev, torch.device("cpu")):
            res[d.type] = ui_sync(out / f"c_{what}_{d.type}", r, data, tun,
                                  n_blocks, d)
        card, cpu = res[dev.type], res["cpu"]
        need(card["frames"] == cpu["frames"],
             f"ui (c) {what}: frames differ card/cpu")
        need(card["counters"] == cpu["counters"],
             f"ui (c) {what}: counters differ card/cpu")
        need(card["rec"] == cpu["rec"] and len(card["rec"]) > 0,
             f"ui (c) {what}: recordings differ card/cpu")
        worst = max(psd_tol(torch, k, p)
                    for k, p in zip(card["psd"], cpu["psd"]))
        need(len(card["psd"]) == len(cpu["psd"]) == n_blocks,
             f"ui (c) {what}: PSD lines")
        aud = [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
               for a, b in zip(card["audio"], cpu["audio"])]
        need(len(aud) == len(cpu["audio"]) > 0 and max(aud) <= 2e-5,
             f"ui (c) {what}: audio differs by {max(aud):.3g} of the "
             "block's largest (> 2e-5)")
        print(f"{tag} ui (c) {what}: {n_blocks} blocks card against cpu: "
              f"{len(card['frames'])} frames and every counter equal, the "
              f"recording equal, PSD within the full-PSD tolerance (worst "
              f"{worst[0]:.2e} dB at or above the floor, {worst[1]:.2e} of "
              f"the RMS amplitude), audio within {max(aud):.2e} of the "
              f"block's largest")
    return mean


# (c)'s lengths: golden_96k's first sync hit is in 0.1 s block 45 (drained
# by block 48, every 4 blocks); one frame at 9600 S/s after 600 preamble
# bits is ~48 blocks of 960 samples
UI_SYNC_BLOCKS_96K = 52
UI_SYNC_BLOCKS_9600 = 52


def ui_9600_signal():
    """One AO-40 frame at 9600 S/s on a 2400 Hz carrier (a multiple of
    750 Hz at that rate: pattern mode, kernel 1 at m = 1), as raw S16LE."""
    from jsdr_tpu_torch.io.convert import complex_to_s16le
    from jsdr_tpu_torch.io.sources import synth_bpsk_stream

    pay = np.random.default_rng(SEED).integers(0, 256, (1, 256), np.uint8)
    sig = synth_bpsk_stream(pay, rate=9600, carrier_offset=2400.0,
                            preamble_bits=600, noise_rms=0.25, seed=SEED)
    sig = np.concatenate([sig, np.zeros(max(0, UI_SYNC_BLOCKS_9600 * 960
                                            - len(sig)), np.complex64)])
    return np.frombuffer(complex_to_s16le(sig), "<i2")


def psd_tol(torch, k, p):
    """(largest dB difference at or above the row's median, largest
    amplitude difference over the row's RMS amplitude) of one published
    PSD (numpy, a row on the last axis) against another, by
    :func:`psd_errors`; fails beyond the full-PSD tolerance (PSD_DB_TOL at
    or above the floor, PSD_AMP_TOL of the RMS amplitude everywhere).
    tests/test_torch_tui.py holds the port's PSD to it too."""
    k, p = (torch.as_tensor(np.atleast_2d(a))[None, ..., None]
            for a in (k, p))
    need(k.shape == p.shape and k.dtype == p.dtype,
         f"PSD {tuple(k.shape)} {k.dtype} against {tuple(p.shape)} {p.dtype}")
    db, amp, _ = psd_errors(torch, k, p)
    need(db <= PSD_DB_TOL and amp <= PSD_AMP_TOL,
         f"PSD differs by {db:.3g} dB at/above the floor, {amp:.3g} of the "
         "RMS amplitude")
    return db, amp


def ui_sync(out, rate: int, raw, tuning: int, n_blocks: int, dev):
    """Phase 14 (c): one StageManager's stages driven by ``Session.run`` on
    the calling thread over ``raw``'s first ``n_blocks`` 0.1 s blocks, a
    fixed key script applied from inside the source iterator: the FFT
    tuner on the second tab, WFM, the recorder on then off, the window
    off, NFM, a re-tune of the second tab. Fails on a stage fault (an
    alert) or a dropped block. Returns the published topics and the
    recording."""
    from jsdr_tpu_torch.app.tui import StageManager
    from jsdr_tpu_torch.io.convert import s16le_to_complex
    from jsdr_tpu_torch.runtime.executor import Session
    from jsdr_tpu_torch.runtime.log import Logger

    class AlertLog(Logger):
        def __init__(self):
            super().__init__()
            self.alerts = []

        def alert(self, msg: str):
            self.alerts.append(msg)
            super().alert(msg)

    out.mkdir(parents=True, exist_ok=True)
    block = rate // 10
    model, pubsub, _ = ui_model(
        out / "c.properties", f"FUNcube0-bpsk-tuning={tuning}\n"
        f"FUNcube1-bpsk-tuning={tuning}\nrecorder-path={out / 'rec.raw'}\n",
        rate)
    script = {1: ["6", "x"], 3: ["3", "w"], 6: ["4", "e"], 9: ["2", "h"],
              12: ["4", "e"], 20: ["3", "n"],
              30: ["6", "F", "9", "0", "0", "0", "enter"]}
    got = {"telemetry-frame": [], "telemetry-counters": [], "fft-psd": [],
           "audio-out": []}
    pubsub.listen(lambda t, v: got[t].append(v) if t in got else None)
    mgr = StageManager(model, rate, device=dev)

    def source():
        for b in range(n_blocks):
            for k in script.get(b, []):
                model.handle_key(k)
            yield s16le_to_complex(raw[2 * b * block:2 * (b + 1) * block])

    session = Session(source=source(), block_samples=block, pubsub=pubsub,
                      logger=AlertLog(), device=dev)
    n = session.run(mgr.stages)
    mgr.close()
    need(n == n_blocks, f"ui (c): {n} blocks of {n_blocks}")
    need(not session.logger.alerts and session.dropped_blocks == {},
         f"ui (c) at {rate} S/s: stage faults {session.logger.alerts[:3]}, "
         f"dropped {session.dropped_blocks}")
    frames = [(f["demod"], f["tuning"], f["ok"], f["corr"],
               f["channel_errors"], f["payload"].tobytes())
              for f in got["telemetry-frame"]]
    need(any(f[0] == 0 and f[2] for f in frames),
         f"ui (c) at {rate} S/s: FUNcube0 decoded no frame")
    return {"frames": frames, "counters": got["telemetry-counters"],
            "psd": got["fft-psd"], "audio": got["audio-out"],
            "rec": (out / "rec.raw").read_bytes()}


def phase_compat_scan(torch, np, dev, rng, tag):
    """Phase 15: ``compat_scan`` (the per-sample timing scan, torch ops, no
    kernel) on the card: golden_192k in 1 s blocks bit-exact, with the
    RuntimeWarning; then one 128 x 96,000 block whose frames complete in
    it, run from the same carried state through the scan and through the
    default path (kernel 2): bits, hits, windows and sync corr equal. The
    scan ran and kernel 2 did not. Returns the ms per 1 s block at S = 1
    and at S = 128."""
    import warnings

    from jsdr_tpu_torch.demod.bpsk import (BpskConfig, _timing_scan_batch,
                                           bpsk_block, bpsk_block_batch,
                                           bpsk_init, bpsk_init_batch)
    from jsdr_tpu_torch.fec.decoder import fec_decode
    from jsdr_tpu_torch.io.convert import s16le_to_complex
    from jsdr_tpu_torch.io.sources import synth_bpsk_stream
    from jsdr_tpu_torch.ops.cplx import from_complex
    from jsdr_tpu_torch.ops.timing_kernel import timing_recover_batch

    g, raw = golden_raw("golden_192k.npz")
    rate = int(g["rate"])
    sig = s16le_to_complex(raw)
    sig = np.concatenate([sig, np.zeros((-len(sig)) % rate, np.complex64)])
    cfg = BpskConfig(rate=rate, tuning=float(g["tuning"]), compat_scan=True)
    st = bpsk_init(cfg, dev)
    payloads, rcs, corrs, ms = [], [], [], []
    _timing_scan_batch.runs = timing_recover_batch.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for b in range(len(sig) // rate):
            x = from_complex(sig[b * rate:(b + 1) * rate], dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, st = bpsk_block(x, cfg, st)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            nh = int(out.n_hits)
            if nh:
                res = fec_decode(out.windows[:nh])
                need(bool(res.ok.all()), "compat_scan: FEC failed")
                payloads += list(res.payload.cpu().numpy())
                rcs += res.rc.cpu().tolist()
                corrs += out.hit_corr[:nh].cpu().tolist()
    need(any(issubclass(w.category, RuntimeWarning)
             and "compat_scan" in str(w.message) for w in caught),
         "compat_scan on the card raised no RuntimeWarning")
    need(len(payloads) == len(g["payloads"])
         and np.array_equal(np.stack(payloads), g["payloads"])
         and rcs == list(g["rc"]) and corrs == list(g["hit_corr"]),
         f"compat_scan golden_192k: rc {rcs}, hit_corr {corrs}")
    need(_timing_scan_batch.runs == len(ms)
         and timing_recover_batch.launches == 0,
         f"compat_scan: {_timing_scan_batch.runs} scans, "
         f"{timing_recover_batch.launches} timing kernel launches")
    one = float(np.mean(ms[1:]))
    print(f"{tag} compat_scan golden_192k: {len(payloads)} frames bit-exact "
          f"(rc {rcs}, hit_corr {corrs}) with the RuntimeWarning; "
          f"{one:.1f} ms per 1 s block at S=1 (mean of {len(ms) - 1} after "
          f"the first; each {', '.join(f'{v:.1f}' for v in ms)}); "
          f"{_timing_scan_batch.runs} scans, kernel 2 launched 0 times")

    s, block = MAIN_SHAPE
    tunings = 6000.0 + 750.0 * (np.arange(s) % 21)
    pay = rng.integers(0, 256, (s, 256), dtype=np.uint8)
    iq = np.zeros((s, 5 * block), np.complex64)
    for i in range(s):
        x = synth_bpsk_stream(pay[i:i + 1], rate=block,
                              carrier_offset=float(tunings[i]),
                              preamble_bits=200, noise_rms=0.25, seed=i)
        iq[i, :len(x)] = x
    base = BpskConfig(rate=block)
    st = bpsk_init_batch(base, s, dev)
    for b in range(4):
        _, st = bpsk_block_batch(from_complex(iq[:, b * block:(b + 1) * block],
                                              dev), base, st, tunings)
    last = from_complex(iq[:, 4 * block:], dev)
    want, wst = bpsk_block_batch(last, base, st, tunings)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, gst = bpsk_block_batch(last, base._replace(compat_scan=True),
                                    st, tunings)
        torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    for name in ("bits", "n_bits", "n_hits", "hit_corr", "windows"):
        need(torch.equal(getattr(got, name), getattr(want, name)),
             f"compat_scan S={s}: {name} differs from the timing kernel's")
    for name in ("peak", "new_peak", "pos"):
        need(torch.equal(getattr(gst.timing, name),
                         getattr(wst.timing, name)),
             f"compat_scan S={s}: timing {name} differs")
    hits = int(want.n_hits.sum())
    need(hits >= s, f"compat_scan S={s}: {hits} sync hits in the block")
    print(f"{tag} compat_scan S={s} T={block}: bits, {hits} sync hits, "
          f"windows and corr equal to the timing kernel's path from the "
          f"same carried state; {batch_ms:.1f} ms for the block (the scan's "
          f"9600 steps do not depend on S; real time needs < 1000)")
    return one, batch_ms


def phase_native_io(np, tag):
    """Phase 16: the native IO library (``io/native.py``, g++ at first
    use): available, and a 1 s S16LE capture converted and a FLAC fixture
    (written by the port's encoder) decoded through it, each byte-equal
    to the numpy / pure-Python path, with its call counter risen."""
    from jsdr_tpu_torch.io import native
    from jsdr_tpu_torch.io.convert import s16le_to_complex
    from jsdr_tpu_torch.io.flac import read_flac, write_flac

    need(native.available(), "the native IO library did not build or load")
    _, raw = golden_raw("golden_96k.npz")
    raw = raw[:2 * 96000]
    calls = dict(native.calls)
    t0 = time.perf_counter()
    fast = s16le_to_complex(raw, 2, 300, -40)
    t_fast = (time.perf_counter() - t0) * 1e3
    keep = native.s16le_to_complex_native
    native.s16le_to_complex_native = lambda *a, **k: None
    try:
        t0 = time.perf_counter()
        plain = s16le_to_complex(raw, 2, 300, -40)
        t_plain = (time.perf_counter() - t0) * 1e3
    finally:
        native.s16le_to_complex_native = keep
    need(fast.dtype == plain.dtype and fast.tobytes() == plain.tobytes(),
         "native S16LE conversion differs from numpy's")
    path = ROOT / "build" / "chip_smoke_native.flac"
    write_flac(path, raw.reshape(-1, 2), 96000)
    a = read_flac(path)
    b = read_flac(path, prefer_native=False)
    need(a[0].tobytes() == b[0].tobytes() == raw.astype(np.int32).tobytes()
         and a[1:] == b[1:], "native FLAC decode differs from Python's")
    need(native.calls["s16le_to_complex"] > calls.get("s16le_to_complex", 0)
         and native.calls["flac_decode"] > calls.get("flac_decode", 0),
         f"the native path was not taken: {dict(native.calls)}")
    print(f"{tag} native IO: {native.library_path().name} loaded; 1 s "
          f"S16LE conversion {t_fast:.3f} ms native, {t_plain:.3f} ms numpy, "
          f"byte-equal; FLAC decode byte-equal to the pure-Python decoder; "
          f"calls {dict(native.calls)}")


if __name__ == "__main__":
    sys.exit(main())
