#!/usr/bin/env python3
"""What bounds kernel 6 (``csrc/mix_dec_mf.cu``) on the card, and kernels
1, 5 and 6 against another checkout's.

Run from the root of a checkout on a CUDA machine:

    python3 tools/mf_probe.py [--parent DIR]

At the Session's shapes (128 x 96,000 at m = 10, 64 x 192,000 at m = 20)
it takes the device time (CUDA events behind a sleep kernel, as
``chip_smoke.device_ms``) of:

* kernel 6, ``mix_decimate_mf``, whose m = 10 and 20 are compiled with m
  fixed, against a copy of ``mix_dec_mf.cu`` built under ``build/mf_probe/``
  that sends every m to the kernel that takes m at run time (its outputs
  are checked equal to the fixed-m kernel's, bit for bit), timed fixed,
  run-time, run-time, fixed;
* kernel 1, ``mix_decimate``, which reads the same input and writes as
  many outputs but has no matched filter;
* three reads of the two input planes: a torch row sum of each, a
  device-to-device ``copy_`` of both (read and written), and a plain
  kernel that reads both as float4, four loads of each a thread in flight
  and nothing written: the card's read rate for these bytes;

and prints each beside the byte bound and the GB/s it reaches, with the
card's name and power limit. chip_smoke.py phase 10 holds the kernel to
its plain version.

With ``--parent DIR`` (the root of another checkout, e.g. a ``git
archive`` of the parent commit unpacked under ``build/``), it builds that
checkout's ``mix_decimate.cu``, ``psd_waterfall.cu`` and ``mix_dec_mf.cu``
into ``build/mf_probe/parent.so`` and runs the package's own wrappers on
them and on this tree's kernels in turns (parent, this tree, this tree,
parent; device time as above), after checking the two agree bit for bit:
kernels 1 and 6 at chip_smoke's ``MIX_CASES``, kernel 5 at its
``PSD_CASES``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mf_probe"
# the entry point's choice of kernel in csrc/mix_dec_mf.cu, and what the
# run-time-m copy puts in its place
DISPATCH = "m == 10 ? &launch<10> : m == 20 ? &launch<20> : &launch<0>"

READ_CU = r"""
#include <cuda_runtime.h>
__global__ void read2(const float4* __restrict__ a,
                      const float4* __restrict__ b, long long n4,
                      float* out) {
  float acc = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[2 * u] = __ldg(a + i + u * stride);
      v[2 * u + 1] = __ldg(b + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u].x + v[u].y + v[u].z + v[u].w;
  }
  for (; i < n4; i += stride) {
    const float4 x = __ldg(a + i), y = __ldg(b + i);
    acc += x.x + x.y + x.z + x.w + y.x + y.y + y.z + y.w;
  }
  if (acc == -1.2345e30f) out[0] = acc;  // never: keeps the loads
}
extern "C" int read2_launch(const void* a, const void* b, long long n4,
                            void* out, int blocks, void* stream) {
  read2<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)a, (const float4*)b, n4, (float*)out);
  return (int)cudaGetLastError();
}
"""


def nvcc(out: Path, srcs, include: Path) -> ctypes.CDLL:
    from jsdr_tpu_torch.ops import _build

    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", str(include), "-o", str(out),
                          *map(str, srcs)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return ctypes.CDLL(str(out))


# the sources of kernels 1, 5 and 6, each named as its C entry point
PARENT_KERNELS = ("mix_decimate", "psd_waterfall", "mix_dec_mf")


def parent_lib(root: Path) -> ctypes.CDLL:
    """The kernels 1, 5 and 6 of the checkout at ``root`` (and its error
    strings), with this tree's ctypes signatures."""
    from jsdr_tpu_torch.ops import _build

    csrc = root / "jsdr_tpu_torch" / "ops" / "csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    lib = nvcc(OUT / "parent.so", [csrc / f"{k}.cu" for k in
                                   PARENT_KERNELS + ("errors",)], csrc)
    for k in PARENT_KERNELS:
        getattr(lib, f"jsdr_{k}").argtypes = _build._SIGNATURES[f"jsdr_{k}"]
        getattr(lib, f"jsdr_{k}").restype = ctypes.c_int
    lib.jsdr_error_string.argtypes = [ctypes.c_int]
    lib.jsdr_error_string.restype = ctypes.c_char_p
    return lib


def on_lib(lib: ctypes.CDLL, fn):
    """``fn`` (a package wrapper) run on the kernels of ``lib``."""
    from jsdr_tpu_torch.ops import _build

    def run(*args):
        saved = _build.kernels
        _build.kernels = lambda: lib
        try:
            return fn(*args)
        finally:
            _build.kernels = saved
    return run


def same(torch, a, b) -> bool:
    """Two wrapper results (tensors, CF pairs, tuples of them) equal bit
    for bit."""
    if isinstance(a, tuple):
        return all(same(torch, x, y) for x, y in zip(a, b))
    if hasattr(a, "re"):
        return torch.equal(a.re, b.re) and torch.equal(a.im, b.im)
    return torch.equal(a, b)


def compare_parent(torch, np, cs, dev, card, parent):
    """Kernels 1, 5 and 6 of the checkout at ``parent`` against this
    tree's, bit for bit, then timed parent, this, this, parent."""
    from jsdr_tpu_torch.demod.bpsk import (DM_FILTER, DS_FILTER,
                                           HOWARD_FUDGE_FACTOR, NU_SCALE,
                                           _nco_pattern, _vco_pattern,
                                           tunings_to_nu)
    from jsdr_tpu_torch.ops.cplx import CF
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.mix_decimate_mf import mix_decimate_mf
    from jsdr_tpu_torch.ops.psd_waterfall import psd_waterfall

    lib = parent_lib(parent)
    rng = np.random.default_rng(11)

    def rand(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape)
                               .astype(np.float32), device=dev)

    def abba(what, fn, inputs, nbytes):
        old, new = on_lib(lib, fn), fn
        cs.need(same(torch, old(*inputs[0]), new(*inputs[0])),
                f"{what}: the parent's kernel and this tree's differ")
        t = [cs.device_ms(torch, f, inputs, 20)
             for f in (old, new, new, old)]
        print(f"[{card}] {what}: device time parent {t[0]:.4f} / "
              f"{t[3]:.4f} ms, this tree {t[1]:.4f} / {t[2]:.4f} ms "
              f"(equal outputs, bit for bit; parent, this, this, parent); "
              f"byte bound {nbytes / cs.PEAK_BYTES * 1e3:.4f} ms")

    taps = torch.as_tensor(DS_FILTER, dtype=torch.float32, device=dev)
    mf_taps = torch.as_tensor(DM_FILTER, dtype=torch.float32, device=dev)
    for s, t_len, rate in cs.MIX_CASES:
        m = rate // 9600
        tu = torch.as_tensor(tunings_to_nu((rate // 128)
                                           * (8 + np.arange(s) % 21)),
                             dtype=torch.int64, device=dev)
        nu0 = torch.as_tensor(rng.integers(0, NU_SCALE * rate, s),
                              dtype=torch.float32, device=dev)
        cos_pat, sin_pat = _nco_pattern(nu0, tu, rate)
        vco_cos, vco_sin = _vco_pattern(torch.as_tensor(
            rng.integers(0, 8, s), dtype=torch.int32, device=dev))
        inputs = [(CF(rand(s, t_len), rand(s, t_len)), cos_pat, sin_pat, taps,
                   m, CF(rand(s, 26), rand(s, 26)), vco_cos, vco_sin,
                   mf_taps, CF(rand(s, 64), rand(s, 64)),
                   HOWARD_FUDGE_FACTOR) for _ in range(3)]
        abba(f"kernel 1 S={s} T={t_len} m={m}", mix_decimate,
             [a[:6] + a[10:] for a in inputs], cs.front_work(s, t_len, m)[1])
        abba(f"kernel 6 S={s} T={t_len} m={m}", mix_decimate_mf, inputs,
             8.0 * s * t_len + 8.0 * s * (t_len // m) + 4 * 4.0 * s * 128
             + 4 * (27 + 65) + 2 * 8.0 * s * (26 + 64))
        del inputs
        torch.cuda.empty_cache()
    for b, n, width in cs.PSD_CASES:
        inputs = [(CF(rand(b, n, scale=40.0), rand(b, n, scale=40.0)), width)
                  for _ in range(3)]
        abba(f"kernel 5 B={b} N={n} width={width}", psd_waterfall, inputs,
             12.0 * b * n + b * width)
        del inputs
        torch.cuda.empty_cache()


def runtime_m_copy() -> ctypes.CDLL:
    """csrc/mix_dec_mf.cu with every m sent to launch<0>, as v_mix_dec_mf."""
    from jsdr_tpu_torch.ops import _build

    src = (_build.CSRC / "mix_dec_mf.cu").read_text()
    if DISPATCH not in src:
        raise RuntimeError(f"anchor not found in mix_dec_mf.cu: {DISPATCH!r}")
    src = src.replace(DISPATCH, "&launch<0>").replace("jsdr_mix_dec_mf",
                                                      "v_mix_dec_mf")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "mf_rt.cu").write_text(src)
    lib = nvcc(OUT / "mf_rt.so", [OUT / "mf_rt.cu"], _build.CSRC)
    lib.v_mix_dec_mf.argtypes = _build._SIGNATURES["jsdr_mix_dec_mf"]
    lib.v_mix_dec_mf.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout whose kernels 1, 5 and "
                    "6 to time against this tree's")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mf_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from jsdr_tpu_torch.demod.bpsk import (DM_FILTER, DS_FILTER,
                                           HOWARD_FUDGE_FACTOR, NU_SCALE,
                                           _nco_pattern, _vco_pattern,
                                           tunings_to_nu)
    from jsdr_tpu_torch.ops import _build
    from jsdr_tpu_torch.ops.cplx import CF
    from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
    from jsdr_tpu_torch.ops.mix_decimate_mf import mix_decimate_mf
    from jsdr_tpu_torch.runtime.device import require_device

    dev = require_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    _build.kernels()
    rt = runtime_m_copy()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "read2.cu").write_text(READ_CU)
    rd_lib = nvcc(OUT / "read2.so", [OUT / "read2.cu"], OUT)
    rd_lib.read2_launch.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(1, dtype=torch.float32, device=dev)

    def runtime_m(iq, cp, sp, tp, m, tail, vc, vs, mt, mtail, gain):
        s, t_len = iq.shape

        def empty(cols):
            return torch.empty((s, cols), dtype=torch.float32, device=dev)

        out = [empty(t_len // m), empty(t_len // m), empty(26), empty(26),
               empty(64), empty(64)]
        code = rt.v_mix_dec_mf(
            iq.re.data_ptr(), iq.im.data_ptr(), cp.data_ptr(), sp.data_ptr(),
            tp.data_ptr(), tail.re.data_ptr(), tail.im.data_ptr(),
            vc.data_ptr(), vs.data_ptr(), mt.data_ptr(), mtail.re.data_ptr(),
            mtail.im.data_ptr(), *(o.data_ptr() for o in out), s, t_len, m,
            float(gain), torch.cuda.current_stream(dev).cuda_stream)
        cs.need(code == 0, f"run-time-m copy: CUDA error {code}")
        return (CF(out[0], out[1]), CF(out[2], out[3]), CF(out[4], out[5]))

    def read_kernel(iq, *_):
        code = rd_lib.read2_launch(iq.re.data_ptr(), iq.im.data_ptr(),
                                   iq.re.numel() // 4, sink.data_ptr(),
                                   8 * n_sm,
                                   torch.cuda.current_stream(dev).cuda_stream)
        cs.need(code == 0, f"read kernel: CUDA error {code}")
        return sink

    rng = np.random.default_rng(7)
    taps = torch.as_tensor(DS_FILTER, dtype=torch.float32, device=dev)
    mf_taps = torch.as_tensor(DM_FILTER, dtype=torch.float32, device=dev)
    for s, t_len, rate in ((128, 96000, 96000), (64, 192000, 192000)):
        m = rate // 9600

        def rand(*shape):
            return torch.as_tensor(rng.standard_normal(shape, np.float32),
                                   device=dev)

        step = 750 if rate == 96000 else 1500
        tu = torch.as_tensor(tunings_to_nu(step * (8 + np.arange(s) % 21)),
                             dtype=torch.int64, device=dev)
        nu0 = torch.as_tensor(rng.integers(0, NU_SCALE * rate, s),
                              dtype=torch.float32, device=dev)
        cos_pat, sin_pat = _nco_pattern(nu0, tu, rate)
        vco_cos, vco_sin = _vco_pattern(torch.as_tensor(
            rng.integers(0, 8, s), dtype=torch.int32, device=dev))
        inputs = [(CF(rand(s, t_len), rand(s, t_len)), cos_pat, sin_pat, taps,
                   m, CF(rand(s, 26), rand(s, 26)), vco_cos, vco_sin,
                   mf_taps, CF(rand(s, 64), rand(s, 64)),
                   HOWARD_FUDGE_FACTOR) for _ in range(3)]
        fixed_out, rt_out = mix_decimate_mf(*inputs[0]), runtime_m(*inputs[0])
        torch.cuda.synchronize()
        cs.need(all(torch.equal(getattr(f, c), getattr(r, c))
                    for f, r in zip(fixed_out, rt_out) for c in ("re", "im")),
                f"S={s} T={t_len}: the run-time-m kernel differs from the "
                "fixed-m kernel")
        del fixed_out, rt_out
        ab = [cs.device_ms(torch, fn, inputs, 20)
              for fn in (mix_decimate_mf, runtime_m, runtime_m,
                         mix_decimate_mf)]
        k1 = cs.device_ms(torch, lambda *a: mix_decimate(*a[:6], a[10]),
                          inputs, 20)
        rs = cs.device_ms(torch, lambda *a: (a[0].re.sum(dim=1),
                                             a[0].im.sum(dim=1)), inputs, 20)
        dst = CF(torch.empty_like(inputs[0][0].re),
                 torch.empty_like(inputs[0][0].im))
        cp = cs.device_ms(torch, lambda *a: (dst.re.copy_(a[0].re),
                                             dst.im.copy_(a[0].im)),
                          inputs, 20)
        rk = cs.device_ms(torch, read_kernel, inputs, 20)
        del dst
        nbytes = (8.0 * s * t_len + 8.0 * s * (t_len // m)
                  + 4 * 4.0 * s * 128 + 4 * (27 + 65)
                  + 2 * 8.0 * s * (26 + 64))
        b_ms = nbytes / cs.PEAK_BYTES * 1e3
        plane = 8.0 * s * t_len
        print(f"[{card}] S={s} T={t_len} m={m}: device time kernel 6 fixed "
              f"m {ab[0]:.4f} / {ab[3]:.4f} ms, run-time m {ab[1]:.4f} / "
              f"{ab[2]:.4f} ms (outputs equal, bit for bit; fixed, run-time,"
              f" run-time, fixed; {nbytes / min(ab) / 1e6:.0f} GB/s at the "
              f"fastest), kernel 1 {k1:.4f} ms; reads of the two input "
              f"planes: torch row sums {rs:.4f} ms ({plane / rs / 1e6:.0f} "
              f"GB/s), copy_ {cp:.4f} ms ({2 * plane / cp / 1e6:.0f} GB/s "
              f"read + written), float4 read kernel {rk:.4f} ms "
              f"({plane / rk / 1e6:.0f} GB/s); byte bound {b_ms:.4f} ms")
        del inputs
        torch.cuda.empty_cache()
    if args.parent is not None:
        compare_parent(torch, np, cs, dev, card, args.parent.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
