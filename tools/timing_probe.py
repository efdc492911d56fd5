#!/usr/bin/env python3
"""Where the timing kernel's cycles go, on a CUDA card (Hopper).

Run from the root of a checkout:

    python3 tools/timing_probe.py

Prints, beside the card's name and power limit:

1. The latency of one step of the EMA chain on its own: a dependent
   ``__fmul_rn`` + ``__fadd_rn`` pair (the kernel's step), and for
   comparison one ``__fmaf_rn`` and one ``__fadd_rn``, from ``clock64()``
   around 8,192 steps in one warp.
2. The split of one iteration of ``jsdr_tpu_torch/ops/csrc/timing.cu``
   (chunks of ``CHUNK_GROUPS`` groups) into its roles: a copy of the
   source with ``clock64()`` marks in CTA 0 is built beside the port's
   library and run at 128 x 46,080 (the flagship block); each mark is
   printed in cycles after the iteration's start, averaged over the
   steady iterations. Its outputs are checked equal to the plain version.
3. The chain lanes' loop in the compiled kernel (``cuobjdump -sass``): its
   instructions per pass, the stall cycles its scheduling fixes, and where
   its shared-memory loads sit.

Builds go to ``build/timing_probe/`` (git-ignored). Imports no jax.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "timing_probe"

LATENCY_CU = r"""
#include <cuda_runtime.h>
__global__ void chain(const float* in, float* out, long long* cyc, int n,
                      int mode, float a) {
  float b[8];
  for (int k = 0; k < 8; ++k) b[k] = in[threadIdx.x * 8 + k];
  float x = in[threadIdx.x];
  const long long t0 = clock64();
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (mode == 0) x = __fadd_rn(__fmul_rn(x, a), b[k]);
      else if (mode == 1) x = __fmaf_rn(x, a, b[k]);
      else x = __fadd_rn(x, b[k]);
    }
  }
  cyc[threadIdx.x] = clock64() - t0;
  out[threadIdx.x] = x;
}
extern "C" int run(const float* in, float* out, long long* cyc, int n,
                   int mode) {
  chain<<<1, 32>>>(in, out, cyc, n, mode, 0.995f);
  return (int)cudaGetLastError();
}
"""

# (mark, thread that records it, what it follows) in the instrumented copy
MARKS = ("top", "staged", "chain end", "energies end", "workers bar 1",
         "workers bar 2", "workers bar 3", "decisions end", "e_out end",
         "copies landed", "iteration end")


def nvcc(cmd_out: Path, src: Path) -> None:
    from jsdr_tpu_torch.ops import _build

    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(cmd_out), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)


def instrumented(src: str) -> str:
    """csrc/timing.cu with clock64() marks of CTA 0, read by v_marks()."""
    def rec(k: int, who: str) -> str:
        return (f"if (blockIdx.x == 0 && tid == ({who})) "
                f"marks[it * 16 + {k}] = clock64();\n")

    def put(s: str, anchor: str, text: str, after: bool = True) -> str:
        if anchor not in s:
            raise RuntimeError(f"anchor not found in timing.cu: {anchor!r}")
        return s.replace(anchor, anchor + text if after else text + anchor, 1)

    s = put(src, "namespace {\n", "__device__ long long marks[16 * 8192];\n")
    s = put(s, "  for (int it = 0; it <= n_chunks + 1; ++it) {\n", rec(0, 32))
    s = put(s, "    if (loader) stage(it + kAhead);\n", rec(1, 32))
    s = put(s, "    } else if (worker) {\n", rec(2, 0), after=False)
    s = put(s, "      if (it + 1 < n_chunks) energies(it + 1);\n", rec(3, 32))
    sync = "        workers_sync(C);\n"
    parts = s.split(sync)
    if len(parts) != 4:
        raise RuntimeError("timing.cu: expected three workers' barriers")
    s = parts[0] + "".join(sync + rec(k, 32) + p
                           for k, p in zip((4, 5, 6), parts[1:]))
    s = put(s, "          lq_c = lq[total - 1];\n        }\n", rec(7, 32))
    s = put(s, "      ema_run<false>(list_c + (c & 1) * 2 * C, nullptr, "
            "n_fired[c & 1], a2,\n                     eo);\n",
            rec(8, "C + 32"))
    s = put(s, "    cp_async_wait_ahead();  // chunk it+2, for the energies of "
            "it+1\n", rec(9, 32))
    end = "    __syncthreads();\n  }\n"
    s = put(s, end, "", after=False).replace(
        end, "    __syncthreads();\n" + rec(10, 32) + "  }\n", 1)
    s = s.replace("jsdr_timing_recover", "v_timing")
    return s + ('\nextern "C" int v_marks(long long* host, int n) {\n'
                "  return (int)cudaMemcpyFromSymbol(host, marks, n * 8);\n}\n")


def sass_loop(so: Path) -> None:
    """The chain lanes' loop: the backward branch whose body holds the
    trajectory's 16-byte stores and the multiplies of the chain."""
    from jsdr_tpu_torch.ops import _build

    dump = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(so)], capture_output=True,
                          text=True).stdout.splitlines()
    ins = []
    for i, line in enumerate(dump[:-1]):
        m = re.match(r"\s*/\*([0-9a-f]{4})\*/\s+(.*?);\s*/\* 0x[0-9a-f]+ \*/",
                     line)
        ctl = re.search(r"/\* (0x[0-9a-f]+) \*/", dump[i + 1])
        if m and ctl:
            # control bits above 105: stall cycles in the low 4
            ins.append((int(m.group(1), 16), m.group(2).strip(),
                        (int(ctl.group(1), 16) >> 41) & 0xF))
    for addr, text, _ in ins:
        if "BRA" not in text:
            continue
        target = int(text.split()[-1], 16)
        body = [x for x in ins if target <= x[0] <= addr]
        if (target < addr and len(body) <= 100
                and any("STS.128" in x[1] for x in body)
                and sum("FMUL" in x[1] for x in body) >= 8):
            fmul = [k for k, x in enumerate(body) if "FMUL" in x[1]]
            loads = [k for k, x in enumerate(body) if "LDS" in x[1]]
            print(f"chain loop {target:#x}-{addr:#x}: {len(body)} "
                  f"instructions, {len(fmul)} steps a pass, "
                  f"{sum(x[2] for x in body)} stall cycles fixed by the "
                  f"schedule ({sum(x[2] for x in body) / len(fmul):.2f} a "
                  f"step); shared-memory loads at positions {loads}, the "
                  f"last multiply at {fmul[-1]}")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("timing_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from jsdr_tpu_torch.demod.bpsk import (BIT_SMOOTH1, BIT_SMOOTH2,
                                           ENERGY_GATE)
    from jsdr_tpu_torch.ops import _build
    from jsdr_tpu_torch.ops.timing_kernel import (CHUNK_GROUPS, _coeffs,
                                                  timing_recover_ref)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    OUT.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")

    # 1. the chain step's latency on its own
    (OUT / "latency.cu").write_text(LATENCY_CU)
    nvcc(OUT / "latency.so", OUT / "latency.cu")
    lat = ctypes.CDLL(str(OUT / "latency.so"))
    lat.run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    inp = torch.rand(256, device=dev)
    out = torch.empty(32, device=dev)
    cyc = torch.zeros(32, dtype=torch.int64, device=dev)
    steps = 8192
    for mode, what in ((0, "__fmul_rn then __fadd_rn (the chain's step)"),
                       (1, "__fmaf_rn"), (2, "__fadd_rn")):
        if lat.run(inp.data_ptr(), out.data_ptr(), cyc.data_ptr(), steps,
                   mode):
            raise RuntimeError("latency kernel did not launch")
        torch.cuda.synchronize()
        print(f"latency [{card}]: {what}: {cyc[0].item() / steps:.2f} "
              f"cycles a dependent step")

    # 2. one iteration of the kernel, split by role
    src = (_build.CSRC / "timing.cu").read_text()
    (OUT / "timing_marks.cu").write_text(instrumented(src))
    nvcc(OUT / "timing_marks.so", OUT / "timing_marks.cu")
    lib = ctypes.CDLL(str(OUT / "timing_marks.so"))
    fn = lib.v_timing
    fn.argtypes = _build._SIGNATURES["jsdr_timing_recover"]
    fn.restype = ctypes.c_int
    lib.v_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    s, t_ds = 128, 46080
    g = t_ds // 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    x = [torch.randn((s, t_ds), generator=gen, device=dev) * 30
         for _ in range(2)]
    st = (torch.rand((s, 8), generator=gen, device=dev) * 2e4,
          torch.randint(0, 8, (s,), generator=gen, device=dev,
                        dtype=torch.int32),
          torch.randint(0, 8, (s,), generator=gen, device=dev,
                        dtype=torch.int32),
          torch.rand((s,), generator=gen, device=dev) * 100,
          torch.randn((s, 2), generator=gen, device=dev) * 50)
    outs = (torch.empty((s, 2 * g), dtype=torch.bool, device=dev),
            torch.empty((s, 2 * g), dtype=torch.bool, device=dev),
            *(torch.empty_like(a) for a in st))
    s1, a1, s2, a2 = _coeffs(BIT_SMOOTH1, BIT_SMOOTH2)
    for _ in range(2):                                 # the second is read
        if fn(*(a.data_ptr() for a in (*x, *st, *outs)), s, g, CHUNK_GROUPS,
              s1, a1, s2, a2, float(np.float32(ENERGY_GATE)),
              torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("instrumented kernel did not launch")
        torch.cuda.synchronize()
    want = timing_recover_ref(*x, *st, smooth1=BIT_SMOOTH1,
                              smooth2=BIT_SMOOTH2, gate=ENERGY_GATE)
    if not all(torch.equal(a, b) for a, b in zip(outs, want)):
        raise RuntimeError("instrumented kernel differs from plain")
    n_it = (g + CHUNK_GROUPS - 1) // CHUNK_GROUPS + 2
    buf = np.zeros(16 * 8192, np.int64)
    if lib.v_marks(buf.ctypes.data, buf.size):
        raise RuntimeError("marks not read")
    m = buf[:16 * n_it].reshape(n_it, 16)[:, :len(MARKS)].astype(float)
    steady = m[3:n_it - 3]
    print(f"iteration split [{card}] S={s} T_ds={t_ds}, chunks of "
          f"{CHUNK_GROUPS} groups, {n_it} iterations (outputs equal to "
          f"plain): {np.diff(m[:, 0])[3:n_it - 3].mean():.0f} cycles an "
          f"iteration; marks, cycles after the iteration's start:")
    for k, name in enumerate(MARKS):
        rel = steady[:, k] - steady[:, 0]
        print(f"  {name:14s} {rel.mean():7.0f} (min {rel.min():.0f}, max "
              f"{rel.max():.0f})")

    # 3. the chain lanes' loop as compiled
    sass_loop(OUT / "timing_marks.so")
    return 0


if __name__ == "__main__":
    sys.exit(main())
