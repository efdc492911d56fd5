#!/usr/bin/env python3
"""Where the FEC drain's kernels spend their cycles, on a CUDA card (Hopper).

Run from the root of a checkout:

    python3 tools/fec_probe.py [--parent DIR]

Builds a copy of kernel A (``jsdr_tpu_torch/ops/csrc/fec_viterbi.cu``) and
kernel B (``fec_rs.cu``) with ``clock64()`` marks in CTA 0 (the sources'
``FEC_MARK`` points, compiled in with ``-DFEC_PROBE``) into
``build/fec_probe/`` (git-ignored), runs them at 128 frames, checks their
outputs equal to the plain versions, and prints beside the card's name and
power limit and its SM clock under this load (``nvidia-smi --query-gpu=
clocks.sm``):

- kernel A: the staging and pair-metric pre-pass, the ACS loop, the
  chain-back, the output store, in cycles, and the ACS loop's cycles a
  step;
- kernel B, on clean, correctable (Berlekamp-Massey, Chien and Forney run)
  and undecodable frames: the table load and demux, the syndromes,
  Berlekamp-Massey/Chien/Forney, the parity, the channel compare and the
  block sum;
- each kernel's device time at 128 frames (CUDA events over 50 calls).

With ``--parent DIR`` (another checkout, e.g. ``git archive f6fbb69 | tar
-x -C build/parent``; ``build/`` is copied to the card's machine) it also
instruments that checkout's two kernels and prints the same split for
them, timed in turns (parent, this, this, parent). A source without
``FEC_MARK`` points is taken as the first design of the two kernels (one
warp a frame with ballot words and a chain-back of 2,560 steps; one CTA of
64 threads a frame with an LFSR parity) and marked through text anchors of
that design. Imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "fec_probe"
N_FRAMES = 128

A_MARKS = ("staging + pre-pass", "ACS loop", "chain-back", "output store")
B_MARKS = ("table load + demux", "syndromes", "BM/Chien/Forney", "parity",
           "channel compare", "block sum")
# kernel A's marks in the first design (one warp a frame; the ACS loop ends
# where the chain-back starts; kernel B's marks are B_MARKS there too)
A_FIRST = ("staging", "ACS loop", "chain-back + bytes")


def _put(s: str, anchor: str, text: str, after: bool = True) -> str:
    if anchor not in s:
        raise RuntimeError(f"anchor not found: {anchor!r}")
    return s.replace(anchor, anchor + text if after else text + anchor, 1)


def _rec(name: str, k: int, who: str = "threadIdx.x == 0") -> str:
    return (f"if (blockIdx.x == 0 && {who}) {name}[{k}] = clock64();\n")


def instrument_first_viterbi(s: str) -> str:
    """Marks in the first design's kernel A (its text anchors)."""
    s = _put(s, "namespace {\n", "__device__ long long fec_viterbi_marks[8];\n")
    s = _put(s, "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n",
             "  " + _rec("fec_viterbi_marks", 0))
    s = _put(s, "  if (!live) return;\n", "  " + _rec("fec_viterbi_marks", 1))
    s = _put(s, "  // ---- chain-back from state 0",
             "  " + _rec("fec_viterbi_marks", 2), after=False)
    s = _put(s, "      s = (s >> 1) | (bit << 5);\n    }\n",
             "    " + _rec("fec_viterbi_marks", 3, "threadIdx.x == 0"))
    return s + ('\nextern "C" int jsdr_fec_viterbi_marks(long long* host) {\n'
                "  return (int)cudaMemcpyFromSymbol(host, fec_viterbi_marks, "
                "64);\n}\n")


def instrument_first_rs(s: str) -> str:
    """Marks in the first design's kernel B (its text anchors)."""
    rec = lambda k: "  " + _rec("fec_rs_marks", k)   # noqa: E731
    s = _put(s, "namespace {\n", "__device__ long long fec_rs_marks[8];\n")
    s = _put(s, "  const long long f = blockIdx.x;\n  load_gf(tab, alpha, index);\n"
             "  const uint8_t* scr = tab + kTabScr;\n", rec(0), after=False)
    s = _put(s, "cw[i & 1][i >> 1] = 0;\n  __syncthreads();\n", rec(1))
    s = _put(s, "  if (__ballot_sync(kFull, s != 0) == 0) return 0;\n", rec(2),
             after=False)
    s = _put(s, "  if (lane == 0) nerr[warp] = n;\n  __syncthreads();\n", rec(3))
    s = _put(s, "  encode_prep(pay, sb, tab + kTabGen, g);\n  __syncthreads();\n",
             rec(4))
    s = _put(s, "    errs += channel_symbol(p, sb, sync) != (r[p] >> 7);\n",
             rec(5))
    s = _put(s, "  if (tid == 0) rc[f] = tot;\n", rec(6))
    return s + ('\nextern "C" int jsdr_fec_rs_marks(long long* host) {\n'
                "  return (int)cudaMemcpyFromSymbol(host, fec_rs_marks, 64);\n}\n")


def first_rs_table(T) -> np.ndarray:
    """The first design's table blob: ALPHA_TO, INDEX_OF, the generator's
    logs g[0..31], SCRAMBLER[:320], SYNC_BITS."""
    g = np.zeros(T.NROOTS, np.int64)
    g[1:16] = T.RS_POLY[:15]
    g[16] = T.RS_POLY[15]
    g[17:32] = T.RS_POLY[14::-1][:15]
    return np.concatenate([np.asarray(T.ALPHA_TO), np.asarray(T.INDEX_OF), g,
                           np.asarray(T.SCRAMBLER[:320]),
                           np.asarray(T.SYNC_BITS)]).astype(np.uint8)


class Design:
    """One checkout's two kernels, instrumented and loaded."""

    def __init__(self, name: str, csrc: Path, torch, dev):
        from jsdr_tpu_torch.fec import _device
        from jsdr_tpu_torch.fec import tables as T
        from jsdr_tpu_torch.ops import _build

        self.name = name
        vit = (csrc / "fec_viterbi.cu").read_text()
        rs = (csrc / "fec_rs.cu").read_text()
        self.first = "FEC_MARK" not in vit
        if self.first:
            vit, rs = instrument_first_viterbi(vit), instrument_first_rs(rs)
            blob = first_rs_table(T)
        else:
            blob = _device.rs_table()
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "fec_viterbi.cu").write_text(vit)
        (d / "fec_rs.cu").write_text(rs)
        so = d / "libfec_probe.so"
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-DFEC_PROBE", "-shared",
             "-o", str(so), str(d / "fec_viterbi.cu"), str(d / "fec_rs.cu")],
            capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(res.stdout + res.stderr)
        self.ptxas = [ln for ln in (res.stdout + res.stderr).splitlines()
                      if "registers" in ln or "spill" in ln]
        self.so = so
        self.lib = ctypes.CDLL(str(so), mode=os.RTLD_LOCAL)
        for fn in ("jsdr_fec_viterbi", "jsdr_fec_frame"):
            getattr(self.lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(self.lib, fn).restype = ctypes.c_int
        for fn in ("jsdr_fec_viterbi_marks", "jsdr_fec_rs_marks"):
            getattr(self.lib, fn).argtypes = [ctypes.c_void_p]
        self.vtab = torch.as_tensor(_device.VITERBI_TABLE, device=dev)
        self.rtab = torch.as_tensor(blob, device=dev)

    def viterbi(self, torch, raw, out):
        stream = torch.cuda.current_stream().cuda_stream
        if self.lib.jsdr_fec_viterbi(raw.data_ptr(), self.vtab.data_ptr(),
                                     out.data_ptr(), raw.shape[0], 1, stream):
            raise RuntimeError(f"{self.name}: kernel A did not launch")

    def check(self, torch, vit, raw, outs):
        stream = torch.cuda.current_stream().cuda_stream
        if self.lib.jsdr_fec_frame(vit.data_ptr(), raw.data_ptr(),
                                   self.rtab.data_ptr(),
                                   *(o.data_ptr() for o in outs),
                                   raw.shape[0], stream):
            raise RuntimeError(f"{self.name}: kernel B did not launch")

    def marks(self, which: str) -> np.ndarray:
        buf = np.zeros(8, np.int64)
        fn = getattr(self.lib, f"jsdr_fec_{which}_marks")
        if fn(buf.ctypes.data):
            raise RuntimeError("marks not read")
        return buf


def sass_acs(so: Path) -> str:
    """Kernel A's ACS loop as compiled: the backward branch in
    ``viterbi_kernel`` whose body holds the most shuffles, its instruction
    count and the opcodes that fill it."""
    import re
    from collections import Counter

    from jsdr_tpu_torch.ops import _build

    dump = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(so)], capture_output=True,
                          text=True).stdout
    parts = re.split(r"\n\s+Function : ", dump)
    body = next((p for p in parts if p.split("\n", 1)[0].find(
        "viterbi_kernel") >= 0), "")
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(.*?);", body)]
    best = None
    for addr, text in ins:
        if "BRA" not in text or "0x" not in text:
            continue
        target = int(text.split()[-1], 16)
        loop = [t for a, t in ins if target <= a <= addr]
        n_shfl = sum("SHFL" in t for t in loop)
        if target < addr and (best is None or n_shfl > best[0]):
            best = (n_shfl, target, addr, loop)
    if best is None:
        return "no loop found"
    n_shfl, target, addr, loop = best
    ops = Counter((t.split()[1] if t.startswith("@") else t.split()[0])
                  .split(".")[0] for t in loop)
    top = ", ".join(f"{k} {v}" for k, v in ops.most_common(10))
    return (f"loop {target:#x}-{addr:#x}: {len(loop)} instructions, "
            f"{n_shfl} SHFL; {top}")


def frames(torch, rng, kind: str) -> np.ndarray:
    """[N_FRAMES, 5200] soft windows: ``clean`` (encoded random payloads,
    soft noise), ``errs`` (8 byte errors in codeword 0 and 4 in codeword 1
    of the Viterbi sequence: correctable, so every phase runs) or ``bad``
    (random bytes: undecodable)."""
    from jsdr_tpu_torch.fec import ref_numpy as R
    from jsdr_tpu_torch.fec.encode import encode_bytes

    if kind == "bad":
        return rng.integers(0, 256, (N_FRAMES, 5200)).astype(np.uint8)
    seqs = []
    for _ in range(N_FRAMES):
        seq = R.frame_bytes(rng.integers(0, 256, 256, dtype=np.uint8))
        if kind == "errs":
            for c, n_err in ((0, 8), (1, 4)):
                k = rng.choice(160, n_err, replace=False)
                seq[2 * k + c] ^= rng.integers(1, 256, n_err).astype(np.uint8)
        seqs.append(seq)
    sym = encode_bytes(torch.from_numpy(np.stack(seqs))).numpy()
    w = np.where(sym > 0, 0xC0, 0x40).astype(np.int32)
    w += rng.integers(-40, 40, w.shape)
    return np.clip(w, 0, 255).astype(np.uint8)


def event_ms(torch, fn, n: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def split(m: np.ndarray, names) -> str:
    d = np.diff(m[:len(names) + 1])
    return ", ".join(f"{n} {int(c)}" for n, c in zip(names, d)) + (
        f"; total {int(m[len(names)] - m[0])} cycles")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="another checkout (repeatable; named by its "
                    "directory)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fec_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from jsdr_tpu_torch.fec import decoder as TD
    from jsdr_tpu_torch.fec import viterbi as TV
    from jsdr_tpu_torch.fec.tables import NBITS

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    designs = [Design("this", ROOT / "jsdr_tpu_torch" / "ops" / "csrc",
                      torch, dev)]
    for parent in args.parent:
        designs.append(Design(parent.name, parent / "jsdr_tpu_torch" /
                              "ops" / "csrc", torch, dev))
    for d in designs:
        for ln in d.ptxas:
            print(f"ptxas [{d.name}]: {ln.strip()}")
        try:
            print(f"sass [{d.name}]: {sass_acs(d.so)}")
        except (OSError, ValueError, IndexError) as e:
            print(f"sass [{d.name}]: not read ({e})")

    rng = np.random.default_rng(2026)
    raws = {k: torch.from_numpy(frames(torch, rng, k)).to(dev)
            for k in ("clean", "errs", "bad")}
    want_a = {k: TV.bits_to_bytes(TV.viterbi27_bits_ref(TV.deinterleave(r)))
              for k, r in raws.items()}
    want_b = {k: TD._fec_check_ref(want_a[k], r) for k, r in raws.items()}
    n = N_FRAMES
    for k in ("errs", "bad"):
        print(f"inputs: {k}: ok {int(want_b[k].ok.sum())} of {n}, rs_errors "
              f"of frame 0 {want_b[k].rs_errors[0].tolist()}")

    order = designs + designs[::-1] if len(designs) > 1 else designs * 2
    times = {d.name: {} for d in designs}
    for d in order:
        out = torch.empty((n, 320), dtype=torch.uint8, device=dev)
        for _ in range(2):                          # the second is read
            d.viterbi(torch, raws["clean"], out)
        torch.cuda.synchronize()
        if not torch.equal(out, want_a["clean"]):
            raise RuntimeError(f"{d.name}: kernel A differs from plain")
        ma = d.marks("viterbi")
        t = times[d.name]
        t.setdefault("A", []).append(event_ms(
            torch, lambda: d.viterbi(torch, raws["clean"], out)))
        lines = [f"kernel A [{d.name}] at {n} frames (equal to plain): "
                 + split(ma, A_FIRST if d.first else A_MARKS)
                 + f"; ACS {(ma[2] - ma[1]) / NBITS:.2f} cycles a step"]
        for k in ("clean", "errs", "bad"):
            outs = (torch.empty((n, 256), dtype=torch.uint8, device=dev),
                    torch.empty(n, dtype=torch.bool, device=dev),
                    torch.empty((n, 2), dtype=torch.int32, device=dev),
                    torch.empty(n, dtype=torch.int32, device=dev))
            for _ in range(2):
                d.check(torch, want_a[k], raws[k], outs)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(outs, want_b[k])):
                raise RuntimeError(f"{d.name}: kernel B differs on {k}")
            mb = d.marks("rs")
            t.setdefault(f"B {k}", []).append(event_ms(
                torch, lambda: d.check(torch, want_a[k], raws[k], outs)))
            names = B_MARKS
            if k == "clean":     # stops after the syndromes: 2 -> 3 is the wait
                names = names[:2] + ("(clean: none)",) + names[3:]
            if k == "bad":       # no parity, no compare
                names = names[:3]
            ok0 = "ok" if want_b[k].ok[0].item() else "not ok"
            lines.append(f"kernel B [{d.name}] {k} (frame 0 {ok0}; equal to "
                         "plain): " + split(mb, names))
        if len(t["A"]) == 1:
            print("\n".join(lines))

    # the SM clock under this load: nvidia-smi samples every 100 ms while
    # kernel A runs back to back for about 2 s
    d = designs[0]
    out = torch.empty((n, 320), dtype=torch.uint8, device=dev)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + 2.0
        while time.perf_counter() < t_end:
            for _ in range(200):
                d.viterbi(torch, raws["clean"], out)
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        clk = smi.communicate(timeout=10)[0].split()
    mhz = [int(c) for c in clk if c.isdigit()]
    print(f"SM clock under kernel A's load: {len(mhz)} samples of clocks.sm, "
          f"median {np.median(mhz) if mhz else 'none'} MHz, min "
          f"{min(mhz, default=0)}, max {max(mhz, default=0)}")
    for name, t in times.items():
        print(f"device ms [{name}] at {n} frames, CUDA events over 50 calls, "
              "in turns: " + ", ".join(
                  f"{k} {' / '.join(f'{v:.4f}' for v in vs)}"
                  for k, vs in t.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
