"""Build and load the port's CUDA kernels.

The sources under ``ops/csrc/*.cu`` have a plain C interface. At first
use each is compiled with ``nvcc`` for Hopper (``sm_90a``), one compiler
process per source, all started together; the objects are linked into
one shared library under ``build/jsdr_tpu_torch/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the sources
(headers included) and flags, and loaded with ``ctypes``. A later call in any process reuses the
library while the sources are unchanged. Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc``.

Each C entry point enqueues on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception. Each Python wrapper that launches one counts its launches
(:func:`counts_launches`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jsdr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: pointer and stream arguments are void*, ints are int
_SIGNATURES = {
    # xr, xi, cos, sin, taps, tail_r, tail_i, yr, yi, ntail_r, ntail_i,
    # n_streams, t_len, m, gain, stream
    "jsdr_mix_decimate": [_P] * 11 + [_I, _I, _I, _F, _P],
    # mf_re, mf_im, e_ema, peak, new_peak, e_out, last_iq, valid, bit,
    # e_ema', peak', new_peak', e_out', last_iq', n_streams, n_groups,
    # chunk, s1, a1, s2, a2, gate, stream
    "jsdr_timing_recover": [_P] * 14 + [_I, _I, _I, _F, _F, _F, _F, _F, _P],
    # xr, xi, win, the plan (passes, ptwr, ptwi, perm, gwr, gwi, s2r, s2i,
    # k2map), twr, twi, wf, mx, idx, n_streams, t_len, n1, q, n_pass, rg,
    # cf, ranks, stream
    "jsdr_spectrum_wf": [_P] * 17 + [_I] * 6 + [_F, _I, _P],
    # xr, xi, win, the plan, twr, twi, cos, sin, taps, tail_r, tail_i, wf,
    # mx, idx, yr, yi, ntail_r, ntail_i, n_streams, t_len, n1, q, n_pass,
    # rg, cf, m, gain, ranks, stream
    "jsdr_spec_front": [_P] * 26 + [_I] * 6 + [_F, _I, _F, _I, _P],
    # ranks, bytes (int*)
    "jsdr_spec_front_static_smem": [_I, _P],
    # re, im, db, line, n_rows, n, width, cf, stream
    "jsdr_psd_waterfall": [_P] * 4 + [_I, _I, _I, _F, _P],
    # xr, xi, cos, sin, taps, tail_r, tail_i, vco_cos, vco_sin, mf_taps,
    # mtail_r, mtail_i, yr, yi, ntail_r, ntail_i, nmtail_r, nmtail_i,
    # n_streams, t_len, m, gain, stream
    "jsdr_mix_dec_mf": [_P] * 18 + [_I, _I, _I, _F, _P],
    # in, tab, out, n_frames, deint, stream
    "jsdr_fec_viterbi": [_P] * 3 + [_I, _I, _P],
    # vit, raw, tab, payload, ok, rs_errors, rc, n_frames, stream
    "jsdr_fec_frame": [_P] * 7 + [_I, _P],
    # data, tab, corrected, n_err, n_words, stream
    "jsdr_rs_decode": [_P] * 4 + [_I, _P],
    # payload, tab, frame, n_frames, stream
    "jsdr_fec_encode": [_P] * 3 + [_I, _P],
    # in, re, im, n, channels, i_corr, q_corr, scale, stream
    "jsdr_s16_to_cf": [_P] * 3 + [_I] * 4 + [_F, _P],
}


# every kernel wrapper that counts its launches, in the order defined
LAUNCH_COUNTERS: list = []


def counts_launches(fn):
    """Register the kernel wrapper ``fn``, which adds each launch it makes
    to ``fn.launches`` (from 0 here): :data:`LAUNCH_COUNTERS` lists it, so
    a replayed CUDA graph adds the launches it holds to their wrappers'
    counters (:class:`~jsdr_tpu_torch.runtime.graph.GraphStep`)."""
    fn.launches = 0
    LAUNCH_COUNTERS.append(fn)
    return fn


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the port's kernels need "
                           "nvcc to build")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists;
    returns its path. The compilers' output (``-Xptxas=-v``: registers,
    shared memory, spills per kernel) is kept beside it as ``.log``."""
    so = BUILD_DIR / f"libjsdr_tpu_torch_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], False
    for cmd, _obj, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        failed |= proc.returncode != 0
    tmp = so.with_name(f"{tag}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(j[1]) for j in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        failed = res.returncode != 0
    for _cmd, obj, _proc in jobs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(log))
    os.replace(tmp, so)
    return so


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.jsdr_error_string.argtypes = [_I]
    lib.jsdr_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = kernels().jsdr_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def check_tensor(fn: str, name: str, x, shape, dtype, device) -> None:
    """Raise unless ``x`` is what a kernel's raw pointer may stand for: a
    contiguous tensor of ``dtype`` and ``shape`` on ``device``."""
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")
