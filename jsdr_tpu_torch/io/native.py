"""ctypes bindings for the native IO library — the port of
:mod:`jsdr_tpu.io.native`, over the port's own copy of its C++ sources
(``io/csrc/jsdr_io.cpp`` and ``io/csrc/flac_dec.cpp``, byte-equal to
``native/``).

At first use the sources are compiled with ``g++`` and the flags of
``native/Makefile`` into ``build/jsdr_tpu_torch/native/`` at the root of
the checkout (git-ignored), never into the source tree. The library is
named by a hash of the sources, the flags and the host's CPU: the flags
hold ``-march=native``, and a build directory copied to a machine with
another CPU must not load a library built for this one. Every entry point
returns None when the library cannot be built or loaded, as the
reference's does (a bare install without a compiler); its callers
(:mod:`~jsdr_tpu_torch.io.convert`, :mod:`~jsdr_tpu_torch.io.flac`) then
take their numpy and pure-Python paths, which give the same bytes.
``calls`` counts the conversions and decodes the library did.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("jsdr_io.cpp", "flac_dec.cpp")
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build" / "jsdr_tpu_torch"
             / "native")
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall")

calls: collections.Counter = collections.Counter()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def cpu_line() -> str:
    """What ``-march=native`` compiles for: the CPU's model name and
    feature flags (``/proc/cpuinfo``), or the machine name without it."""
    keep = []
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key = line.split(":")[0].strip()
            if key in ("model name", "flags") and line not in keep:
                keep.append(line)
            if len(keep) == 2:
                break
    except OSError:
        pass
    return "\n".join(keep) or f"{platform.machine()} {platform.processor()}"


def library_path(cpu: Optional[str] = None) -> Path:
    """Where the library of these sources, flags and ``cpu`` (default:
    this host's :func:`cpu_line`) is built."""
    h = hashlib.sha256(" ".join((CXX, *CXXFLAGS)).encode())
    h.update((cpu_line() if cpu is None else cpu).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libjsdr_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises if
    the compiler fails (its output is kept beside the library as
    ``.log``)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    cmd = [CXX, *CXXFLAGS, "-o", str(tmp), *(str(CSRC / n) for n in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + res.stdout
                                      + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
        lib.jsdr_s16le_iq_to_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int16, ctypes.c_int16,
            ctypes.c_void_p]
        lib.jsdr_s16le_mono_to_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int16, ctypes.c_void_p]
        lib.jsdr_f32_to_s16le.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
        lib.jsdr_flac_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_longlong]
        lib.jsdr_flac_decode.restype = ctypes.c_longlong
        _lib = lib
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    return _lib


def available() -> bool:
    return _load() is not None


def s16le_to_complex_native(samples: np.ndarray, channels: int = 2,
                            i_corr: int = 0,
                            q_corr: int = 0) -> Optional[np.ndarray]:
    """Native conversion; returns None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    s = np.ascontiguousarray(samples, dtype="<i2")
    n_frames = len(s) // channels
    out = np.empty(2 * n_frames, dtype=np.float32)
    if channels == 2:
        lib.jsdr_s16le_iq_to_f32(
            s.ctypes.data, n_frames, i_corr & 0xFFFF, q_corr & 0xFFFF,
            out.ctypes.data)
    else:
        lib.jsdr_s16le_mono_to_f32(
            s.ctypes.data, n_frames, i_corr & 0xFFFF, out.ctypes.data)
    calls["s16le_to_complex"] += 1
    return out.view(np.complex64)


def complex_to_s16le_native(iq: np.ndarray) -> Optional[bytes]:
    """Native float -> S16LE (round half away from zero, clamped); None
    if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    f = np.ascontiguousarray(iq, dtype=np.complex64).view(np.float32)
    out = np.empty(len(f), dtype="<i2")
    lib.jsdr_f32_to_s16le(f.ctypes.data, len(f) // 2, out.ctypes.data)
    calls["complex_to_s16le"] += 1
    return out.tobytes()


def flac_decode_native(data: bytes, channels: int,
                       total: int) -> Optional[np.ndarray]:
    """Native FLAC decode (io/csrc/flac_dec.cpp) -> int32 interleaved
    [total*channels], or None when the library is unavailable or the
    stream needs the Python decoder (e.g. unknown total_samples)."""
    lib = _load()
    if lib is None or total <= 0:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(total * channels, np.int32)
    got = lib.jsdr_flac_decode(buf.ctypes.data, len(data), out.ctypes.data,
                               total)
    if got != total:
        return None
    calls["flac_decode"] += 1
    return out
