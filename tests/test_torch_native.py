"""The port's native IO library (``jsdr_tpu_torch/io/native.py`` over its
copy of the C++ sources) against the reference's (``jsdr_tpu.io.native``
over ``native/``) and against the numpy / pure-Python paths, on the host.

The copied sources are byte-equal to ``native/``; the library is built
with ``g++`` into ``build/jsdr_tpu_torch/native/`` under a name keyed by
the sources, the flags and the CPU; every binding's output is byte-equal
to the reference binding's and to the numpy / Python path's, but for the
float -> S16LE rounding at exact half-way points, where numpy rounds half
to even and the C loop half away from zero, in both packages."""

from pathlib import Path

import numpy as np
import pytest

import jsdr_tpu.io.native as j_native
import jsdr_tpu_torch.io.convert as t_convert
import jsdr_tpu_torch.io.flac as t_flac
import jsdr_tpu_torch.io.native as t_native

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", t_native.SOURCES)
def test_sources_are_byte_equal_to_native(name):
    assert ((ROOT / "jsdr_tpu_torch" / "io" / "csrc" / name).read_bytes()
            == (ROOT / "native" / name).read_bytes())


def test_library_builds_under_build_keyed_by_sources_flags_and_cpu():
    assert t_native.available()
    so = t_native.build()
    assert so == t_native.library_path() and so.is_file()
    assert so.parent == ROOT / "build" / "jsdr_tpu_torch" / "native"
    assert so.resolve() != (ROOT / "native" / "libjsdr_io.so").resolve()
    line = t_native.cpu_line()
    assert line
    other = t_native.library_path(line + " avx512f")
    assert other != so and other.parent == so.parent
    assert t_native.library_path(line) == so


@pytest.mark.parametrize("channels,i_corr,q_corr",
                         [(2, 0, 0), (2, 1200, -77), (2, -40000, 70000),
                          (1, 32767, 0), (1, -5, 0)])
def test_s16le_to_complex_native_is_byte_equal(channels, i_corr, q_corr):
    raw = np.random.default_rng(3).integers(-32768, 32768, 8192,
                                            dtype=np.int16).astype("<i2")
    got = t_native.s16le_to_complex_native(raw, channels, i_corr, q_corr)
    want = j_native.s16le_to_complex_native(raw, channels, i_corr, q_corr)
    assert got is not None and want is not None
    assert got.dtype == np.complex64 and got.tobytes() == want.tobytes()
    before = t_native.calls["s16le_to_complex"]
    assert t_convert.s16le_to_complex(raw.tobytes(), channels, i_corr,
                                      q_corr).tobytes() == got.tobytes()
    assert t_native.calls["s16le_to_complex"] == before + 1
    # the numpy path (the same function without the library)
    s = raw
    if channels == 2:
        s = s.reshape(-1, 2)
        i = (s[:, 0].astype(np.uint16) + np.uint16(i_corr & 0xFFFF)
             ).astype(np.int16)
        q = (s[:, 1].astype(np.uint16) + np.uint16(q_corr & 0xFFFF)
             ).astype(np.int16)
    else:
        i = (s.astype(np.uint16) + np.uint16(i_corr & 0xFFFF)).astype(np.int16)
        q = np.zeros_like(i)
    scale = np.float32(1.0 / 32767.0)
    plain = (i.astype(np.float32) * scale
             + 1j * (q.astype(np.float32) * scale)).astype(np.complex64)
    assert plain.tobytes() == got.tobytes()


def test_complex_to_s16le_native_is_byte_equal():
    rng = np.random.default_rng(8)
    iq = (rng.uniform(-1.2, 1.2, 6000)
          + 1j * rng.uniform(-1.2, 1.2, 6000)).astype(np.complex64)
    got = t_native.complex_to_s16le_native(iq)
    assert got is not None
    assert got == j_native.complex_to_s16le_native(iq)
    # the numpy path (io.convert.complex_to_s16le, which the reference does
    # not route to the library) rounds half to even, the C loop half away
    # from zero: equal everywhere but on exact half-way products
    g = np.frombuffer(got, "<i2")
    w = np.frombuffer(t_convert.complex_to_s16le(iq), "<i2")
    v = iq.view(np.float32) * np.float32(32767.0)
    tie = (np.abs(v - np.trunc(v)) == 0.5) & (np.abs(v) < 32767)
    assert 0 < tie.sum() < 20
    np.testing.assert_array_equal(g[~tie], w[~tie])
    np.testing.assert_array_equal(g[tie], np.trunc(v[tie] + np.sign(v[tie])
                                                   * 0.5).astype(np.int16))


@pytest.mark.parametrize("channels,bps", [(2, 16), (1, 16), (2, 24)])
def test_flac_decode_native_is_byte_equal(tmp_path, channels, bps):
    rng = np.random.default_rng(channels * bps)
    n = 9000
    hi = 1 << (bps - 1)
    t = np.arange(n)
    smooth = (0.6 * hi * np.sin(2 * np.pi * 440 * t / 48000))[:, None]
    samples = np.clip(smooth + rng.integers(-300, 300, (n, channels)),
                      -hi, hi - 1).astype(np.int32)
    path = tmp_path / "x.flac"
    t_flac.write_flac(path, samples, 48000, bps=bps)
    data = path.read_bytes()
    rate, ch, got_bps, total, _md5, _pos = t_flac.parse_streaminfo(data)
    assert (rate, ch, got_bps, total) == (48000, channels, bps, n)
    got = t_native.flac_decode_native(data, ch, total)
    want = j_native.flac_decode_native(data, ch, total)
    assert got is not None and got.tobytes() == want.tobytes()
    before = t_native.calls["flac_decode"]
    fast = t_flac.read_flac(path)
    slow = t_flac.read_flac(path, prefer_native=False)
    assert t_native.calls["flac_decode"] == before + 1
    assert fast[0].dtype == slow[0].dtype == np.int32
    assert fast[0].tobytes() == slow[0].tobytes() == samples.tobytes()
    assert fast[1:] == slow[1:] == (48000, bps)
    assert got.tobytes() == samples.reshape(-1).tobytes()
