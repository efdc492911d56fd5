"""The port keeps its own copies of the JAX package's JAX-free host modules
(``fec.tables``, ``fec.ref_numpy``, ``io.convert``, ``io.sources``,
``io.flac``, ``io.framer``, ``io.recorder``, ``io.live``, ``io.fcd``,
``runtime.pubsub``, ``runtime.log``, ``runtime.config``, ``display.*``,
and the shell's model in ``app.tui``) so that it imports nothing of
``jsdr_tpu``.

These tests hold that rule and the copies: an AST scan of every module of
the port and of ``chip_smoke.py`` for imports of ``jax`` or ``jsdr_tpu``,
byte equality of the copies' tables and outputs with the reference's,
and, for the verbatim copies, equal code (the syntax tree without the
module docstring; for ``app.tui``, of each copied class and function)."""

import ast
import struct
from pathlib import Path

import numpy as np
import pytest

import jsdr_tpu.fec.ref_numpy as j_ref
import jsdr_tpu.fec.tables as j_tables
import jsdr_tpu.io.convert as j_convert
import jsdr_tpu.io.flac as j_flac
import jsdr_tpu.io.framer as j_framer
import jsdr_tpu.io.live as j_live
import jsdr_tpu.io.recorder as j_recorder
import jsdr_tpu.io.sources as j_sources
import jsdr_tpu_torch.fec.ref_numpy as t_ref
import jsdr_tpu_torch.fec.tables as t_tables
import jsdr_tpu_torch.io.convert as t_convert
import jsdr_tpu_torch.io.flac as t_flac
import jsdr_tpu_torch.io.framer as t_framer
import jsdr_tpu_torch.io.live as t_live
import jsdr_tpu_torch.io.recorder as t_recorder
import jsdr_tpu_torch.io.sources as t_sources

ROOT = Path(__file__).resolve().parents[1]
SCANNED = sorted((ROOT / "jsdr_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# copied without a change to their code
VERBATIM = ("io/framer.py", "io/recorder.py", "io/live.py", "io/fcd.py",
            "io/convert.py", "io/flac.py",
            "runtime/pubsub.py", "runtime/log.py", "runtime/config.py",
            "display/phase_scope.py")
# the TUI's classes and functions copied without a change to their code
# (the module around them is ported: its stages take a torch device)
TUI_COPIED = ("_SHADES", "DEMOD_MODES", "Controls", "TuiModel", "decode_key")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "jsdr_tpu")


def _imports(path: Path):
    """(line, module) for every import statement of a file, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", SCANNED,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference_module(path):
    bad = [f"{path.name}:{line} imports {mod}"
           for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, bad


def test_scan_catches_reference_imports(tmp_path):
    """The scan sees through aliases, nesting and ``from`` forms, and lets
    the port's own package name through."""
    src = tmp_path / "m.py"
    src.write_text("import jsdr_tpu_torch.ops\n"
                   "def f():\n    from jsdr_tpu.io import sources\n"
                   "    import jax.numpy as jnp\n")
    assert [m for _, m in _imports(src) if _forbidden(m)] == [
        "jsdr_tpu.io", "jax.numpy"]


def test_fec_tables_equal_the_reference():
    names = [n for n in dir(j_tables) if n.isupper()]
    assert "METTAB" in names and "SYNC_VECTOR" in names
    assert names == [n for n in dir(t_tables) if n.isupper()]
    for name in names:
        want, got = getattr(j_tables, name), getattr(t_tables, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name


def test_encode_fec40_equals_the_reference():
    pay = np.random.default_rng(40).integers(0, 256, (3, 256), np.uint8)
    for p in pay:
        want = j_ref.encode_fec40(p)
        got = t_ref.encode_fec40(p)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("channels,i_corr,q_corr",
                         [(2, 0, 0), (2, 1200, -77), (1, 32767, 0)])
def test_s16le_to_complex_equals_the_reference(channels, i_corr, q_corr):
    raw = np.random.default_rng(3).integers(
        -32768, 32768, 4096, dtype=np.int16).astype("<i2").tobytes()
    want = j_convert.s16le_to_complex(raw, channels, i_corr, q_corr)
    got = t_convert.s16le_to_complex(raw, channels, i_corr, q_corr)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert (t_convert.complex_to_s16le(got)
            == j_convert.complex_to_s16le(want))


@pytest.mark.parametrize("rate,offset,noise", [(96000, 12000.0, 0.25),
                                               (192000, 9000.0, 0.0)])
def test_synth_bpsk_stream_equals_the_reference(rate, offset, noise):
    pay = np.random.default_rng(5).integers(0, 256, (2, 256), np.uint8)
    kw = dict(rate=rate, carrier_offset=offset, preamble_bits=200,
              noise_rms=noise, seed=9)
    want = j_sources.synth_bpsk_stream(pay, **kw)
    got = t_sources.synth_bpsk_stream(pay, **kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for fn, args in (("synth_sine", (4000, 1234.5, 96000.0)),
                     ("synth_noise", (4000,))):
        assert (getattr(t_sources, fn)(*args).tobytes()
                == getattr(j_sources, fn)(*args).tobytes())


def _wav(body: bytes, tag: int, bits: int, fmt_after_data: bool = False):
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, tag, 2, 48000,
                                48000 * 2 * bits // 8, 2 * bits // 8, bits)
    data = b"data" + struct.pack("<I", len(body)) + body
    chunks = data + fmt if fmt_after_data else fmt + data
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def test_read_wav_and_sources_equal_the_reference(tmp_path):
    """Every WAV width, raw and FLAC files through FileSource, and the
    known fault kept as it is (a fmt chunk after the data chunk is
    refused by both; ROADMAP.md, queue 3)."""
    s16 = np.random.default_rng(8).integers(-20000, 20000, 2000,
                                            dtype=np.int16)
    bodies = {
        "w16": (s16.astype("<i2").tobytes(), 1, 16),
        "w24": (b"".join(struct.pack("<i", int(v) << 8)[:3] for v in s16),
                1, 24),
        "w32": ((s16.astype(np.int32) << 16).astype("<i4").tobytes(), 1, 32),
        "f32": ((s16.astype(np.float32) / 32767.0).astype("<f4").tobytes(),
                3, 32),
    }
    for name, (body, tag, bits) in bodies.items():
        p = tmp_path / f"{name}.wav"
        p.write_bytes(_wav(body, tag, bits))
        want, got = j_sources.read_wav(p), t_sources.read_wav(p)
        assert got[1:] == want[1:]
        assert got[0].dtype == want[0].dtype
        assert got[0].tobytes() == want[0].tobytes(), name
    late = tmp_path / "late_fmt.wav"
    late.write_bytes(_wav(bodies["w16"][0], 1, 16, fmt_after_data=True))
    for mod in (j_sources, t_sources):
        with pytest.raises(ValueError, match="missing fmt/data"):
            mod.read_wav(late)

    raw = tmp_path / "c.raw"
    raw.write_bytes(s16.astype("<i2").tobytes())
    flac = tmp_path / "c.flac"
    j_flac.write_flac(flac, s16.reshape(-1, 2), 48000)
    for path in (raw, tmp_path / "w24.wav", flac):
        want = j_sources.open_source(f"file:{path}", rate=48000).all()
        got = t_sources.open_source(f"file:{path}", rate=48000).all()
        assert got.tobytes() == want.tobytes(), path.name
    samples, rate, bps = t_flac.read_flac(flac)
    np.testing.assert_array_equal(samples, s16.reshape(-1, 2))
    assert (rate, bps) == (48000, 16)


def _code(path: Path) -> str:
    """The module's syntax tree without its docstring."""
    tree = ast.parse(path.read_text(), str(path))
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_equals_the_reference(rel):
    assert (ROOT / "jsdr_tpu_torch" / rel).is_file()
    assert _code(ROOT / "jsdr_tpu_torch" / rel) == _code(ROOT / "jsdr_tpu"
                                                          / rel)
    for new in ("runtime/executor.py", "runtime/state.py",
                "io/convert_device.py", "ops/nco.py", "demod/fft_tuner.py",
                "demod/am_fm.py", "app/main.py", "app/tui.py",
                "io/native.py"):
        assert ROOT / "jsdr_tpu_torch" / new in SCANNED


def _top_level(path: Path) -> dict:
    """The syntax tree of each top-level class, function and assignment
    of a module, by name."""
    out = {}
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            out[getattr(node.targets[0], "id", "")] = ast.dump(node)
    return out


@pytest.mark.parametrize("name", TUI_COPIED)
def test_tui_copied_code_equals_the_reference(name):
    got = _top_level(ROOT / "jsdr_tpu_torch" / "app" / "tui.py")
    want = _top_level(ROOT / "jsdr_tpu" / "app" / "tui.py")
    assert name in got and got[name] == want[name]


def test_framer_recorder_and_live_sources_equal_the_reference(tmp_path):
    """The copies' outputs byte-equal the reference's: framed blocks from
    ragged chunks (complex and raw), recorded files, a pipe: stream
    (converted and raw) and paced replay on a fake clock."""
    rng = np.random.default_rng(11)
    raw = rng.integers(-32768, 32768, 2 * 5000, dtype=np.int16)
    iq = t_convert.s16le_to_complex(raw)
    cuts = [0, 700, 701, 2900, 5000]
    outs = []
    for fr, rec, live in ((j_framer, j_recorder, j_live),
                          (t_framer, t_recorder, t_live)):
        got = []
        for framer, data, k in ((fr.BlockFramer(960), iq, 1),
                                (fr.RawBlockFramer(960), raw, 2)):
            for a, b in zip(cuts, cuts[1:]):
                got += [x.tobytes() for x in framer.push(data[k * a:k * b])]
            got.append(framer.flush(pad=True).tobytes())
        path = tmp_path / f"{fr.__name__}.raw"
        with rec.RawRecorder(path) as r:
            r.write_iq(iq[:100])
            r.write_raw(raw[:64].tobytes())
        got.append(path.read_bytes())
        cap = tmp_path / "cap.raw"
        cap.write_bytes(raw.tobytes())
        for is_raw in (False, True):
            src = live.StreamSource(f"pipe:{cap}", chunk_samples=1500,
                                    i_corr=5, q_corr=-3, raw=is_raw)
            got += [x.tobytes() for x in src]
        now, slept = [0.0], []
        paced = live.PacedSource(
            [raw[:2 * 480], iq[:960], iq[:96]], rate=9600,
            clock=lambda: now[0], sleep=slept.append)
        got += [x.tobytes() for x in paced] + [repr(slept)]
        outs.append(got)
    assert outs[0] == outs[1]


def test_config_and_phase_scope_equal_the_reference(tmp_path):
    """The copies' outputs equal the reference's: a properties file read
    with typed accessors, overrides, default write-back, a stale schema
    discarded and the file saved back (byte-equal); the phase scope's
    points, traces and scale of a noisy block (byte-equal)."""
    import jsdr_tpu.display.phase_scope as j_phase
    import jsdr_tpu.runtime.config as j_config
    import jsdr_tpu_torch.display.phase_scope as t_phase
    import jsdr_tpu_torch.runtime.config as t_config

    text = ("# c\njsdr-tpu-version=1\naudio-rate = 192000\n"
            "demod-mode=x\n! bang\nfft-hamming=0\n")
    outs = []
    for cfg_mod, phase_mod, tag in ((j_config, j_phase, "j"),
                                    (t_config, t_phase, "t")):
        path = tmp_path / f"{tag}.properties"
        path.write_text(text)
        c = cfg_mod.Config(path, overrides=["audio-ic=5", "bad"])
        got = [c.get_int("audio-rate", 96000), c.get_int("demod-mode", 3),
               c.get_float("audio-ic", 0.0), c.get("missing", "dflt"),
               c.get_int("fft-hamming", 1), c.as_dict()]
        c.set("extra", 7)
        c.save()
        got.append(path.read_text())
        stale = tmp_path / f"{tag}.stale"
        stale.write_text("jsdr-tpu-version=0\naudio-rate=44100\n")
        got.append(cfg_mod.Config(stale).get_int("audio-rate", 96000))
        rng = np.random.default_rng(9)
        iq = (rng.standard_normal(9600) + 1j * rng.standard_normal(9600)
              ).astype(np.complex64)
        d = phase_mod.phase_scope_data(iq, width=300)
        got.append([d.points.tobytes(), d.i_trace.tobytes(),
                    d.q_trace.tobytes(), d.max_abs])
        outs.append(got)
    assert outs[0] == outs[1]
