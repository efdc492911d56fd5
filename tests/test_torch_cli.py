"""The port's CLI: ``jsdr-tpu-torch telemetry`` on the CPU prints the
decoded frames and counters of a synthesized capture, in the format of
``jsdr-tpu telemetry``."""

import numpy as np
import pytest

from jsdr_tpu.io.convert import complex_to_s16le
from jsdr_tpu.io.sources import synth_bpsk_stream
from jsdr_tpu_torch.app.main import main


def test_cli_telemetry_prints_decoded_frames(tmp_path, capsys):
    rng = np.random.default_rng(21)
    payload = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payload, rate=96000, carrier_offset=12000.0,
                            preamble_bits=200, noise_rms=0.1)
    path = tmp_path / "frame.raw"
    path.write_bytes(complex_to_s16le(sig))
    assert main(["telemetry", f"file:{path}", "--tuning", "12000,9000",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "demod0@12000Hz t=4s corr=65 channel_errors=0:" in out
    row0 = " ".join(f"{v:02x}" for v in payload[0, :16])
    assert f"    0: {row0}" in out
    assert "demod1 @ 9000 Hz counters: raw=480000 ds=48000" in out
    assert out.strip().endswith("frames=1")


def test_cli_spectrum_prints_the_reference_peaks(tmp_path, capsys):
    """``spectrum`` on the CPU: the same block count, peak frequencies and
    (to 0.1 dB) peak levels as ``jsdr-tpu spectrum``, and the PNGs."""
    from jsdr_tpu.app.main import main as jax_main

    path = tmp_path / "tone.raw"
    t = np.arange(2 * 96000)
    tone = 0.5 * np.exp(2j * np.pi * 4410.0 * t / 96000)
    noise = np.random.default_rng(4).standard_normal((2, len(t))) * 0.01
    path.write_bytes(complex_to_s16le(
        (tone + noise[0] + 1j * noise[1]).astype(np.complex64)))
    png, psd_png = tmp_path / "wf.png", tmp_path / "psd.png"
    assert main(["--seconds", "2", "spectrum", f"file:{path}", "--show",
                 "20", "--png", str(png), "--psd-png", str(psd_png),
                 "--ascii", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    jax_main(["--cpu", "--seconds", "2", "spectrum", f"file:{path}",
              "--show", "20"])
    want = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == "20 blocks of 9600 samples at 96000 S/s"
    for g, w in zip(got[1:21], want[1:21]):
        gb, wb = g.split(), w.split()
        assert gb[:2] == wb[:2] and gb[6:] == wb[6:] == ["4410", "Hz"]
        assert abs(float(gb[3]) - float(wb[3])) <= 0.1
    assert png.stat().st_size > 0 and psd_png.stat().st_size > 0


def _capture(tmp_path):
    rng = np.random.default_rng(21)
    payload = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payload, rate=96000, carrier_offset=12000.0,
                            preamble_bits=200, noise_rms=0.1)
    path = tmp_path / "frame.raw"
    path.write_bytes(complex_to_s16le(sig))
    return path, payload


def test_cli_telemetry_checkpoint_resume(tmp_path, capsys):
    """``--checkpoint`` writes the stream state in the reference's format
    (it loads in ``jsdr_tpu``'s ``load_state`` with the CLI's meta, and
    its decisions equal the JAX CLI's checkpoint); ``--resume`` continues
    from it."""
    import jax
    from jsdr_tpu.app.main import main as jax_main
    from jsdr_tpu.demod.bpsk import BpskConfig, bpsk_init_batch
    from jsdr_tpu.runtime.state import load_state

    path, _ = _capture(tmp_path)
    ck, ck_j = tmp_path / "port.npz", tmp_path / "jax.npz"
    assert main(["telemetry", f"file:{path}", "--tuning", "12000,9000",
                 "--checkpoint", str(ck), "--device", "cpu"]) == 0
    assert f"stream state -> {ck}" in capsys.readouterr().out
    jax_main(["--cpu", "telemetry", f"file:{path}", "--tuning", "12000,9000",
              "--checkpoint", str(ck_j)])
    capsys.readouterr()
    like = bpsk_init_batch(BpskConfig(), 2)
    meta = {"rate": 96000, "n_demods": 2}
    got = load_state(ck, like, expect_meta=meta)
    want = load_state(ck_j, like, expect_meta=meta)
    for name in ("vco_idx", "ring", "counters", "tu_phase"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    for a, b in zip(jax.tree.leaves(got.mf_tail), jax.tree.leaves(
            want.mf_tail)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3)

    assert main(["telemetry", f"file:{path}", "--tuning", "12000,9000",
                 "--checkpoint", str(ck), "--resume", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"resumed stream state from {ck}" in out
    assert "demod1 @ 9000 Hz counters: raw=960000 ds=96000" in out


def test_cli_telemetry_stream_blocks_and_device_convert(tmp_path, capsys):
    """A live ``pipe:`` source runs the Session: ``--blocks`` stops it,
    ``--device-convert`` uploads raw int16, and frames print in the
    reference's streaming format, and the closing line adds the drain's
    counters (sync hits decoded, good, failed) and the telemetry step's
    (graph replays, captures, eager blocks: all eager on the CPU) and the
    front end's blocks by mode to the reference's. The
    stream is whole 1 s blocks: a live source's last partial block is not
    processed (as in the reference)."""
    path, payload = _capture(tmp_path)
    data = path.read_bytes()
    path.write_bytes(data + bytes((-len(data)) % (96000 * 4)))
    assert main(["telemetry", f"pipe:{path}", "--blocks", "2",
                 "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().endswith(
        "2 blocks streamed, frames=0, dropped=none, hits=0, good=0, "
        "failed=0, graph replays/captures/eager=0/0/2, front pattern=2")
    ck = tmp_path / "stream.npz"
    assert main(["telemetry", f"pipe:{path}", "--device-convert",
                 "--checkpoint", str(ck), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "demod0@12000Hz corr=65 ok=True channel_errors=0" in out
    row0 = " ".join(f"{v:02x}" for v in payload[0, :16])
    assert f"    0: {row0}" in out
    assert out.strip().endswith("5 blocks streamed, frames=1, dropped=none, "
                                "hits=1, good=1, failed=0, graph "
                                "replays/captures/eager=0/0/5, "
                                "front pattern=5")
    assert ck.exists()
    # --mesh 2x4: the sharded step in the same Session prints the same
    # frames as the JAX package's --mesh 2x4 (its 8 virtual CPU devices)
    from jsdr_tpu.app.main import main as jax_main

    frames = {}
    for who, fn, dev, tail in (
            ("port", main, ["--device", "cpu"],
             ", hits=1, good=1, failed=0, "
             "graph replays/captures/eager=0/0/5, front general=5"),
            ("jax", jax_main, [], "")):
        assert fn(["telemetry", f"pipe:{path}", "--tuning", "12000,9000",
                   "--mesh", "2x4", *dev]) == 0
        out = capsys.readouterr().out
        assert "mesh dp=2 x sp=4" in out
        assert out.strip().endswith("5 blocks streamed, frames=1, "
                                    "dropped=none" + tail)
        frames[who] = [ln for ln in out.splitlines()
                       if ln.startswith(("demod", "  "))]
    assert frames["port"] == frames["jax"]
    assert "demod0@12000Hz corr=65 ok=True channel_errors=0" in frames["port"]


def _auto_capture(tmp_path):
    """A noisy capture carrying one frame in each half-band of the
    auto-tuner's search (11.9 and 30 kHz), in whole 1 s blocks."""
    rng = np.random.default_rng(23)
    pay = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    sig = sum(synth_bpsk_stream(pay[i:i + 1], rate=96000, carrier_offset=c,
                                preamble_bits=400, amplitude=0.4,
                                noise_rms=0.15, seed=i)
              for i, c in enumerate((11900.0, 30000.0)))
    sig = np.concatenate([sig, np.zeros((-len(sig)) % 96000, np.complex64)])
    path = tmp_path / "auto.raw"
    path.write_bytes(complex_to_s16le(sig))
    return path, pay


def _rows(payload):
    return [f"  {off:3d}: " + " ".join(f"{v:02x}" for v in
                                       payload[off:off + 16])
            for off in range(0, 256, 16)]


@pytest.mark.parametrize("flags,frame,n_frames", [
    (["--tuning", "0", "--fft-tune"], 0, 1),
    (["--tuning", "0", "--fft-tune", "--track-high"], 1, 1),
    (["--tuning", "11900,12000.5"], 0, 2),            # general
    (["--tuning", "11900.05"], 0, 1),                 # static
])
def test_cli_telemetry_every_tuning_mode_matches_jax(tmp_path, capsys,
                                                     flags, frame, n_frames):
    """``telemetry`` on the file path in every tuning mode, ``--fft-tune``
    and ``--track-high`` included: the same print-out, line for line, as
    ``jsdr-tpu telemetry``, with the frame of the searched half-band (or
    the tuned carrier) decoded."""
    from jsdr_tpu.app.main import main as jax_main

    path, pay = _auto_capture(tmp_path)
    assert main(["telemetry", f"file:{path}", *flags, "--device",
                 "cpu"]) == 0
    got = capsys.readouterr().out
    jax_main(["--cpu", "telemetry", f"file:{path}", *flags])
    want = capsys.readouterr().out
    assert got == want
    for row in _rows(pay[frame]):
        assert row in got
    assert got.strip().endswith(f"frames={n_frames}")


def test_cli_telemetry_stream_auto_tune(tmp_path, capsys):
    """The streaming path (a ``pipe:`` source, the Session) with
    ``--fft-tune --track-high``: the upper half-band's frame, printed as
    ``jsdr-tpu`` prints it."""
    from jsdr_tpu.app.main import main as jax_main

    path, pay = _auto_capture(tmp_path)
    args = ["telemetry", f"pipe:{path}", "--tuning", "0", "--fft-tune",
            "--track-high"]
    assert main([*args, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    jax_main(["--cpu", *args])
    want = capsys.readouterr().out.splitlines()
    frames = [line for line in got if line.startswith("demod")]
    assert frames == [line for line in want if line.startswith("demod")]
    assert frames == ["demod0@0Hz corr=65 ok=True channel_errors=0"]
    assert want[-1] == "5 blocks streamed, frames=1, dropped=none"
    assert got[-1] == want[-1] + (", hits=1, good=1, failed=0, "
                                  "graph replays/captures/eager=0/0/5, "
                                  "front dofft=5")
    for row in _rows(pay[1]):
        assert row in got


# -- demod, synth, record, phase, fir, fcd and --config ----------------------
# Fixtures come from the port's own ``synth``. S16 audio is held to the
# JAX CLI's within 1 count with at least 99.9% of samples equal (AM: 99.5%,
# as tests/test_torch_am_fm.py's AM_EQUAL explains); other outputs
# byte-equal.

def _synth(tmp_path, name, *args):
    path = tmp_path / name
    assert main(["--seconds", "2", "synth", *args, "--out", str(path)]) == 0
    return path


def _s16_close(a, b, equal=0.999):
    a = np.fromfile(a, "<i2").astype(int)
    b = np.fromfile(b, "<i2").astype(int)
    assert a.shape == b.shape and len(a) > 0
    d = np.abs(a - b)
    assert d.max() <= 1 and (d == 0).mean() >= equal


@pytest.mark.parametrize("args", [
    ["sine", "--freq", "5000"], ["sine", "--freq", "4410", "--real"],
    ["noise", "--amplitude", "0.3", "--seed", "3"],
    ["telemetry", "--freq", "9000", "--noise", "0.1", "--seed", "2"],
    ["sine", "--freq", "-3000", "flac"]], ids=lambda a: "-".join(a))
def test_cli_synth_equals_jax(tmp_path, capsys, args):
    """``synth`` writes the JAX CLI's bytes (raw S16LE or FLAC, and the
    telemetry payloads) and prints its lines."""
    from jsdr_tpu.app.main import main as jax_main

    ext = ".flac" if args[-1] == "flac" else ".raw"
    args = [a for a in args if a != "flac"]
    secs = ["--seconds", "5" if args[0] == "telemetry" else "1"]
    out = {}
    for who, fn in (("port", main), ("jax", jax_main)):
        path = tmp_path / f"{who}{ext}"
        fn([*secs, "--rate", "44100", "synth", *args, "--out", str(path)])
        out[who] = (path.read_bytes(), capsys.readouterr().out.replace(
            str(path), "OUT"))
    assert out["port"] == out["jax"] and len(out["port"][0]) > 0
    if args[0] == "telemetry":
        np.testing.assert_array_equal(
            np.load(tmp_path / "port.raw.payloads.npy"),
            np.load(tmp_path / "jax.raw.payloads.npy"))
    if "--real" in args:
        assert not np.frombuffer(out["port"][0], "<i2")[1::2].any()


@pytest.mark.parametrize("ext", [".raw", ".flac"])
def test_cli_record_equals_jax(tmp_path, capsys, ext):
    from jsdr_tpu.app.main import main as jax_main

    src = _synth(tmp_path, "n.raw", "noise", "--amplitude", "0.3")
    capsys.readouterr()
    got = {}
    for who, fn in (("port", main), ("jax", jax_main)):
        path = tmp_path / f"{who}{ext}"
        fn(["--seconds", "1", "record", f"file:{src}", "--out", str(path)])
        got[who] = (path.read_bytes(),
                    capsys.readouterr().out.replace(str(path), "OUT"))
    assert got["port"] == got["jax"]
    if ext == ".raw":
        assert len(got["port"][0]) == 96000 * 4


def test_cli_phase_equals_jax(tmp_path, capsys):
    """``phase`` on a sine4410-style fixture (``synth --real``): the same
    autoscale line and ASCII traces, and the same PNG bytes."""
    from jsdr_tpu.app.main import main as jax_main

    src = tmp_path / "sine4410.raw"
    main(["--rate", "44100", "--seconds", "1", "synth", "sine", "--freq",
          "4410", "--real", "--out", str(src)])
    capsys.readouterr()
    got = {}
    for who, fn in (("port", main), ("jax", jax_main)):
        png = tmp_path / f"{who}.png"
        fn(["--rate", "44100", "--seconds", "1", "phase", f"file:{src}",
            "--ascii", "--png", str(png)])
        got[who] = (png.read_bytes(),
                    capsys.readouterr().out.replace(str(png), "PNG"))
    assert got["port"] == got["jax"]
    out = got["port"][1]
    assert "autoscale max" in out and "I trace" in out and "Q trace" in out


@pytest.mark.parametrize("flags", [
    ["--print-taps"], ["--no-filter"], [], ["--widen", "8"],
    ["--move", "4"], ["--mix", "1000"],
    ["--taps", "33", "--flo", "-5000", "--fhi", "2000", "--print-taps"]],
    ids=lambda f: "-".join(f) or "default")
def test_cli_fir_equals_jax(tmp_path, capsys, flags):
    """``fir`` with each testbench flag: the same print-out (taps to 8
    decimals, the rms line) and the written IQ within 1 count."""
    from jsdr_tpu.app.main import main as jax_main

    got = {}
    for who, fn, dev in (("port", main, ["--device", "cpu"]),
                         ("jax", jax_main, [])):
        path = tmp_path / f"{who}.raw"
        cpu = [] if who == "port" else ["--cpu"]
        fn([*cpu, "--rate", "44100", "--seconds", "1", "fir", "sine:4410",
            *flags, "--out", str(path), *dev])
        got[who] = capsys.readouterr().out.replace(str(path), "OUT")
    assert got["port"] == got["jax"]
    _s16_close(tmp_path / "port.raw", tmp_path / "jax.raw")


def test_cli_fir_testbench(tmp_path, capsys):
    """tests/test_cli.py's testbench checks through the port: the band
    [-3000, 3000] attenuates a 4410 Hz tone, widening by 8 x 250 Hz each
    side brings it back."""
    def rms(*flags):
        main(["--rate", "44100", "--seconds", "1", "fir", "sine:4410",
              *flags, "--device", "cpu"])
        return float(capsys.readouterr().out.split("rms=")[1].split()[0])

    rms_open, rms_filt = rms("--no-filter"), rms()
    assert rms_filt < 0.5 * rms_open
    assert rms("--widen", "8") > 2.0 * rms_filt


def test_cli_fcd_without_fcdctl(capsys):
    assert main(["fcd", "status", "--fcdctl", "/nonexistent/fcdctl"]) == 1
    assert "no FCD" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--mode", "am"], ["--mode", "nfm", "--agc"],
    ["--mode", "wfm", "--flo", "-20000", "--fhi", "20000", "--downshift",
     "--agc"],
    ["--mode", "raw", "--flo", "8000", "--fhi", "12000", "--downshift"],
    ["--mode", "off"]], ids=lambda f: "-".join(f))
def test_cli_demod_file_matches_jax(tmp_path, capsys, flags):
    """``demod`` on a file (1 s blocks, S16LE stereo out): the JAX CLI's
    audio within 1 count, and its print-out."""
    from jsdr_tpu.app.main import main as jax_main

    src = _synth(tmp_path, "n.raw", "noise", "--amplitude", "0.3",
                 "--seed", "4")
    capsys.readouterr()
    got = {}
    for who, fn, dev in (("port", main, ["--device", "cpu"]),
                         ("jax", jax_main, [])):
        path = tmp_path / f"{who}.raw"
        cpu = [] if who == "port" else ["--cpu"]
        fn([*cpu, "--seconds", "2", "demod", f"file:{src}", *flags,
            "--out", str(path), *dev])
        got[who] = capsys.readouterr().out.replace(str(path), "OUT")
    assert got["port"] == got["jax"]
    assert "2 blocks demodulated" in got["port"]
    _s16_close(tmp_path / "port.raw", tmp_path / "jax.raw",
               0.995 if flags[1] == "am" else 0.999)


def test_cli_demod_live_pipe_to_sink(tmp_path, capsys):
    """The streaming loop (tests/test_live.py:118 through the port): S16LE
    IQ piped into ``demod``, 0.1 s blocks through the Session, audio
    streamed to a file sink; the same file replayed with ``--pace``; and
    ``--device-convert``. Each sink's audio equals the file path's within
    1 count (the sink rounds, the file path truncates). The sink drops its
    oldest block when its queue of 8 is full (a saturated audio line), and
    an unpaced pipe outruns real time, so the pipe runs stop at 8 blocks
    (``--blocks``) and the whole second runs paced."""
    import os
    import subprocess
    import sys

    from jsdr_tpu_torch.io import convert, sources

    carrier = sources.synth_sine(96000, 4000.0, 96000.0, amplitude=0.4)
    t = np.arange(96000) / 96000.0
    iq = (carrier * (1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * t))
          ).astype(np.complex64)                 # AM: 1 kHz envelope
    src = tmp_path / "in.raw"
    src.write_bytes(convert.complex_to_s16le(iq))
    whole = tmp_path / "file.raw"
    main(["--seconds", "1", "demod", f"file:{src}", "--mode", "am",
          "--out", str(whole), "--device", "cpu"])
    want = np.fromfile(whole, "<i2").astype(int)
    out = tmp_path / "live_audio.raw"
    r = subprocess.run(
        [sys.executable, "-m", "jsdr_tpu_torch.app.main", "demod",
         "pipe:" + str(src), "--mode", "am", "--audio-out", str(out),
         "--blocks", "8", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "8 blocks (0.8s) demodulated (am)" in r.stdout, r.stdout
    assert "sink wrote 8 blocks, 0 overruns, no dropped" in r.stdout
    live = np.frombuffer(out.read_bytes(), dtype="<i2").astype(int)
    assert len(live) == 2 * 76800 and live.std() > 0
    assert np.abs(live - want[:len(live)]).max() <= 1
    capsys.readouterr()
    for name, flags, n in (("paced", [f"file:{src}", "--pace"], 10),
                           ("conv", [f"pipe:{src}", "--device-convert",
                                     "--blocks", "4"], 4)):
        path = tmp_path / f"{name}.raw"
        assert main(["demod", *flags, "--mode", "am", "--audio-out",
                     str(path), "--device", "cpu"]) == 0
        text = capsys.readouterr().out
        assert f"{n} blocks ({n / 10:.1f}s) demodulated (am)" in text
        assert f"sink wrote {n} blocks, 0 overruns, no dropped" in text
        got = np.fromfile(path, "<i2").astype(int)
        assert len(got) == n * 19200
        assert np.abs(got - want[:len(got)]).max() <= 1


def test_cli_config_schema_telemetry(tmp_path, capsys):
    """``--config`` with the reference's key schema (tests/test_cli.py:83):
    two FUNcube demodulators from the file, the JAX CLI's print-out."""
    from jsdr_tpu.app.main import main as jax_main

    path, _ = _capture(tmp_path)
    cfg = tmp_path / "jsdr.properties"
    cfg.write_text("jsdr-tpu-version=1\naudio-rate=96000\n"
                   "jsdr-funcube-demods=2\nFUNcube0-bpsk-tuning=12000\n"
                   "FUNcube1-bpsk-tuning=9000\n")
    assert main(["--config", str(cfg), "telemetry", f"file:{path}",
                 "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "@ 12000 Hz" in got and "@ 9000 Hz" in got
    jax_main(["--cpu", "--config", str(cfg), "telemetry", f"file:{path}"])
    assert got == capsys.readouterr().out


def test_cli_config_schema_demod(tmp_path, capsys):
    """``--config``'s demod keys (mode, FIR band, AGC) take effect where no
    flag is given, as in the JAX CLI, and a flag overrides them."""
    from jsdr_tpu.app.main import main as jax_main

    src = _synth(tmp_path, "n.raw", "noise", "--amplitude", "0.3")
    cfg = tmp_path / "jsdr.properties"
    cfg.write_text("jsdr-tpu-version=1\ndemod-mode=4\ndemod-fir-enable=1\n"
                   "demod-filter-low=-15000\ndemod-filter-high=15000\n"
                   "demod-agc-enable=1\n")
    capsys.readouterr()
    for flags in ([], ["--mode", "am"]):
        got = {}
        for who, fn, dev in (("port", main, ["--device", "cpu"]),
                             ("jax", jax_main, [])):
            out = tmp_path / f"{who}.raw"
            cpu = [] if who == "port" else ["--cpu"]
            fn([*cpu, "--config", str(cfg), "--seconds", "1", "demod",
                f"file:{src}", *flags, "--out", str(out), *dev])
            got[who] = capsys.readouterr().out.replace(str(out), "OUT")
        assert got["port"] == got["jax"]
        assert f"({'am' if flags else 'wfm'})" in got["port"]
        _s16_close(tmp_path / "port.raw", tmp_path / "jax.raw",
                   0.995 if flags else 0.999)


def test_cli_tensor_commands_default_to_the_card(tmp_path):
    """``demod``, ``fir`` and ``ui`` run on ``cuda`` unless ``--device
    cpu`` is given, so without a card they raise rather than run on the
    CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["--seconds", "1", "demod", "noise", "--out",
              str(tmp_path / "a.raw")])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["--seconds", "1", "fir", "noise"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["ui"])
