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
    reference's streaming format. The stream is whole 1 s blocks: a live
    source's last partial block is not processed (as in the reference)."""
    path, payload = _capture(tmp_path)
    data = path.read_bytes()
    path.write_bytes(data + bytes((-len(data)) % (96000 * 4)))
    assert main(["telemetry", f"pipe:{path}", "--blocks", "2",
                 "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().endswith(
        "2 blocks streamed, frames=0, dropped=none")
    ck = tmp_path / "stream.npz"
    assert main(["telemetry", f"pipe:{path}", "--device-convert",
                 "--checkpoint", str(ck), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "demod0@12000Hz corr=65 ok=True channel_errors=0" in out
    row0 = " ".join(f"{v:02x}" for v in payload[0, :16])
    assert f"    0: {row0}" in out
    assert out.strip().endswith("5 blocks streamed, frames=1, dropped=none")
    assert ck.exists()
    with pytest.raises(NotImplementedError, match="--mesh 2x4"):
        main(["telemetry", f"pipe:{path}", "--mesh", "2x4", "--device",
              "cpu"])


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
    assert got[-1] == want[-1] == "5 blocks streamed, frames=1, dropped=none"
    for row in _rows(pay[1]):
        assert row in got
