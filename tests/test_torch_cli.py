"""The port's CLI: ``jsdr-tpu-torch telemetry`` on the CPU prints the
decoded frames and counters of a synthesized capture, in the format of
``jsdr-tpu telemetry``."""

import numpy as np

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
