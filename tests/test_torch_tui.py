"""The port's interactive shell (``jsdr_tpu_torch/app/tui.py``) on the
CPU: the counterparts of tests/test_tui.py's 14 tests, and the port's
stages under the shell against the JAX package's.

The model tests (key dispatch per accelerator-map.txt, pub/sub ingestion,
screen composition, config persistence) run over both packages'
``TuiModel``, which is one copied code. The pipeline tests drive the
port's ``StageManager`` and ``PipelineThread`` with ``device="cpu"``.

The parity test drives one synthesised FUNcube signal and one key script
(applied at fixed blocks from inside the source iterator) through the JAX
package's ``StageManager`` + ``Session`` and the port's. Frames and
counters must be equal and the recorder's bytes too; the PSD within the
repo's full-PSD tolerance (chip_smoke.py's ``psd_tol``, one rule for the
card and the tests: ``PSD_DB_TOL`` = 2e-3 dB at or above the floor,
``PSD_AMP_TOL`` = 3e-4 of the RMS amplitude everywhere; a bin deep below
the floor of a FUNcube capture moved by 4e-3 dB, more than the 1e-3 dB
that tests/test_torch_spectrum.py holds ``spectrum_block`` to on tones)
and the audio within 2e-5 of the block's largest |audio|
(tests/test_torch_am_fm.py's tolerance without AGC: the packages sum the
FIR in other orders). Every drive fails on a stage fault: the Session
alerts it (retried, or its block dropped) and streams on, so a fault
would otherwise hide behind the frames that did come."""

import importlib.util
import time
import types
from pathlib import Path

import numpy as np
import pytest

import jsdr_tpu.app.tui as J
import jsdr_tpu_torch.app.tui as T

PKGS = pytest.mark.parametrize("tui", [J, T], ids=["jax", "torch"])


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class AlertLog:
    """A Session logger that keeps its alerts (a stage's fault)."""

    def __init__(self):
        self.alerts = []

    def alert(self, msg):
        self.alerts.append(msg)

    def log(self, msg):
        pass

    def status(self, msg):
        pass


def _config(tui):
    return (__import__("jsdr_tpu.runtime.config", fromlist=["Config"])
            if tui is J else
            __import__("jsdr_tpu_torch.runtime.config", fromlist=["Config"]))


def _pubsub(tui):
    return (__import__("jsdr_tpu.runtime.pubsub", fromlist=["PubSub"])
            if tui is J else
            __import__("jsdr_tpu_torch.runtime.pubsub", fromlist=["PubSub"]))


def make_model(tui, tmp_path, **kw):
    cfg = _config(tui).Config(tmp_path / "jsdr.properties")
    pubsub = _pubsub(tui).PubSub()
    controls = tui.Controls()
    return tui.TuiModel(cfg, pubsub, controls, **kw), cfg, pubsub, controls


def keys(model, seq):
    for k in seq:
        model.handle_key(k)


# ------------------------------------------------------------- key decode

@PKGS
def test_decode_key(tui):
    decode_key = tui.decode_key
    assert decode_key(ord("a")) == "a"
    assert decode_key(17) == "ctrl-q"                 # Ctrl-Q
    assert decode_key(15) == "ctrl-o"                 # Ctrl-O
    assert decode_key(9) == "tab"
    assert decode_key(353) == "shift-tab"
    assert decode_key(10) == "enter"
    assert decode_key(127) == "backspace"
    assert decode_key(27) == "esc"
    assert decode_key(27, ord("p")) == "alt-p"        # Alt-P pause
    assert decode_key(27, ord("I")) == "alt-I"        # Alt-Shift-I
    assert decode_key(500) is None                    # unmapped special


# ----------------------------------------------------------- key handling

@PKGS
def test_tab_focus_and_persistence(tui, tmp_path):
    model, cfg, _, _ = make_model(tui, tmp_path)
    assert model.tabs == ["phase", "fft", "demod", "record",
                          "FUNcube0", "FUNcube1"]
    model.handle_key("tab")
    assert model.tabs[model.tab] == "demod"   # default focus 1 (fft) + 1
    model.handle_key("shift-tab")
    model.handle_key("1")
    assert model.tabs[model.tab] == "phase"
    model.handle_key("5")
    assert model.tabs[model.tab] == "FUNcube0"
    assert model.handle_key("ctrl-q") is False
    saved = _config(tui).Config(tmp_path / "jsdr.properties")
    assert saved.get_int("jsdr-tab-focus", -1) == 4


@PKGS
def test_pause_and_corrections(tui, tmp_path):
    model, _, _, controls = make_model(tui, tmp_path)
    model.handle_key("p")
    assert controls.paused
    model.handle_key("alt-p")
    assert not controls.paused
    keys(model, ["alt-i", "alt-i", "alt-Q"])
    assert (controls.icorr, controls.qcorr) == (2, -1)
    model.handle_key("alt-r")
    assert (controls.icorr, controls.qcorr) == (0, 0)
    keys(model, ["1", "i", "q", "Q", "Q"])
    assert (controls.icorr, controls.qcorr) == (1, -1)


@PKGS
def test_fcd_tuning_steps_and_prompt(tui, tmp_path):
    model, _, pubsub, _ = make_model(tui, tmp_path)
    f0 = model.fcd_khz
    keys(model, ["+", ">", "}", "-"])
    assert model.fcd_khz == f0 + 1 + 10 + 50 - 1
    assert pubsub.get("fcd-tune-khz") == model.fcd_khz
    model.handle_key("ctrl-f")
    assert model.prompt is not None
    keys(model, list("145935") + ["enter"])
    assert model.prompt is None and model.fcd_khz == 145935
    keys(model, ["ctrl-f", "9", "backspace", "esc"])
    assert model.prompt is None and model.fcd_khz == 145935


@PKGS
def test_fft_hamming_toggle_scoped(tui, tmp_path):
    model, _, _, _ = make_model(tui, tmp_path)
    model.handle_key("2")
    assert model.hamming
    model.handle_key("h")
    assert not model.hamming
    keys(model, ["1", "h"])
    assert not model.hamming
    model.handle_key("alt-h")
    assert model.hamming


@PKGS
def test_demod_tab_keys(tui, tmp_path):
    model, _, pubsub, _ = make_model(tui, tmp_path)
    keys(model, ["3", "n"])
    assert model.demod_mode == "nfm" and model.demod_dirty
    model.handle_key("a")
    assert model.demod_mode == "am"
    model.handle_key("w")
    assert model.demod_mode == "wfm"
    keys(model, ["g", "i", "s"])
    assert model.agc and model.fir_enabled and model.downshift
    flo, fhi = model.flo, model.fhi
    model.handle_key("l")
    assert (model.flo, model.fhi) == (flo + 500, fhi + 500)
    keys(model, ["k", "L"])
    assert (model.flo, model.fhi) == (flo - 250, fhi + 250)
    model.handle_key("K")
    assert pubsub.get("demod-filter-low") == model.flo
    assert pubsub.get("demod-filter-high") == model.fhi
    keys(model, ["f"] + list("-2000:2500") + ["enter"])
    assert (model.flo, model.fhi) == (-2000, 2500)
    keys(model, ["1", "o"])
    assert model.demod_mode == "wfm"


@PKGS
def test_funcube_tab_keys(tui, tmp_path):
    model, _, pubsub, _ = make_model(tui, tmp_path)
    keys(model, ["6", "F"] + list("9000") + ["enter"])
    assert model.tunings == [12000.0, 9000.0]
    assert pubsub.get("FUNcube1-bpsk-tune") == 9000.0
    assert pubsub.get("bpsk-tunings") == [12000.0, 9000.0]
    model.handle_key("u")
    assert model.track_high[1] and model.bpsk_dirty
    model.handle_key("x")
    assert model.dofft[1]


@PKGS
def test_record_tab_keys(tui, tmp_path):
    model, _, _, _ = make_model(tui, tmp_path)
    keys(model, ["4", "o"] + list("cap.raw") + ["enter"])
    assert model.record_path == "cap.raw"
    model.handle_key("e")
    assert model.record_enabled and model.record_dirty


@PKGS
def test_open_and_close_source(tui, tmp_path):
    model, _, _, controls = make_model(tui, tmp_path)
    keys(model, ["ctrl-o"] + list("x.raw") + ["enter"])
    assert controls.new_source == "file:x.raw"
    assert controls.source_epoch == 1
    keys(model, ["ctrl-d"] + list("pipe:/tmp/f") + ["enter"])
    assert controls.new_source == "pipe:/tmp/f"
    model.handle_key("ctrl-w")
    assert controls.stop_source


@PKGS
def test_config_roundtrip(tui, tmp_path):
    model, _, _, controls = make_model(tui, tmp_path)
    keys(model, ["3", "n", "g", "alt-i", "6", "f"] + list("8500")
         + ["enter", "ctrl-q"])
    model2, _, _, c2 = make_model(tui, tmp_path)
    assert model2.demod_mode == "nfm" and model2.agc
    assert c2.icorr == 1
    assert model2.tunings[1] == 8500.0
    assert model2.tabs[model2.tab] == "FUNcube1"


# ---------------------------------------------------------------- render

@PKGS
def test_render_screens(tui, tmp_path):
    model, _, pubsub, _ = make_model(tui, tmp_path)
    w, h = 100, 36
    psd = np.full(9600, -90.0, np.float32)
    psd[1200] = -20.0
    pubsub.publish("fft-psd", psd)
    pubsub.publish("fft-peak", (12000, -20.0))
    pubsub.publish("audio-frame", 41)
    scr = model.render(w, h)
    assert len(scr) == h and all(len(ln) == w for ln in scr)
    assert "block 42" in scr[0]
    model.handle_key("2")
    scr = "\n".join(model.render(w, h))
    assert "peak -20.0 dBFS @ 12000 Hz" in scr
    assert "#" in scr
    assert model.waterfall.buf[0].max() > 0
    pubsub.publish("iq-block",
                   (0.5 * np.exp(2j * np.pi * 0.01 *
                                 np.arange(2048))).astype(np.complex64))
    model.handle_key("1")
    scr = "\n".join(model.render(w, h))
    assert "*" in scr and "autoscale" in scr
    pubsub.publish("telemetry-frame",
                   {"demod": 0, "tuning": 12000.0, "ok": True, "corr": 60,
                    "channel_errors": 3,
                    "payload": np.arange(256, dtype=np.uint8)})
    pubsub.publish("telemetry-counters", {0: (100, 10, 5, 1)})
    model.handle_key("5")
    scr = "\n".join(model.render(w, h))
    assert "corr=60" in scr and "00 01 02 03" in scr
    assert "raw=100" in scr
    keys(model, ["F", "9"])
    assert "9_" in model.render(w, h)[-1]


# ------------------------------------------------------- pipeline thread

def test_pipeline_thread_end_to_end(tmp_path):
    """Full application loop on the CPU: file source -> StageManager
    stages -> pub/sub -> model, telemetry on (9600 S/s: decim 1), a live
    demod-mode change swapping the stage in, pause, and quit; the thread
    records no error and no stage fault, and drops no block."""
    from jsdr_tpu_torch.io.convert import complex_to_s16le
    from jsdr_tpu_torch.io.sources import synth_sine

    rate = 9600
    iq = synth_sine(rate * 2, 1200.0, rate, analytic=False)
    path = tmp_path / "tone.raw"
    path.write_bytes(complex_to_s16le(iq))

    model, cfg, pubsub, controls = make_model(T, tmp_path, rate=rate,
                                              n_funcube=1)
    drops = []
    pubsub.listen(lambda t, v: drops.append(v) if t == "dropped-block"
                  else None)
    controls.new_source = f"file:{path}"
    controls.source_epoch += 1
    pipe = T.PipelineThread(model, rate, paced=False, device="cpu")
    pipe.start()
    deadline = time.time() + 60
    while ((model.blocks < 5 or pubsub.get("telemetry-counters") is None)
           and time.time() < deadline):
        time.sleep(0.05)
    assert model.blocks >= 5, f"pipeline stalled: {model.status}"
    assert model.last_psd is not None and model.last_iq is not None
    # telemetry runs at 9600 S/s (decim 1; drained every 4 blocks)
    assert pubsub.get("telemetry-counters")[0][0] >= 4 * rate // 10
    keys(model, ["3", "a"])
    b0 = model.blocks
    while (model.blocks < b0 + 3 or pubsub.get("audio-out") is None) \
            and time.time() < deadline:
        time.sleep(0.05)
    assert pubsub.get("audio-out") is not None, "demod stage not swapped in"
    model.handle_key("p")
    time.sleep(0.3)
    b1 = model.blocks
    time.sleep(0.3)
    assert model.blocks <= b1 + 1
    model.handle_key("p")
    model.handle_key("ctrl-q")
    pipe.join(timeout=10)
    assert not pipe.is_alive()
    assert pipe.error is None, pipe.error
    assert pipe.alerts == [] and drops == [], (pipe.alerts, drops)


def test_stage_manager_mesh(tmp_path):
    """ui --mesh: the StageManager builds the telemetry stage on the
    device mesh, and degrades (with a status note) when the shell's 0.1 s
    block cadence cannot satisfy the mesh's shard-shape contract (dofft
    needs whole 0.1 s blocks PER SHARD) — in both packages, with the same
    note; the CLI's --mesh spec parses to the same meshes."""
    from jsdr_tpu.app.main import _parse_mesh as j_parse_mesh
    from jsdr_tpu_torch.app.main import _parse_mesh

    notes = []
    for tui, mesh, dev in ((J, j_parse_mesh("2x4"), {}),
                           (T, _parse_mesh("2x4", "cpu"),
                            {"device": "cpu"})):
        assert dict(mesh.shape) == {"dp": 2, "sp": 4}
        model, _, _, _ = make_model(tui, tmp_path, rate=96000, n_funcube=1)
        mgr = tui.StageManager(model, 96000, mesh=mesh, **dev)
        assert mgr.telem is not None and mgr.telem.mesh is mesh
        assert mgr.telem.n == 2 and mgr.telem.n_real == 1   # dp padding
        mgr.close()
        model2, _, _, _ = make_model(tui, tmp_path, rate=96000, n_funcube=1)
        keys(model2, ["5", "x"])                  # FUNcube tab, dofft on
        mgr2 = tui.StageManager(model2, 96000, mesh=mesh, **dev)
        assert mgr2.telem is not None and mgr2.telem.mesh is None
        assert "mesh off" in model2.status
        notes.append(model2.status)
        mgr2.close()
    assert notes[0] == notes[1]
    assert _parse_mesh("auto", "cpu").shape == {"dp": 1, "sp": 1}
    with pytest.raises(SystemExit, match="DPxSP"):
        _parse_mesh("2by4", "cpu")


def test_stage_manager_swaps(tmp_path):
    model, _, pubsub, _ = make_model(T, tmp_path, rate=9600, n_funcube=1)
    mgr = T.StageManager(model, 9600, device="cpu")
    names = [s.name for s in mgr.stages]
    assert names == ["control-sync", "phase-tap", "spectrum", "telemetry"]
    assert mgr.telem.device.type == "cpu"
    keys(model, ["3", "n"])
    fake = types.SimpleNamespace(pubsub=pubsub)
    mgr.process(None, fake)
    assert [s.name for s in mgr.stages][-1] == "demod"
    assert mgr.demod.device.type == "cpu"
    model.handle_key("o")
    mgr.process(None, fake)
    assert "demod" not in [s.name for s in mgr.stages]
    telem0 = mgr.telem
    keys(model, ["5", "F"] + list("9000") + ["enter"])
    mgr.process(None, fake)
    assert mgr.telem is telem0 and mgr.telem.tunings == [9000.0]
    model.handle_key("x")
    mgr.process(None, fake)
    assert mgr.telem is not telem0
    mgr.close()


def test_ui_requires_a_card_unless_cpu(monkeypatch):
    """``ui`` runs on the card by default: without one it raises before
    any screen opens."""
    import torch

    from jsdr_tpu_torch.app.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["ui", "file:/nonexistent.raw"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.PipelineThread(types.SimpleNamespace(), 9600)


def test_phase_tap_publishes_host_complex64():
    import torch

    from jsdr_tpu_torch.ops.cplx import CF
    from jsdr_tpu_torch.runtime.pubsub import PubSub

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    ps = PubSub()
    T.PhaseTapStage(max_samples=4096).process(
        CF(torch.from_numpy(x[0]), torch.from_numpy(x[1])),
        types.SimpleNamespace(pubsub=ps))
    got = ps.get("iq-block")
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    assert got.shape == (4096,)
    np.testing.assert_array_equal(got.real, x[0, :4096])
    np.testing.assert_array_equal(got.imag, x[1, :4096])


# ------------------------------------------------ the two packages' stages

RATE = 96000
BLOCK = RATE // 10


def _signal(n_frames, carrier, seed):
    from jsdr_tpu_torch.io.sources import synth_bpsk_stream

    pay = np.random.default_rng(seed).integers(0, 256, (n_frames, 256),
                                               dtype=np.uint8)
    sig = synth_bpsk_stream(pay, rate=RATE, carrier_offset=carrier,
                            preamble_bits=600, noise_rms=0.25, seed=seed)
    sig = np.concatenate([sig, np.zeros((-len(sig)) % BLOCK, np.complex64)])
    return sig, pay


def _drive(tui, tmp_path, sig, script, cfg_text, mesh=None, n_funcube=2,
           **dev):
    """Run ``sig`` in 0.1 s blocks through ``tui``'s StageManager (on
    ``mesh`` if given) and a Session on the calling thread, applying
    ``script[b]``'s keys before block b; returns the published topics and
    the recorder's bytes."""
    if tui is J:
        from jsdr_tpu.runtime.executor import Session
    else:
        from jsdr_tpu_torch.runtime.executor import Session
    (tmp_path / "jsdr.properties").write_text(cfg_text)
    model, _, pubsub, _ = make_model(tui, tmp_path, rate=RATE,
                                     n_funcube=n_funcube)
    model.record_path = str(tmp_path / "rec.raw")
    got = {"telemetry-frame": [], "telemetry-counters": [], "fft-psd": [],
           "audio-out": []}

    def listen(topic, value):
        if topic in got:
            got[topic].append(value)

    pubsub.listen(listen)
    mgr = tui.StageManager(model, RATE, mesh=mesh, **dev)
    telem0 = mgr.telem

    def source():
        for b in range(len(sig) // BLOCK):
            keys(model, script.get(b, []))
            yield sig[b * BLOCK:(b + 1) * BLOCK]

    log = AlertLog()
    session = Session(source=source(), block_samples=BLOCK, pubsub=pubsub,
                      logger=log, **dev)
    session.run(mgr.stages)
    mgr.close()
    assert session.dropped_blocks == {}, session.dropped_blocks
    # the JAX package's StageManager and PhaseTapStage have no finish(),
    # which its Session alerts at the stream's end
    assert tui is J or log.alerts == [], log.alerts
    rec = tmp_path / "rec.raw"
    return got, rec.read_bytes() if rec.exists() else b"", telem0, mgr


def test_stages_under_the_shell_equal_the_jax_package(tmp_path):
    """Two FUNcube tabs on one stream (12000 Hz manual; the second
    switched to FFT auto-tune in block 2, a rebuild into a mixed set),
    WFM demod swapped in, the window toggled, the recorder on and off,
    NFM swapped for WFM, the second tab re-tuned."""
    sig, pay = _signal(2, 12000.0, seed=21)
    script = {2: ["6", "x"], 4: ["3", "w"], 7: ["4", "e"], 9: ["2", "h"],
              15: ["4", "e"], 30: ["3", "n"], 40: ["6", "F", "9", "0", "0",
                                                   "0", "enter"]}
    cfg = ("jsdr-tpu-version=1\njsdr-funcube-demods=2\n"
           "FUNcube0-bpsk-tuning=12000\nFUNcube1-bpsk-tuning=12000\n")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want, rec_j, _, _ = _drive(J, tmp_path / "j", sig, script, cfg)
    got, rec_t, _, mgr = _drive(T, tmp_path / "t", sig, script, cfg,
                                device="cpu")
    assert mgr.telem.dofft == [False, True]

    frames = [(f["demod"], f["tuning"], f["ok"], f["corr"],
               f["channel_errors"], np.asarray(f["payload"]).tobytes())
              for f in got["telemetry-frame"]]
    assert frames == [(f["demod"], f["tuning"], f["ok"], f["corr"],
                       f["channel_errors"],
                       np.asarray(f["payload"]).tobytes())
                      for f in want["telemetry-frame"]]
    ok0 = [f[5] for f in frames if f[0] == 0 and f[2]]
    assert ok0 == [p.tobytes() for p in pay]
    assert got["telemetry-counters"] == want["telemetry-counters"]
    # what the model reads is host data, never a tensor
    assert all(isinstance(x, np.ndarray) for x in
               got["fft-psd"] + got["audio-out"]
               + [f["payload"] for f in got["telemetry-frame"]])
    assert all(type(v) is int for c in got["telemetry-counters"]
               for t in c.values() for v in t)
    assert len(got["fft-psd"]) == len(want["fft-psd"]) == len(sig) // BLOCK
    import torch

    psd_tol = _chip_smoke().psd_tol
    for g, w in zip(got["fft-psd"], want["fft-psd"]):
        psd_tol(torch, g, np.asarray(w))
    assert len(got["audio-out"]) == len(want["audio-out"]) > 0
    for g, w in zip(got["audio-out"], want["audio-out"]):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max()
    assert len(rec_t) == 8 * 4 * BLOCK and rec_t == rec_j


def test_retune_key_reaches_the_running_telemetry_stage(tmp_path):
    """A frame at 9000 Hz; the tab starts at 12000 and is re-tuned in
    block 2 through the prompt: the same TelemetryStage (no rebuild, its
    state carried) decodes the frame at the new tuning."""
    sig, pay = _signal(1, 9000.0, seed=5)
    script = {2: ["5", "F"] + list("9000") + ["enter"]}
    cfg = "jsdr-tpu-version=1\njsdr-funcube-demods=2\n"
    got, _, telem0, mgr = _drive(T, tmp_path, sig, script, cfg,
                                 device="cpu")
    assert mgr.telem is telem0 and mgr.telem.tunings == [9000.0, 12000.0]
    ok = [f for f in got["telemetry-frame"] if f["ok"]]
    assert [(f["demod"], f["tuning"]) for f in ok] == [(0, 9000.0)]
    assert ok[0]["payload"].tobytes() == pay[0].tobytes()


def test_shell_on_a_mesh_equals_the_jax_package(tmp_path):
    """ui --mesh 2x4: two FUNcube tabs through the sharded step under each
    package's StageManager + Session, the second tab re-tuned in block
    30: the same frames and counters as the JAX package's sharded shell;
    then one tab (padded to dp=2 with its own tuning) keeps its padding
    across a re-tune and decodes at the new tuning. (The JAX package's
    shell drops the padding at a re-tune and its step then fails: ROADMAP
    queue 3.)"""
    from jsdr_tpu.parallel import make_mesh as j_make_mesh
    from jsdr_tpu_torch.parallel import make_mesh

    sig, pay = _signal(1, 12000.0, seed=21)
    script = {30: ["6", "F", "9", "0", "0", "0", "enter"]}
    cfg = ("jsdr-tpu-version=1\njsdr-funcube-demods=2\n"
           "FUNcube0-bpsk-tuning=12000\nFUNcube1-bpsk-tuning=12000\n")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want, _, _, jmgr = _drive(J, tmp_path / "j", sig, script, cfg,
                              mesh=j_make_mesh(dp=2, sp=4))
    mesh = make_mesh(dp=2, sp=4, device="cpu")
    got, _, telem0, mgr = _drive(T, tmp_path / "t", sig, script, cfg,
                                 mesh=mesh, device="cpu")
    assert jmgr.telem.mesh is not None
    assert mgr.telem is telem0 and mgr.telem.mesh is mesh
    assert mgr.telem.tunings == [12000.0, 9000.0]

    def rows(frames):
        return [(f["demod"], f["tuning"], f["ok"], f["corr"],
                 f["channel_errors"], np.asarray(f["payload"]).tobytes())
                for f in frames]

    assert rows(got["telemetry-frame"]) == rows(want["telemetry-frame"])
    assert [r[5] for r in rows(got["telemetry-frame"])
            if r[0] == 0 and r[2]] == [p.tobytes() for p in pay]
    assert got["telemetry-counters"] == want["telemetry-counters"]

    sig1, pay1 = _signal(1, 9000.0, seed=5)
    (tmp_path / "one").mkdir()
    got1, _, telem1, mgr1 = _drive(
        T, tmp_path / "one", sig1, {2: ["5", "F"] + list("9000") + ["enter"]},
        "jsdr-tpu-version=1\njsdr-funcube-demods=1\n", mesh=mesh,
        n_funcube=1, device="cpu")
    assert mgr1.telem is telem1 and mgr1.telem.tunings == [9000.0, 9000.0]
    ok = [f for f in got1["telemetry-frame"] if f["ok"]]
    assert [(f["demod"], f["tuning"]) for f in ok] == [(0, 9000.0)]
    assert ok[0]["payload"].tobytes() == pay1[0].tobytes()
    assert list(got1["telemetry-counters"][-1]) == [0]
