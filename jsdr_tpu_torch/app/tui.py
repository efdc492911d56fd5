"""Interactive terminal UI — the port of :mod:`jsdr_tpu.app.tui`, the
analog of the reference's Swing shell (jsdr.java tabs + menus +
accelerator map), over the port's Session and stages on a torch device.

The reference presents phase/FFT/demod/record/FUNcube-N tabs over an
always-visible waterfall split pane (jsdr.java:432-484) and drives every
action through menu accelerators (accelerator-map.txt). This module is
the terminal equivalent: a curses front-end over the same Session
executor and pub/sub bus the headless CLI uses, with the reference's
hotkey map adapted to terminal key reachability (the map is in
:mod:`jsdr_tpu.app.tui`'s docstring; ``Tab``/``1..9`` select tabs,
``p`` pauses, ``Ctrl-Q`` quits and saves the config).

``Controls``, ``TuiModel``, ``decode_key``, ``DEMOD_MODES`` and
``_SHADES`` are the reference's code unchanged (no curses, no tensors:
the stages publish host numpy, which is what ``TuiModel.on_publish``
reads); tests/test_torch_host_copies.py holds them equal. The rest is
ported onto the port's stages: ``PhaseTapStage`` copies its tap to the
host explicitly, ``StageManager`` and ``PipelineThread`` take the torch
``device`` the stages hold their state on (``"cuda"`` by default; the
pipeline thread makes it its current device), and the device mesh of
``StageManager(mesh=...)`` raises NotImplementedError until
``parallel/`` is ported. The curses runner (:func:`run_tui`) is a thin
IO shell around the model.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..display import Waterfall
from ..display.render import render_psd_ascii
from ..runtime.config import Config
from ..runtime.pubsub import PubSub

# intensity ramp for the terminal waterfall (dark -> bright); the PNG
# renderer keeps the reference's peak-color law, here we quantize it
_SHADES = " .:-=+*#%@"

DEMOD_MODES = ("off", "raw", "am", "nfm", "wfm")


@dataclass
class Controls:
    """Knobs shared between the UI thread and the pipeline thread.

    The pipeline reads these between blocks (the analog of the
    reference's menu actions poking the running capture thread's
    objects, jsdr.java:203-222); plain attribute reads/writes under the
    GIL, same coarse granularity as the reference's synchronized blocks.
    """

    paused: bool = False
    quit: bool = False
    icorr: int = 0
    qcorr: int = 0
    # source lifecycle: Ctrl-O/Ctrl-D set new_source and bump the epoch;
    # Ctrl-W stops the current source without a replacement
    source_name: str = ""
    new_source: Optional[str] = None
    source_epoch: int = 0
    stop_source: bool = False


class TuiModel:
    """The interactive shell's state machine (jsdr.java's tab/menu state,
    minus Swing)."""

    def __init__(self, cfg: Config, pubsub: PubSub, controls: Controls,
                 rate: int = 96000, n_funcube: int = 2,
                 waterfall_width: int = 120):
        self.cfg = cfg
        self.pubsub = pubsub
        self.controls = controls
        self.rate = rate
        self.n_funcube = n_funcube
        self.tabs = (["phase", "fft", "demod", "record"]
                     + [f"FUNcube{i}" for i in range(n_funcube)])
        self.tab = int(np.clip(cfg.get_int("jsdr-tab-focus", 1), 0,
                               len(self.tabs) - 1))
        self.split = cfg.get_int("jsdr-split-position", 12)  # waterfall rows
        # audio / corrections (JavaAudio.java:161-169 persistence)
        controls.icorr = cfg.get_int("audio-ic", 0)
        controls.qcorr = cfg.get_int("audio-qc", 0)
        # fcd
        self.fcd_khz = cfg.get_int("jsdr-fcd-frequency", 145935)
        # fft
        self.hamming = cfg.get_int("fft-hamming", 1) != 0
        # demod tab state (demod.java:32-37 keys)
        self.demod_mode = DEMOD_MODES[
            int(np.clip(cfg.get_int("demod-mode", 0), 0, 4))]
        self.flo = cfg.get_int("demod-filter-low", -3000)
        self.fhi = cfg.get_int("demod-filter-high", 3000)
        self.fir_enabled = cfg.get_int("demod-fir-enable", 0) != 0
        self.agc = cfg.get_int("demod-agc-enable", 0) != 0
        self.downshift = cfg.get_int("demod-downshift-enable", 0) != 0
        self.audio_out = cfg.get("demod-output", "audio.raw")
        self.demod_dirty = False        # pipeline rebuilds cfg when set
        # funcube tabs (FUNcube<n>-bpsk-* keys)
        self.tunings = [float(cfg.get_int(f"FUNcube{i}-bpsk-tuning", 12000))
                        for i in range(n_funcube)]
        self.track_high = [cfg.get_int(f"FUNcube{i}-bpsk-upper", 0) != 0
                           for i in range(n_funcube)]
        self.dofft = [cfg.get_int(f"FUNcube{i}-bpsk-dofft", 0) != 0
                      for i in range(n_funcube)]
        self.bpsk_dirty = False
        # record tab
        self.record_path = cfg.get("recorder-path", "capture.raw")
        self.record_enabled = False
        self.record_dirty = False
        # live data (filled by on_publish)
        self.waterfall = Waterfall(width=waterfall_width, height=64)
        self.last_psd: Optional[np.ndarray] = None
        self.peak: Optional[tuple] = None
        self.last_iq: Optional[np.ndarray] = None
        self.frames: deque = deque(maxlen=8)
        self.counters: dict[int, tuple] = {}
        self.blocks = 0
        self.status = "ready"
        self.alive = True
        # prompt: (label, buffer, commit callback)
        self.prompt: Optional[list] = None
        pubsub.listen(self.on_publish)

    # ---------------------------------------------------------- pub/sub

    def on_publish(self, topic: str, value: Any) -> None:
        """Ingest the observability topics the stages publish — the same
        bus the reference tabs listen on (fft-psd, FUNcube<n>-bpsk-*,
        jsdr.java:118-147)."""
        if topic == "fft-psd":
            psd = np.atleast_2d(np.asarray(value))
            self.waterfall.push_many(psd)
            self.last_psd = psd[-1]
        elif topic == "fft-peak":
            self.peak = value
        elif topic == "iq-block":
            self.last_iq = value
        elif topic == "audio-frame":
            self.blocks = int(value) + 1
        elif topic == "telemetry-frame":
            self.frames.appendleft(value)
        elif topic == "telemetry-counters":
            self.counters = value
        elif topic == "status":
            self.status = str(value)

    # ------------------------------------------------------------- keys

    def handle_key(self, key: str) -> bool:
        """Dispatch one decoded key name; returns False once quit."""
        if self.prompt is not None:
            self._prompt_key(key)
            return self.alive
        fn = self._global_keys().get(key)
        if fn is None:
            fn = self._tab_keys().get(key)
        if fn is not None:
            fn()
        return self.alive

    def _global_keys(self) -> dict[str, Callable[[], None]]:
        k: dict[str, Callable[[], None]] = {
            # file menu
            "ctrl-o": lambda: self._open_prompt(
                "open file (path)", self._do_open_file),
            "ctrl-d": lambda: self._open_prompt(
                "open device (pipe:<path> | capture:<cmd> | fcd)",
                self._do_open_device),
            "ctrl-w": self._close_audio,
            "ctrl-q": self._quit,
            # audio menu
            "p": self._pause, "alt-p": self._pause,
            "alt-i": lambda: self._icorr(+1),
            "alt-I": lambda: self._icorr(-1),
            "alt-q": lambda: self._qcorr(+1),
            "alt-Q": lambda: self._qcorr(-1),
            "alt-r": self._reset_corr,
            # fcd menu (+-1 / +-10 / +-50 kHz, jsdr.java:318-367)
            "ctrl-f": lambda: self._open_prompt(
                "FCD frequency (kHz)", self._do_tune_khz),
            "+": lambda: self._tune_step(1), "-": lambda: self._tune_step(-1),
            "alt-+": lambda: self._tune_step(10),
            "alt--": lambda: self._tune_step(-10),
            ">": lambda: self._tune_step(10), "<": lambda: self._tune_step(-10),
            "}": lambda: self._tune_step(50), "{": lambda: self._tune_step(-50),
            "alt-h": self._toggle_hamming,
            # tabs
            "tab": lambda: self._focus((self.tab + 1) % len(self.tabs)),
            "shift-tab": lambda: self._focus((self.tab - 1) % len(self.tabs)),
        }
        for i in range(min(len(self.tabs), 9)):
            k[str(i + 1)] = (lambda i=i: self._focus(i))
        return k

    def _tab_keys(self) -> dict[str, Callable[[], None]]:
        name = self.tabs[self.tab]
        if name == "phase":
            return {"i": lambda: self._icorr(+1), "I": lambda: self._icorr(-1),
                    "q": lambda: self._qcorr(+1), "Q": lambda: self._qcorr(-1),
                    "r": self._reset_corr}
        if name == "fft":
            return {"h": self._toggle_hamming}
        if name == "demod":
            k = {m[0]: (lambda m=m: self._set_mode(m)) for m in DEMOD_MODES}
            k.update({
                "g": self._toggle_agc, "i": self._toggle_fir,
                "s": self._toggle_downshift,
                "f": lambda: self._open_prompt(
                    "FIR band lo:hi (Hz)", self._do_fir_band),
                "d": lambda: self._open_prompt(
                    "audio output (path | cmd:<player>)", self._do_audio_out),
                "l": lambda: self._fir_move(+500),
                "k": lambda: self._fir_move(-500),
                "L": lambda: self._fir_widen(+500),
                "K": lambda: self._fir_widen(-500),
            })
            return k
        if name == "record":
            return {"e": self._toggle_record,
                    "o": lambda: self._open_prompt(
                        "record path", self._do_record_path)}
        if name.startswith("FUNcube"):
            return {"F": lambda: self._open_prompt(
                        "BPSK centre frequency (Hz)", self._do_bpsk_tune),
                    "f": lambda: self._open_prompt(
                        "BPSK centre frequency (Hz)", self._do_bpsk_tune),
                    "u": self._toggle_upper,
                    "x": self._toggle_dofft}
        return {}

    # prompt handling (the terminal analog of the reference's
    # JOptionPane input dialogs, jsdr.java:597-610)

    def _open_prompt(self, label: str, commit: Callable[[str], None]):
        self.prompt = [label, "", commit]

    def _prompt_key(self, key: str):
        label, buf, commit = self.prompt
        if key == "enter":
            self.prompt = None
            try:
                commit(buf)
            except (ValueError, TypeError) as e:
                self.status = f"bad input: {e}"
        elif key == "esc":
            self.prompt = None
        elif key == "backspace":
            self.prompt[1] = buf[:-1]
        elif len(key) == 1 and key.isprintable():
            self.prompt[1] = buf + key

    # actions

    def _quit(self):
        self.alive = False
        self.controls.quit = True
        self.save_config()

    def _pause(self):
        self.controls.paused = not self.controls.paused
        self.status = "paused" if self.controls.paused else "running"

    def _close_audio(self):
        self.controls.stop_source = True
        self.status = "audio closed (Ctrl-O / Ctrl-D to reopen)"

    def _do_open_file(self, path: str):
        if not path:
            raise ValueError("empty path")
        self.controls.new_source = f"file:{path.removeprefix('file:')}"
        self.controls.source_epoch += 1
        self.status = f"opening {path}"

    def _do_open_device(self, spec: str):
        if not spec:
            raise ValueError("empty device spec")
        self.controls.new_source = spec
        self.controls.source_epoch += 1
        self.status = f"opening {spec}"

    def _icorr(self, d: int):
        self.controls.icorr += d
        self.status = f"I corr = {self.controls.icorr}"

    def _qcorr(self, d: int):
        self.controls.qcorr += d
        self.status = f"Q corr = {self.controls.qcorr}"

    def _reset_corr(self):
        self.controls.icorr = self.controls.qcorr = 0
        self.status = "I/Q corrections reset"

    def _tune_step(self, khz: int):
        self._do_tune_khz(str(self.fcd_khz + khz))

    def _do_tune_khz(self, txt: str):
        self.fcd_khz = int(txt)
        self.status = f"FCD tune {self.fcd_khz} kHz"
        self.pubsub.publish("fcd-tune-khz", self.fcd_khz)

    def _toggle_hamming(self):
        self.hamming = not self.hamming
        self.status = f"hamming {'on' if self.hamming else 'off'}"
        self.pubsub.publish("fft-window", self.hamming)

    def _set_mode(self, mode: str):
        self.demod_mode = mode
        self.demod_dirty = True
        self.status = f"demod mode {mode}"

    def _toggle_agc(self):
        self.agc = not self.agc
        self.demod_dirty = True
        self.status = f"AGC {'on' if self.agc else 'off'}"

    def _toggle_fir(self):
        self.fir_enabled = not self.fir_enabled
        self.demod_dirty = True
        self.status = f"FIR {'on' if self.fir_enabled else 'off'}"
        self._publish_band()

    def _toggle_downshift(self):
        self.downshift = not self.downshift
        self.demod_dirty = True
        self.status = f"downshift {'on' if self.downshift else 'off'}"

    def _do_fir_band(self, txt: str):
        lo, hi = txt.split(":")
        self.flo, self.fhi = int(lo), int(hi)
        self.fir_enabled = True
        self.demod_dirty = True
        self._publish_band()
        self.status = f"FIR band [{self.flo}, {self.fhi}] Hz"

    def _fir_move(self, d: int):
        # demod.java:305-311 band shift
        self.flo += d
        self.fhi += d
        self.demod_dirty = True
        self._publish_band()
        self.status = f"FIR band [{self.flo}, {self.fhi}] Hz"

    def _fir_widen(self, d: int):
        # demod.java:312-317 widen/narrow both edges
        self.flo -= d // 2
        self.fhi += d // 2
        self.demod_dirty = True
        self._publish_band()
        self.status = f"FIR band [{self.flo}, {self.fhi}] Hz"

    def _publish_band(self):
        # the topics fft.java:98-106 overlays read
        self.pubsub.publish("demod-filter-low", self.flo)
        self.pubsub.publish("demod-filter-high", self.fhi)

    def _do_audio_out(self, txt: str):
        self.audio_out = txt
        self.demod_dirty = True
        self.status = f"audio out -> {txt}"

    def _funcube_idx(self) -> int:
        name = self.tabs[self.tab]
        return int(name.removeprefix("FUNcube")) if name.startswith(
            "FUNcube") else 0

    def _do_bpsk_tune(self, txt: str):
        i = self._funcube_idx()
        self.tunings[i] = float(txt)
        # tunings are traced data in the batched chain — retune without
        # recompile (FUNcube<n>-bpsk-tuning analog)
        self.pubsub.publish(f"FUNcube{i}-bpsk-tune", self.tunings[i])
        self.pubsub.publish("bpsk-tunings", list(self.tunings))
        self.status = f"FUNcube{i} tuning {self.tunings[i]:.0f} Hz"

    def _toggle_upper(self):
        i = self._funcube_idx()
        self.track_high[i] = not self.track_high[i]
        self.bpsk_dirty = True
        self.status = (f"FUNcube{i} tracking "
                       f"{'upper' if self.track_high[i] else 'lower'} half")

    def _toggle_dofft(self):
        i = self._funcube_idx()
        self.dofft[i] = not self.dofft[i]
        self.bpsk_dirty = True
        self.status = (f"FUNcube{i} FFT auto-tune "
                       f"{'on' if self.dofft[i] else 'off'}")

    def _toggle_record(self):
        self.record_enabled = not self.record_enabled
        self.record_dirty = True
        self.status = (f"recording {'-> ' + self.record_path if self.record_enabled else 'stopped'}")

    def _do_record_path(self, txt: str):
        self.record_path = txt
        self.record_dirty = True
        self.status = f"record path {txt}"

    def _focus(self, i: int):
        self.tab = i
        self.status = f"tab {self.tabs[i]}"

    # ------------------------------------------------------------ config

    def save_config(self):
        """Persist the session's UI state on quit (jsdr.java:105-115,
        547-550)."""
        c = self.cfg
        c.set("jsdr-tab-focus", self.tab)
        c.set("jsdr-split-position", self.split)
        c.set("jsdr-fcd-frequency", self.fcd_khz)
        c.set("audio-ic", self.controls.icorr)
        c.set("audio-qc", self.controls.qcorr)
        c.set("fft-hamming", int(self.hamming))
        c.set("demod-mode", DEMOD_MODES.index(self.demod_mode))
        c.set("demod-filter-low", self.flo)
        c.set("demod-filter-high", self.fhi)
        c.set("demod-fir-enable", int(self.fir_enabled))
        c.set("demod-agc-enable", int(self.agc))
        c.set("demod-downshift-enable", int(self.downshift))
        c.set("demod-output", self.audio_out)
        c.set("jsdr-funcube-demods", self.n_funcube)
        for i in range(self.n_funcube):
            c.set(f"FUNcube{i}-bpsk-tuning", int(self.tunings[i]))
            c.set(f"FUNcube{i}-bpsk-upper", int(self.track_high[i]))
            c.set(f"FUNcube{i}-bpsk-dofft", int(self.dofft[i]))
        c.set("recorder-path", self.record_path)
        c.save()

    # ------------------------------------------------------------ render

    def render(self, width: int = 100, height: int = 36) -> list[str]:
        """Compose the screen as a list of ``height`` strings."""
        wf_rows = min(self.split, height - 8)
        body_rows = height - wf_rows - 4
        lines = [self._header(width), self._tab_bar(width)]
        body = self._render_tab(width, body_rows)
        body += [""] * (body_rows - len(body))
        lines += [ln[:width] for ln in body[:body_rows]]
        lines.append(("-- waterfall " + "-" * width)[:width])
        lines += self._render_waterfall(width, wf_rows)
        lines.append(self._status_bar(width))
        return [ln[:width].ljust(width) for ln in lines[:height]]

    def _header(self, width: int) -> str:
        run = "PAUSED" if self.controls.paused else "running"
        src = self.controls.source_name or "(no source)"
        return (f" jsdr-tpu | {src} @ {self.rate} S/s | {run} | "
                f"block {self.blocks} | FCD {self.fcd_khz} kHz")[:width]

    def _tab_bar(self, width: int) -> str:
        parts = []
        for i, t in enumerate(self.tabs):
            parts.append(f"[{t.upper()}]" if i == self.tab else f" {t} ")
        return " ".join(parts)[:width]

    def _status_bar(self, width: int) -> str:
        if self.prompt is not None:
            return f" {self.prompt[0]}: {self.prompt[1]}_"[:width]
        return (f" {self.status} | keys: Tab=next p=pause Ctrl-Q=quit "
                f"Ctrl-O=open")[:width]

    def _render_tab(self, width: int, rows: int) -> list[str]:
        name = self.tabs[self.tab]
        if name == "phase":
            return self._render_phase(width, rows)
        if name == "fft":
            return self._render_fft(width, rows)
        if name == "demod":
            return self._render_demod(width, rows)
        if name == "record":
            return self._render_record(width, rows)
        return self._render_funcube(width, rows)

    def _render_phase(self, width: int, rows: int) -> list[str]:
        out = [f" I corr {self.controls.icorr}  Q corr {self.controls.qcorr}"
               f"  (i/I q/Q adjust, r reset)"]
        if self.last_iq is None:
            return out + [" (no data yet)"]
        iq = self.last_iq
        # constellation cloud on a rows x (2*rows) character grid
        grid_h = max(rows - 2, 4)
        grid_w = min(width - 2, grid_h * 2)
        m = float(np.max(np.abs(np.stack([iq.real, iq.imag])))) or 1.0
        x = np.clip(((iq.real / m + 1) * 0.5 * (grid_w - 1)).astype(int),
                    0, grid_w - 1)
        y = np.clip(((1 - iq.imag / m) * 0.5 * (grid_h - 1)).astype(int),
                    0, grid_h - 1)
        grid = np.full((grid_h, grid_w), " ", dtype="<U1")
        grid[grid_h // 2, :] = "-"
        grid[:, grid_w // 2] = "|"
        grid[y, x] = "*"
        out += ["".join(r) for r in grid]
        out.append(f" autoscale max |I/Q| = {m:.4f}")
        return out

    def _render_fft(self, width: int, rows: int) -> list[str]:
        head = f" window: {'hamming' if self.hamming else 'none'} (h toggles)"
        if self.peak:
            head += f" | peak {self.peak[1]:.1f} dBFS @ {self.peak[0]} Hz"
        if self.last_psd is None:
            return [head, " (no data yet)"]
        plot = render_psd_ascii(self.last_psd, width=width - 2,
                                height=max(rows - 3, 4)).splitlines()
        # tuning-bar overlay (fft.java:152-173): mark each FUNcube tuning
        marks = [" "] * (width - 2)
        n = len(self.last_psd)
        for tn in self.tunings:
            col = int((tn / self.rate + 0.5) * (width - 2))
            if 0 <= col < len(marks):
                marks[col] = "^"
        return [head] + plot + ["".join(marks)]

    def _render_demod(self, width: int, rows: int) -> list[str]:
        band = (f"[{self.flo}, {self.fhi}] Hz" if self.fir_enabled
                else "off")
        return [
            f" mode: {self.demod_mode.upper()}   (o/r/a/n/w to set)",
            f" FIR band: {band}   (i toggle, f set, l/k move, L/K width)",
            f" AGC: {'on' if self.agc else 'off'} (g)   "
            f"downshift: {'on' if self.downshift else 'off'} (s)",
            f" output: {self.audio_out} (d)",
        ]

    def _render_record(self, width: int, rows: int) -> list[str]:
        return [
            f" recording: {'ON' if self.record_enabled else 'off'} (e toggles)",
            f" path: {self.record_path} (o sets)",
        ]

    def _render_funcube(self, width: int, rows: int) -> list[str]:
        i = self._funcube_idx()
        c = self.counters.get(i, (0, 0, 0, 0))
        out = [
            f" FUNcube{i}  tuning {self.tunings[i]:.0f} Hz (F sets)  "
            f"track {'upper' if self.track_high[i] else 'lower'} (u)  "
            f"fft-tune {'on' if self.dofft[i] else 'off'} (x)",
            f" counters: raw={c[0]} ds={c[1]} bits={c[2]} syncs={c[3]}",
        ]
        shown = 0
        for fr in self.frames:
            if fr.get("demod") != i or shown >= max((rows - 4) // 5, 1):
                continue
            shown += 1
            out.append(f" frame ok={fr['ok']} corr={fr['corr']} "
                       f"channel_errors={fr['channel_errors']}:")
            payload = np.asarray(fr["payload"])
            for off in range(0, 64, 16):   # first 4 hexdump rows fit a TUI
                row = " ".join(f"{b:02x}" for b in payload[off:off + 16])
                out.append(f"   {off:3d}: {row}")
        if not shown:
            out.append(" (no frames decoded yet)")
        return out

    def _render_waterfall(self, width: int, rows: int) -> list[str]:
        buf = self.waterfall.buf[:rows]
        w = min(width, buf.shape[1])
        idx = (buf[:, :w].astype(int) * (len(_SHADES) - 1)) // 255
        return ["".join(_SHADES[v] for v in row) for row in idx]


# --------------------------------------------------------------- curses IO


def decode_key(ch: int, next_ch: int = -1) -> Optional[str]:
    """Translate curses key codes to the model's key names.

    ESC-prefixed chars arrive as Alt chords (terminal convention);
    control codes 1..26 as ctrl-<letter>. Returns None for unmapped keys.
    """
    if ch == 27:
        if next_ch == -1:
            return "esc"
        if 32 <= next_ch < 127:
            return f"alt-{chr(next_ch)}"
        return None
    if ch == 9:
        return "tab"
    if ch in (10, 13):
        return "enter"
    if ch in (8, 127, 263):            # BS / DEL / KEY_BACKSPACE
        return "backspace"
    if ch == 353:                      # KEY_BTAB
        return "shift-tab"
    if 1 <= ch <= 26:
        return f"ctrl-{chr(ord('a') + ch - 1)}"
    if 32 <= ch < 127:
        return chr(ch)
    return None



class PhaseTapStage:
    """Publishes a host copy of each block for the phase scope
    (phase.java:123-128's per-block copy): its first ``max_samples``
    samples as complex64 on 'iq-block', read back from the block's device
    (one small copy a block, as the reference's ``np.asarray`` was)."""

    name = "phase-tap"
    state = None

    def __init__(self, max_samples: int = 4096):
        self.max_samples = max_samples

    def process(self, block, session):
        re = block.re[: self.max_samples].cpu().numpy()
        im = block.im[: self.max_samples].cpu().numpy()
        session.pubsub.publish("iq-block", re + 1j * im)

    def finish(self, session):
        """Nothing is deferred (the Session flushes every stage)."""


class StageManager:
    """Owns one session's stage list and rebuilds stages when the model's
    dirty flags fire — the analog of the reference's menu actions
    reconfiguring the live tab objects (demod.java:205-212 etc.).

    Registered as the FIRST stage so the swap happens between blocks on
    the pipeline thread; session.run iterates the shared list object, so
    in-place mutation takes effect on the same block. The telemetry and
    demod stages hold their state on ``device``; a re-tune reaches the
    running telemetry stage's host tuning list on the next block, without
    a rebuild. A device mesh (``mesh``) raises NotImplementedError: the
    port has no ``parallel/`` yet.
    """

    name = "control-sync"
    state = None

    def __init__(self, model: TuiModel, rate: int, mesh=None,
                 device: Any = "cuda"):
        from ..runtime.device import require_device
        if mesh is not None:
            raise NotImplementedError(
                "StageManager(mesh=...) needs parallel/, which is not "
                "ported to jsdr_tpu_torch yet (ROADMAP.md, queue 1); use "
                "jsdr-tpu for it")
        self.model = model
        self.rate = rate
        self.mesh = mesh
        self.device = require_device(device)
        self.stages: list = [self]
        self._build_initial()

    def _build_initial(self):
        from ..runtime.executor import SpectrumStage
        m = self.model
        self.spectrum = SpectrumStage(self.rate, window=m.hamming)
        self.telem = self._make_telem()
        self.demod = self._make_demod() if m.demod_mode != "off" else None
        self.recorder = None
        self.stages += [PhaseTapStage(), self.spectrum]
        if self.telem:
            self.stages.append(self.telem)
        if self.demod:
            self.stages.append(self.demod)
        if m.record_enabled:
            self._swap_recorder()

    def _make_telem(self):
        """BPSK telemetry tabs — only when the rate supports the chain
        (the 9600 Hz decimator and the timing recovery's 8*decim block
        grouping; 96 k / 192 k always do)."""
        from ..demod.bpsk import BpskConfig
        from ..runtime.executor import TelemetryStage
        m = self.model
        decim = self.rate // 9600
        if decim < 1 or (self.rate // 10) % (8 * max(decim, 1)):
            m.status = (f"telemetry disabled: {self.rate} S/s blocks do "
                        f"not fit the 9600 Hz chain")
            return None
        # per-instance dofft/upper run in ONE batched call (a mixed set
        # selects per stream; FUNcube<n>-bpsk-dofft/-upper)
        return TelemetryStage(
            BpskConfig(rate=self.rate, tuning=m.tunings[0]),
            tunings=list(m.tunings), dofft=list(m.dofft),
            track_high=list(m.track_high), device=self.device)

    def _make_demod(self):
        from ..demod.am_fm import AmFmConfig
        from ..runtime.executor import DemodStage
        m = self.model
        return DemodStage(AmFmConfig(
            rate=self.rate, mode=DEMOD_MODES.index(m.demod_mode),
            dofir=m.fir_enabled, dodwn=m.downshift, doagc=m.agc,
            flo=m.flo if m.fir_enabled else None,
            fhi=m.fhi if m.fir_enabled else None), device=self.device)

    def _swap(self, old, new):
        if old is not None and old in self.stages:
            if new is not None:
                self.stages[self.stages.index(old)] = new
            else:
                self.stages.remove(old)
        elif new is not None:
            self.stages.append(new)
        return new

    def _swap_recorder(self):
        from ..runtime.executor import RecorderStage
        m = self.model
        if self.recorder is not None:
            self.recorder.close()
        new = RecorderStage(m.record_path) if m.record_enabled else None
        self.recorder = self._swap(self.recorder, new)

    def process(self, block, session):
        m = self.model
        self.spectrum.window = m.hamming
        if self.telem is not None:
            self.telem.tunings = [float(t) for t in m.tunings]
        if m.bpsk_dirty:
            m.bpsk_dirty = False
            self.telem = self._swap(self.telem, self._make_telem())
        if m.demod_dirty:
            m.demod_dirty = False
            new = self._make_demod() if m.demod_mode != "off" else None
            self.demod = self._swap(self.demod, new)
        if m.record_dirty:
            m.record_dirty = False
            self._swap_recorder()

    def finish(self, session):
        """Nothing is deferred: the managed stages sit in the same list,
        and the Session flushes each of them."""

    def close(self):
        if self.recorder is not None:
            self.recorder.close()


class PipelineThread(threading.Thread):
    """The capture/processing thread (JavaAudio.java:195-329 analog):
    opens the current source, drives the Session on ``device``, applies
    control changes between blocks, and reopens on Ctrl-O/Ctrl-D.

    Torch keeps the current CUDA device per thread, so a ``"cuda"``
    device is pinned to the constructing thread's current card here and
    made the thread's current device when it starts; the kernels launch
    on that device's current stream. Grad mode needs nothing: no tensor
    of the pipeline requires grad. A pipeline exception ends the source's
    session, lands in ``error`` and the status line (the reference's UI
    behaviour). A stage's exception does not: the Session retries the
    block, then drops it for that stage and streams on, and alerts the
    status line either way; those alerts also land in ``alerts``. A
    headless caller asserts ``error is None`` and ``alerts == []``."""

    def __init__(self, model: TuiModel, rate: int, paced: bool = True,
                 mesh=None, device: Any = "cuda"):
        from ..runtime.device import require_device
        super().__init__(daemon=True)
        self.model = model
        self.rate = rate
        self.paced = paced
        self.mesh = mesh
        dev = require_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.error: Optional[str] = None
        self.alerts: list[str] = []       # the sessions' stage faults

    def _open(self, name: str):
        from ..io.live import PacedSource, StreamSource
        from ..io.sources import FileSource
        if name.startswith(("pipe:", "capture:")) or name == "-":
            src = StreamSource(name, rate=self.rate,
                               i_corr=self.model.controls.icorr,
                               q_corr=self.model.controls.qcorr)
            return src, iter(src)
        if name == "fcd":
            from ..io.fcd import FCD
            spec = FCD().capture_source(self.rate)
            if spec is None:
                raise RuntimeError("no FUNcube Dongle capture device")
            return self._open(spec)
        path = name.removeprefix("file:")
        src = FileSource(path, rate=self.rate, loop=True,
                         i_corr=self.model.controls.icorr,
                         q_corr=self.model.controls.qcorr)
        blocks = src.blocks(self.rate // 10)
        if self.paced:
            blocks = iter(PacedSource(blocks, src.rate))
        return src, blocks

    def _controlled(self, src, blocks):
        """Wrap a block iterator with pause/stop/correction handling."""
        c = self.model.controls
        epoch = c.source_epoch
        for chunk in blocks:
            while c.paused and not c.quit and not c.stop_source:
                time.sleep(0.05)
            if c.quit or c.stop_source or c.source_epoch != epoch:
                return
            src.i_corr, src.q_corr = c.icorr, c.qcorr
            yield chunk

    def run(self):
        from ..runtime.executor import Session
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        c = self.model.controls
        while not c.quit:
            name = c.new_source or c.source_name
            c.new_source = None
            c.stop_source = False
            if not name:
                time.sleep(0.1)
                continue
            c.source_name = name
            try:
                src, blocks = self._open(name)
            except Exception as e:  # noqa: BLE001
                self.model.status = f"open failed: {e}"
                c.source_name = ""
                continue
            # route alerts into the status line — stderr prints would
            # corrupt the curses screen (the reference's ILogger alert
            # dialog analog)
            from ..runtime.log import Logger

            class _TuiLogger(Logger):
                def _emit(inner, level, msg):
                    if level == "ALT":
                        self.alerts.append(msg)
                    self.model.status = f"[{level}] {msg}"[:160]

            session = Session(source=self._controlled(src, blocks),
                              block_samples=self.rate // 10,
                              pubsub=self.model.pubsub,
                              logger=_TuiLogger(), device=self.device)
            mgr = StageManager(self.model, self.rate, mesh=self.mesh,
                               device=self.device)
            self._session = session
            try:
                session.run(mgr.stages)
            except Exception as e:  # noqa: BLE001
                self.error = repr(e)
                self.model.status = f"pipeline error: {e!r:.80}"
            finally:
                mgr.close()
            if c.stop_source:
                c.source_name = ""


def run_tui(args) -> int:
    """Entry point for the ``ui`` subcommand: curses shell around the
    model + pipeline thread on ``args.device`` (raises without a card
    unless it is ``cpu``; ``--mesh`` raises NotImplementedError)."""
    import curses

    from ..runtime.device import require_device
    if getattr(args, "mesh", None):
        raise NotImplementedError(
            f"ui --mesh {args.mesh}: the multi-device path (parallel/) is "
            "not ported to jsdr_tpu_torch yet (ROADMAP.md, queue 1); use "
            "jsdr-tpu for it")
    device = require_device(args.device)
    cfg = Config(args.config) if args.config else Config("jsdr.properties")
    pubsub = PubSub()
    controls = Controls()
    n_demods = cfg.get_int("jsdr-funcube-demods", 2)
    model = TuiModel(cfg, pubsub, controls, rate=args.rate,
                     n_funcube=n_demods)
    if getattr(args, "source", None):
        controls.new_source = args.source
        controls.source_epoch += 1
    pipe = PipelineThread(model, args.rate, paced=not args.no_pace,
                          device=device)
    pipe.start()

    def loop(scr):
        curses.raw()      # deliver Ctrl-Q/Ctrl-S (no XON/XOFF flow control)
        curses.curs_set(0)
        scr.nodelay(True)
        scr.timeout(100)               # 10 Hz redraw, the reference cadence
        while model.alive:
            ch = scr.getch()
            if ch != -1:
                nxt = scr.getch() if ch == 27 else -1
                key = decode_key(ch, nxt)
                if key:
                    model.handle_key(key)
            h, w = scr.getmaxyx()
            for y, line in enumerate(model.render(w - 1, h)):
                try:
                    scr.addstr(y, 0, line)
                except curses.error:
                    pass
            scr.refresh()

    try:
        curses.wrapper(loop)
    except KeyboardInterrupt:
        model._quit()
    controls.quit = True
    pipe.join(timeout=5)
    return 0
