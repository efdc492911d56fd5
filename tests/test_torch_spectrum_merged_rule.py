"""The two rules of :func:`jsdr_tpu_torch.demod.bpsk.spectrum_step_merged`,
which choose between the merged kernel 3 and the staged pair (kernel 4,
then the front end) for the spectrum-telemetry step.

Without a device or on the CPU it is the reference's rule: T a multiple
of the TPU kernel's chunk (4 FFT blocks at 96 kS/s, 2 at 192 kS/s), so
the CPU parity tests compare the same branches in both packages. On a
CUDA device it is the card's rule: T a multiple of one FFT block
(n = rate/10), since the CUDA kernel takes one FFT block a CTA. Both
refuse non-pattern tunings, dofft and fuse_mf. ``SpectrumTelemetryStage``
decides its counters with the rule of its own device, and counts
``spectrum_telemetry.merged_card`` where only the card's rule merges. On
the CPU the merged branch (its kernels' plain versions) at one FFT block
a row equals the staged pair over chained blocks. No JAX here: the truth
tables restate the reference's rule (jsdr_tpu/demod/bpsk.py)."""

import numpy as np
import pytest
import torch

from jsdr_tpu_torch.demod import bpsk as B
from jsdr_tpu_torch.io.sources import synth_bpsk_stream, synth_noise
from jsdr_tpu_torch.ops.cplx import from_complex
from jsdr_tpu_torch.ops.spectrum_fused import spectrum_waterfall
from jsdr_tpu_torch.runtime.executor import SpectrumTelemetryStage

TABS = {96000: (12000.0, 24000.0), 192000: (12000.0, 25500.0)}
OFF_GRID = {96000: (12730.0, 24730.0), 192000: (12730.0, 26230.0)}

# (rate, block samples): (reference's rule, card's rule) on pattern tabs
RULES = {
    (96000, 9600): (False, True),        # 0.1 s
    (96000, 96000): (False, True),       # 1 s: 2.5 chunks of 38,400
    (96000, 460800): (True, True),       # 4.8 s
    (192000, 19200): (False, True),      # 0.1 s: java-sdr's own blocks
    (192000, 192000): (True, True),      # 1 s: 5 chunks of 38,400
    (192000, 921600): (True, True),      # 4.8 s
}


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
@pytest.mark.parametrize("rate,block", list(RULES))
def test_off_a_card_the_rule_is_the_references(rate, block, device):
    cfg = B.BpskConfig(rate=rate)
    assert B.spectrum_step_merged(cfg, block, TABS[rate], device) == (
        RULES[rate, block][0])


@pytest.mark.parametrize("device", ["cuda", torch.device("cuda", 0)])
@pytest.mark.parametrize("rate,block", list(RULES))
def test_on_a_card_one_fft_block_is_enough(rate, block, device):
    """The card's rule admits 19,200 samples at 192 kS/s and 96,000 at
    96 kS/s, and every block the reference's rule admits. A device is a
    name here: no card is needed to ask the rule."""
    cfg = B.BpskConfig(rate=rate)
    assert B.spectrum_step_merged(cfg, block, TABS[rate], device) == (
        RULES[rate, block][1])


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
@pytest.mark.parametrize("rate", [96000, 192000])
def test_both_rules_refuse_what_kernel_3_cannot_run(rate, device):
    """General tunings, dofft, fuse_mf, and T not a multiple of n (here
    one FFT block and 8 decimation groups more or less)."""
    n = rate // 10
    cfg = B.BpskConfig(rate=rate)
    assert B.spectrum_step_merged(cfg, 48 * n, TABS[rate], device)
    assert not B.spectrum_step_merged(cfg, 48 * n, OFF_GRID[rate], device)
    for flags in ({"dofft": True}, {"fuse_mf": True}):
        assert not B.spectrum_step_merged(B.BpskConfig(rate=rate, **flags),
                                          48 * n, TABS[rate], device)
    for t_len in (n + 8 * cfg.decim, n - 8 * cfg.decim, 48 * n // 7):
        assert not B.spectrum_step_merged(cfg, t_len, TABS[rate], device)


@pytest.mark.parametrize("device,block,counted", [
    ("cpu", 19200, ("spectrum_telemetry.staged",)),
    ("cuda", 19200, ("spectrum_telemetry.merged",
                     "spectrum_telemetry.merged_card")),
    ("cuda", 921600, ("spectrum_telemetry.merged",)),
    ("cuda", 960000, ("spectrum_telemetry.merged",)),
    ("cuda", 18 * 19200 + 9600, ("spectrum_telemetry.staged",))])
def test_the_stage_decides_with_its_own_device(device, block, counted):
    """At 0.1 s blocks at 192 kS/s the stage on the CPU counts the staged
    branch, and on a card the merged one with ``merged_card`` beside it;
    on a card a block the reference's rule merges too counts no
    ``merged_card``, and a block of no whole FFT blocks stays staged.
    (The stage is built on the CPU; its device is then set, as a card's
    stage has it, to ask only the counters' decision.)"""
    stage = SpectrumTelemetryStage(B.BpskConfig(rate=192000), TABS[192000],
                                   device="cpu")
    stage.device = torch.device(device)
    assert stage._step_counters(block) == ("telemetry.front.pattern",
                                           *counted)


def _station(n_blocks: int, n: int, rate: int) -> np.ndarray:
    sig = synth_noise(n_blocks * n, amplitude=0.05, seed=25)
    for i, carrier in enumerate(TABS[rate]):
        tab = synth_bpsk_stream(np.full((1, 256), 0x5A + i, np.uint8),
                                rate=rate, carrier_offset=carrier,
                                amplitude=0.3, preamble_bits=40 + 60 * i,
                                seed=i)[:len(sig)]
        sig[:len(tab)] += tab
    return sig


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return all(_same(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("rate", [96000, 192000])
def test_merged_branch_at_one_fft_block_a_row_equals_the_staged_pair(
        rate, monkeypatch):
    """12 chained 0.1 s blocks of two tabs (T = n: one FFT block a row)
    through the merged branch, which the card's rule takes, and through
    the staged pair, each carrying its own state: every block's waterfall,
    outputs and state equal bit for bit. On the CPU the merged branch runs
    kernel 3's plain version; the rule is pointed at a card so that the
    step takes it."""
    rule = B.spectrum_step_merged
    monkeypatch.setattr(B, "spectrum_step_merged",
                        lambda cfg, t, tun, device=None: rule(cfg, t, tun,
                                                              "cuda"))
    n, n_blocks = rate // 10, 12
    cfg = B.BpskConfig(rate=rate)
    tun = np.asarray(TABS[rate])
    sig = _station(n_blocks, n, rate)
    calls = []
    fused = B.spectrum_front_fused
    monkeypatch.setattr(B, "spectrum_front_fused",
                        lambda *a, **kw: calls.append(1) or fused(*a, **kw))
    st_m = st_s = B.bpsk_init_batch(cfg, 2, "cpu")
    for b in range(n_blocks):
        x = from_complex(np.broadcast_to(sig[b * n:(b + 1) * n], (2, n)),
                         "cpu")
        spec, out_m, st_m = B.bpsk_block_batch_spectrum(x, cfg, st_m, tun)
        wf, mx, idx = spectrum_waterfall(x, n)
        out_s, st_s = B.bpsk_block_batch(x, cfg, st_s, tun)
        assert tuple(spec.wf.shape) == (1, 2, 15, 128)
        assert _same(spec, B._waterfall_out(wf, mx, idx, rate)), b
        assert _same(out_m, out_s), b
        assert _same(st_m, st_s), b
    assert len(calls) == n_blocks
    assert int(st_m.counters[0, 0]) == n_blocks * n
