"""A whole run of each cell on the CPU at a small size (a window of 8
blocks counted rather than timed, the check following the first 2 drain
groups from the start and the other 2 from the program's state; the look
for a card is skipped, the port runs its kernels' plain versions): the
program comes out correct, with every frame sent on a tab's tuning
published; the control (the reference in bfloat16 in its place) does
not; nor does a run with the timed path broken underneath, once for each
fault a cell can have: the telemetry step returns its state unchanged,
half the tabs are left out, a decoded payload is altered where it is
produced. (One card holds a cell: no exchange between cards to leave
out.) A test marked ``card`` runs the control at the cells' own size on
the card."""

import time

import pytest
import torch

from portbench import harness
from portbench.cells import load_cell
from conftest import PARKED, parked_benchmark

SMALL = sorted(["fcd1-96k-tabs2.quiet", *PARKED])
SEED = 2**31 + 1234


def cell_of(name, tmp_path):
    return load_cell(name, parked_benchmark(tmp_path / "bench.json"))


def small_run(cell, tmp_path, control=False, fault=None, seed=SEED,
              device="cpu", seconds=0, max_blocks=8):
    c = cell_of(cell, tmp_path)
    if device == "cpu":
        c.config["check_start_groups"] = 2
    return harness.run(c, seed, seconds, False, device, time.perf_counter(),
                       control=control, max_blocks=max_blocks, fault=fault)


def numbers(res):
    return {name: value for name, value, _ in res["check"]}


@pytest.mark.parametrize("cell", SMALL)
def test_program_is_correct(cell, tmp_path):
    res = small_run(cell, tmp_path)
    assert res["correct"], res["check"]
    assert res["attempted"] == 8 and res["failed"] == 0
    assert numbers(res)["groups_checked"] == 4
    m = res["metrics"]
    assert {"stream_msps", "setup_s"} <= set(m)
    assert all(v["value"] > 0 for v in m.values())


@pytest.mark.parametrize("cell", SMALL)
def test_control_is_not_correct(cell, tmp_path):
    res = small_run(cell, tmp_path, control=True)
    assert not res["correct"], res["check"]


def _state_unchanged(stages):
    st = next(s for s in stages if hasattr(s, "_drain"))
    process = st.process

    def frozen(block, session):
        before = st.state
        process(block, session)
        st.state = before

    st.process = frozen


def _half(a, b, h):
    if isinstance(a, tuple):
        return type(a)(*(_half(x, y, h) for x, y in zip(a, b)))
    return torch.cat([a[:h], b[h:]])


@pytest.fixture
def half_the_tabs(monkeypatch):
    """Every step leaves out the second half of the tabs: their hits are
    dropped and their state does not move."""
    import jsdr_tpu_torch.demod.bpsk as B

    def wrap(real, with_spec):
        def step(iq, cfg, states, *a, **kw):
            res = real(iq, cfg, states, *a, **kw)
            out, new = res[-2:]
            h = iq.shape[0] // 2
            out = out._replace(n_hits=torch.cat(
                [out.n_hits[:h], torch.zeros_like(out.n_hits[h:])]))
            new = _half(new, states, h)
            return (res[0], out, new) if with_spec else (out, new)
        return step

    monkeypatch.setattr(B, "bpsk_block_batch",
                        wrap(B.bpsk_block_batch, False))
    monkeypatch.setattr(B, "bpsk_block_batch_spectrum",
                        wrap(B.bpsk_block_batch_spectrum, True))


@pytest.fixture
def altered_payload(monkeypatch):
    """The drain's decoder flips a byte of every good payload."""
    import jsdr_tpu_torch.fec.decoder as D
    real = D.fec_decode

    def decode(raw):
        res = real(raw)
        pay = res.payload.clone()
        pay[:, 0] ^= torch.where(res.ok, 1, 0).to(pay.dtype)
        return res._replace(payload=pay)

    monkeypatch.setattr(D, "fec_decode", decode)


FRAMES = [c for c in SMALL if c.endswith(".frames")]


@pytest.mark.parametrize("cell", SMALL)
def test_state_unchanged_is_not_correct(cell, tmp_path):
    assert not small_run(cell, tmp_path, fault=_state_unchanged)["correct"]


@pytest.mark.parametrize("cell", SMALL)
def test_half_the_tabs_is_not_correct(cell, tmp_path, half_the_tabs):
    assert not small_run(cell, tmp_path)["correct"]


@pytest.mark.parametrize("cell", FRAMES)
def test_altered_payload_is_not_correct(cell, tmp_path, altered_payload):
    res = small_run(cell, tmp_path)
    assert not res["correct"] and numbers(res)["frames_diff"] > 0
    assert numbers(res)["frames_missed"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", FRAMES)
def test_control_at_full_size_on_the_card(cell, tmp_path):
    """The control on the card at the cell's own size, a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (11, 12, 13):
        res = small_run(cell, tmp_path, control=True, seed=2**31 + seed,
                        device="cuda", seconds=3, max_blocks=None)
        assert not res["correct"], res["check"]


def test_frames_missed_counts_each_sent_frame():
    """Every occurrence of a sent frame whose last sample falls in the
    window before the last drain's block is due, from the tab tuned to its
    carrier; a frame missing, altered or not good counts, and a frame
    published more than due does not."""
    from portbench.checklib import frames_missed
    from portbench.gen.synth import make_capture

    rate, tunings = 96000, [12000.0, 24000.0]
    cap = make_capture(rate, [6000, 12000, 24000], 0.2, 0.02, 3, SEED,
                       "cpu")
    first, last = 8, 47
    due = []
    for pay, carrier, end in zip(cap.payloads, cap.carrier,
                                 cap.last_sample):
        for j in range(8):
            if first * rate <= end + j * cap.n_samples < last * rate:
                due += [(t, True, pay.tobytes()) for t, f in
                        enumerate(tunings) if f == carrier]
    assert len(due) > 10

    def missed(frames):
        drains = [harness.Drain(first - 1, 0.0, [0.0], [due[0]]),
                  harness.Drain(last, 0.0, [0.0] * len(frames), frames)]
        return frames_missed(drains, cap, tunings, rate, first)

    assert missed(due) == 0
    assert missed(due + due[:3]) == 0
    assert missed(due[1:]) == 1
    assert missed(due[1:] + [(due[0][0], False, due[0][2])]) == 1
    altered = bytes([due[0][2][0] ^ 1]) + due[0][2][1:]
    assert missed(due[1:] + [(due[0][0], True, altered)]) == 2
    assert missed([(1 - t, ok, p) for t, ok, p in due]) == len(due)
