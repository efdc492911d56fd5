"""The Session's upload of raw blocks (``runtime/executor.py::Session``,
``io/convert_device.py``).

On the CPU a raw Session frames into unpinned tensor blocks and converts
with the plain torch chain (``s16_to_cf_ref``): no kernel launch, no
``session.h2d_pinned``. Tests marked ``card`` hold the card's path: the
conversion kernel (``ops/csrc/s16_convert.cu``) equal to the plain chain
bit for bit over random and extreme values, every correction the plain
chain takes, stereo and mono, ragged and unaligned lengths; a card
Session, which frames into pinned memory (``TensorRawFramer``), uploads
from there and converts with one launch a block, publishing the CPU
path's raw bytes and converting each block as the plain chain does while
its listener keeps no block and the card lags behind the host; and
``RecorderStage`` writing the CPU path's file. They skip without a card:
``python -m pytest --noconftest -m card tests/test_torch_h2d.py`` (this
file imports no JAX)."""

import numpy as np
import pytest
import torch

from jsdr_tpu_torch.io.convert_device import (TensorRawFramer, s16_to_cf,
                                              s16_to_cf_ref)
from jsdr_tpu_torch.runtime.executor import RecorderStage, Session, Stage

BLOCK = 9600
EXTREMES = np.array([-32768, -1, 0, 32767], np.int16)


def _data(n_values: int, seed: int = 24) -> np.ndarray:
    """Random int16 with every extreme value in it."""
    d = np.random.default_rng(seed).integers(-32768, 32768, n_values,
                                             dtype=np.int16)
    ext = np.tile(EXTREMES, 4)[:n_values]
    d[:len(ext)] = ext
    return d


def _chunks(data: np.ndarray, seed: int = 7):
    """``data`` in ragged chunks of whole samples (stereo)."""
    rng = np.random.default_rng(seed)
    at = 0
    while at < len(data):
        n = 2 * int(rng.integers(1, 2 * BLOCK))
        yield data[at:at + n]
        at += n


class _Keep(Stage):
    """Keeps each block's CF as the stage got it, after a sleep kernel
    that keeps the card behind the host."""

    name = "keep"

    def __init__(self, sleep_cycles: int = 0):
        self.got, self.sleep = [], sleep_cycles

    def process(self, block, session):
        if self.sleep:
            torch.cuda._sleep(self.sleep)
        self.got.append(block)


def _raw_session(data, device, stages, **kw):
    """Run a raw Session over ``data``; returns it and the raw blocks'
    bytes as published (the listener keeps no block)."""
    s = Session(source=_chunks(data), block_samples=BLOCK, device=device,
                **kw)
    raw = []
    s.pubsub.listen(lambda t, v: raw.append(v.tobytes())
                    if t == "raw-block" else None)
    s.run(stages)
    return s, raw


def test_a_cpu_session_converts_with_the_plain_chain():
    data = _data(2 * 6 * BLOCK + 500)
    launches = s16_to_cf.launches
    keep = _Keep()
    s, raw = _raw_session(data, "cpu", [keep], i_corr=3, q_corr=-5)
    assert len(raw) == len(keep.got) == 6
    assert s16_to_cf.launches == launches
    assert "session.h2d_pinned" not in s.tracer.counters
    for b, cf in enumerate(keep.got):
        blk = data[2 * b * BLOCK:2 * (b + 1) * BLOCK]
        assert raw[b] == blk.tobytes()
        want = s16_to_cf_ref(torch.from_numpy(blk), 3, -5)
        assert torch.equal(cf.re, want.re) and torch.equal(cf.im, want.im)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from jsdr_tpu_torch.runtime.device import require_device
    return require_device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("n", [96000, 4099, 3, 0])
@pytest.mark.parametrize("corr", [(0, 0), (3, -5), (2000, -40000),
                                  (65536 + 7, -65536 + 7)])
def test_the_kernel_equals_the_plain_chain(card, corr, n, channels):
    data = torch.from_numpy(_data(channels * n))
    launches = s16_to_cf.launches
    want = s16_to_cf_ref(data, *corr, channels)
    aligned = data.to(card)
    # a view one int16 in: the input is not aligned for a vector load
    shifted = torch.cat([data[:1], data]).to(card)[1:]
    for x in (aligned, shifted):
        got = s16_to_cf(x, *corr, channels)
        assert got.re.device.type == "cuda" and got.re.shape == (n,)
        assert torch.equal(got.re.cpu(), want.re)
        assert torch.equal(got.im.cpu(), want.im)
    assert s16_to_cf.launches == launches + 2 * (n > 0)


@pytest.mark.card
def test_the_kernel_refuses_what_it_cannot_take(card):
    with pytest.raises(ValueError, match="int16"):
        s16_to_cf(torch.zeros(8, dtype=torch.int32, device=card), 0, 0)
    with pytest.raises(ValueError, match="whole"):
        s16_to_cf(torch.zeros(7, dtype=torch.int16, device=card), 0, 0)


@pytest.mark.card
def test_a_card_session_frames_into_pinned_memory(card):
    """64 blocks, each converted after a sleep kernel of the block
    before: the host frames and uploads ahead of the card, and the
    listener drops every block at once, so a pinned block handed out
    again before its copy ran would change what the card converts."""
    data = _data(2 * 64 * BLOCK + 300)
    launches = s16_to_cf.launches
    keep = _Keep(sleep_cycles=2_000_000)
    s, raw = _raw_session(data, card, [keep], i_corr=2000, q_corr=-40000)
    cpu, cpu_raw = _raw_session(data, "cpu", [_Keep()], i_corr=2000,
                                q_corr=-40000)
    torch.cuda.synchronize()
    assert len(raw) == len(keep.got) == 64
    assert raw == cpu_raw
    assert s.tracer.counters["session.h2d_pinned"] == 64
    assert s16_to_cf.launches == launches + 64
    assert s.tracer.counters["session.framer_bytes"] == (
        cpu.tracer.counters["session.framer_bytes"])
    for b, cf in enumerate(keep.got):
        blk = data[2 * b * BLOCK:2 * (b + 1) * BLOCK]
        want = s16_to_cf_ref(torch.from_numpy(blk), 2000, -40000)
        assert torch.equal(cf.re.cpu(), want.re), b
        assert torch.equal(cf.im.cpu(), want.im), b


@pytest.mark.card
def test_the_pinned_framer_yields_views_of_pinned_tensors(card):
    framer = TensorRawFramer(BLOCK, device=card)
    data = _data(2 * 3 * BLOCK)
    blocks = []
    for chunk in _chunks(data):
        for block in framer.push(chunk):
            assert framer.tensor.is_pinned()
            assert block.ctypes.data == framer.tensor.data_ptr()
            blocks.append(block)
    assert b"".join(b.tobytes() for b in blocks) == data.tobytes()


@pytest.mark.card
def test_the_recorder_writes_the_cpu_paths_file(card, tmp_path):
    data = _data(2 * 5 * BLOCK)
    for dev in ("cpu", card):
        rec = RecorderStage(tmp_path / f"{torch.device(dev).type}.raw")
        _raw_session(data, dev, [rec], i_corr=3, q_corr=-5)
        rec.close()
    assert (tmp_path / "cuda.raw").read_bytes() == (
        tmp_path / "cpu.raw").read_bytes() == data.tobytes()
