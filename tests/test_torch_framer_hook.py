"""The framers' one hook for making a block array (``_BlockFill.
_new_block``, ``jsdr_tpu_torch/io/framer.py``), which a card's Session
uses to frame raw blocks into torch tensors, pinned memory on a card
(``io/convert_device.py::TensorRawFramer``; its card tests are in
``tests/test_torch_h2d.py``).

Here the hook draws each block from a plain numpy arena outside the
framer, filled with a marker value: over the cut patterns of
``tests/test_torch_framer_fill.py`` the framer yields and flushes the
bytes ``RawBlockFramer`` yields, every block is the allocator's, and a
block the caller keeps is never written again. The Session's own framer
does the same on the CPU, each block a view of its own unpinned
tensor."""

import numpy as np
import pytest

import jsdr_tpu_torch.io.framer as t_framer
from jsdr_tpu_torch.io.convert_device import TensorRawFramer
from test_torch_framer_fill import BLOCK, CUTS, _random_cuts, _stream

MARK = 0x5A5A


class _ArenaFramer(t_framer.RawBlockFramer):
    """Blocks are consecutive slices of one marked arena."""

    def __init__(self, block_samples: int, n_blocks: int):
        super().__init__(block_samples)
        self.arena = np.full(n_blocks * self.block, MARK, self.dtype)
        self.drawn = 0

    def _new_block(self) -> np.ndarray:
        at = self.drawn * self.block
        self.drawn += 1
        return self.arena[at:at + self.block]


def _cuts(name: str) -> list[int]:
    return (_random_cuts(int(name[-1])) if name.startswith("random")
            else CUTS[name])


@pytest.mark.parametrize("pad", [None, False, True])
@pytest.mark.parametrize("cuts", list(CUTS) + ["random0", "random1"])
def test_a_hooked_framer_yields_the_raw_framers_bytes(cuts, pad):
    cuts = _cuts(cuts)
    data = _stream("raw", sum(cuts))
    plain = t_framer.RawBlockFramer(BLOCK)
    hooked = _ArenaFramer(BLOCK, sum(cuts) // BLOCK + 1)
    kept, copies, at = [], [], 0
    for c in cuts:
        chunk = data[2 * at:2 * (at + c)]
        want = [b.tobytes() for b in plain.push(chunk)]
        got = list(hooked.push(chunk))
        assert [b.tobytes() for b in got] == want
        kept += got
        copies += [b.copy() for b in got]
        at += c
    if pad is not None:
        want, tail = plain.flush(pad=pad), hooked.flush(pad=pad)
        assert (tail is None) == (want is None)
        if tail is not None:
            assert tail.tobytes() == want.tobytes()
            kept.append(tail)
            copies.append(tail.copy())
        assert hooked.flush(pad=pad) is None
    assert hooked.copied_bytes == plain.copied_bytes
    assert hooked.drawn == len(kept) + (pad is None and hooked._fill > 0)
    for block, copy in zip(kept, copies):
        assert np.shares_memory(block, hooked.arena)
        assert block.tobytes() == copy.tobytes()


@pytest.mark.parametrize("cuts", list(CUTS) + ["random0", "random1"])
def test_the_sessions_framer_on_the_cpu_yields_the_raw_framers_bytes(cuts):
    cuts = _cuts(cuts)
    data = _stream("raw", sum(cuts))
    plain = t_framer.RawBlockFramer(BLOCK)
    framer = TensorRawFramer(BLOCK)
    kept, copies, tensors, at = [], [], [], 0
    for c in cuts:
        chunk = data[2 * at:2 * (at + c)]
        want = [b.tobytes() for b in plain.push(chunk)]
        got = []
        for block in framer.push(chunk):
            assert not framer.pin and not framer.tensor.is_pinned()
            assert block.ctypes.data == framer.tensor.data_ptr()
            got.append(block)
            tensors.append(framer.tensor)
        assert [b.tobytes() for b in got] == want
        kept += got
        copies += [b.copy() for b in got]
        at += c
    assert framer.copied_bytes == plain.copied_bytes
    assert len({t.data_ptr() for t in tensors}) == len(tensors)
    for block, copy in zip(kept, copies):
        assert block.tobytes() == copy.tobytes()
