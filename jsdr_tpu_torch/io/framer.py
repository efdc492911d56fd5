"""Block framing: slice a sample stream into fixed TPU-friendly blocks.

The reference frames at 10 blocks/s (JavaAudio.java:58-59) because Swing
needs display cadence; the TPU framework frames at whatever block size
amortizes dispatch best (typically >= 1 s of samples) — block size is a
throughput knob, not a latency contract. A compat helper gives the
0.1 s cadence for display-parity tests.

The port of :mod:`jsdr_tpu.io.framer` (it imports no jax): the same
classes, calls and outputs, byte for byte (tests/test_torch_host_copies.py
and tests/test_torch_framer_fill.py hold them to the reference's), with
another buffering. The reference appends every chunk to what it holds, so
a block of c chunks copies c(c+1)/2 chunks' bytes, each time into a new
array; here a framer fills one block array of the block's size in place
and copies each sample once. A yielded block is the caller's: the framer
starts a new array for the next block and never writes into it again.
``copied_bytes`` counts the bytes the framer has copied.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class _BlockFill:
    """A block array of ``block`` values of ``dtype`` and its fill index."""

    dtype: np.dtype

    def __init__(self, block: int):
        self.block = block
        self._blk: Optional[np.ndarray] = None    # the block being filled
        self._fill = 0
        self.copied_bytes = 0

    def _new_block(self) -> np.ndarray:
        """A new block array of ``block`` values of ``dtype``; a subclass
        may draw it from another allocator (the Session's raw framer,
        :class:`jsdr_tpu_torch.io.convert_device.TensorRawFramer`)."""
        return np.empty(self.block, self.dtype)

    def _push(self, chunk: np.ndarray) -> Iterator[np.ndarray]:
        """Copy ``chunk`` into the block array; yield it each time it is
        full. A chunk may end inside a block, complete it, or span
        several."""
        pos = 0
        while pos < len(chunk):
            if self._blk is None:
                self._blk = self._new_block()
            take = min(self.block - self._fill, len(chunk) - pos)
            self._blk[self._fill:self._fill + take] = chunk[pos:pos + take]
            self._fill += take
            pos += take
            self.copied_bytes += take * self._blk.itemsize
            if self._fill == self.block:
                out, self._blk, self._fill = self._blk, None, 0
                yield out

    def flush(self, pad: bool = False) -> Optional[np.ndarray]:
        """Remaining samples, zero-padded to a full block if ``pad``."""
        if not self._fill:
            return None
        out, fill = self._blk, self._fill
        self._blk, self._fill = None, 0
        if pad:
            out[fill:] = 0
            return out
        return out[:fill]


class BlockFramer(_BlockFill):
    """Accumulate arbitrary-size chunks, emit fixed-size blocks."""

    dtype = np.dtype(np.complex64)

    def __init__(self, block_samples: int):
        super().__init__(block_samples)

    def push(self, chunk: np.ndarray) -> Iterator[np.ndarray]:
        return self._push(np.asarray(chunk))


class RawBlockFramer(_BlockFill):
    """Frame a raw interleaved-int16 stream into fixed-size blocks.

    The raw-mode analog of :class:`BlockFramer`: blocks keep the exact
    capture values so pre-conversion taps (recorder.java:66-74) see the
    device bytes verbatim, and conversion can happen on the TPU
    (io.convert_device.s16_to_cf)."""

    dtype = np.dtype(np.int16)

    def __init__(self, block_samples: int, channels: int = 2):
        super().__init__(block_samples * channels)   # int16 values per block

    def push(self, chunk: np.ndarray) -> Iterator[np.ndarray]:
        chunk = np.asarray(chunk)
        assert chunk.dtype == np.int16, "raw framer wants int16 chunks"
        return self._push(chunk)


def compat_block_len(rate: int) -> int:
    """The reference's block size in samples: rate/10 (JavaAudio.java:58)."""
    return rate // 10
