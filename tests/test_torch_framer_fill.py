"""The port's framers (``jsdr_tpu_torch/io/framer.py``) fill one block
array in place and copy each sample once; their outputs stay those of the
JAX package's framers, which append every chunk to what they hold.

On ragged cuts (chunks smaller than a block, exactly a block, straddling
two, several blocks in one chunk, a last partial block flushed with and
without padding) both port framers yield and flush byte-equal to
``jsdr_tpu.io.framer``; a yielded block the caller keeps is not written
by later pushes or a flush; ``copied_bytes`` counts the bytes pushed."""

import numpy as np
import pytest

import jsdr_tpu.io.framer as j_framer
import jsdr_tpu_torch.io.framer as t_framer

BLOCK = 960

# chunk lengths in samples; each list is one stream's cuts
CUTS = {
    "smaller": [100, 250, 300, 200, 110],
    "exact": [BLOCK, BLOCK, BLOCK],
    "straddling": [700, 700, 700, 700],
    "several_in_one": [3 * BLOCK + 17, 5, 2 * BLOCK - 22],
    "mixed": [1, BLOCK - 1, 2 * BLOCK + 1, BLOCK, 0, 4, BLOCK - 5, 333],
    "exact_end": [480, 480, 2 * BLOCK],
}


def _random_cuts(seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(0, 3 * BLOCK, 12)]


def _stream(kind: str, n: int, seed: int = 19) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "raw":
        return rng.integers(-32768, 32768, 2 * n, dtype=np.int16)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _framer(mod, kind: str):
    return (mod.RawBlockFramer(BLOCK) if kind == "raw"
            else mod.BlockFramer(BLOCK))


def _frame(mod, kind: str, cuts: list[int], pad):
    """Every block pushed out of the stream cut at ``cuts``, then the
    flush (``pad`` None: no flush), as bytes with their dtype."""
    k = 2 if kind == "raw" else 1
    data = _stream(kind, sum(cuts))
    framer = _framer(mod, kind)
    got, at = [], 0
    for c in cuts:
        got += [(x.dtype.str, x.tobytes())
                for x in framer.push(data[k * at:k * (at + c)])]
        at += c
    if pad is not None:
        tail = framer.flush(pad=pad)
        got.append(None if tail is None else (tail.dtype.str,
                                              tail.tobytes()))
        got.append(framer.flush(pad=pad))        # nothing left: None
    return got


@pytest.mark.parametrize("pad", [None, False, True])
@pytest.mark.parametrize("kind", ["complex", "raw"])
@pytest.mark.parametrize("cuts", list(CUTS) + ["random0", "random1"])
def test_blocks_and_flush_equal_the_reference(cuts, kind, pad):
    cuts = (_random_cuts(int(cuts[-1])) if cuts.startswith("random")
            else CUTS[cuts])
    want = _frame(j_framer, kind, cuts, pad)
    got = _frame(t_framer, kind, cuts, pad)
    assert got == want
    assert len(want) >= sum(cuts) // BLOCK


def test_complex_framer_converts_as_the_reference():
    """Chunks of another dtype are converted to complex64 on the way in,
    as the reference's ``astype`` does."""
    rng = np.random.default_rng(3)
    chunks = [rng.standard_normal(700) + 1j * rng.standard_normal(700),
              rng.standard_normal(900).astype(np.float32),
              rng.integers(-5, 5, 400).astype(np.int16)]
    out = []
    for mod in (j_framer, t_framer):
        fr = mod.BlockFramer(BLOCK)
        got = [x.tobytes() for c in chunks for x in fr.push(c)]
        out.append(got + [fr.flush(pad=True).tobytes()])
    assert out[0] == out[1] and len(out[0]) == 3


@pytest.mark.parametrize("kind", ["complex", "raw"])
def test_a_kept_block_is_not_written_again(kind):
    """The caller owns every yielded block (a listener such as
    ``RecorderStage`` may keep it): later pushes and a flush leave it
    as it was."""
    k = 2 if kind == "raw" else 1
    data = _stream(kind, 6 * BLOCK + 100)
    framer = _framer(t_framer, kind)
    kept, copies, at = [], [], 0
    for c in (BLOCK + 300, 50, 2 * BLOCK, BLOCK - 350, 2 * BLOCK + 100):
        for block in framer.push(data[k * at:k * (at + c)]):
            kept.append(block)
            copies.append(block.copy())
        at += c
    tail = framer.flush(pad=True)
    assert len(kept) == 6 and tail is not None
    for i, (block, copy) in enumerate(zip(kept, copies)):
        assert block.tobytes() == copy.tobytes()
        assert block.tobytes() == data[k * i * BLOCK:k * (i + 1)
                                       * BLOCK].tobytes()
    assert len({id(b) for b in kept} | {id(tail)}) == 7
    assert not any(np.shares_memory(a, b) for i, a in enumerate(kept)
                   for b in kept[i + 1:] + [tail])


@pytest.mark.parametrize("kind", ["complex", "raw"])
def test_copied_bytes_equal_the_bytes_pushed(kind):
    k = 2 if kind == "raw" else 1
    cuts = CUTS["mixed"] + _random_cuts(7)
    data = _stream(kind, sum(cuts))
    framer = _framer(t_framer, kind)
    pushed, at = 0, 0
    for c in cuts:
        chunk = data[k * at:k * (at + c)]
        list(framer.push(chunk))
        pushed += chunk.nbytes
        at += c
        assert framer.copied_bytes == pushed
    framer.flush(pad=True)
    assert framer.copied_bytes == data.nbytes


def test_raw_framer_refuses_other_dtypes():
    with pytest.raises(AssertionError, match="int16"):
        list(t_framer.RawBlockFramer(BLOCK).push(np.zeros(10, np.float32)))
