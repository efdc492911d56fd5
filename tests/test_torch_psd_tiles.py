"""Kernel 5's walk (``csrc/psd_waterfall.cu``), rehearsed on the CPU
through its plain mirror ``ops/psd_waterfall.py::_psd_waterfall_tiles``:
tiles of G whole groups of a row, the dB of their bins kept as the tile,
each group's maximum taken from the tile and written at its rolled place
in the line, ragged last tiles, and groups larger than a slab walked by
threads with a running maximum. It must equal ``psd_waterfall_ref`` bit
for bit on db and the line, for the G the kernel's rule picks and for
forced G, and the rule must keep every tile within a slab and fill the
card at the Session's 10 rows. chip_smoke.py phase 9 holds the CUDA
kernel against the plain version on the card."""

import numpy as np
import pytest
import torch

from jsdr_tpu_torch.ops.cplx import CF
from jsdr_tpu_torch.ops.psd_waterfall import (CTAS_PER_SM, H100_SMS, SLAB,
                                              _psd_waterfall_tiles,
                                              psd_waterfall_ref, tile_groups)

SHAPES = [(n, w) for n in (1920, 9600, 19200) for w in (1, 75, 960, n)
          if n % w == 0]


def _spec(seed, b, n):
    """Noise with a strong bin a row and some bins far below the floor
    (intensity clipped to 0), as chip_smoke.py phase 9 makes them."""
    rng = np.random.default_rng(seed)
    re = (40 * rng.standard_normal((b, n))).astype(np.float32)
    im = (40 * rng.standard_normal((b, n))).astype(np.float32)
    re[:, n // 7] = 3e4
    re[:, 5::97] *= 1e-7
    im[:, 5::97] *= 1e-7
    return CF(torch.from_numpy(re), torch.from_numpy(im))


@pytest.mark.parametrize("n,width", SHAPES)
@pytest.mark.parametrize("g", [None, 1, 3, 7, "width"])
def test_tiles_equal_plain(n, width, g):
    spec = _spec(n + width, 3, n)
    got = _psd_waterfall_tiles(spec, width, width if g == "width" else g)
    want = psd_waterfall_ref(spec, width)
    assert got[1].dtype == torch.uint8 and got[1].shape == (3, width)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# rows whose starts are not 16-byte aligned (n % 4 != 0), an odd step, and
# groups larger than a slab there
@pytest.mark.parametrize("width", [70, 5, 1])
def test_tiles_equal_plain_unaligned_rows(width):
    spec = _spec(width, 3, 9590)
    got = _psd_waterfall_tiles(spec, width)
    want = psd_waterfall_ref(spec, width)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,width", SHAPES + [(9600, 3), (9590, 70)])
@pytest.mark.parametrize("rows", [1, 10, 1280])
def test_tile_rule(n, width, rows):
    """The G the kernel takes: at most width; a tile of more than one
    group stays within a slab (its dB fits the CTA's shared memory); where
    the rows' starts are aligned and the slab allows, a tile spans a
    multiple of 4 bins; and one wave's worth of CTAs where width allows."""
    g = tile_groups(n, width, rows)
    step = n // width
    tiles = -(-width // g)
    assert 1 <= g <= width
    assert g == 1 or g * step <= SLAB
    if n % 4 == 0 and (4 * step <= SLAB or step % 4 == 0) and g < width:
        assert (g * step) % 4 == 0
    assert rows * tiles >= min(CTAS_PER_SM * H100_SMS, rows * width) // 2


def test_tile_rule_at_the_sessions_shapes():
    """10 rows of 9,600 bins (width 960, step 10) give a few hundred CTAs
    of 20 groups, and 1280 rows give tiles of a few KB (192 groups, 7.5 KB
    of dB)."""
    assert tile_groups(9600, 960, 10) == 20
    assert 10 * (960 // 20) == 480
    assert tile_groups(9600, 960, 1280) == 192
    assert tile_groups(19200, 960, 10) == 19
