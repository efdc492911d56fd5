"""The reference's frozen copies hold to the program's own oracles: the
AO-40 tables equal the port's, the batched codec encodes and decodes as
the port's numpy oracle (``fec/ref_numpy.py``) does frame by frame, and
the reference chain gives the port's CPU step's hits and counters."""

import numpy as np
import pytest
import torch

from jsdr_tpu_torch.fec import ref_numpy, tables
from portbench.gen.synth import make_capture
from portbench.reference import ao40, ao40_tables, demod

RNG = np.random.default_rng(2**31 + 99)


@pytest.mark.parametrize("name", [k for k in dir(tables) if k.isupper()])
def test_tables_equal_the_ports(name):
    assert np.array_equal(np.asarray(getattr(ao40_tables, name)),
                          np.asarray(getattr(tables, name)))


def test_encode_batch_equals_the_oracle():
    pay = RNG.integers(0, 256, (4, 256), dtype=np.uint8)
    got = ao40.encode_batch(pay)
    for i in range(4):
        assert np.array_equal(got[i], ref_numpy.encode_fec40(pay[i]))


def test_decode_batch_equals_the_oracle():
    pay = RNG.integers(0, 256, (4, 256), dtype=np.uint8)
    soft = np.where(ao40.encode_batch(pay) > 0, 0xC0, 0x40).astype(np.uint8)
    soft[1, RNG.choice(5200, 60, replace=False)] ^= 0x80     # correctable
    soft[2] = RNG.integers(0, 256, 5200)                     # undecodable
    payload, ok, rc = ao40.decode_batch(soft)
    for i in range(4):
        want, want_rc = ref_numpy.fec_decode(soft[i])
        assert np.array_equal(payload[i], want) and rc[i] == want_rc
        assert ok[i] == (want_rc >= 0)
    assert list(ok) == [True, True, False, True] and rc[1] == 60


@pytest.mark.parametrize("rate, tunings, fuse", [
    (96000, [6000.0, 6750.0, 12000.0, 14250.0], True),
    (192000, [12000.0, 13500.0, 24000.0], False)])
def test_reference_chain_equals_the_ports_cpu_step(rate, tunings, fuse):
    """Four 1 s blocks of the frames traffic: the port's step on the CPU
    (its kernels' plain versions) and the reference in float64 give the
    same hits, windows and counters."""
    from jsdr_tpu_torch.demod.bpsk import (BpskConfig, bpsk_block_batch,
                                           bpsk_init_batch)
    from jsdr_tpu_torch.io.convert_device import s16_to_cf

    carriers = [6000, 12000] if rate == 96000 else [12000]
    cap = make_capture(rate, carriers, 0.2, 0.02, 3, 2**31 + 7, "cpu")
    cfg = BpskConfig(rate=rate, fuse_mf=fuse)
    st = bpsk_init_batch(cfg, len(tunings), "cpu")
    ref = demod.Demod(rate, tunings, 4, "cpu")
    rst = demod.fresh_state(len(tunings), "cpu")
    flat = cap.raw.reshape(-1)
    for b in range(4):
        raw = flat[2 * b * rate:2 * (b + 1) * rate]
        iq = s16_to_cf(torch.from_numpy(raw.copy()), 0, 0)
        rows = type(iq)(iq.re.expand(len(tunings), -1),
                        iq.im.expand(len(tunings), -1))
        out, st = bpsk_block_batch(rows, cfg, st, tunings)
        hits, rst = ref.block(raw, rst)
        assert hits["tab"] == [t for t in range(len(tunings))
                               for _ in range(int(out.n_hits[t]))]
        assert hits["corr"] == [int(c) for t in range(len(tunings))
                                for c in out.hit_corr[t, :out.n_hits[t]]]
        for w, (t, k) in zip(hits["windows"],
                             [(t, k) for t in range(len(tunings))
                              for k in range(int(out.n_hits[t]))]):
            assert np.array_equal(w, out.windows[t, k].numpy())
        assert np.array_equal(rst["counters"].numpy(),
                              st.counters.numpy().astype(np.int64))
        assert torch.equal(rst["ring"], st.ring)


def test_counts_wrap_as_int32():
    """A long window passes 2**31 raw samples: the counters wrap as the
    program's int32 (and Java's int) do, and the check follows them."""
    from portbench.checklib import skipped_state_diff

    rate, block, first = 192000, 921600, 2400           # 2.2e9 samples
    tun = [12000.0, 13500.0]
    raw_n = first * block
    assert raw_n > 2**31
    tu = np.array([120000, 135000])
    snap = {"counters": torch.tensor([[demod.wrap32(raw_n),
                                       raw_n // 20, 0, 0]] * 2,
                                     dtype=torch.int32),
            "tu_phase": torch.tensor((raw_n % 1920000) * tu % 1920000,
                                     dtype=torch.float32),
            "vco_idx": torch.full((2,), (raw_n // 20) % 8, dtype=torch.int32)}
    assert skipped_state_diff(snap, first, block, rate, tun) == 0
    snap["counters"][:, 0] += 1
    assert skipped_state_diff(snap, first, block, rate, tun) == 2
