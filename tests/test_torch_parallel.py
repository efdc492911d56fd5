"""The port's sharded telemetry step and tensor-parallel FFT
(``jsdr_tpu_torch/parallel/``) on a CPU mesh of 8 stacked shards: one
counterpart of each test of tests/test_parallel.py (the sharded step must
match the port's single-device chain exactly on carrier streams, carry
state across segments, take per-stream tunings and every front-end mode,
and the TP FFT must match numpy and the port's spectrum), then the port
against the JAX package on the same seeded inputs (the sharded step at
dp=2 x sp=4 on the 8 virtual CPU devices of tests/conftest.py, and
``tp_fft``), and a tuning whose shard offset overflows an int32 product.

Tolerances: bits, hits, ``hit_corr``, windows and FEC payloads are
bit-exact; carried float state within rtol 2e-4, atol 1e-6 (the sharded
EMA and e_out compose in another float order than the single-device
timing kernel's serial sums, as in the reference); TP within n * 2e-6 of
numpy (n * 1e-6 between two meshes), its PSD within 0.15 dB of
``spectrum_block`` with peaks within 1e-3 dB."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from jsdr_tpu_torch.demod.bpsk import (BpskConfig, bpsk_block,
                                       bpsk_block_batch, bpsk_init,
                                       bpsk_init_batch, state_from_numpy,
                                       state_to_numpy)
from jsdr_tpu_torch.fec.decoder import fec_decode
from jsdr_tpu_torch.io.sources import synth_bpsk_stream, synth_noise
from jsdr_tpu_torch.ops.cplx import CF, from_complex
from jsdr_tpu_torch.parallel import (make_mesh, sharded_spectrum,
                                     sharded_telemetry_step)
from jsdr_tpu_torch.runtime.state import tree_map

FIELDS = ("n_bits", "bits", "n_hits", "windows", "hit_corr")


def _cf(x) -> CF:
    return from_complex(x, "cpu")


def _mesh(dp, sp):
    return make_mesh(dp=dp, sp=sp, device="cpu")


def _leaves(st):
    return jax.tree.leaves(state_to_numpy(st))


def _states_close(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_allclose(np.asarray(x, np.float64),
                                   np.asarray(y, np.float64),
                                   rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def streams():
    rng = np.random.default_rng(11)
    payloads = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    t_len = 96000 * 6
    s0 = synth_bpsk_stream(payloads[:1], rate=96000, preamble_bits=200, seed=1)
    s1 = synth_bpsk_stream(payloads[1:], rate=96000, preamble_bits=300, seed=2)

    def fit(x):
        out = np.zeros(t_len, np.complex64)
        out[:min(len(x), t_len)] = x[:t_len]
        return out

    arr = np.stack([fit(s0), fit(s1),
                    synth_noise(t_len, 0.3, 3),
                    synth_noise(t_len, 0.3, 4)])
    return arr, payloads


def test_sharded_matches_single_device(streams):
    arr, payloads = streams
    step = sharded_telemetry_step(_mesh(2, 4), rate=96000)
    cfg = BpskConfig(rate=96000, tuning=12000.0)
    out, new_states = step(arr, bpsk_init_batch(cfg, 4, "cpu"))
    for s in range(2):
        ref, st = bpsk_block(_cf(arr[s]), cfg, bpsk_init(cfg, "cpu"))
        assert int(out.n_bits[s]) == int(ref.n_bits)
        assert int(out.n_hits[s]) == int(ref.n_hits) == 1
        assert int(out.hit_corr[s, 0]) == int(ref.hit_corr[0]) == 65
        assert torch.equal(out.windows[s, 0], ref.windows[0])
        assert torch.equal(out.bits[s], ref.bits)
        assert int(new_states.timing.peak[s]) == int(st.timing.peak)
        assert float(new_states.tu_phase[s]) == float(st.tu_phase)
        assert torch.equal(new_states.ring[s], st.ring)
        assert torch.equal(new_states.counters[s], st.counters)
    res = fec_decode(out.windows)
    for s in range(2):
        assert bool(res.ok[s, 0])
        assert np.array_equal(res.payload[s, 0].numpy(), payloads[s])


def test_sharded_state_chains_across_segments(streams):
    """A frame that straddles two consecutive sharded steps decodes, and
    both steps equal the chained single-device batch over the same split
    (FUNcubeBPSKDemod.java:503, 553-554)."""
    arr, payloads = streams
    half = arr.shape[-1] // 2                # 3 s: frame 0 ends ~4.5 s
    cfg = BpskConfig(rate=96000, tuning=12000.0)
    step = sharded_telemetry_step(_mesh(2, 4), rate=96000)
    states = bpsk_init_batch(cfg, 4, "cpu")
    out1, states = step(arr[:, :half], states)
    out2, states = step(arr[:, half:], states)
    assert int(out1.n_hits[0]) == 0
    assert int(out2.n_hits[0]) == 1
    res = fec_decode(out2.windows[:2])
    assert bool(res.ok[0, 0])
    assert np.array_equal(res.payload[0, 0].numpy(), payloads[0])

    st = bpsk_init_batch(cfg, 4, "cpu")
    ref1, st = bpsk_block_batch(_cf(arr[:, :half]), cfg, st)
    ref2, st = bpsk_block_batch(_cf(arr[:, half:]), cfg, st)
    for o, r in ((out1, ref1), (out2, ref2)):
        for f in FIELDS:
            assert torch.equal(getattr(o, f), getattr(r, f)), f
    assert torch.equal(states.counters, st.counters)
    _states_close(states, st)


def test_sharded_per_stream_tunings(streams):
    """Stream 1 shifted to a 9 kHz carrier decodes beside stream 0 at
    12 kHz in one sharded call."""
    arr, payloads = streams
    t = np.arange(1, arr.shape[-1] + 1, dtype=np.float64)
    arr2 = arr.copy()
    arr2[1] = (arr[1] * np.exp(-2j * np.pi * 3000.0 * t / 96000.0)
               ).astype(np.complex64)
    cfg = BpskConfig(rate=96000)
    step = sharded_telemetry_step(_mesh(2, 4), rate=96000)
    tun = [12000, 9000, 12000, 12000]
    out, _ = step(arr2, bpsk_init_batch(cfg, 4, "cpu"), tunings=tun)
    assert int(out.n_hits[0]) == 1 and int(out.n_hits[1]) == 1
    res = fec_decode(out.windows[:2])
    assert bool(res.ok[0, 0]) and bool(res.ok[1, 0])
    assert np.array_equal(res.payload[1, 0].numpy(), payloads[1])
    ref, _ = bpsk_block_batch(_cf(arr2), cfg, bpsk_init_batch(cfg, 4, "cpu"),
                              tun)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


def test_mesh_shape_invariance(streams):
    """The dp x sp factorisation does not change the results."""
    arr, _ = streams
    cfg = BpskConfig(rate=96000, tuning=12000.0)
    results = []
    for dp, sp in [(4, 2), (2, 4), (1, 8)]:
        step = sharded_telemetry_step(_mesh(dp, sp), rate=96000)
        out, _ = step(arr[:4], bpsk_init_batch(cfg, 4, "cpu"))
        results.append(out)
    for out in results[1:]:
        for f in FIELDS:
            assert torch.equal(getattr(out, f), getattr(results[0], f)), f


def test_sharded_spectrum(streams):
    arr, _ = streams
    fn = sharded_spectrum(_mesh(4, 2), rate=96000.0)
    res = fn(arr.reshape(-1, 9600)[:64])
    assert res.psd.shape == (64, 9600)
    # stream 0 carries BPSK spread around 13.2 kHz
    assert abs(int(res.peak_freq[0]) - 13200) < 1300


def _dofft_pair(seed: int, seg: int):
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    sig_a = synth_bpsk_stream(payloads[:1], rate=96000,
                              carrier_offset=12000.0, preamble_bits=400)
    sig_b = synth_bpsk_stream(payloads[1:], rate=96000,
                              carrier_offset=11900.0, preamble_bits=400,
                              seed=2)
    t_len = 2 * seg
    arr = np.zeros((2, t_len), np.complex64)
    arr[0, :len(sig_a)] = sig_a[:t_len]
    arr[1, :len(sig_b)] = sig_b[:t_len]
    return arr, payloads


def test_sharded_dofft_matches_single_device():
    """A mixed manual/auto batch sharded dp x sp equals the single-device
    mixed batch bit-exactly across two chained segments (the tuner state
    relays across sp and carries across segments), and the auto-tuned
    stream decodes a carrier it was never told about
    (FUNcubeBPSKDemod.java:406-464)."""
    seg = 307_200                     # 3.2 s; t_loc = 8 whole 0.1 s blocks
    arr, payloads = _dofft_pair(21, seg)
    cfg = BpskConfig(rate=96000)
    step = sharded_telemetry_step(_mesh(2, 4), rate=96000)
    tunings = np.asarray([12000, 0])
    dofft = [False, True]
    states = bpsk_init_batch(cfg, 2, "cpu")
    ref_states = bpsk_init_batch(cfg, 2, "cpu")
    good = [0, 0]
    for b in range(2):
        blk = arr[:, b * seg:(b + 1) * seg]
        out, states = step(blk, states, tunings, dofft=dofft)
        ref, ref_states = bpsk_block_batch(_cf(blk), cfg, ref_states,
                                           tunings, dofft=dofft)
        for f in FIELDS:
            assert torch.equal(getattr(out, f), getattr(ref, f)), (b, f)
        for s in range(2):
            nh = int(out.n_hits[s])
            if nh:
                res = fec_decode(out.windows[s, :nh])
                good[s] += sum(bool(res.ok[i]) and np.array_equal(
                    res.payload[i].numpy(), payloads[s]) for i in range(nh))
    assert good == [1, 1]
    assert torch.equal(states.fft_tuner.centre_bin,
                       ref_states.fft_tuner.centre_bin)
    assert int(states.fft_tuner.centre_bin[1]) > 1000
    assert int(states.fft_tuner.centre_bin[0]) == 0


def test_sharded_randomized_property_matches_single_device():
    """Random segment lengths, random 0.1 Hz-multiple tunings (a
    fractional one and a pass-through 0), frames at random offsets in
    noise: every segment's hits and windows, the bits of the streams that
    carry a frame (0 and 3), and their carried state match the
    single-device chain. Streams 1 and 2 hold noise only: there the EMA's
    two float orders may break a near-tie between two phases differently
    (trial 1 flips one of stream 1's bits), so their bits and ring are
    not compared."""
    rng = np.random.default_rng(77)
    rate = 96000
    cfg = BpskConfig(rate=rate)
    step = sharded_telemetry_step(_mesh(2, 4), rate=rate)
    for trial in range(2):
        seg = int(rng.integers(96000, 212000)) // 320 * 320
        n_seg = 3
        tunings = np.asarray(
            [12000, float(rng.integers(80000, 140000)) / 10.0, 0.0, 9000])
        payloads = rng.integers(0, 256, (2, 256), dtype=np.uint8)
        arr = (0.25 * (rng.standard_normal((4, n_seg * seg))
                       + 1j * rng.standard_normal((4, n_seg * seg)))
               ).astype(np.complex64)
        off = int(rng.integers(0, seg // 2))
        s0 = synth_bpsk_stream(payloads[:1], rate=rate, preamble_bits=100,
                               carrier_offset=12000.0, seed=trial)
        s1 = synth_bpsk_stream(payloads[1:], rate=rate, preamble_bits=150,
                               carrier_offset=tunings[1], seed=trial + 9)
        arr[0, off:off + len(s0)] += s0[:n_seg * seg - off]
        arr[3, :len(s1)] += s1[:n_seg * seg]
        st_s = bpsk_init_batch(cfg, 4, "cpu")
        st_r = bpsk_init_batch(cfg, 4, "cpu")
        carrier = [0, 3]
        for b in range(n_seg):
            blk = arr[:, b * seg:(b + 1) * seg]
            out, st_s = step(blk, st_s, tunings)
            ref, st_r = bpsk_block_batch(_cf(blk), cfg, st_r, tunings)
            for f in FIELDS:
                a, r = getattr(out, f), getattr(ref, f)
                if f in ("n_bits", "bits"):
                    a, r = a[carrier], r[carrier]
                assert torch.equal(a, r), (trial, b, f)
        for f in ("vco_idx", "tu_phase"):
            assert torch.equal(getattr(st_s, f), getattr(st_r, f)), (trial, f)
        assert torch.equal(st_s.counters[:, :2], st_r.counters[:, :2])
        keep = torch.as_tensor(carrier)
        _states_close(tree_map(lambda x: x[keep], st_s),
                      tree_map(lambda x: x[keep], st_r))


def test_sharded_shape_validation():
    """Off-contract [S, T] shapes fail with the reference's actionable
    ValueError, and valid_block_samples gives passing shapes."""
    from jsdr_tpu_torch.parallel.sharded import valid_block_samples

    cfg = BpskConfig(rate=96000)
    step = sharded_telemetry_step(_mesh(2, 4), rate=96000)
    sts = bpsk_init_batch(cfg, 4, "cpu")
    with pytest.raises(ValueError, match="multiple of dp"):
        step(np.zeros((3, 96000), np.complex64),
             bpsk_init_batch(cfg, 3, "cpu"))
    with pytest.raises(ValueError, match="split over sp"):
        step(np.zeros((4, 96002), np.complex64), sts)
    with pytest.raises(ValueError, match="whole decimated bit groups"):
        step(np.zeros((4, 96032), np.complex64), sts)
    with pytest.raises(ValueError, match=">= 2 bit groups"):
        step(np.zeros((4, 4 * 80), np.complex64), sts)
    with pytest.raises(ValueError, match="whole 0.1 s blocks"):
        step(np.zeros((4, 4 * 2400), np.complex64), sts, dofft=[True] * 4)
    with pytest.raises(ValueError, match="e.g. T=96000"):
        step(np.zeros((4, 96032), np.complex64), sts)
    with pytest.raises(ValueError, match="3 tunings for 4 streams"):
        step(np.zeros((4, 96000), np.complex64), sts, [12000] * 3)
    assert valid_block_samples(96000, 4) == 96000
    assert valid_block_samples(96000, 4, dofft=True) == 4 * 19200
    assert valid_block_samples(192000, 4) == 192000
    out, _ = step(np.zeros((4, valid_block_samples(96000, 4, dofft=True)),
                           np.complex64), sts, dofft=[True] * 4)
    assert int(out.n_hits.sum()) == 0


def test_place_segments_matches_concatenation():
    """The global bit stream assembled from per-shard segments equals the
    concatenation of each shard's valid prefix (empty and full segments
    included)."""
    from jsdr_tpu_torch.parallel.sharded import _place_segments

    rng = np.random.default_rng(33)
    n_sp, s_loc, mb_loc = 4, 5, 258
    max_bits = n_sp * (mb_loc - 2) + 2
    n_g = rng.integers(0, mb_loc - 1, (n_sp, s_loc)).astype(np.int32)
    n_g[0, 0] = 0
    n_g[:, 1] = mb_loc - 2
    n_g[:, 2] = 0
    bits_g = np.zeros((n_sp, s_loc, mb_loc), np.int8)
    for j in range(n_sp):
        for s in range(s_loc):
            bits_g[j, s, :n_g[j, s]] = rng.choice([-1, 1], n_g[j, s])
    got = _place_segments(torch.as_tensor(bits_g), torch.as_tensor(n_g),
                          max_bits).numpy()
    for s in range(s_loc):
        ref = np.concatenate([bits_g[j, s, :n_g[j, s]] for j in range(n_sp)])
        assert np.array_equal(got[s], np.pad(ref, (0, max_bits - len(ref))))


def test_sharded_compat_scan_matches_single_device(streams):
    """compat_scan gathers the decimated stream and runs the per-sample
    scan tail; it equals the single-device compat chain."""
    arr, _ = streams
    arr2 = arr[:, :96000 * 2]
    cfg = BpskConfig(rate=96000, tuning=12000.0, compat_scan=True)
    step = sharded_telemetry_step(_mesh(2, 4), rate=96000, compat_scan=True)
    out, st = step(arr2, bpsk_init_batch(cfg, 4, "cpu"))
    ref, st_r = bpsk_block_batch(_cf(arr2), cfg, bpsk_init_batch(cfg, 4,
                                                                 "cpu"))
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    for a, b in zip(_leaves(st), _leaves(st_r)):
        assert np.array_equal(a, b)


def test_sharded_checkpoint_resume_mid_stream(streams, tmp_path):
    """A dp x sp run checkpoints its state mid-stream (a frame in flight)
    in the reference's .npz format, reloads it into either package's
    state, and the resumed run decodes the straddling frame with outputs
    bit-identical to the uninterrupted run."""
    from jsdr_tpu.demod.bpsk import bpsk_init_batch as j_init_batch
    from jsdr_tpu.runtime import load_state as j_load
    from jsdr_tpu_torch.runtime.state import load_state, save_state

    arr, payloads = streams
    half = arr.shape[-1] // 2
    cfg = BpskConfig(rate=96000, tuning=12000.0)
    step = sharded_telemetry_step(_mesh(2, 4), rate=96000)
    states = bpsk_init_batch(cfg, 4, "cpu")
    out1, states = step(arr[:, :half], states)
    assert int(out1.n_hits[0]) == 0
    save_state(tmp_path / "ckpt.npz", states)
    restored = load_state(tmp_path / "ckpt.npz",
                          bpsk_init_batch(cfg, 4, "cpu"))
    via_jax = state_from_numpy(j_load(tmp_path / "ckpt.npz",
                                      j_init_batch(cfg, 4)), "cpu")
    out2, states_c = step(arr[:, half:], states)
    for like in (restored, via_jax):
        out2r, states_r = step(arr[:, half:], like)
        for f in FIELDS:
            assert torch.equal(getattr(out2r, f), getattr(out2, f)), f
        for a, b in zip(_leaves(states_r), _leaves(states_c)):
            assert np.array_equal(a, b)
    assert int(out2.n_hits[0]) == 1
    res = fec_decode(out2.windows[:1])
    assert bool(res.ok[0, 0])
    assert np.array_equal(res.payload[0, 0].numpy(), payloads[0])


@pytest.fixture(scope="module")
def streams_192k():
    """192 kS/s (decim m=20, jsdr.java:271-277): the other halo
    geometry."""
    rng = np.random.default_rng(12)
    payloads = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    t_len = 192000 * 6
    s0 = synth_bpsk_stream(payloads[:1], rate=192000, preamble_bits=200,
                           seed=5)
    s1 = synth_bpsk_stream(payloads[1:], rate=192000, preamble_bits=300,
                           seed=6)

    def fit(x):
        out = np.zeros(t_len, np.complex64)
        out[:min(len(x), t_len)] = x[:t_len]
        return out

    return np.stack([fit(s0), fit(s1)]), payloads


def test_sharded_192k_matches_single_device(streams_192k):
    arr, payloads = streams_192k
    cfg = BpskConfig(rate=192000, tuning=12000.0)
    step = sharded_telemetry_step(_mesh(2, 4), rate=192000)
    out, new_states = step(arr, bpsk_init_batch(cfg, 2, "cpu"))
    ref, st = bpsk_block_batch(_cf(arr), cfg, bpsk_init_batch(cfg, 2, "cpu"))
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert torch.equal(new_states.ring, st.ring)
    assert out.n_hits.tolist() == [1, 1]
    res = fec_decode(out.windows)
    for s in range(2):
        assert bool(res.ok[s, 0])
        assert np.array_equal(res.payload[s, 0].numpy(), payloads[s])


def test_sharded_tuning_past_int32():
    """13999.9 Hz is 139999 tenth-Hz units; at sp=4 over 1 s blocks the
    shards start at offsets g0 up to 72000 samples, so tu * g0 ~ 1.0e10
    wraps an int32 product (what the reference's _modmul_traced avoids).
    The sharded step equals the single-device general-mode chain and
    decodes the frame."""
    rng = np.random.default_rng(41)
    pay = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(pay, rate=96000, carrier_offset=13999.9,
                            preamble_bits=100, noise_rms=0.1, seed=4)
    n_blk = -(-len(sig) // 96000)
    arr = np.zeros((2, n_blk * 96000), np.complex64)
    arr[0, :len(sig)] = sig
    arr[1] = synth_noise(arr.shape[1], 0.2, 6)
    assert 139999 * 72000 > 2 ** 31
    tun = [13999.9, 13999.9]
    cfg = BpskConfig(rate=96000)
    step = sharded_telemetry_step(_mesh(2, 4), rate=96000)
    st, st_r = bpsk_init_batch(cfg, 2, "cpu"), bpsk_init_batch(cfg, 2, "cpu")
    hits = 0
    for b in range(n_blk):
        blk = arr[:, b * 96000:(b + 1) * 96000]
        out, st = step(blk, st, tun)
        ref, st_r = bpsk_block_batch(_cf(blk), cfg, st_r, tun)
        for f in FIELDS:
            assert torch.equal(getattr(out, f), getattr(ref, f)), (b, f)
        if int(out.n_hits[0]):
            res = fec_decode(out.windows[0, :1])
            assert bool(res.ok[0])
            assert np.array_equal(res.payload[0].numpy(), pay[0])
            hits += 1
    assert hits == 1
    assert torch.equal(st.tu_phase, st_r.tu_phase)


# ---------------------------------------------------------------------------
# Tensor-parallel FFT
# ---------------------------------------------------------------------------

def test_tp_fft_matches_numpy():
    from jsdr_tpu_torch.parallel.tp import tp_fft
    rng = np.random.default_rng(5)
    n = 4096
    x = (rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
         ).astype(np.complex64)
    y = tp_fft(_mesh(2, 4), n)(x)
    got = y.re.numpy() + 1j * y.im.numpy()
    np.testing.assert_allclose(got, np.fft.fft(x), atol=n * 2e-6)


def test_tp_fft_mesh_shape_invariance():
    """The same transform sharded two ways and unsharded agrees."""
    from jsdr_tpu_torch.ops.mxu_fft import fft_cf
    from jsdr_tpu_torch.parallel.tp import tp_fft
    rng = np.random.default_rng(6)
    n = 2048
    x = (rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))
         ).astype(np.complex64)
    outs = []
    for dp, sp in ((1, 8), (4, 2)):
        y = tp_fft(_mesh(dp, sp), n)(x)
        outs.append(y.re.numpy() + 1j * y.im.numpy())
    single = fft_cf(_cf(x))
    single = single.re.numpy() + 1j * single.im.numpy()
    np.testing.assert_allclose(outs[0], outs[1], atol=n * 1e-6)
    np.testing.assert_allclose(outs[0], single, atol=n * 2e-6)
    # unsplit stage output: D[k1, k2] of the whole transform
    d = tp_fft(_mesh(1, 8), n, gather=False)(x)
    n1, n2 = d.re.shape[1:]
    np.testing.assert_allclose(
        (d.re.numpy() + 1j * d.im.numpy()).swapaxes(1, 2).reshape(8, n),
        outs[0], atol=n * 1e-6)
    assert n1 * n2 == n


def test_tp_spectrum_matches_spectrum_block():
    """One 2 s windowed PSD sharded over the mesh equals the port's
    spectrum (fft.java formula), peaks included."""
    from jsdr_tpu_torch.io.sources import synth_sine
    from jsdr_tpu_torch.ops.spectrum import spectrum_block
    from jsdr_tpu_torch.parallel.tp import tp_spectrum
    n = 96000 * 2
    rate = 96000.0
    tones = np.stack([synth_sine(n, f, rate, amplitude=0.5)
                      + synth_noise(n, 0.01, seed=int(abs(f)))
                      for f in (4410.0, -12345.0)])
    db, freq, peak_db = tp_spectrum(_mesh(2, 4), n, rate)(tones)
    ref = spectrum_block(_cf(tones), rate=rate, window=True)
    np.testing.assert_allclose(db.numpy(), ref.psd.numpy(), atol=0.15)
    assert freq.tolist() == ref.peak_freq.tolist() == [4410, -12345]
    np.testing.assert_allclose(peak_db.numpy(), ref.peak_db.numpy(),
                               atol=1e-3)


# ---------------------------------------------------------------------------
# The port against the JAX package on the same inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cross_streams():
    """Two chained 2.4 s segments of 4 streams: frames at 12000 Hz and at
    13999.9 Hz (a general-mode tuning whose shard offsets overflow an
    int32 product) straddling the segment boundary, and two noise-only
    streams."""
    rng = np.random.default_rng(42)
    seg = 230400
    arr = (0.1 * (rng.standard_normal((4, 2 * seg))
                  + 1j * rng.standard_normal((4, 2 * seg)))
           ).astype(np.complex64)
    pays = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    for i, (c, pre) in enumerate(((12000.0, 64), (13999.9, 40))):
        burst = synth_bpsk_stream(pays[i:i + 1], rate=96000,
                                  carrier_offset=c, preamble_bits=pre,
                                  seed=i)
        arr[i, :min(len(burst), 2 * seg)] += burst[:2 * seg]
    return arr, pays, seg


@pytest.mark.parametrize("mode", ["manual", "mixed"])
def test_sharded_step_matches_the_jax_package(cross_streams, mode):
    """dp=2 x sp=4: the port's sharded step against the reference's on
    the JAX package's 8-device CPU mesh, over two chained segments.
    Carrier streams (0 and 1) bit-exact in bits, hits, hit_corr and
    windows; every stream's windows and hits equal; the straddling frames
    decode to their payloads; state within rtol 2e-4. "mixed" auto-tunes
    stream 3 (a noise stream: its tuner state is held to the tolerance)."""
    from jsdr_tpu.demod.bpsk import BpskConfig as JCfg
    from jsdr_tpu.demod.bpsk import bpsk_init_batch as j_init_batch
    from jsdr_tpu.parallel import make_mesh as j_make_mesh
    from jsdr_tpu.parallel import sharded_telemetry_step as j_step

    arr, pays, seg = cross_streams
    tun = [12000.0, 13999.9, 12000.0, 9000.0]
    dofft = [False, False, False, mode == "mixed"]
    j_mesh = j_make_mesh(dp=2, sp=4)
    jstep = j_step(j_mesh, rate=96000)
    step = sharded_telemetry_step(_mesh(2, 4), rate=96000)
    st = bpsk_init_batch(BpskConfig(), 4, "cpu")
    jst = j_init_batch(JCfg(), 4)
    sh = NamedSharding(j_mesh, P("dp", "sp"))
    got = []
    for b in range(2):
        blk = arr[:, b * seg:(b + 1) * seg]
        out, st = step(blk, st, tun, dofft=dofft)
        jout, jst = jstep(jax.device_put(jnp.asarray(blk), sh), jst, tun,
                          dofft=dofft)
        for f in ("n_hits", "windows", "hit_corr"):
            assert np.array_equal(getattr(out, f).numpy(),
                                  np.asarray(getattr(jout, f))), (b, f)
        for f in ("n_bits", "bits"):
            assert np.array_equal(getattr(out, f).numpy()[:2],
                                  np.asarray(getattr(jout, f))[:2]), (b, f)
        got.append(out)
    assert got[0].n_hits.tolist()[:2] == [0, 0]
    assert got[1].n_hits.tolist()[:2] == [1, 1]
    res = fec_decode(got[1].windows[:2, 0])
    assert res.ok.tolist() == [True, True]
    assert np.array_equal(res.payload.numpy(), pays)
    for a, b_ in zip(_leaves(st), jax.tree.leaves(jst)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b_, np.float64),
                                   rtol=2e-4, atol=1e-6)


def test_tp_fft_matches_the_jax_package():
    from jsdr_tpu.parallel import make_mesh as j_make_mesh
    from jsdr_tpu.parallel.tp import tp_fft as j_tp_fft
    from jsdr_tpu_torch.parallel.tp import tp_fft
    rng = np.random.default_rng(8)
    n = 6144
    x = (rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
         ).astype(np.complex64)
    j_mesh = j_make_mesh(dp=2, sp=4)
    sh = NamedSharding(j_mesh, P("dp", "sp"))
    from jsdr_tpu.ops.cplx import CF as JCF
    for window in (False, True):
        jy = j_tp_fft(j_mesh, n, window=window)(JCF(
            jax.device_put(np.ascontiguousarray(x.real), sh),
            jax.device_put(np.ascontiguousarray(x.imag), sh)))
        y = tp_fft(_mesh(2, 4), n, window=window)(x)
        np.testing.assert_allclose(
            y.re.numpy() + 1j * y.im.numpy(),
            np.asarray(jy.re) + 1j * np.asarray(jy.im), atol=n * 2e-6)
