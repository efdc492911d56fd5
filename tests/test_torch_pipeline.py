"""The port's pipelined telemetry chain (``jsdr_tpu_torch/parallel/
pipeline.py``) on CPU meshes of stacked stage shards: one counterpart of
each pipeline test of tests/test_parallel.py (pp 2 and 3 x dp 1 and 2,
the auto-tuned front end, a mid-stream flush, 192 kS/s), each equal to
the port's sequential ``bpsk_block_batch`` chain shifted by the
(n_stages-1)-block latency, with in-pipeline FEC decoding the sent
payloads; then the 3-stage pipeline against the JAX package's on the
same seeded input. Every compared field is bit-exact."""

import numpy as np
import pytest
import torch

from jsdr_tpu_torch.demod.bpsk import (BpskConfig, bpsk_block_batch,
                                       bpsk_init_batch)
from jsdr_tpu_torch.fec.decoder import fec_decode
from jsdr_tpu_torch.io.sources import synth_bpsk_stream, synth_noise
from jsdr_tpu_torch.ops.cplx import from_complex
from jsdr_tpu_torch.parallel import (make_pp_mesh, pipeline_flush,
                                     pipeline_init, pipelined_telemetry)
from jsdr_tpu_torch.parallel.pipeline import _index


def _fit(x, t_len):
    out = np.zeros(t_len, np.complex64)
    out[:min(len(x), t_len)] = x[:t_len]
    return out


@pytest.fixture(scope="module")
def streams():
    rng = np.random.default_rng(11)
    payloads = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    t_len = 96000 * 6
    s0 = synth_bpsk_stream(payloads[:1], rate=96000, preamble_bits=200, seed=1)
    s1 = synth_bpsk_stream(payloads[1:], rate=96000, preamble_bits=300, seed=2)
    arr = np.stack([_fit(s0, t_len), _fit(s1, t_len),
                    synth_noise(t_len, 0.3, 3), synth_noise(t_len, 0.3, 4)])
    return arr, payloads


def _seq_reference(arr, cfg, block, tunings=None, dofft=None):
    st = bpsk_init_batch(cfg, arr.shape[0], "cpu")
    seq = []
    for b in range(arr.shape[1] // block):
        o, st = bpsk_block_batch(
            from_complex(arr[:, b * block:(b + 1) * block], "cpu"), cfg, st,
            tunings, dofft=dofft)
        seq.append(o)
    return seq, st


def _ticks(out, start, stop):
    return [_index(out, t) for t in range(start, stop)]


def _pipe(n_stages, dp):
    return pipelined_telemetry(make_pp_mesh(n_stages, dp, device="cpu"),
                               rate=96000)


@pytest.mark.parametrize("n_stages,dp", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_pipelined_telemetry_matches_sequential(streams, n_stages, dp):
    """The n-stage pipeline (front end / decode tail / optional FEC)
    composed with dp over streams reproduces the sequential chain
    exactly, shifted by the (n_stages-1)-block latency; the FEC stage
    decodes the known payloads in-pipeline."""
    arr, payloads = streams
    s, t = arr.shape
    block = 96000
    n_mb = t // block
    blocks = arr.reshape(s, n_mb, block).swapaxes(0, 1)
    lat = n_stages - 1
    cfg = BpskConfig(rate=96000, tuning=12000.0)
    run = _pipe(n_stages, dp)
    carry = pipeline_init(cfg, s, block, n_stages, device="cpu")
    out, carry = run(blocks, carry)
    last, carry = pipeline_flush(run, carry, s, block)
    seq, st = _seq_reference(arr, cfg, block)

    assert not out.valid[:lat].any()
    assert int(out.telem.n_hits[:lat].sum()) == 0
    pipe = _ticks(out, lat, n_mb) + _ticks(last, 0, lat)
    assert all(bool(p.valid) for p in pipe)
    for got, ref in zip(pipe, seq):
        for f in ("n_bits", "bits", "n_hits", "windows", "hit_corr"):
            assert torch.equal(getattr(got.telem, f), getattr(ref, f)), f
    # the tail stage's carried decode state has consumed every block
    final_st = _index(carry[1], 1)
    assert torch.equal(final_st.counters, st.counters)
    assert torch.equal(final_st.ring, st.ring)
    total_hits = sum(int(o.telem.n_hits.sum()) for o in pipe)
    assert total_hits == 2
    for s_i in range(2):
        o, nh = next((o, int(o.telem.n_hits[s_i])) for o in pipe
                     if o.telem.n_hits[s_i])
        if n_stages == 3:               # FEC ran in-pipeline on stage 2
            assert bool(o.fec_ok[s_i, 0])
            assert np.array_equal(o.fec_payload[s_i, 0].numpy(),
                                  payloads[s_i])
        res = fec_decode(o.telem.windows[s_i, :nh])
        assert bool(res.ok[0])
        assert np.array_equal(res.payload[0].numpy(), payloads[s_i])


def test_pipelined_dofft_matches_sequential():
    """A mixed manual/auto batch in stage 0 reproduces the sequential
    mixed batch exactly (shifted by the latency) and decodes the
    auto-tuned carrier; the tuner state advances on stage 0 only, and
    the flush's bubbles do not advance it."""
    rng = np.random.default_rng(22)
    payloads = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    sig_a = synth_bpsk_stream(payloads[:1], rate=96000,
                              carrier_offset=12000.0, preamble_bits=400)
    sig_b = synth_bpsk_stream(payloads[1:], rate=96000,
                              carrier_offset=11900.0, preamble_bits=400,
                              seed=2)
    block, n_mb = 96000, 6
    arr = np.stack([_fit(sig_a, n_mb * block), _fit(sig_b, n_mb * block)])
    blocks = arr.reshape(2, n_mb, block).swapaxes(0, 1)
    tunings = np.asarray([12000, 0])
    dofft = [False, True]
    cfg = BpskConfig(rate=96000)
    run = _pipe(2, 1)
    carry = pipeline_init(cfg, 2, block, 2, device="cpu")
    out, carry = run(blocks, carry, tunings, dofft=dofft)
    last, carry = pipeline_flush(run, carry, 2, block, tunings, dofft=dofft)
    seq, st = _seq_reference(arr, cfg, block, tunings, dofft)
    pipe = _ticks(out, 1, n_mb) + _ticks(last, 0, 1)
    good = [0, 0]
    for got, ref in zip(pipe, seq):
        assert torch.equal(got.telem.n_bits, ref.n_bits)
        assert torch.equal(got.telem.windows, ref.windows)
        for s_i in range(2):
            nh = int(got.telem.n_hits[s_i])
            if nh:
                res = fec_decode(got.telem.windows[s_i, :nh])
                good[s_i] += sum(bool(res.ok[i]) and np.array_equal(
                    res.payload[i].numpy(), payloads[s_i]) for i in range(nh))
    assert good == [1, 1]
    front_st = _index(carry[1], 0)
    assert torch.equal(front_st.fft_tuner.centre_bin,
                       st.fft_tuner.centre_bin)
    assert int(front_st.fft_tuner.centre_bin[1]) > 1000


def test_pipeline_flush_is_a_bubble_mid_stream(streams):
    """Draining mid-stream advances no stage state: resuming with the
    remaining blocks gives outputs bit-identical to an uninterrupted
    run."""
    arr, _ = streams
    s, t = arr.shape
    block = 96000
    n_mb = t // block
    blocks = arr.reshape(s, n_mb, block).swapaxes(0, 1)
    cfg = BpskConfig(rate=96000, tuning=12000.0)
    run = _pipe(2, 1)
    carry = pipeline_init(cfg, s, block, 2, device="cpu")
    out_a, carry = run(blocks[:3], carry)
    drained, carry = pipeline_flush(run, carry, s, block)   # mid-stream
    out_b, carry = run(blocks[3:], carry)
    last, carry = pipeline_flush(run, carry, s, block)
    seq, _ = _seq_reference(arr, cfg, block)
    got = (_ticks(out_a, 1, 3) + _ticks(drained, 0, 1)
           + _ticks(out_b, 1, n_mb - 3) + _ticks(last, 0, 1))
    assert len(got) == n_mb
    for g, ref in zip(got, seq):
        assert bool(g.valid)
        assert torch.equal(g.telem.n_bits, ref.n_bits)
        assert torch.equal(g.telem.windows, ref.windows)


def test_pipelined_192k_matches_sequential():
    """The 3-stage pipeline at 192 kS/s (m=20 front-end geometry) with
    in-pipeline FEC."""
    rng = np.random.default_rng(12)
    payloads = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    t_len = 192000 * 6
    arr = np.stack([
        _fit(synth_bpsk_stream(payloads[:1], rate=192000, preamble_bits=200,
                               seed=5), t_len),
        _fit(synth_bpsk_stream(payloads[1:], rate=192000, preamble_bits=300,
                               seed=6), t_len)])
    block = 192000
    n_mb = t_len // block
    blocks = arr.reshape(2, n_mb, block).swapaxes(0, 1)
    cfg = BpskConfig(rate=192000, tuning=12000.0)
    run = pipelined_telemetry(make_pp_mesh(3, 1, device="cpu"), rate=192000)
    carry = pipeline_init(cfg, 2, block, 3, device="cpu")
    out, carry = run(blocks, carry)
    last, carry = pipeline_flush(run, carry, 2, block)
    seq, _ = _seq_reference(arr, cfg, block)
    pipe = _ticks(out, 2, n_mb) + _ticks(last, 0, 2)
    for got, ref in zip(pipe, seq):
        assert torch.equal(got.telem.n_bits, ref.n_bits)
        assert torch.equal(got.telem.windows, ref.windows)
    assert sum(int(p.fec_ok.sum()) for p in pipe) == 2
    for s_i in range(2):
        for p in pipe:
            if p.fec_ok[s_i].any():
                assert np.array_equal(p.fec_payload[s_i, 0].numpy(),
                                      payloads[s_i])


def test_pipelined_telemetry_matches_the_jax_package():
    """pp=3: the port's pipeline against the reference's (the JAX
    package's plain-XLA path on the CPU) on one seeded input, tick by
    tick: validity, telemetry outputs and in-pipeline FEC results."""
    from jsdr_tpu.demod.bpsk import BpskConfig as JCfg
    from jsdr_tpu.parallel.pipeline import make_pp_mesh as j_pp_mesh
    from jsdr_tpu.parallel.pipeline import pipeline_init as j_init
    from jsdr_tpu.parallel.pipeline import pipelined_telemetry as j_pipe

    rng = np.random.default_rng(31)
    pay = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    block, n_mb = 96000, 7
    t_len = 5 * block
    sig = synth_bpsk_stream(pay, rate=96000, preamble_bits=64,
                            noise_rms=0.2, seed=3)
    arr = np.stack([_fit(sig, t_len), synth_noise(t_len, 0.2, 9)])
    blocks = np.concatenate([arr.reshape(2, 5, block).swapaxes(0, 1),
                             np.zeros((2, 2, block), np.complex64)])
    tun = [12000, 13500]
    run = _pipe(3, 1)
    out, _ = run(blocks, pipeline_init(BpskConfig(), 2, block, 3,
                                       device="cpu"), tun)
    jrun = j_pipe(j_pp_mesh(3, 1), rate=96000)
    jout, _ = jrun(blocks, j_init(JCfg(), 2, block, 3), tun)
    assert out.valid.tolist() == np.asarray(jout.valid).tolist()
    assert out.valid.tolist() == [False, False] + [True] * 5
    for f in ("n_bits", "bits", "n_hits", "windows", "hit_corr"):
        assert np.array_equal(getattr(out.telem, f).numpy(),
                              np.asarray(getattr(jout.telem, f))), f
    for f in ("fec_ok", "fec_rc", "fec_payload"):
        assert np.array_equal(getattr(out, f).numpy(),
                              np.asarray(getattr(jout, f))), f
    assert int(out.fec_ok.sum()) == 1
    t, s_i = (int(v) for v in torch.nonzero(out.fec_ok[..., 0])[0])
    assert s_i == 0
    assert np.array_equal(out.fec_payload[t, 0, 0].numpy(), pay[0])
