"""Worker process of the two-process test of the port's meshes (run by
tests/test_torch_multihost.py). Each process joins a gloo world through
``init_multihost`` and owns 4 stacked CPU shards of every mesh: first dp
spans the two processes (sp stays inside each), then sp spans them —
the layouts ``make_mesh`` lays out by default and by ``devices``.
Imports no jax.

Usage: python -m tests._torch_multihost_worker <host:port> <num_procs> <pid>
"""

import sys

import numpy as np
import torch


def main(coordinator: str, num_processes: int, process_id: int) -> None:
    import torch.distributed as dist

    from jsdr_tpu_torch.parallel.mesh import init_multihost, make_mesh
    init_multihost(coordinator, num_processes, process_id, device="cpu")
    assert dist.get_world_size() == num_processes
    assert dist.get_backend() == "gloo"
    torch.set_num_threads(2)
    me = process_id

    # 1) collectives across the process boundary: dp spans processes,
    # sp stays inside each (the default row-major layout)
    mesh = make_mesh(dp=2, sp=4, device="cpu")
    assert mesh.local_range("dp") == (me, me + 1)
    assert mesh.local_range("sp") == (0, 4)
    full = np.arange(8 * 4 * 8, dtype=np.float32).reshape(8, 4 * 8)
    rows = torch.as_tensor(full[4 * me:4 * me + 4])           # my dp row
    total = mesh.psum(rows[None], "dp")                       # all_reduce
    assert np.array_equal(total.numpy(), full.reshape(2, 4, -1).sum(0))
    by_sp = rows.reshape(4, 4, 8).transpose(0, 1)             # [sp, 4, 8]
    ring = mesh.ring(by_sp, "sp").transpose(0, 1).reshape(4, 32)
    expect_ring = full.reshape(8, 4, 8)[:, [3, 0, 1, 2], :].reshape(8, 32)
    assert np.array_equal(ring.numpy(), expect_ring[4 * me:4 * me + 4])
    gathered = mesh.all_gather(rows[None], "dp")
    assert np.array_equal(gathered.numpy(), full.reshape(2, 4, 32))

    # 2) the sharded spectrum over the 2-process mesh: this process's rows
    from jsdr_tpu_torch.ops.cplx import from_complex
    from jsdr_tpu_torch.ops.spectrum import spectrum_block
    from jsdr_tpu_torch.parallel.sharded import sharded_spectrum
    rng = np.random.default_rng(7)
    blocks = (rng.standard_normal((8, 1024))
              + 1j * rng.standard_normal((8, 1024))).astype(np.complex64)
    mine = blocks[4 * me:4 * me + 4]
    res = sharded_spectrum(mesh, rate=96000.0)(mine)
    local = spectrum_block(from_complex(blocks, "cpu"), rate=96000.0)
    assert torch.equal(res.psd, local.psd[4 * me:4 * me + 4])

    # 3) the sharded step, first with dp across processes (each takes 2
    # of the 4 streams), then with sp across them (each takes all 4
    # streams and its half of every segment): every collective of the
    # decode tail crosses the process boundary in the second. Bit-equal
    # to the single-device chain, with a frame straddling two steps.
    from jsdr_tpu_torch.demod.bpsk import (BpskConfig, bpsk_block_batch,
                                           bpsk_init_batch, state_to_numpy)
    from jsdr_tpu_torch.fec.decoder import fec_decode
    from jsdr_tpu_torch.io.sources import synth_bpsk_stream
    from jsdr_tpu_torch.parallel.sharded import sharded_telemetry_step

    rate, seg = 96000, 230400                 # 2.4 s; the frame straddles
    rng2 = np.random.default_rng(42)
    arr = (0.1 * (rng2.standard_normal((4, 2 * seg))
                  + 1j * rng2.standard_normal((4, 2 * seg)))
           ).astype(np.complex64)
    payload = np.arange(256, dtype=np.uint8)[None]
    burst = synth_bpsk_stream(payload, rate=rate, preamble_bits=64)
    arr[0, :min(len(burst), 2 * seg)] += burst[:2 * seg]
    cfg = BpskConfig(rate=rate)
    tun = [12000.0, 12000.0, 13999.9, 9000.0]
    st_ref = bpsk_init_batch(cfg, 4, "cpu")
    refs = []
    for b in range(2):
        ref, st_ref = bpsk_block_batch(
            from_complex(arr[:, b * seg:(b + 1) * seg], "cpu"), cfg, st_ref,
            tun)
        refs.append(ref)
    half = seg // 2
    layouts = {
        "dp": (make_mesh(dp=2, sp=4, device="cpu"),
               slice(2 * me, 2 * me + 2), slice(0, seg)),
        "sp": (make_mesh(dp=4, sp=2, devices=[0, 1] * 4, device="cpu"),
               slice(0, 4), slice(half * me, half * me + half)),
    }
    for label, (m, streams, span) in layouts.items():
        step = sharded_telemetry_step(m, rate=rate)
        n_s = streams.stop - streams.start
        states = bpsk_init_batch(cfg, n_s, "cpu")
        for b in range(2):
            blk = arr[streams, b * seg:(b + 1) * seg][:, span]
            out, states = step(blk, states, tun[streams])
            for f in ("n_bits", "n_hits", "windows", "bits", "hit_corr"):
                assert torch.equal(getattr(out, f),
                                   getattr(refs[b], f)[streams]), (label, f)
        want = [1, 0] if label == "dp" else [1, 0, 0, 0]
        hits = out.n_hits.tolist()
        assert hits == (want if me == 0 or label == "sp" else [0, 0]), hits
        if me == 0 or label == "sp":
            dec = fec_decode(out.windows[:1, 0])
            assert bool(dec.ok[0])
            assert np.array_equal(dec.payload[0].numpy(), payload[0])
        got = state_to_numpy(states)
        want_st = state_to_numpy(st_ref)
        for a, b_ in zip(_leaves(got), _leaves(want_st)):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b_, np.float64)[streams],
                                       rtol=2e-4, atol=1e-6)
        print(f"proc {me}: sharded step with {label} across processes "
              "bit-equal, straddling frame decoded", flush=True)

    # 4) the TP FFT with its axis across processes: all_reduce of the
    # stage-1 partials, all_gather of the k1 shards
    from jsdr_tpu_torch.parallel.tp import tp_fft
    n = 4096
    x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
         ).astype(np.complex64)
    m8 = make_mesh(dp=1, sp=8, device="cpu")
    y = tp_fft(m8, n)(x[:, me * n // 2:(me + 1) * n // 2])
    np.testing.assert_allclose(y.re.numpy() + 1j * y.im.numpy(),
                               np.fft.fft(x), atol=n * 2e-6)

    assert "jax" not in sys.modules and "jsdr_tpu" not in sys.modules
    dist.destroy_process_group()
    print(f"proc {me}: OK", flush=True)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
