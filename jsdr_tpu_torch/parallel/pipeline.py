"""Pipeline parallelism — the port of :mod:`jsdr_tpu.parallel.pipeline`:
the telemetry chain's stages on the rows of a ("pp", "dp") mesh,
composable with data parallelism over streams.

The reference's thread/stage structure (capture thread -> demod handlers
-> FEC/output, JavaAudio.java:195-329 / FUNcubeBPSKDemod.java:357-595 /
FECDecoder.java:703) as pipeline stages over successive blocks:

- **stage 0 (front end)**: the NCO mix + 27-tap decimating FIR of the
  shared front-end dispatcher (``demod.bpsk._front_dispatch`` with the
  matched filter unfused: kernel 1 on a card in the pattern and dofft
  modes);
- **stage 1 (decode tail)**: VCO mix -> matched filter -> timing
  recovery (kernel 2 on a card) -> sync search (``demod.bpsk.
  _post_batch``);
- **stage 2 (FEC, 3-stage meshes)**: batched AO-40 ``fec_decode`` of the
  extracted windows, so frame decoding overlaps both upstream stages.

Schedule (GPipe-style, microbatch = one time block): at tick t, stage s
processes the payload stage s-1 produced at tick t-1. The stages of one
tick read only the previous tick's payloads and their own state, so they
are independent; here they run in stage order on the mesh's device, and
the payloads hop one stage between ticks.

**Validity travels with the data.** Every payload carries a ``valid``
flag: the first (n_stages-1) ticks prime the pipe with invalid payloads,
and :func:`pipeline_flush` drains in-flight blocks by feeding bubbles
(``valid=False`` inputs). A stage given an invalid payload runs nothing
and advances no state, so a pipeline can be drained mid-stream and
resumed exactly. The flags are host data (the caller's bubble flags
decide them), so they are CPU bool tensors and no tick waits for the
device to learn them.

State is exact: the front-end state (NCO numerator, decimator tail,
tuner) advances on stage 0, the decode state (VCO, matched filter,
timing, 5199-bit ring, counters) on stage 1 — equal to the sequential
``bpsk_block_batch`` chain with (n_stages-1) blocks of latency
(tests/test_torch_pipeline.py). The pipeline runs in one process: all of
its stages sit on that process's device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..demod import bpsk as B
from ..fec.decoder import fec_decode
from ..ops.cplx import CF, from_complex
from .mesh import Mesh, _world


def make_pp_mesh(n_stages: int = 2, dp: int = 1, devices=None, *,
                 device="cuda") -> Mesh:
    """An [n_stages, dp] ("pp", "dp") mesh of this process's shards on
    ``device`` (``devices``: owner ranks per shard, as in ``make_mesh``;
    the pipeline takes only this process's)."""
    need = n_stages * dp
    rank, _ = _world()
    owners = (np.full(need, rank) if devices is None
              else np.asarray(list(devices)[:need]))
    if owners.size != need:
        raise ValueError(f"pipeline mesh needs {need} devices")
    if (owners != rank).any():
        raise ValueError("the pipeline runs all of its stages in one "
                         "process")
    return Mesh(owners.reshape(n_stages, dp), ("pp", "dp"), device)


class PipeOut(NamedTuple):
    """Pipeline outputs (leaves lead with [n_mb, S])."""

    telem: B.BpskBlockOut
    fec_ok: torch.Tensor       # [S, max_hits] bool (3-stage only)
    fec_rc: torch.Tensor       # [S, max_hits] i32 (-1 where no frame)
    fec_payload: torch.Tensor  # [S, max_hits, 256] u8
    valid: torch.Tensor        # [] bool (host) — False on prime/bubble ticks


class _Payload(NamedTuple):
    """The inter-stage activation."""

    valid: torch.Tensor     # [] bool (host)
    ds_re: torch.Tensor     # [S, T//m] front -> tail
    ds_im: torch.Tensor
    tu: torch.Tensor        # [S] tu_phase after the block
    tail_re: torch.Tensor   # [S, ntaps-1]
    tail_im: torch.Tensor
    telem: B.BpskBlockOut   # tail -> fec (zeros on the first hop)


def _zero_out(s: int, t_ds: int, max_hits: int, dev) -> B.BpskBlockOut:
    max_bits = 2 * (t_ds // B.SAMPLES_PER_BIT) + 2
    return B.BpskBlockOut(
        windows=torch.full((s, max_hits, B.FEC_BITS), 0x40,
                           dtype=torch.uint8, device=dev),
        hit_corr=torch.zeros((s, max_hits), dtype=torch.int32, device=dev),
        n_hits=torch.zeros((s,), dtype=torch.int32, device=dev),
        bits=torch.zeros((s, max_bits), dtype=torch.int8, device=dev),
        n_bits=torch.zeros((s,), dtype=torch.int32, device=dev),
        energies=torch.zeros((s, 2), dtype=torch.float32, device=dev))


def _pipeout(telem: B.BpskBlockOut, valid: bool, fec=None) -> PipeOut:
    s, h = telem.hit_corr.shape
    dev = telem.n_hits.device
    ok, rc, pay = fec if fec is not None else (
        torch.zeros((s, h), dtype=torch.bool, device=dev),
        torch.full((s, h), -1, dtype=torch.int32, device=dev),
        torch.zeros((s, h, 256), dtype=torch.uint8, device=dev))
    return PipeOut(telem, ok, rc, pay, torch.tensor(valid))


def _zero_payload(s: int, t_ds: int, max_hits: int, dev) -> _Payload:
    n_tail = len(B.DS_FILTER) - 1

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return _Payload(torch.tensor(False), z(s, t_ds), z(s, t_ds), z(s),
                    z(s, n_tail), z(s, n_tail),
                    _zero_out(s, t_ds, max_hits, dev))


def _stack(items: list):
    """Stack same-shaped trees (NamedTuples of tensors) leaf by leaf."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return type(first)(*(_stack(list(leaves)) for leaves in zip(*items)))


def _index(tree, i: int):
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return type(tree)(*(_index(x, i) for x in tree))


def pipelined_telemetry(mesh: Mesh, rate: int = 96000, max_hits: int = 4,
                        compat_scan: bool = False):
    """Build the pipelined telemetry step over ``mesh`` (("pp", "dp");
    pp size 2 = front/tail, 3 = front/tail/FEC).

    Returns ``fn(iq_blocks, carry, tunings=None, bubble=None, dofft=None,
    track_high=None) -> (out, new_carry)``: ``iq_blocks`` [n_mb, S, T]
    (CF of tensors, or host complex) — n_mb microbatches of S streams;
    ``carry`` starts as :func:`pipeline_init`. ``out`` is a PipeOut
    stacked over the n_mb ticks, the last stage's outputs; out[t] decodes
    input block t-(n_stages-1) (earlier ticks have valid=False and empty
    fields). ``bubble`` [n_mb] bool marks ticks whose input must NOT be
    consumed (used by :func:`pipeline_flush`). Tunings (default 12000 Hz)
    must be multiples of 0.1 Hz; the tensors' device picks the kernels or
    their plain versions, as everywhere in the port.
    """
    n_stages = mesh.shape["pp"]
    if n_stages not in (2, 3):
        raise ValueError("pipeline supports 2 or 3 stages")
    dp = mesh.shape.get("dp", 1)
    m = rate // B.DOWN_SAMPLE_RATE
    dev = mesh.device

    def run(iq_blocks, carry, tunings=None, bubble=None, dofft=None,
            track_high=None):
        n_mb, s, t_len = iq_blocks.shape
        if s % dp:
            raise ValueError(f"S={s} streams must be a multiple of dp={dp}")
        if t_len % (8 * m):
            raise ValueError(f"block length {t_len} must be a multiple of "
                             f"8*decim = {8 * m}")
        tun = np.asarray(np.full(s, 12000) if tunings is None else tunings,
                         np.float64).reshape(-1)
        if B.tunings_to_nu(tun) is None:
            raise ValueError("pipelined path needs tunings in multiples of "
                             "0.1 Hz")
        flags = np.broadcast_to(np.asarray(
            False if dofft is None else dofft, bool), (s,)).copy()
        high = torch.as_tensor(np.broadcast_to(np.asarray(
            False if track_high is None else track_high, bool), (s,)).copy(),
            device=dev)
        mode = B.mix_mode_for(tun, rate, flags)
        bubble = (np.zeros(n_mb, bool) if bubble is None
                  else np.asarray(bubble, bool))
        t_ds = t_len // m
        buf = [_index(carry[0], k) for k in range(n_stages)]
        st = [_index(carry[1], k) for k in range(n_stages)]
        outs = []
        for t in range(n_mb):
            pays = []
            # stage 0: the front end (a bubble consumes no input)
            if bubble[t]:
                pays.append(_zero_payload(s, t_ds, max_hits, dev))
            else:
                x = (CF(iq_blocks.re[t], iq_blocks.im[t])
                     if isinstance(iq_blocks, CF)
                     else from_complex(iq_blocks[t], dev))
                x = CF(x.re.to(dev).contiguous(), x.im.to(dev).contiguous())
                ds, tail, _mft, tu, ft = B._front_dispatch(
                    x, st[0], tun, flags, high, mode, rate, fuse_mf=False)
                st[0] = st[0]._replace(tu_phase=tu, ds_tail=tail,
                                       fft_tuner=ft)
                pays.append(_zero_payload(s, t_ds, max_hits, dev)._replace(
                    valid=torch.tensor(True), ds_re=ds.re, ds_im=ds.im,
                    tu=tu, tail_re=tail.re, tail_im=tail.im))
            # stage 1: the decode tail of the payload stage 0 sent
            b1 = buf[1]
            if bool(b1.valid):
                telem, st[1] = B._post_batch(
                    CF(b1.ds_re, b1.ds_im), st[1], b1.tu,
                    CF(b1.tail_re, b1.tail_im), st[1].fft_tuner, t_len,
                    max_hits, compat_scan)
                pays.append(_zero_payload(s, t_ds, max_hits, dev)._replace(
                    valid=torch.tensor(True), telem=telem))
                out = _pipeout(telem, True)
            else:
                pays.append(_zero_payload(s, t_ds, max_hits, dev))
                out = _pipeout(_zero_out(s, t_ds, max_hits, dev), False)
            # stage 2: FEC of the windows stage 1 sent
            if n_stages == 3:
                b2 = buf[2]
                if bool(b2.valid):
                    out = _pipeout(b2.telem, True,
                                   _fec(b2.telem, max_hits))
                else:
                    out = _pipeout(_zero_out(s, t_ds, max_hits, dev), False)
            outs.append(out)
            # activations hop stage k -> k+1
            buf = [_zero_payload(s, t_ds, max_hits, dev)] + pays[:n_stages - 1]
        return _stack(outs), (_stack(buf), _stack(st))

    run.n_stages = n_stages
    return run


def _fec(telem: B.BpskBlockOut, max_hits: int):
    """(ok, rc, payload) of every live window (FECDecoder.java:703-852);
    slots past n_hits read as no frame."""
    res = fec_decode(telem.windows)
    live = (torch.arange(max_hits, device=telem.n_hits.device)[None]
            < telem.n_hits[:, None])
    return (res.ok & live, torch.where(live, res.rc, -1).to(torch.int32),
            torch.where(live[..., None], res.payload, 0).to(torch.uint8))


def pipeline_init(cfg: B.BpskConfig, n_streams: int, block_len: int,
                  n_stages: int = 2, max_hits: int = 4, *,
                  device="cuda") -> Tuple[_Payload, B.BpskState]:
    """Initial pipeline carry on ``device``.

    Layout: every leaf leads with the pp axis [n_stages, ...] — each
    stage owns its own activation buffer and stage state. Initial
    payloads carry valid=False, so the first (n_stages-1) output ticks
    are empty prime ticks."""
    from ..runtime.device import require_device
    dev = require_device(device)
    p0 = _zero_payload(n_streams, block_len // cfg.decim, max_hits, dev)
    st0 = B.bpsk_init_batch(cfg, n_streams, dev)
    return _stack([p0] * n_stages), _stack([st0] * n_stages)


def pipeline_flush(run, carry, n_streams: int, block_len: int,
                   tunings=None, ticks: int | None = None, dofft=None,
                   track_high=None) -> Tuple[PipeOut, tuple]:
    """Drain the in-flight blocks: feeds (n_stages-1) bubble ticks —
    inputs marked invalid, so no stage state advances — and returns the
    decodes of the last real blocks. Safe mid-stream: processing can
    resume with real blocks afterwards and stays bit-identical. Pass the
    session's ``dofft``/``track_high`` flags so the flush takes the same
    front end."""
    n = ticks if ticks is not None else run.n_stages - 1
    z = np.zeros((n, n_streams, block_len), np.complex64)
    return run(z, carry, tunings, bubble=np.ones(n, bool), dofft=dofft,
               track_high=track_high)
