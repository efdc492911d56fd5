"""Device-side sample conversion: upload raw int16 and convert on the card —
the port of :mod:`jsdr_tpu.io.convert_device`.

Shipping the raw S16LE values to the device halves the transfer size
against a float32 planar pair and moves the convert loop off the host.
Semantics identical to ``io.convert.s16le_to_complex`` (wrapping 16-bit
DC correction, then the 1/32767 scale, JavaAudio.java:275-293); the
output is a planar :class:`~jsdr_tpu_torch.ops.cplx.CF` pair. On a card
one hand-written kernel converts (``ops/csrc/s16_convert.cu``); on the
CPU the plain torch chain does.

Uploads to a CUDA device go through pinned host memory without a
synchronise, so the host can frame and convert the next block while the
card still works on this one (what JAX's asynchronous dispatch gave the
reference). A card's Session frames its raw blocks straight into pinned
memory (:class:`TensorRawFramer`) and uploads from there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _build
from ..ops.cplx import CF
from .framer import RawBlockFramer

_SCALE = float(np.float32(1.0 / 32767.0))
_ROW_ALIGN = 32        # floats: both output rows of the kernel 128 B aligned


class TensorRawFramer(RawBlockFramer):
    """A :class:`~jsdr_tpu_torch.io.framer.RawBlockFramer` whose block
    arrays are torch tensors, pinned host memory from torch's caching host
    allocator when the Session's ``device`` is a card.

    Each block is a new ``torch.empty(..., pin_memory=...)`` tensor, and
    the framer yields its numpy view, as its base class yields a block.
    ``tensor`` is the tensor behind the block being filled, or behind the
    block last yielded until the next one starts: upload from it (an
    asynchronous ``to(device, non_blocking=True)``; on the CPU that is the
    tensor itself). A card's copy records an event on the allocator's
    block, so the allocator hands that memory out again only once no
    reference to it is left and the copy has completed: a yielded block
    stays the caller's, and no ring of buffers is needed."""

    def __init__(self, block_samples: int, channels: int = 2,
                 device: torch.device | str = "cpu"):
        super().__init__(block_samples, channels)
        self.pin = torch.device(device).type == "cuda"
        self.tensor: torch.Tensor | None = None

    def _new_block(self) -> np.ndarray:
        self.tensor = torch.empty(self.block, dtype=torch.int16,
                                  pin_memory=self.pin)
        return self.tensor.numpy()


def _to_device(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """Host array -> tensor on ``device``; a CUDA copy is enqueued from a
    pinned buffer and does not wait for the device."""
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def upload_raw(raw: bytes | np.ndarray,
               device: torch.device | str) -> torch.Tensor:
    """Host bytes -> device int16 tensor (half the bytes of a float pair)."""
    s = (np.frombuffer(raw, dtype="<i2") if not isinstance(raw, np.ndarray)
         else np.ascontiguousarray(raw, dtype="<i2"))
    return _to_device(s, device)


def upload_cf(iq: np.ndarray, device: torch.device | str) -> CF:
    """Host complex64 block -> CF on ``device`` (host split, then upload)."""
    iq = np.asarray(iq)
    return CF(_to_device(np.ascontiguousarray(iq.real, np.float32), device),
              _to_device(np.ascontiguousarray(iq.imag, np.float32), device))


def s16_to_cf_ref(samples: torch.Tensor, i_corr: int, q_corr: int,
                  channels: int = 2) -> CF:
    """Plain torch version of :func:`s16_to_cf` (the chain the reference
    writes in jnp): int32 sums, the wrap, one float32 multiply."""
    s = samples.to(torch.int32)
    if channels == 2:
        s = s.view(-1, 2)
        i, q = s[:, 0], s[:, 1]
    else:
        i, q = s, torch.zeros_like(s)

    def wrap16(x):
        return ((x + 32768) & 0xFFFF) - 32768

    i = wrap16(i + int(i_corr))
    q = wrap16(q + int(q_corr))
    return CF((i.to(torch.float32) * _SCALE).contiguous(),
              (q.to(torch.float32) * _SCALE).contiguous())


@_build.counts_launches
def s16_to_cf(samples: torch.Tensor, i_corr: int, q_corr: int,
              channels: int = 2) -> CF:
    """Interleaved int16 I/Q on the device -> planar CF float32.

    ``samples``: [2N] (channels=2) or [N] (mono -> Q=0) int16. The DC
    correction is added with Java ``short`` wrap-around semantics
    (JavaAudio.java:275-293): computed in int32, wrapped to
    [-32768, 32767].

    A CUDA tensor launches the kernel (``csrc/s16_convert.cu``, counted in
    ``s16_to_cf.launches``), which writes both planes into one allocation,
    bit for bit the plain chain's values; any other runs
    :func:`s16_to_cf_ref`."""
    dev = samples.device
    if dev.type != "cuda":
        return s16_to_cf_ref(samples, i_corr, q_corr, channels)
    stereo = channels == 2
    if (samples.dtype != torch.int16 or samples.dim() != 1
            or not samples.is_contiguous() or samples.numel() % (1 + stereo)):
        raise ValueError(
            f"s16_to_cf: want a contiguous 1-D int16 tensor of whole "
            f"samples ({channels} channels); got {samples.dtype} "
            f"{tuple(samples.shape)} (contiguous={samples.is_contiguous()})")
    n = samples.numel() // (1 + stereo)
    pitch = -(-n // _ROW_ALIGN) * _ROW_ALIGN
    out = torch.empty((2, pitch), dtype=torch.float32, device=dev)
    re, im = out[0, :n], out[1, :n]
    if n:
        lib = _build.kernels()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.jsdr_s16_to_cf(
                samples.data_ptr(), re.data_ptr(), im.data_ptr(), n,
                2 if stereo else 1, int(i_corr) % 65536,
                int(q_corr) % 65536, _SCALE, stream)
        _build.check(code, "s16_to_cf")
        s16_to_cf.launches += 1
    return CF(re, im)
