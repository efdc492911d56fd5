"""Device meshes — the port of :mod:`jsdr_tpu.parallel.mesh`.

A :class:`Mesh` is a grid of shards over two named axes (``("dp", "sp")``
for the sharded telemetry step and the TP FFT, ``("pp", "dp")`` for the
pipeline). Each shard is owned by one process, and the shards one process
owns form a rectangle of the grid that sits, stacked, on one torch device:
a sharded tensor carries a leading axis of the process's shards along the
axis a collective runs over. This is the torch form of ``shard_map`` over
several devices of one process, so a dp=2 x sp=4 mesh runs in one process
on one card (or on the CPU in tests).

Each collective applies in rank order along its axis:

- :meth:`Mesh.ring` (``ppermute`` on the ring or, with ``wrap=False``, the
  chain) is a shift along the stacked axis, with zeros where no source is;
- :meth:`Mesh.all_gather` is the stacked tensor itself;
- :meth:`Mesh.psum` is a sum in rank order; :meth:`Mesh.from_last` takes
  the last shard's value (``_psum_from_last``).

Where the shards along an axis belong to several processes (after
:func:`init_multihost`), the same collectives also go through
``torch.distributed``: ``all_gather`` of each process's stacked shards,
``all_reduce`` for the sum, and ``batch_isend_irecv`` for the ring's hop
over a process boundary. The backend follows the mesh's device: NCCL for a
card, gloo for the CPU; a collective refuses a tensor the backend cannot
carry.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.device import require_device


def _world() -> tuple[int, int]:
    """(rank, world size) of this process (0, 1 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A grid of shards over two named axes, owned by processes.

    ``owners``: an int array whose shape is the mesh's shape, naming the
    rank of the process that owns each shard. ``device``: where this
    process's shards live. Every process of the world must build the same
    mesh, in the same order as its other meshes (the process groups of
    the axes that span processes are made here, collectively).
    """

    def __init__(self, owners, axis_names: Sequence[str], device):
        owners = np.asarray(owners, np.int64)
        if owners.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a mesh has two axes")
        self.owners = owners
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, owners.shape))
        self.size = int(owners.size)
        self.device = require_device(device)
        self.rank, world = _world()
        if owners.min() < 0 or owners.max() >= world:
            raise ValueError(f"mesh owners {sorted(set(owners.flat))} are "
                             f"not ranks of a world of {world} processes")
        self._block = {}                  # rank -> ((r0, r1), (c0, c1))
        for r in sorted(set(owners.flat)):
            at = np.argwhere(owners == r)
            lo, hi = at.min(0), at.max(0) + 1
            if len(at) != int(np.prod(hi - lo)):
                raise ValueError(f"process {r}'s shards are not a rectangle "
                                 "of the mesh")
            self._block[int(r)] = ((int(lo[0]), int(hi[0])),
                                   (int(lo[1]), int(hi[1])))
        if self.rank not in self._block:
            raise ValueError(f"process {self.rank} owns no shard of the mesh")
        if world > 1:
            backend = dist.get_backend()
            want = "nccl" if self.device.type == "cuda" else "gloo"
            if backend != want:
                raise ValueError(
                    f"a mesh on {self.device.type} needs the {want} backend; "
                    f"the process group runs {backend}")
        # per axis: (process group or None, member ranks in axis order)
        self._groups = {a: self._axis_group(i, world)
                        for i, a in enumerate(self.axis_names)}

    def _axis_group(self, axis: int, world: int):
        """The processes whose shards share this process's range on the
        other axis, in order along ``axis``; and their process group
        (every group of the mesh is made, in one order, by every process
        of the world, as ``new_group`` requires)."""
        other = 1 - axis
        groups = {}
        for r, blk in self._block.items():
            groups.setdefault(blk[other], []).append(r)
        for key, members in groups.items():
            members.sort(key=lambda r: self._block[r][axis][0])
            counts = {self._block[r][axis][1] - self._block[r][axis][0]
                      for r in members}
            spans = [self._block[r][other] for r in members]
            if len(counts) != 1 or any(s != key for s in spans):
                raise ValueError("the processes along a mesh axis must own "
                                 "equal, aligned blocks")
        mine = groups[self._block[self.rank][other]]
        group = None
        if dist.is_available() and dist.is_initialized():
            for key in sorted(groups, key=lambda k: min(groups[k])):
                members = groups[key]
                if len(members) == world:
                    g = dist.group.WORLD
                elif len(members) > 1:
                    g = dist.new_group(sorted(members))
                else:
                    g = None
                if members is mine:
                    group = g
        return group, mine

    # ---- this process's shards ------------------------------------------
    def local_range(self, axis: str) -> tuple[int, int]:
        """[lo, hi) of this process's shards along ``axis``."""
        return self._block[self.rank][self.axis_names.index(axis)]

    def local_count(self, axis: str) -> int:
        lo, hi = self.local_range(axis)
        return hi - lo

    def axis_index(self, axis: str) -> torch.Tensor:
        """[K] global positions along ``axis`` of the K local shards
        (``lax.axis_index``), int64 on the mesh's device."""
        lo, hi = self.local_range(axis)
        return torch.arange(lo, hi, device=self.device)

    def spans_processes(self) -> bool:
        return len(self._block) > 1

    # ---- collectives over the stacked leading axis -----------------------
    def _check(self, x: torch.Tensor, axis: str) -> None:
        if x.device.type != self.device.type:
            raise ValueError(f"a collective of a mesh on {self.device} got a "
                             f"tensor on {x.device}")
        if x.shape[0] != self.local_count(axis):
            raise ValueError(f"tensor leads with {x.shape[0]} shards, the "
                             f"process holds {self.local_count(axis)} along "
                             f"{axis}")

    def ring(self, x: torch.Tensor, axis: str, wrap: bool = True
             ) -> torch.Tensor:
        """``ppermute`` i -> i+1 along ``axis`` (``wrap``: the last shard
        feeds the first, else the first gets zeros). x: [K, ...]."""
        self._check(x, axis)
        group, peers = self._groups[axis]
        if len(peers) == 1:
            first = x[-1:] if wrap else torch.zeros_like(x[:1])
            return torch.cat([first, x[:-1]])
        me = peers.index(self.rank)
        nxt, prv = peers[(me + 1) % len(peers)], peers[me - 1]
        wire = _to_wire(x[-1])
        recv = torch.empty_like(wire)
        ops = []
        if wrap or me < len(peers) - 1:
            ops.append(dist.P2POp(dist.isend, wire, nxt, group))
        got = wrap or me > 0
        if got:
            ops.append(dist.P2POp(dist.irecv, recv, prv, group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        first = (_from_wire(recv, x.dtype)[None] if got
                 else torch.zeros_like(x[:1]))
        return torch.cat([first, x[:-1]])

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Every shard's x along ``axis``, in axis order: [n_axis, ...]."""
        self._check(x, axis)
        group, peers = self._groups[axis]
        if len(peers) == 1:
            return x
        wire = _to_wire(x)
        parts = [torch.empty_like(wire) for _ in peers]
        dist.all_gather(parts, wire, group=group)
        by_rank = sorted(peers)          # all_gather's order: group ranks
        return _from_wire(torch.cat([parts[by_rank.index(r)]
                                     for r in peers]), x.dtype)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over every shard along ``axis`` (replicated, without
        the shard axis): the local shards in order, then ``all_reduce``
        over the processes of the axis."""
        self._check(x, axis)
        acc = x[0].clone()
        for i in range(1, x.shape[0]):
            acc = acc + x[i]
        group, _ = self._groups[axis]
        if group is not None:
            dist.all_reduce(acc, group=group)
        return acc

    def from_last(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The last shard's x along ``axis``, replicated (without the shard
        axis; ``_psum_from_last``)."""
        return self.all_gather(x, axis)[-1]

    def __repr__(self) -> str:
        dims = " x ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}, {len(self._block)} process(es), {self.device})"


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor every backend carries (gloo has no bool)."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def _from_wire(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(torch.bool) if dtype == torch.bool else x


def make_mesh(dp: Optional[int] = None, sp: Optional[int] = None,
              devices: Optional[Sequence[int]] = None, *,
              device="cuda") -> Mesh:
    """Build a ("dp", "sp") mesh of shards.

    dp shards independent streams/channels (the analog of the reference's
    N FUNcubeBPSKDemod instances, jsdr.java:479-483); sp shards the time
    axis of each stream (overlap-save with halo exchange). Defaults to
    putting every shard on dp.

    ``devices``: the owner of each shard in row-major (dp-major) order, as
    process ranks, the counterpart of the reference's device list (its
    length sets the default shard count); by default the shards are laid
    row-major over the processes of the world, an equal block each, and
    the default shard count is the number of processes. On one process
    any dp x sp grid fits: its shards sit stacked on ``device`` (default
    ``"cuda"``).
    """
    rank, world = _world()
    n = len(devices) if devices is not None else world
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = max(1, n // sp)
    elif sp is None:
        sp = max(1, n // dp)
    if devices is not None:
        if dp * sp > len(devices):
            raise ValueError(f"mesh {dp}x{sp} needs more than "
                             f"{len(devices)} devices")
        owners = np.asarray(list(devices)[:dp * sp]).reshape(dp, sp)
    else:
        if (dp * sp) % world:
            raise ValueError(f"mesh {dp}x{sp} does not split over "
                             f"{world} processes")
        owners = (np.arange(dp * sp) * world // (dp * sp)).reshape(dp, sp)
    return Mesh(owners, ("dp", "sp"), device)


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   device="cuda") -> None:
    """Join a multi-process world (``torch.distributed`` over
    ``tcp://<coordinator>``, "host:port").

    Call once per process before building meshes; after this,
    :func:`make_mesh` lays dp/sp over every process. The backend follows
    ``device``: NCCL for a card (one process per GPU: the process takes
    ``cuda:<process_id % device count>``), gloo for the CPU. No-op when a
    process group already exists or no coordinator is given (one
    process). Every collective times out after 300 s, so a lost peer
    fails rather than hangs.
    """
    if dist.is_initialized() or coordinator is None:
        return
    dev = require_device(device)
    rank = int(process_id or 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=int(num_processes or 1), rank=rank,
        timeout=datetime.timedelta(seconds=300))
