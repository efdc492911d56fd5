"""Checkpoint / resume of stream-processing state — the port of
:mod:`jsdr_tpu.runtime.state`, in the reference's ``.npz`` format.

A state is a tree of tensors: dicts, tuples (``BpskState`` and the other
NamedTuples, ``CF`` pairs), lists and ``None``. It is saved as a flat
list of leaves in ``jax.tree.flatten`` order — dicts by sorted key,
(Named)tuples and lists in field order, ``None`` holding no leaf — beside
``state_version``, ``n_leaves`` and ``meta_json``; so a checkpoint that
either package writes loads in the other, leaf for leaf. ``load_state``
makes the same refusals as the reference, with its messages: another
format version, no version (pre-round-5 files), another leaf count,
another leaf shape or dtype, and declared meta that the file lacks or
contradicts. Leaves are saved from the host copy of each tensor and
loaded onto the device of the matching leaf of ``like``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np
import torch

STATE_VERSION = 2


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def _rebuild(like: Any, leaves: Iterator) -> Any:
    """``like``'s structure with the next leaves of ``leaves`` in its place
    (dicts come back with sorted keys, as ``jax.tree.unflatten`` gives)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(x, leaves) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(x, leaves) for x in like)
    return next(leaves)


def tree_map(fn, *trees: Any) -> Any:
    """The structure of ``trees[0]`` with ``fn`` of each of its leaves and
    the leaves in the same place of the other trees in their place (as
    ``jax.tree.map``). The other trees must hold as many leaves, in
    containers of any type (another package's NamedTuples)."""
    leaves = [tree_leaves(t) for t in trees]
    if len({len(x) for x in leaves}) > 1:
        raise ValueError("tree_map: the trees hold "
                         f"{[len(x) for x in leaves]} leaves")
    return _rebuild(trees[0], map(fn, *leaves))


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_dtype(x: Any) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def save_state(path: str | Path, state: Any,
               meta: Optional[dict] = None) -> None:
    """Save a tree of tensors (or arrays); the structure is rebuilt from a
    tree of the same layout at load. ``meta`` is an optional
    JSON-serialisable dict of configuration facts (e.g.
    ``{"rate": 96000}``) checked against ``expect_meta`` at load."""
    leaves = tree_leaves(state)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta or {}).encode(), np.uint8).copy()
    np.savez(path, state_version=STATE_VERSION, n_leaves=len(leaves),
             **arrays)


def load_state(path: str | Path, like: Any,
               expect_meta: Optional[dict] = None) -> Any:
    """Load into the structure of ``like``, validating version, leaf count,
    per-leaf shape/dtype, and (when given) ``expect_meta`` entries against
    the file's saved meta. Raises ``ValueError`` with a config-mismatch
    diagnosis on any violation. A leaf whose ``like`` is a tensor comes
    back as a tensor on that tensor's device; any other as a numpy
    array."""
    data = np.load(path)
    if "state_version" not in data:
        raise ValueError(
            f"{path}: unversioned (pre-round-5) checkpoint — refusing to "
            "load: BpskState.tu_phase changed units (0.1 Hz NCO "
            "numerators) and would resume with a 10x-misread mix phase. "
            "See docs/MIGRATION.md for the manual migration.")
    version = int(data["state_version"])
    if version != STATE_VERSION:
        raise ValueError(
            f"{path}: checkpoint format v{version}, this build reads "
            f"v{STATE_VERSION} — re-create the checkpoint (or migrate "
            "per docs/MIGRATION.md)")
    n = int(data["n_leaves"])
    like_leaves = tree_leaves(like)
    if n != len(like_leaves):
        raise ValueError(
            f"{path}: checkpoint has {n} state leaves but the current "
            f"configuration expects {len(like_leaves)} — it was written "
            "under a different stage/state layout")
    saved_meta = {}
    if "meta_json" in data:
        saved_meta = json.loads(bytes(data["meta_json"]).decode())
    for key, want in (expect_meta or {}).items():
        if key not in saved_meta:
            raise ValueError(
                f"{path}: checkpoint meta lacks {key!r} (expected "
                f"{want!r}) — it was written by a caller that did not "
                "record this configuration fact")
        if saved_meta[key] != want:
            raise ValueError(
                f"{path}: checkpoint was written with {key}="
                f"{saved_meta[key]!r} but the current configuration has "
                f"{key}={want!r} — resume under the original "
                "configuration or re-create the checkpoint")
    leaves = []
    for i, lk in enumerate(like_leaves):
        arr = data[f"leaf_{i}"]
        shape, dtype = tuple(np.shape(lk)), _np_dtype(lk)
        if tuple(arr.shape) != shape or arr.dtype != dtype:
            raise ValueError(
                f"{path}: state leaf {i} is {arr.dtype}{list(arr.shape)} "
                f"in the checkpoint but {dtype}{list(shape)} "
                "in the current configuration (different n_streams/"
                "stage config?) — resume under the original configuration")
        leaves.append(torch.from_numpy(arr).to(lk.device)
                      if isinstance(lk, torch.Tensor) else arr)
    return _rebuild(like, iter(leaves))
