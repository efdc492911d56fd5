"""Device selection for the port.

Every function of the port takes its device from its input tensors or
from an explicit argument; nothing defaults to CUDA or to the CPU. This
module turns a device name into a ``torch.device`` and refuses a CUDA
request when no card is present, so a run that asked for the GPU never
quietly runs on the CPU. It also keeps the constant tables that steps
upload to a device (:func:`device_table`), and lets a caller hold them
(:func:`holding`).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

_held = threading.local()


def require_device(name: str) -> torch.device:
    """``torch.device(name)``, raising if ``"cuda"`` is asked for and no
    card is present.

    Also turns TF32 off for matmuls and cuDNN convolutions: the matched
    filter and sync search feed exact contracts (bit decisions, sync hits,
    FEC payloads), and cuDNN runs float32 convolutions in TF32 (about
    three decimal digits) by default.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False (no CUDA card, or a CPU-only PyTorch build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def device_table(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function that builds constant
    device tensors from its (hashable, positional) arguments, so a step
    uploads each table once. Inside :func:`holding` every value it gives
    is also kept in the holder's dict, and a later call under that dict
    returns the kept value without the cache: a CUDA graph captured there
    reads tensors that its owner keeps alive whatever the cache evicts,
    and its capture never uploads (the first, eager, call of the holder
    did)."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def table(*args):
            tables = getattr(_held, "tables", None)
            if tables is None:
                return cached(*args)
            key = (table, args)
            if key not in tables:
                tables[key] = cached(*args)
            return tables[key]

        table.cache_clear = cached.cache_clear
        return table
    return wrap


@contextlib.contextmanager
def holding(tables: dict):
    """Keep in ``tables`` every :func:`device_table` value this thread
    gets until the block ends, and give back those already there."""
    outer = getattr(_held, "tables", None)
    _held.tables = tables
    try:
        yield tables
    finally:
        _held.tables = outer
