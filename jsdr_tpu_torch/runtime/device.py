"""Device selection for the port.

Every function of the port takes its device from its input tensors or
from an explicit argument; nothing defaults to CUDA or to the CPU. This
module turns a device name into a ``torch.device`` and refuses a CUDA
request when no card is present, so a run that asked for the GPU never
quietly runs on the CPU.
"""

from __future__ import annotations

import torch


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
