"""Planar complex tensors: ``CF(re, im)``, a pair of float32 tensors.

The counterpart of :mod:`jsdr_tpu.ops.cplx`. The port keeps IQ data
planar, as the reference does, so kernels read two contiguous float32
planes and the public functions of both packages share one layout.
Host boundaries (files, numpy oracles, tests) speak numpy complex64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CF(NamedTuple):
    """A complex tensor as two same-shaped float32 tensors."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape


def from_complex(x, device: torch.device | str) -> CF:
    """Host numpy complex array -> CF of float32 tensors on ``device``."""
    x = np.asarray(x)
    return CF(torch.as_tensor(np.ascontiguousarray(x.real, np.float32),
                              device=device),
              torch.as_tensor(np.ascontiguousarray(x.imag, np.float32),
                              device=device))


def to_complex(x: CF) -> np.ndarray:
    """CF -> host numpy complex64."""
    return (x.re.cpu().numpy() + 1j * x.im.cpu().numpy()).astype(np.complex64)
