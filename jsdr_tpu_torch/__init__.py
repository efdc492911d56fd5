"""jsdr_tpu_torch — the PyTorch/CUDA port of :mod:`jsdr_tpu`.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``demod/``, ``fec/``, ``app/``) so each module's counterpart is
found by name. Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path is a hand-written CUDA C++ kernel for Hopper (``sm_90a``)
under ``ops/csrc/``, built with ``nvcc`` at first use and bound with
``ctypes`` (``ops/_build.py``). Each kernel wrapper runs its plain
PyTorch version for CPU tensors and launches its kernel for CUDA
tensors; there is no fallback between the two.

The package never imports jax. JAX-free host modules of ``jsdr_tpu``
(``fec.tables``, ``fec.ref_numpy``, ``io.convert``, ``io.sources`` and
the CLI's host helpers) are imported, not copied.

Ported so far: the telemetry decode path in "pattern" tuning mode —
``demod.bpsk.bpsk_block_batch`` and ``fec.decoder.fec_decode`` — and the
``jsdr-tpu-torch telemetry`` command. ROADMAP.md lists what is still to
port.
"""

__version__ = "0.1.0"
