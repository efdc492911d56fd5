"""jsdr_tpu_torch — the PyTorch/CUDA port of :mod:`jsdr_tpu`.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``demod/``, ``fec/``, ``app/``) so each module's counterpart is
found by name. Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path is a hand-written CUDA C++ kernel for Hopper (``sm_90a``)
under ``ops/csrc/``, built with ``nvcc`` at first use and bound with
``ctypes`` (``ops/_build.py``). Each kernel wrapper runs its plain
PyTorch version for CPU tensors and launches its kernel for CUDA
tensors; there is no fallback between the two.

The package never imports jax, nor anything of ``jsdr_tpu``: the
JAX-free host modules it needs (``fec.tables``, ``fec.ref_numpy``,
``io.convert``, ``io.sources``, ``io.flac``, ``io.framer``,
``io.recorder``, ``io.live``, ``io.fcd``, ``runtime.pubsub``,
``runtime.log``, ``runtime.config``, ``display.waterfall``,
``display.phase_scope``, ``display.render``, the CLI's host helpers and
the shell's model ``app.tui.TuiModel``) are copies, held equal to the
reference's by tests/test_torch_host_copies.py.

Ported so far: the telemetry decode path in every tuning mode —
``demod.bpsk.bpsk_block_batch`` (with ``BpskConfig.fuse_mf``, the FFT
auto-tuner ``demod.fft_tuner``) and ``fec.decoder.fec_decode`` — the
flagship spectrum + telemetry step ``demod.bpsk.bpsk_block_batch_spectrum``
with ``ops.spectrum`` (``spectrum_block``, ``spectrum_wide``), the
AM/NFM/WFM audio demodulator ``demod.am_fm`` (torch ops, no kernel of its
own) with ``ops.fir``'s band-pass design, the streaming Session
(``runtime.executor`` with its spectrum, telemetry, demod, audio-sink and
recorder stages, ``runtime.state``, ``io.convert_device``), the
interactive shell ``app.tui`` (``StageManager`` and ``PipelineThread``
on a torch device), the ``compat_scan`` per-sample timing path, the
native IO library ``io.native`` (its own build of the C++ sources), and
the ``jsdr-tpu-torch`` commands ``spectrum``, ``demod``, ``telemetry``,
``synth``, ``record``, ``phase``, ``fir``, ``fcd`` and ``ui`` with
``--config``. All six TPU kernels of the JAX package have their CUDA
counterpart. Every single-device module is ported; ROADMAP.md lists what
is still to port: ``parallel/`` (the device mesh of ``--mesh``,
``TelemetryStage(mesh=...)`` and the shell's ``StageManager(mesh=...)``).
"""

__version__ = "0.1.0"
