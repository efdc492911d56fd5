"""Signal-processing primitives of the port and its CUDA kernels
(``csrc/``, built by ``_build``)."""
