"""Multi-device execution — the port of :mod:`jsdr_tpu.parallel`: device
meshes of shards (several of them on one device, or spread over
processes with ``torch.distributed``), the sharded telemetry step (DP over
streams, SP over time with ring halos), the tensor-parallel FFT
(``tp.py``), the pipelined chain (``pipeline.py``) and multi-process
worlds (``mesh.init_multihost``, tests/test_torch_multihost.py).
"""

from .mesh import init_multihost, make_mesh  # noqa: F401
from .pipeline import (make_pp_mesh, pipeline_flush, pipeline_init,  # noqa: F401
                       pipelined_telemetry)  # noqa: F401
from .sharded import (sharded_telemetry_step, sharded_spectrum,  # noqa: F401
                      valid_block_samples)  # noqa: F401
from .tp import tp_fft, tp_spectrum  # noqa: F401
