"""Parallel layer: device lists, the data-parallel batch runner and the
streaming pipeline (the port of sequencealigning_tpu/parallel).

Pairs are split by rows over a list of devices (parallel.mesh.make_mesh:
every local CUDA device, or devices the caller names, such as
``["cpu"] * 8``), the results merged on the first device and, across
processes, with ``torch.distributed`` collectives (multihost_init).  One pair's DP matrix
can also be spread over the devices (seqpar_fill, seqpar_align).
"""

from sequencealigning_tpu_torch.parallel.mesh import (
    make_mesh,
    multihost_init,
)
from sequencealigning_tpu_torch.parallel.runner import DataParallelRunner
from sequencealigning_tpu_torch.parallel.seqpar import (
    seqpar_align,
    seqpar_fill,
)
from sequencealigning_tpu_torch.parallel.streaming import stream_align

__all__ = ["make_mesh", "multihost_init", "DataParallelRunner",
           "stream_align", "seqpar_fill", "seqpar_align"]
