"""sequencealigning_tpu_torch: the PyTorch + CUDA port of sequencealigning_tpu.

The JAX package stays the reference.  This package imports ``torch`` and
never ``jax``, and nothing of the JAX package: it carries its own copies of
the host modules it needs (``config``, ``errors``, ``io``, ``native``, the
host walkers in ``ops.traceback``, ``ops.dirbits``, ``ops.oracle_gotoh``,
``utils``) and brings its own ops, models and CLI, laid out like the JAX
package's.  Its kernels are hand-written CUDA for Hopper (``csrc/``), built
on first use; on CPU tensors every op runs its plain PyTorch version.
"""

from sequencealigning_tpu_torch import config, errors, io, parallel

__version__ = "0.1.0"

__all__ = ["config", "errors", "io", "parallel", "__version__"]
