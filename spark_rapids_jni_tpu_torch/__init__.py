"""The PyTorch + CUDA port of spark_rapids_jni_tpu.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find.  Columns live in torch tensors on one device;
the row-wire kernels under ``kernels/`` are CUDA C++ written for Hopper
(sm_90a).  This package never imports jax nor anything of
``spark_rapids_jni_tpu``: what it needs from there, it keeps its own copy of.

Data enters through constructors that take ``device=`` (default ``"cuda"``;
pass ``"cpu"`` to run on the host), and every entry point takes ``device=``
with the same default and runs there.  A CUDA tensor either goes through
the hand-written kernel or the call raises: nothing falls back to the CPU.
"""

from . import dtypes
from .columnar.column import Column, PackedByteColumn
from .columnar.table import Table

__version__ = "0.1.0"

__all__ = ["dtypes", "Column", "PackedByteColumn", "Table", "__version__"]
