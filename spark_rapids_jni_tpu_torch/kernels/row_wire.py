"""K1/K2: the row-wire interleave and its inverse as hand-written CUDA kernels.

They replace the TPU kernels ``_interleave_kernel`` and
``_deinterleave_kernel`` of ``spark_rapids_jni_tpu/ops/pallas_kernels.py``.
Both move 32-bit words between the word planes ``int32[nwords, n]`` that
RowConversion builds column by column and the packed-row wire
``int32[n * nwords]`` (row-major, ``nwords`` words per row): a transpose and
its inverse.  Words are ``torch.int32`` tensors, bit-identical to u32.

The CUDA source is ``csrc/row_wire.cu`` (its header gives the bound and the
design).  ``kernels/nvcc.py`` compiles it for ``sm_90a`` into ``_build/`` at
first use and loads it through ``ctypes``; nothing is built when this module
is imported.

Each wrapper takes the plain PyTorch version only for a tensor that lies on
the CPU.  For a CUDA tensor it launches the kernel or raises; there is no
fallback.  Every launch adds one to the counter ``kernel.<wrapper name>``
of ``utils.tracing``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from . import nvcc

GROUP = 32  # rows per wire group; row counts must be a multiple of it

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p]
_SIGNATURES = {"srjt_interleave_planes": _ARGS,
               "srjt_deinterleave_wire": _ARGS}


def build(verbose: bool = False) -> dict:
    """Compile ``csrc/row_wire.cu`` if needed (see ``nvcc.build``)."""
    return nvcc.build("row_wire", verbose)


def _launch(name: str, src: torch.Tensor, dst: torch.Tensor, n: int,
            nwords: int) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{src.device}")
    if n == 0 or nwords == 0:
        return
    nvcc.launch("row_wire", _SIGNATURES, "srjt_" + name, src.device,
                src.data_ptr(), dst.data_ptr(), n, nwords)
    tracing.count("kernel." + name)


def launches(name: str) -> int:
    """Launch count of wrapper ``name`` ("interleave_planes" or
    "deinterleave_wire") since the counters were last reset."""
    return tracing.counter_value("kernel." + name)


# -- plain versions (the CPU path, and the oracle the kernels are held to) --

def interleave_planes_plain(mat: torch.Tensor) -> torch.Tensor:
    return mat.t().contiguous().view(-1)


def deinterleave_wire_plain(wire: torch.Tensor, nwords: int) -> torch.Tensor:
    return wire.view(-1, nwords).t().contiguous()


# -- wrappers ---------------------------------------------------------------

def _check_words(t: torch.Tensor, what: str, ndim: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{what} must be int32 words, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {ndim}-D tensor")


def interleave_planes(mat: torch.Tensor) -> torch.Tensor:
    """Word planes ``int32[nwords, n]`` -> wire ``int32[n * nwords]``.

    ``n`` must be a multiple of 32, the wire's row-group width (the 32-row
    batch alignment RowConversion keeps).
    """
    _check_words(mat, "planes", 2)
    nwords, n = mat.shape
    if n % GROUP:
        raise ValueError(f"n={n} not a multiple of {GROUP}")
    if mat.device.type == "cpu":
        return interleave_planes_plain(mat)
    wire = torch.empty(n * nwords, dtype=torch.int32, device=mat.device)
    _launch("interleave_planes", mat, wire, n, nwords)
    return wire


def deinterleave_wire(wire: torch.Tensor, nwords: int) -> torch.Tensor:
    """Wire ``int32[n * nwords]`` -> word planes ``int32[nwords, n]``."""
    _check_words(wire, "wire", 1)
    if nwords <= 0 or wire.shape[0] % nwords:
        raise ValueError(f"wire of {wire.shape[0]} words is not whole rows "
                         f"of {nwords} words")
    n = wire.shape[0] // nwords
    if n % GROUP:
        raise ValueError(f"n={n} not a multiple of {GROUP}")
    if wire.device.type == "cpu":
        return deinterleave_wire_plain(wire, nwords)
    mat = torch.empty((nwords, n), dtype=torch.int32, device=wire.device)
    _launch("deinterleave_wire", wire, mat, n, nwords)
    return mat
