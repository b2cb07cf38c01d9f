"""Build and load the port's CUDA sources: one helper for every wrapper.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into
``_build/`` at first use, as a shared library with a plain C interface, and
loaded through ``ctypes``.  The library's name carries a hash of the source
and the flags, so an edited source builds anew; the write is atomic, so a
concurrent build sees a whole file.  Nothing is built when a module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from ..utils import tracing

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # torch's own lookup: CUDA_HOME / CUDA_PATH, then nvcc's directory,
    # then /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME
    path = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                           "toolkit to build")
    return str(path)


def build(name: str, verbose: bool = False) -> dict:
    """Compile ``csrc/<name>.cu`` if its library is not built yet.

    Returns ``{"path", "seconds", "built", "log"}``; ``log`` holds the
    compiler's output (``-Xptxas -v`` when ``verbose``, which always
    rebuilds so the log is there).
    """
    source = CSRC / f"{name}.cu"
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists() and not verbose:
        return {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "built": True,
            "log": proc.stdout + proc.stderr}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first call).

    ``signatures`` maps each exported C function to its ``argtypes``; every
    function returns the ``cudaError_t`` of its launch as an int.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)["path"])
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def launch(lib_name: str, signatures: dict, fn_name: str, device, *args):
    """Call ``fn_name`` of library ``lib_name`` on ``device``'s current
    stream (passed last); raises if the launch reports a CUDA error.  Each
    launch adds one to ``kernel_device.<fn_name>.<device>`` of
    ``utils.tracing``: the card its tensors lie on."""
    fn = getattr(load(lib_name, signatures), fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed with CUDA "
                           f"error {err}")
    tracing.count(f"kernel_device.{fn_name}.{device}")
