"""POSIX shared-memory segments as /dev/shm files.

A copy of ``spark_rapids_jni_tpu/bridge/shm.py`` (the same names, layout
and alignment), with two changes for columns of hundreds of megabytes:

- segments are mapped with ``MAP_POPULATE``, so the kernel backs and maps
  every page at ``mmap`` time instead of one fault a 4 KiB page on first
  touch (about half the time to create and fill a 320 MiB segment, and a
  third to attach and read it, on an 8-core x86 host);
- ``SegmentWriter.add`` also takes a tensor (on the CPU or a card) or a
  numpy array, copied into the mapping at ``finish`` without an
  intermediate ``bytes`` object: a card's buffer crosses in one
  device-to-host copy straight into the segment;
- ``write_column`` and ``read_columns`` put the port's columns into a
  segment and take them out (the descriptors of protocol.py), for both
  the client's imports and the server's exports.

On Linux ``shm_open(name)`` IS ``open("/dev/shm" + name)`` — using the file
API directly keeps Python 3.12's multiprocessing resource tracker out of the
picture (it would warn-and-unlink segments the C side still owns) and gives
the C client and this server the same view byte-for-byte.
"""

from __future__ import annotations

import mmap
import os

import torch

from ..columnar import Column
from ..dtypes import DType, TypeId
from . import protocol as P

SHM_DIR = "/dev/shm"

_FLAGS = mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE", 0)


def shm_path(name: str) -> str:
    if "/" in name or name.startswith("."):
        raise ValueError(f"bad shm name {name!r}")
    return os.path.join(SHM_DIR, name)


def create(name: str, size: int) -> mmap.mmap:
    fd = os.open(shm_path(name), os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    try:
        os.ftruncate(fd, size)
        return mmap.mmap(fd, size, flags=_FLAGS)
    finally:
        os.close(fd)


def attach(name: str) -> mmap.mmap:
    fd = os.open(shm_path(name), os.O_RDWR)
    try:
        size = os.fstat(fd).st_size
        return mmap.mmap(fd, size, flags=_FLAGS)
    finally:
        os.close(fd)


def unlink(name: str) -> None:
    try:
        os.unlink(shm_path(name))
    except FileNotFoundError:
        pass


def align8(x: int) -> int:
    return (x + 7) & ~7


def _nbytes(raw) -> int:
    if isinstance(raw, torch.Tensor):
        return raw.numel() * raw.element_size()
    return raw.nbytes if hasattr(raw, "nbytes") else len(raw)


class SegmentWriter:
    """Accumulates 8-byte-aligned buffers, then writes one shm segment.

    The single definition of the segment layout both bridge sides use (the
    client for imports, the server for exports) — keep it in lockstep with
    the (offset, length) descriptors in protocol.py.
    """

    def __init__(self, name: str):
        self.name = name
        self.chunks: list[tuple[int, object]] = []
        self.size = 0

    def add(self, raw) -> tuple[int, int]:
        """Reserve the next 8-byte-aligned range for ``raw`` (bytes, a
        numpy array, or a tensor on any device); returns its (offset,
        length) in bytes."""
        off = align8(self.size)
        n = _nbytes(raw)
        self.chunks.append((off, raw))
        self.size = off + n
        return off, n

    def finish(self) -> mmap.mmap:
        m = create(self.name, max(self.size, 1))
        for off, raw in self.chunks:
            n = _nbytes(raw)
            if n == 0:
                continue
            if isinstance(raw, torch.Tensor):
                raw = raw.contiguous().reshape(-1).view(torch.uint8)
                if raw.device.type != "cpu":
                    # one device-to-host copy into the mapping
                    view = torch.frombuffer(m, dtype=torch.uint8, count=n,
                                            offset=off)
                    view.copy_(raw)
                    del view  # releases the mapping's buffer export
                    continue
                raw = raw.numpy()  # a host memcpy beats a torch copy here
            m[off:off + n] = memoryview(raw).cast("B")
        self.chunks = []
        return m


def read_tensor(buf, off: int, nbytes: int, dtype: torch.dtype,
                dev: torch.device) -> torch.Tensor:
    """``nbytes`` of the segment at ``off`` as a ``dtype`` tensor on
    ``dev``: one copy (host to device, or a host clone), and no view of
    the mapping outlives the call, so the caller can close it."""
    width = torch.empty((), dtype=dtype).element_size()
    if nbytes % width:
        raise ValueError(f"buffer of {nbytes} bytes is not a whole number "
                         f"of {dtype} values")
    if nbytes == 0:
        return torch.empty(0, dtype=dtype, device=dev)
    view = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes,
                            offset=off).view(dtype)
    out = view.to(dev) if dev.type == "cuda" else view.clone()
    del view
    return out


def read_columns(desc: bytes, off: int, ncols: int, buf,
                 dev: torch.device) -> tuple[list[Column], int]:
    """Columns on ``dev`` from ``ncols`` descriptors in ``desc`` (from
    ``off``) naming buffers of the mapped segment ``buf``; returns them
    and the offset past the last descriptor."""
    cols = []
    for _ in range(ncols):
        tid, scale, n, hasv, doff, dlen, voff, vlen = P.COLDESC.unpack_from(
            desc, off)
        off += P.COLDESC.size
        dtype = DType(TypeId(tid), scale)
        validity = None
        if hasv:
            if vlen != n:
                raise ValueError(f"validity of {vlen} bytes for {n} rows")
            validity = read_tensor(buf, voff, vlen, torch.uint8, dev) \
                .to(torch.bool)
        if dtype.is_string:
            ooff, olen = P.STRDESC.unpack_from(desc, off)
            off += P.STRDESC.size
            if olen != 4 * (n + 1):
                raise ValueError(f"offsets of {olen} bytes for {n} rows")
            cols.append(Column(
                dtype, data=read_tensor(buf, doff, dlen, torch.uint8, dev),
                validity=validity,
                offsets=read_tensor(buf, ooff, olen, torch.int32, dev)))
            continue
        if dlen != n * dtype.itemsize:
            raise ValueError(f"{dtype!r} data of {dlen} bytes for {n} rows")
        data = read_tensor(buf, doff, dlen, dtype.torch_dtype, dev)
        if dtype.id == TypeId.DECIMAL128:
            data = data.view(n, 2)  # (lo, hi) limbs
        cols.append(Column(dtype, data=data, validity=validity))
    return cols, off


def write_column(seg: SegmentWriter, col: Column) -> bytes:
    """Add one column's buffers to ``seg``; returns its descriptor."""
    n = col.size
    hasv = col.validity is not None
    voff = vlen = 0
    if hasv:
        voff, vlen = seg.add(col.validity.to(torch.uint8))
    if col.dtype.is_string:
        doff, dlen = seg.add(col.data)
        ooff, olen = seg.add(col.offsets.to(torch.int32))
        return P.COLDESC.pack(int(col.dtype.id), col.dtype.scale, n, hasv,
                              doff, dlen, voff, vlen) + \
            P.STRDESC.pack(ooff, olen)
    # fixed width: the device buffer's bytes are the wire bytes (FLOAT64
    # values and the JAX package's int64 bit patterns are the same bytes;
    # DECIMAL128 limbs are cudf's __int128 layout); the segment writer
    # copies them from the card straight into the mapping
    doff, dlen = seg.add(col.data)
    return P.COLDESC.pack(int(col.dtype.id), col.dtype.scale, n, hasv,
                          doff, dlen, voff, vlen)
