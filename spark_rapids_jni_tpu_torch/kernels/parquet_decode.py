"""K3, W1, W2: the Parquet page-decode kernels, hand-written in CUDA.

- ``plain_gather`` (K3) replaces the TPU kernel ``_asm_kernel`` of
  ``spark_rapids_jni_tpu/ops/parquet_decode.py`` together with the byte
  gather of ``_plain_gather`` around it: the PLAIN values of page planes,
  read at per-slot offsets and assembled into int32 or int64 words in one
  pass.
- ``snappy_walk`` (W1) is the snappy token walk that the JAX package
  writes as a vmapped ``while_loop`` (``_snappy_pass1``): one block per
  page row chases the token headers through a shared-memory window and
  writes the compact token table.
- ``hybrid_decode`` (W2) decodes RLE/bit-packed hybrid streams to values
  in one call: the run-header walk of ``_hybrid_pass1`` (the same windowed
  chase, into a compact run table) and the per-slot expansion of
  ``_rle_hybrid``, two launches from one source.

The CUDA source is ``csrc/parquet_decode.cu`` (its header gives the bounds
and the design).  ``kernels/nvcc.py`` compiles it for ``sm_90a`` into
``_build/`` at first use and loads it through ``ctypes``.

Each wrapper takes its plain version only for tensors that lie on the CPU.
For CUDA tensors it launches the kernel or raises; there is no fallback.
Every wrapper call that launches adds one to the counter
``kernel.<wrapper name>`` of ``utils.tracing``.  The plain walks
(``snappy_walk_plain``, ``hybrid_walk_plain``) are Python loops over pages
and tokens (or runs) that do the JAX package's 32-bit arithmetic with its
wrap-around, so a torn page walks the same way everywhere; the torch
helpers below them (``last_mark`` and its kin) are the plain expansion's
building blocks, which ``ops/parquet_decode.py`` shares.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import tracing
from . import nvcc

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "srjt_plain_gather": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P],
    "srjt_snappy_walk": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "srjt_hybrid_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                           _P],
    "srjt_hop_probe": [_I, _P, _P],
}


def build(verbose: bool = False) -> dict:
    """Compile ``csrc/parquet_decode.cu`` if needed (see ``nvcc.build``)."""
    return nvcc.build("parquet_decode", verbose)


def launches(name: str) -> int:
    """Launch count of wrapper ``name`` ("plain_gather", "snappy_walk" or
    "hybrid_decode") since the counters were last reset."""
    return tracing.counter_value("kernel." + name)


def _launch(name: str, device: torch.device, *args) -> None:
    nvcc.launch("parquet_decode", _SIGNATURES, "srjt_" + name, device, *args)
    tracing.count("kernel." + name)


def _check(t: torch.Tensor, what: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {ndim}-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{t.device}")
    return True


def _w32(x: int) -> int:
    """Python int -> the int32 it wraps to (the JAX package's int32 math)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _clip(x: int, lo: int, hi: int) -> int:
    return lo if x < lo else (hi if x > hi else x)


_M32 = 0xFFFFFFFF


# -- torch building blocks of the plain versions ----------------------------

def gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(t, idx, axis=1)`` (idx broadcast over t's rows)."""
    if idx.shape[0] != t.shape[0]:
        idx = idx.expand(t.shape[0], -1)
    return torch.gather(t, 1, idx.to(torch.int64))


def scatter_drop(width: int, fill: int, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``full((R, width), fill).at[row, idx].set(vals, mode="drop")`` with
    JAX's index rules (a negative index counts from the end; anything still
    outside ``[0, width)`` is dropped), without a host sync: dropped writes
    go to a spare column that is cut off."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + width, idx)
    idx = torch.where((idx >= 0) & (idx < width), idx,
                      torch.full_like(idx, width))
    out = torch.full((idx.shape[0], width + 1), fill, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_(1, idx, vals)[:, :width]


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along each row of ``x[R, W]``.

    Taken over the flattened planes and rebased per row: the planes are a
    few rows of up to millions of slots, and a scan along a short innermost
    dimension runs one row per block, which leaves most of a GPU idle."""
    r, w = x.shape
    flat = torch.cumsum(x.reshape(-1), 0, dtype=torch.int32).view(r, w)
    base = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    return flat - base[:, None]


def last_mark(mark: torch.Tensor) -> torch.Tensor:
    """``clip(cummax(mark, dim=1), 0, W - 1)`` for the mark planes of the
    two walks, where every non-negative entry holds its own slot index (or,
    in the last slot only, more): the last marked slot at or before each
    slot, 0 where there is none.  Computed as a prefix count of the marks,
    a scatter of each marked slot to its rank and a gather, which is the
    same integers without ``cummax``'s pass over (value, index) pairs."""
    r, w = mark.shape
    marked = mark >= 0
    cnt = row_cumsum(marked)
    iota = torch.arange(w, dtype=torch.int32, device=mark.device).expand(r, w)
    pos = scatter_drop(w, 0, torch.where(marked, cnt - 1, w), iota)
    last = gather_rows(pos, (cnt - 1).clamp(min=0))
    return torch.where(cnt > 0, last, torch.zeros_like(last))


# -- K3: PLAIN gather + word assembly ---------------------------------------

def plain_gather_plain(unc: torch.Tensor, voff: torch.Tensor,
                       nn: torch.Tensor, size: int) -> torch.Tensor:
    """The plain version of K3 (``_plain_gather`` of the JAX package for
    4- and 8-byte values): a byte gather at 32-bit wrapping offsets, each
    clipped to the row, then a little-endian ``view``."""
    r, ub = unc.shape
    v = nn.shape[1]
    base = voff[:, None] + nn.clamp(min=0) * size            # int32, wraps
    offs = base[:, :, None] + torch.arange(size, dtype=torch.int32,
                                           device=unc.device)
    offs = offs.clamp(0, ub - 1).reshape(r, v * size).to(torch.int64)
    b = torch.gather(unc, 1, offs).contiguous()
    return b.view(torch.int32 if size == 4 else torch.int64).reshape(r, v)


def plain_gather(unc: torch.Tensor, voff: torch.Tensor, nn: torch.Tensor,
                 size: int) -> torch.Tensor:
    """PLAIN ``size``-byte values (4 or 8) of the page planes
    ``unc uint8[R, UB]``: slot ``(r, v)`` reads bytes
    ``clip(voff[r] + max(nn[r, v], 0) * size + k, 0, UB - 1)``.
    ``voff int32[R]``, ``nn int32[R, V]``.  Returns int32[R, V] (size 4) or
    int64[R, V] (size 8), the little-endian words."""
    if size not in (4, 8):
        raise ValueError(f"plain_gather: size must be 4 or 8, got {size}")
    dev = unc.device
    _check(unc, "unc", torch.uint8, 2, dev)
    _check(voff, "voff", torch.int32, 1, dev)
    _check(nn, "nn", torch.int32, 2, dev)
    r, ub = unc.shape
    if voff.shape[0] != r or nn.shape[0] != r or ub < 1:
        raise ValueError("plain_gather: unc, voff and nn disagree on rows")
    if not _on_cuda(unc, "plain_gather"):
        return plain_gather_plain(unc, voff, nn, size)
    v = nn.shape[1]
    out = torch.empty((r, v), dtype=torch.int32 if size == 4 else torch.int64,
                      device=dev)
    if r * v:
        _launch("plain_gather", dev, unc.data_ptr(), voff.data_ptr(),
                nn.data_ptr(), out.data_ptr(), r * v, v, ub, size)
    return out


# -- W1: snappy token walk --------------------------------------------------

def snappy_walk_plain(comp: torch.Tensor, clen: torch.Tensor,
                      ulen: torch.Tensor, ub: int, tb: int):
    """The plain version of W1 (``_snappy_pass1`` of the JAX package), one
    page row at a time: ``(dk, ls, co)`` int32[R, tb] — each token's output
    position, literal source offset and copy offset.  Unused slots keep
    ``dk = ub``, ``ls = co = 0``."""
    r, cb = comp.shape
    rows = comp.cpu().numpy()
    cls, uls = clen.cpu().tolist(), ulen.cpu().tolist()
    dk = np.full((r, tb), ub, np.int32)
    ls = np.zeros((r, tb), np.int32)
    co = np.zeros((r, tb), np.int32)
    for i in range(r):
        row = rows[i].tobytes()

        def rd(pos):
            return row[_clip(pos, 0, cb - 1)]
        c = [rd(k) >> 7 for k in range(5)]
        s = 1 + c[0] + c[0] * c[1] + c[0] * c[1] * c[2] \
            + c[0] * c[1] * c[2] * c[3]
        d, k = 0, 0
        while s < cls[i] and d < uls[i] and k < tb:
            tag = rd(s)
            kind, lcode = tag & 3, tag >> 2
            nlb = _clip(lcode - 59, 0, 4)
            e = [rd(_w32(s + 1 + j)) for j in range(4)]
            extra = _w32(e[0] | e[1] << 8 | e[2] << 16 | e[3] << 24)
            emask = -1 if nlb >= 4 else (1 << (8 * min(nlb, 3))) - 1
            lit_len = lcode + 1 if lcode < 60 else _w32((extra & emask) + 1)
            if kind == 0:
                dk[i, k], ls[i, k], co[i, k] = d, _w32(s + 1 + nlb), 0
                s = _w32(s + 1 + nlb + lit_len)
                d = _w32(d + lit_len)
            else:
                off = (((tag & 0xE0) << 3) | e[0] if kind == 1 else
                       e[0] | e[1] << 8 if kind == 2 else extra)
                dk[i, k], ls[i, k], co[i, k] = d, 0, max(off, 1)
                s = _w32(s + (2, 3, 5)[kind - 1])
                d = _w32(d + (((tag >> 2) & 7) + 4 if kind == 1
                              else lcode + 1))
            k += 1
    return tuple(torch.from_numpy(a).to(comp.device) for a in (dk, ls, co))


def snappy_walk(comp: torch.Tensor, clen: torch.Tensor, ulen: torch.Tensor,
                ub: int, tb: int):
    """Walk the snappy token headers of each page row of ``comp
    uint8[R, CB]`` (``clen``/``ulen`` int32[R]: compressed and uncompressed
    bytes) -> ``(dk, ls, co)`` int32[R, tb]; see ``snappy_walk_plain``."""
    dev = comp.device
    _check(comp, "comp", torch.uint8, 2, dev)
    _check(clen, "clen", torch.int32, 1, dev)
    _check(ulen, "ulen", torch.int32, 1, dev)
    r, cb = comp.shape
    if clen.shape[0] != r or ulen.shape[0] != r or cb < 1 or tb < 1:
        raise ValueError("snappy_walk: comp, clen and ulen disagree on rows")
    if not _on_cuda(comp, "snappy_walk"):
        return snappy_walk_plain(comp, clen, ulen, ub, tb)
    # the kernel writes every entry, the unused ones included
    dk, ls, co = (torch.empty((r, tb), dtype=torch.int32, device=dev)
                  for _ in range(3))
    if r:
        _launch("snappy_walk", dev, comp.data_ptr(), clen.data_ptr(),
                ulen.data_ptr(), r, cb, tb, ub, dk.data_ptr(), ls.data_ptr(),
                co.data_ptr())
    return dk, ls, co


# -- W2: RLE / bit-packed hybrid decode ---------------------------------------

def hybrid_walk_plain(data: torch.Tensor, start: torch.Tensor,
                      end: torch.Tensor, bw: torch.Tensor, n: torch.Tensor,
                      vb: int):
    """The plain version of W2 (``_hybrid_pass1`` of the JAX package):
    ``(mark int32, pk bool, bb int32, rv int32)`` [R, vb] — at each run's
    first value slot ``v`` (clipped to ``vb - 1``; the last write wins):
    ``v``, whether the run is bit-packed, the bit offset of its payload and
    the RLE value (u32 bits)."""
    r, ub = data.shape
    rows = data.cpu().numpy()
    starts, ends = start.cpu().tolist(), end.cpu().tolist()
    bws, ns = bw.cpu().tolist(), n.cpu().tolist()
    mark = np.full((r, vb), -1, np.int32)
    pk = np.zeros((r, vb), np.bool_)
    bb = np.zeros((r, vb), np.int32)
    rv = np.zeros((r, vb), np.int32)
    for i in range(r):
        row = rows[i].tobytes()

        def rd(pos):
            return row[_clip(pos, 0, ub - 1)]
        w = bws[i]
        bwb = _w32(w + 7) >> 3
        vmask = -1 if bwb >= 4 else (1 << (8 * min(bwb, 3))) - 1
        s, v, it = starts[i], 0, 0
        while s < ends[i] and v < ns[i] and it < ns[i]:
            b = [rd(_w32(s + k)) for k in range(5)]
            c = [x >> 7 for x in b]
            seg = [x & 0x7F for x in b]
            h = _w32(seg[0] + c[0] * (seg[1] << 7)
                     + c[0] * c[1] * (seg[2] << 14)
                     + c[0] * c[1] * c[2] * (seg[3] << 21)
                     + c[0] * c[1] * c[2] * c[3] * _w32(seg[4] << 28))
            hlen = 1 + c[0] + c[0] * c[1] + c[0] * c[1] * c[2] \
                + c[0] * c[1] * c[2] * c[3]
            dp = _w32(s + hlen)
            packed = (h & 1) == 1
            groups = h >> 1
            d = [rd(_w32(dp + k)) for k in range(4)]
            raw = _w32(d[0] | d[1] << 8 | d[2] << 16 | d[3] << 24)
            cnt = max(_w32(groups * 8) if packed else groups, 1)
            adv = _w32(groups * w) if packed else bwb
            vc = _clip(v, 0, vb - 1)
            mark[i, vc], pk[i, vc] = v, packed
            bb[i, vc], rv[i, vc] = _w32(dp * 8), raw & vmask
            s, v, it = _w32(dp + adv), _w32(v + cnt), it + 1
    return tuple(torch.from_numpy(a).to(data.device)
                 for a in (mark, pk, bb, rv))


def hybrid_decode_plain(data: torch.Tensor, start: torch.Tensor,
                        end: torch.Tensor, bw: torch.Tensor, n: torch.Tensor,
                        vb: int) -> torch.Tensor:
    """The plain version of W2: ``hybrid_walk_plain``'s run planes, then
    each value slot takes its run (``last_mark``, the JAX ``cummax``) and
    extracts its bits, as ``_rle_hybrid`` of the JAX package does."""
    r, ub = data.shape
    mark, pk, bb, rv = hybrid_walk_plain(data, start, end, bw, n, vb)
    ridc = last_mark(mark)  # each value slot's run
    pk2 = gather_rows(pk, ridc)
    bb2 = gather_rows(bb, ridc)
    rv2 = gather_rows(rv, ridc).to(torch.int64) & _M32
    iota = torch.arange(vb, dtype=torch.int32, device=data.device)[None, :]
    bit = bb2 + (iota - ridc) * bw[:, None]                 # int32, wraps
    byte0 = bit >> 3
    sh = (bit & 7).to(torch.int64)
    by = [gather_rows(data, (byte0 + k).clamp(0, ub - 1)).to(torch.int64)
          for k in range(5)]
    lo = by[0] | by[1] << 8 | by[2] << 16 | by[3] << 24
    # straddle byte: (hi << (32 - sh)) is taken mod 32 and selected away at
    # sh == 0, as in the JAX package
    hi = torch.where(sh == 0, torch.zeros_like(lo),
                     (by[4] << ((32 - sh) & 31)) & _M32)
    bw64 = bw.to(torch.int64)
    bwm = torch.where(bw64 >= 32, torch.full_like(bw64, _M32),
                      ((1 << bw64.clamp(max=31)) - 1) & _M32)
    val = ((lo >> sh) | hi) & bwm[:, None]
    val = torch.where(pk2, val, rv2)
    return torch.where(iota < n[:, None], val, torch.zeros_like(val))


def hybrid_decode(data: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                  bw: torch.Tensor, n: torch.Tensor, vb: int) -> torch.Tensor:
    """Decode one RLE/bit-packed hybrid stream per row of ``data
    uint8[R, UB]``: bytes ``[start, end)``, bit width ``bw``, ``n`` values
    (all int32[R]) -> int64[R, vb] holding u32 values, zero at slots
    ``>= n``; see ``hybrid_decode_plain``.  On the card: the run walk, then
    the expansion (two launches, one count)."""
    dev = data.device
    _check(data, "data", torch.uint8, 2, dev)
    for t, what in ((start, "start"), (end, "end"), (bw, "bw"), (n, "n")):
        _check(t, what, torch.int32, 1, dev)
        if t.shape[0] != data.shape[0]:
            raise ValueError(f"hybrid_decode: {what} disagrees on rows")
    r, ub = data.shape
    if ub < 1 or vb < 1:
        raise ValueError("hybrid_decode: empty rows")
    if not _on_cuda(data, "hybrid_decode"):
        return hybrid_decode_plain(data, start, end, bw, n, vb)
    out = torch.empty((r, vb), dtype=torch.int64, device=dev)
    # a rising walk writes at most one run a slot and one a stream byte
    cap = min(vb, ub)
    tbl = torch.empty((r, cap), dtype=torch.int64, device=dev)
    meta = torch.empty((r, 2), dtype=torch.int32, device=dev)
    if r:
        _launch("hybrid_decode", dev, data.data_ptr(), start.data_ptr(),
                end.data_ptr(), bw.data_ptr(), n.data_ptr(), r, ub, vb, cap,
                tbl.data_ptr(), meta.data_ptr(), out.data_ptr())
    return out


# -- the walks' chain step, for timing -------------------------------------

def hop_probe(hops: int, device="cuda") -> torch.Tensor:
    """Launch the chain probe on the card: one thread follows ``hops``
    next-pointers through a shared-memory table, one dependent load a hop,
    which is what a windowed walk pays a header while it takes one hop a
    load.  Time it to get the cost of a hop.  No decode launches it, so it
    has no launch counter and no plain version."""
    dev = torch.device(device)
    if dev.type != "cuda" or hops < 1:
        raise ValueError(f"hop_probe: needs a CUDA device and hops >= 1, "
                         f"got {dev} and {hops}")
    out = torch.empty(1, dtype=torch.int32, device=dev)
    nvcc.launch("parquet_decode", _SIGNATURES, "srjt_hop_probe", dev, hops,
                out.data_ptr())
    return out
