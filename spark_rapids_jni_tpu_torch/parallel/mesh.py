"""Meshes of shards and row-sharded tables.

The port of ``spark_rapids_jni_tpu/parallel/mesh.py``.  The JAX package runs
one controller over an N-device mesh; the port runs one process a rank
(``parallel/ranks.py``), each rank holding a contiguous block of the N
*shards* on its own device: rank r of W owns shards ``[r * N / W, (r + 1)
* N / W)``.  Without a group (or with one rank) one process holds every
shard on one device.  A rank's row-sharded table is its block of the
global table, whose rows split into N equal contiguous blocks (shard s
owns rows ``[s * n / N, (s + 1) * n / N)``), exactly JAX's global view of a
``P(axis)``-sharded array: the ranks' blocks in rank order are the
one-process table.  Per-shard work runs batched along the rank's shard
axis (parallel/shuffle.py), never as a loop of launches; rows cross ranks
only in the collectives of ``ranks``.

A 2-D ``dcn x shard`` mesh (``make_multislice_mesh``) shards rows over both
axes, slice-major, as ``P((dcn, shard))`` does in JAX.  Over a group its
grid is laid slice-major over the ranks as the 1-D mesh's shards are: rank
r of W holds the contiguous block of ``n_slices * chips_per_slice / W``
shards, so a slice may span ranks and a rank may hold parts of two
slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import device as _device
from ..columnar import Column, Table
from . import ranks as _ranks

ROW_AXIS = "shard"
DCN_AXIS = "dcn"


@dataclass(frozen=True)
class Mesh:
    """``sizes[i]`` shards along ``axis_names[i]``; this process holds its
    rank's block of them on ``device`` (every shard without ``ranks``)."""

    sizes: tuple
    axis_names: tuple
    device: torch.device
    ranks: _ranks.Ranks | None = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def group(self):
        return None if self.ranks is None else self.ranks.group

    @property
    def rank(self) -> int:
        return 0 if self.ranks is None else self.ranks.rank

    @property
    def world(self) -> int:
        return 1 if self.ranks is None else self.ranks.world


def local_shards(mesh: Mesh, axis=ROW_AXIS) -> int:
    """The shards this rank holds."""
    return axis_size(mesh, axis) // mesh.world


def shard_offset(mesh: Mesh, axis=ROW_AXIS) -> int:
    """The global index of this rank's first shard."""
    return mesh.rank * local_shards(mesh, axis)


def default_shards(ranks: _ranks.Ranks | None = None) -> int:
    """The engine's shard count: ``config.shards``, or one shard a rank of
    ``ranks`` (1 without a group), as JAX takes one a device."""
    from ..utils.config import config
    if config.shards:
        return int(config.shards)
    return 1 if ranks is None else ranks.world


def make_mesh(n_shards: int | None = None, axis: str = ROW_AXIS,
              device=_device.DEFAULT,
              ranks: _ranks.Ranks | None = None) -> Mesh:
    """A mesh of ``n_shards`` (``default_shards(ranks)``) spread over the
    group ``ranks`` (None keeps them in this process), this rank's block
    of shards on ``device``."""
    n = n_shards or default_shards(ranks)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    if ranks is not None and n % ranks.world:
        raise ValueError(f"{n} shards do not split over {ranks.world} "
                         "ranks")
    return Mesh((int(n),), (axis,), _device.resolve(device), ranks)


def make_multislice_mesh(n_slices: int, chips_per_slice: int,
                         dcn_axis: str = DCN_AXIS,
                         ici_axis: str = ROW_AXIS,
                         device=_device.DEFAULT,
                         ranks: _ranks.Ranks | None = None) -> Mesh:
    """(n_slices, chips_per_slice) mesh: the multi-slice layout.  Row data
    shards over BOTH axes (pass ``axis=(dcn_axis, ici_axis)`` to the
    distributed entry points), slice-major.  With ``ranks`` the grid is
    spread over the group (this rank's block of it on ``device``); the
    group's world must divide the grid."""
    sizes = (int(n_slices), int(chips_per_slice))
    if ranks is not None and (sizes[0] * sizes[1]) % ranks.world:
        raise ValueError(f"a {sizes[0]} x {sizes[1]} mesh does not split "
                         f"over {ranks.world} ranks")
    return Mesh(sizes, (dcn_axis, ici_axis), _device.resolve(device), ranks)


def axis_size(mesh: Mesh, axis) -> int:
    """Total shard count over one axis name or a tuple of axis names."""
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def pad_to_multiple(table: Table, multiple: int,
                    mesh: Mesh | None = None) -> tuple[Table, int]:
    """Pad the row count to a multiple with null rows; returns (table,
    original n).  Shards are equal-sized blocks.

    Over a mesh of ranks, ``table`` is this rank's block and ``multiple``
    the mesh's shard count: every rank pads its block to the longest
    block's length rounded up to its own shard count (one gather of the
    blocks' lengths), and the original n is this rank's."""
    n = table.num_rows
    if mesh is not None and _ranks.active(mesh.ranks):
        per = multiple // mesh.world
        longest = _ranks.host_max(n, mesh.ranks)
        target = (longest + per - 1) // per * per
    else:
        target = (n + multiple - 1) // multiple * multiple
    if target == n:
        return table, n
    pad = target - n
    cols = []
    for c in table.columns:
        if not c.dtype.is_fixed_width:
            raise TypeError("pad_to_multiple: shard STRING columns via "
                            "explode_strings or dictionary encoding first")
        data = torch.cat([c.data, c.data.new_zeros(
            (pad,) + tuple(c.data.shape[1:]))])
        valid = torch.cat([c.valid_mask(),
                           torch.zeros(pad, dtype=torch.bool,
                                       device=c.data.device)])
        cols.append(Column(c.dtype, data=data, validity=valid))
    return Table(cols, table.names), n


def shard_table(table: Table, mesh: Mesh, axis=ROW_AXIS) -> Table:
    """The table (this rank's block) placed row-sharded over the mesh
    axis: every buffer on the mesh's device, the row count a multiple of
    the rank's shard count."""
    n = local_shards(mesh, axis)
    for c in table.columns:
        if not c.dtype.is_fixed_width:
            raise TypeError("shard_table: STRING columns don't row-shard "
                            "(offsets are n+1); explode them first")
    if table.num_rows % n:
        raise ValueError(f"{table.num_rows} rows do not split into {n} "
                         "equal shards; pad_to_multiple first")
    return table.to(mesh.device)


def gather_table(table: Table, ranks) -> Table:
    """The ranks' tables concatenated in rank order, on every rank: fixed
    width and STRING columns (one host gather of the lengths, then one
    device gather a buffer).  A table with STRING columns first fetches
    their character counts to the host, in one sync labelled
    ``ranks-gather-sizing``."""
    if not _ranks.active(ranks):
        return table
    from ..utils import metrics
    strs = [i for i, c in enumerate(table.columns) if c.dtype.is_string]
    nchars = []
    if strs:
        nchars = torch.stack([table.columns[i].offsets[-1:].to(
            torch.int64).sum() for i in strs]).tolist()
        metrics.host_sync(label="ranks-gather-sizing")
    # every rank's row count, whether each column is null-free there, and
    # each STRING column's character count
    meta = _ranks.host_gather_ints(
        [table.num_rows] + [c.validity is None for c in table.columns]
        + nchars, ranks)
    lens = [m[0] for m in meta]
    nc = len(table.columns)
    cols = []
    for i, c in enumerate(table.columns):
        valid = None if all(m[1 + i] for m in meta) else \
            _ranks.all_gather_rows(c.valid_mask(), ranks, lens)
        if c.dtype.is_string:
            j = strs.index(i)
            offs = c.offsets.to(torch.int64)
            chars = _ranks.all_gather_rows(
                c.data[:nchars[j]], ranks, [m[1 + nc + j] for m in meta])
            lengths = _ranks.all_gather_rows(offs[1:] - offs[:-1], ranks,
                                             lens)
            offsets = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64,
                                  device=lengths.device)
            torch.cumsum(lengths, 0, out=offsets[1:])
            cols.append(Column(c.dtype, data=chars,
                               offsets=offsets.to(c.offsets.dtype),
                               validity=valid))
        elif c.dtype.is_fixed_width:
            cols.append(Column(c.dtype, data=_ranks.all_gather_rows(
                c.data, ranks, lens), validity=valid))
        else:
            raise NotImplementedError(
                f"gathering a {c.dtype!r} column across ranks")
    return Table(cols, table.names)


def broadcast_table(table: Table, mesh: Mesh) -> Table:
    """Replicate the table to every shard (the broadcast Exchange: the
    build side of a broadcast-hash join).  Every shard of one process
    reads the same buffers, so there the replica is the table itself on
    the mesh's device; over ranks it is the gather of the ranks' blocks."""
    return gather_table(table.to(mesh.device), mesh.ranks)
