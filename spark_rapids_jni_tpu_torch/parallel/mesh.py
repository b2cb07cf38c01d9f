"""Meshes of shards and row-sharded tables.

The port of ``spark_rapids_jni_tpu/parallel/mesh.py``.  The JAX package runs
one controller over an N-device mesh; the port runs one process over a mesh
of N *shards* on one device.  A row-sharded table is the global table whose
rows split into N equal contiguous blocks (shard s owns rows
``[s * n / N, (s + 1) * n / N)``), exactly JAX's global view of a
``P(axis)``-sharded array.  Per-shard work runs batched along the shard
axis (parallel/shuffle.py), never as a loop of N launches.

A 2-D ``dcn x shard`` mesh (``make_multislice_mesh``) shards rows over both
axes, slice-major, as ``P((dcn, shard))`` does in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import device as _device
from ..columnar import Column, Table

ROW_AXIS = "shard"
DCN_AXIS = "dcn"


@dataclass(frozen=True)
class Mesh:
    """``sizes[i]`` shards along ``axis_names[i]``, all on ``device``."""

    sizes: tuple
    axis_names: tuple
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def default_shards() -> int:
    """The engine's shard count: ``config.shards``, or one shard per device
    of the target (the port runs on one device, so 1)."""
    from ..utils.config import config
    return int(config.shards) if config.shards else 1


def make_mesh(n_shards: int | None = None, axis: str = ROW_AXIS,
              device=_device.DEFAULT) -> Mesh:
    n = n_shards or default_shards()
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh((int(n),), (axis,), _device.resolve(device))


def make_multislice_mesh(n_slices: int, chips_per_slice: int,
                         dcn_axis: str = DCN_AXIS,
                         ici_axis: str = ROW_AXIS,
                         device=_device.DEFAULT) -> Mesh:
    """(n_slices, chips_per_slice) mesh: the multi-slice layout.  Row data
    shards over BOTH axes (pass ``axis=(dcn_axis, ici_axis)`` to the
    distributed entry points), slice-major."""
    return Mesh((int(n_slices), int(chips_per_slice)), (dcn_axis, ici_axis),
                _device.resolve(device))


def axis_size(mesh: Mesh, axis) -> int:
    """Total shard count over one axis name or a tuple of axis names."""
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def pad_to_multiple(table: Table, multiple: int) -> tuple[Table, int]:
    """Pad the row count to a multiple with null rows; returns (table,
    original n).  Shards are equal-sized blocks."""
    n = table.num_rows
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
    """The table placed row-sharded over the mesh axis: every buffer on the
    mesh's device, the row count a multiple of the shard count."""
    n = axis_size(mesh, axis)
    for c in table.columns:
        if not c.dtype.is_fixed_width:
            raise TypeError("shard_table: STRING columns don't row-shard "
                            "(offsets are n+1); explode them first")
    if table.num_rows % n:
        raise ValueError(f"{table.num_rows} rows do not split into {n} "
                         "equal shards; pad_to_multiple first")
    return table.to(mesh.device)


def broadcast_table(table: Table, mesh: Mesh) -> Table:
    """Replicate the table to every shard (the broadcast Exchange: the
    build side of a broadcast-hash join).  Every shard of a one-device mesh
    reads the same buffers, so the replica is the table itself on the
    mesh's device."""
    return table.to(mesh.device)
