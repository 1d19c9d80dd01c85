"""Particle-by-cell partitioning — the counterpart of
``fluidsim_tpu/ops/partition.py`` (``openvdb/tools/PointIndexGrid.h`` /
``PointPartitioner.h`` analogs): a dense counts/offsets (CSR) partition
built from one stable sort, with fixed-capacity range queries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fluidsim_tpu_torch.core.gridspec import flat_index

__all__ = ["CellPartition", "partition_by_cell", "cells_of", "points_in_cell",
           "neighbor_counts"]


class CellPartition(NamedTuple):
    """CSR layout of particle ids grouped by owning cell (int32 tensors).

    Attributes:
      order:   (P,) particle ids sorted by flat cell id (the permutation;
               ids of one cell in increasing order).
      cell_of: (P,) flat cell id per *sorted* slot (``flat[order]``).
      counts:  (N³,) particles per cell.
      offsets: (N³+1,) exclusive prefix sum — cell ``c`` owns sorted slots
               ``offsets[c] : offsets[c+1]``.
    """
    order: torch.Tensor
    cell_of: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor


def cells_of(pos, bound: int):
    """Owning cell (nearest voxel, rounding half to even as the JAX
    package's ``jnp.round``) as int32 flat ids into the dense ``N³`` box."""
    n = 2 * bound + 1
    cells = torch.clamp(torch.round(pos).to(torch.int32) + bound, 0, n - 1)
    return flat_index(cells, n)


def partition_by_cell(pos, bound: int) -> CellPartition:
    """Build the cell partition of a particle set with one stable sort and
    one integer count (the replacement for PointPartitioner's bucket radix
    sort)."""
    n = 2 * bound + 1
    flat = cells_of(pos, bound)
    cell_sorted, order = torch.sort(flat, stable=True)
    counts = torch.zeros((n * n * n,), dtype=torch.int32, device=pos.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                     device=pos.device),
                         torch.cumsum(counts, 0, dtype=torch.int32)])
    return CellPartition(order=order.to(torch.int32), cell_of=cell_sorted,
                         counts=counts, offsets=offsets)


def points_in_cell(part: CellPartition, flat_cell, capacity: int):
    """Fixed-capacity range query (``PointIndexIterator`` analog): particle
    ids in ``flat_cell``, padded with ``-1`` beyond the true count."""
    start = part.offsets[flat_cell]
    count = part.counts[flat_cell]
    lane = torch.arange(capacity, dtype=torch.int32, device=start.device)
    p = part.order.shape[0]
    ids = part.order[torch.clamp(start + lane, 0, p - 1).long()]
    return torch.where(lane < count, ids, -1), count


def _shift_zero(v, axis: int, s: int):
    """result[i] = v[i - s] along ``axis``, zero where ``i - s`` leaves the
    box (out-of-box reads see the background 0)."""
    if s == 0:
        return v
    out = torch.zeros_like(v)
    if s > 0:
        out.narrow(axis, s, v.shape[axis] - s).copy_(
            v.narrow(axis, 0, v.shape[axis] - s))
    else:
        out.narrow(axis, 0, v.shape[axis] + s).copy_(
            v.narrow(axis, -s, v.shape[axis] + s))
    return out


def neighbor_counts(part: CellPartition, bound: int, radius: int = 1):
    """Dense per-cell count of particles within the ``(2r+1)³`` cell
    neighborhood — the aggregate query PointIndexGrid accelerates."""
    n = 2 * bound + 1
    c = part.counts.reshape(n, n, n)
    out = torch.zeros_like(c)
    for dx in range(-radius, radius + 1):
        for dy in range(-radius, radius + 1):
            for dz in range(-radius, radius + 1):
                v = c
                for axis, s in enumerate((dx, dy, dz)):
                    v = _shift_zero(v, axis, s)
                out = out + v
    return out
