"""Velocity extrapolation and MAC conversion utilities — the counterpart of
``fluidsim_tpu/ops/extrapolate.py``, on (N,N,N,3) velocity.

``extrapolate`` is the reference's layer-by-layer velocity extension: each
sweep, every undefined cell with at least one defined 27-neighbour receives
the average of those neighbours' values and becomes defined.  A sweep is
26 dense shifts; the loop runs on the host and reads one count from the
device per sweep.  ``to_staggered`` / ``to_collocated`` convert between MAC
faces and cell centres, and ``resample_mask`` caps the particles per cell.
No frame calls them.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch.core.gridspec import shift_to_minus, shift_to_plus
from fluidsim_tpu_torch.core.splines import cround
from fluidsim_tpu_torch.ops.transfer import _OFFSETS
from fluidsim_tpu_torch.ops.transfer_kernels import _shift3


def _sweep(v: torch.Tensor, d: torch.Tensor):
    """One layer: (v', d', newly) with the 26 neighbours summed in offset
    order, as the JAX sweep sums them (the shifts on a channel-first view
    of the (N,N,N,3) velocity)."""
    dm = d.to(v.dtype)
    vsum = torch.zeros_like(v)
    count = torch.zeros_like(dm)
    vm = (v * dm[..., None]).permute(3, 0, 1, 2)
    for o in _OFFSETS:
        if not o.any():
            continue
        vsum = vsum + _shift3(vm, o).permute(1, 2, 3, 0)
        count = count + _shift3(dm, o)
    newly = ~d & (count > 0)
    avg = vsum / torch.where(count > 0, count, 1.0)[..., None]
    return torch.where(newly[..., None], avg, v), d | newly, newly


def extrapolate(vel: torch.Tensor, defined: torch.Tensor,
                max_layers: int | None = None):
    """Extend ``vel`` (N,N,N,3) from the ``defined`` (N,N,N) cells into the
    undefined ones, one layer per sweep, until a sweep defines nothing or
    ``max_layers`` sweeps ran.

    The JAX function computes ``max_layers`` and never uses it: it sweeps
    until nothing changes.  Here it is a cap.  Its default, ``3 N``, gives
    the JAX result: a flood through 27 neighbours needs at most ``N - 1``
    sweeps that define a cell, and one more that finds nothing to define.

    Returns (vel, defined).
    """
    n = vel.shape[0]
    if max_layers is None:
        max_layers = 3 * n
    v, d = vel, defined
    for _ in range(max_layers):
        v, d, newly = _sweep(v, d)
        if not bool(newly.any()):
            break
    return v, d


def to_collocated(vel: torch.Tensor) -> torch.Tensor:
    """MAC face velocities -> cell centres (the working ``getUnstaggered``)."""
    return torch.stack([0.5 * (vel[..., d] + shift_to_plus(vel[..., d], d))
                        for d in range(3)], dim=-1)


def to_staggered(vc: torch.Tensor) -> torch.Tensor:
    """Cell-centred velocities -> MAC faces by averaging the two adjacent
    centres (the working ``getStaggered``; zero beyond the box)."""
    return torch.stack([0.5 * (vc[..., d] + shift_to_minus(vc[..., d], d))
                        for d in range(3)], dim=-1)


def resample_mask(pos: torch.Tensor, bound: int,
                  max_per_cell: int) -> torch.Tensor:
    """Keep-mask capping the particles per cell at ``max_per_cell``: the
    first ones in the current order survive (the reference's
    ``PointList::resample``)."""
    n = 2 * bound + 1
    base = torch.clamp(cround(pos).to(torch.int32) + bound, 0, n - 1)
    flat = (base[:, 0] * n + base[:, 1]) * n + base[:, 2]
    flat_s, order = torch.sort(flat, stable=True)
    idx = torch.arange(flat.shape[0], device=pos.device)
    rank = idx - torch.searchsorted(flat_s, flat_s, side="left")
    keep = torch.zeros(flat.shape[0], dtype=torch.bool, device=pos.device)
    keep[order] = rank < max_per_cell
    return keep
