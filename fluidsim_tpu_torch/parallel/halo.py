"""Halo exchange primitives of the 1-D slab decomposition over
``torch.distributed`` — the counterpart of ``fluidsim_tpu/parallel/halo.py``.

The grid's x axis is cut into slabs, one per rank of a process group (NCCL
on the card, gloo on the CPU), and rank r owns slab r.  The JAX helpers run
inside ``shard_map`` over a mesh axis and move data with ``ppermute``; here
they take the process group (None: the default group, or one process when
``torch.distributed`` is not initialised) and each exchange is one
``dist.batch_isend_irecv`` with the ranks r - 1 and r + 1.  A missing link
(a domain end) yields zeros, as ``ppermute`` fills it, which matches the
solver's rule that outside the box reads as background 0.  At world size 1
nothing is communicated at all.

Every helper takes ``dim``, the axis of its tensors that runs along x (0,
as in the JAX helpers, or 1 for the port's channel-major fields).

The two collectives every exchange and reduction goes through count what
this rank hands them, as the kernel wrappers count their launches:
``shift_pair.calls`` and ``.bytes`` (the tensors sent, bool as uint8) and
``all_reduce.calls`` and ``.bytes`` (the tensor reduced), only where
something is communicated; while the program's spans are traced, each runs
in the span ``halo`` or ``all_reduce``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fluidsim_tpu_torch.utils.profiling import span


def world(group=None) -> tuple[int, int]:
    """(rank, world size) of this process in ``group``; (0, 1) without an
    initialised ``torch.distributed``."""
    if not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` in ``group``, as the point-to-point
    operations take it."""
    return rank if group is None else dist.get_global_rank(group, rank)


def shift_pair(to_left: Sequence[torch.Tensor],
               to_right: Sequence[torch.Tensor], group=None):
    """Send ``to_left`` to rank r - 1 and ``to_right`` to rank r + 1 in one
    batch; returns ``(from_left, from_right)``, what ranks r - 1 and r + 1
    sent this way (their ``to_right`` and ``to_left``), zeros where there is
    no such rank.  The two lists pair up tensor by tensor in shape and
    dtype."""
    rank, size = world(group)
    # bool tensors travel as uint8, which every backend carries
    wire = lambda t: t.to(torch.uint8) if t.dtype == torch.bool else t
    sent_left, sent_right = to_left, to_right
    to_left, to_right = [wire(t) for t in to_left], [wire(t) for t in to_right]
    from_left = [torch.zeros_like(t) for t in to_right]
    from_right = [torch.zeros_like(t) for t in to_left]
    ops = []
    if rank > 0:
        left = _peer(group, rank - 1)
        ops += [dist.P2POp(dist.isend, t.contiguous(), left, group)
                for t in to_left]
        ops += [dist.P2POp(dist.irecv, t, left, group) for t in from_left]
    if rank < size - 1:
        right = _peer(group, rank + 1)
        ops += [dist.P2POp(dist.isend, t.contiguous(), right, group)
                for t in to_right]
        ops += [dist.P2POp(dist.irecv, t, right, group) for t in from_right]
    if ops:
        shift_pair.calls += 1
        sent = ((to_left if rank > 0 else [])
                + (to_right if rank < size - 1 else []))
        shift_pair.bytes += sum(t.numel() * t.element_size() for t in sent)
        with span("halo"):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    unwire = lambda t, like: t.to(torch.bool) if like.dtype == torch.bool else t
    return ([unwire(t, s) for t, s in zip(from_left, sent_right)],
            [unwire(t, s) for t, s in zip(from_right, sent_left)])


shift_pair.calls = 0
shift_pair.bytes = 0


def _rows(t: torch.Tensor, dim: int, start: int, stop: int | None):
    return t.narrow(dim, start, (t.shape[dim] if stop is None else stop)
                    - start)


def exchange_halo(slab: torch.Tensor, width: int, group=None, dim: int = 0):
    """(.., nl, ..) -> (.., nl + 2 width, ..) along ``dim``: both
    neighbours' edge rows appended, zeros beyond the domain ends."""
    if world(group)[1] == 1:
        pad = (0, 0) * (slab.dim() - 1 - dim) + (width, width)
        return F.pad(slab, pad)
    nl = slab.shape[dim]
    (from_left,), (from_right,) = shift_pair(
        [_rows(slab, dim, 0, width)], [_rows(slab, dim, nl - width, nl)], group)
    return torch.cat([from_left, slab, from_right], dim=dim)


def edge_rows(slabs: Sequence[torch.Tensor], width: int, group=None):
    """The neighbours' edge rows of each (nl, ..) tensor of ``slabs`` along
    dim 0, in one batch and without building a tensor with a halo: a list
    of ``(lo, hi)``, ``lo`` rank r - 1's last ``width`` rows and ``hi`` rank
    r + 1's first ``width`` rows, None at a domain end (the stencil kernels
    read it as 0).  At world size 1 nothing is sent and every pair is
    ``(None, None)``."""
    rank, size = world(group)
    if size == 1:
        return [(None, None)] * len(slabs)
    lo, hi = shift_pair([t[:width] for t in slabs],
                        [t[t.shape[0] - width:] for t in slabs], group)
    return [(l if rank > 0 else None, h if rank < size - 1 else None)
            for l, h in zip(lo, hi)]


def halo_reduce(ext: torch.Tensor, width: int, group=None, dim: int = 0):
    """(.., nl + 2 width, ..) -> (.., nl, ..) along ``dim``: the halo rows
    folded back into the neighbours that own them, the scatter side of
    ``exchange_halo``.  Rank r's left halo holds contributions to rank
    r - 1's right edge: it goes left and is added there (after what came
    from the left, as the JAX function adds them)."""
    rows = ext.shape[dim]
    interior = _rows(ext, dim, width, rows - width)
    if world(group)[1] == 1:
        return interior.contiguous()
    (add_first,), (add_last,) = shift_pair(
        [_rows(ext, dim, 0, width)], [_rows(ext, dim, rows - width, rows)],
        group)
    out = interior.clone()
    nl = out.shape[dim]
    first = _rows(out, dim, 0, width)
    first += add_first
    last = _rows(out, dim, nl - width, nl)
    last += add_last
    return out


def migrate_edge_bands(band_l, mask_l, band_r, mask_r, group=None):
    """Ship the raw sorted edge bands to the two neighbours: ``band_l`` and
    ``mask_l`` ((F, D) rows and their (F,) sender mask) go to the LEFT
    neighbour, ``band_r`` and ``mask_r`` to the RIGHT.  Returns
    ``(incoming (2F, D), valid (2F,))``, the rows from the left neighbour
    first; a missing link arrives as zeros, ``valid`` False."""
    (rows_fl, mask_fl), (rows_fr, mask_fr) = shift_pair(
        [band_l, mask_l], [band_r, mask_r], group)
    return (torch.cat([rows_fl, rows_fr], dim=0),
            torch.cat([mask_fl, mask_fr], dim=0))


def _pack(payload, mask, capacity: int):
    """The first ``capacity`` rows of ``payload`` where ``mask`` holds, in
    order, packed into (capacity, D) rows, and their (capacity,) validity."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (rank < capacity), rank, capacity)
    rows = payload.new_zeros((capacity + 1, payload.shape[1]))
    rows[tgt] = payload
    nvalid = torch.clamp(mask.sum(), max=capacity)
    valid = torch.arange(capacity, device=payload.device) < nvalid
    return rows[:capacity], valid


def migrate_neighbors(payload, send_left, send_right, capacity: int,
                      group=None):
    """Fixed-size nearest-neighbour migration of the (P, D) ``payload``
    rows marked by the disjoint (P,) masks ``send_left`` and
    ``send_right``: at most ``capacity`` rows each way.  Returns
    ``(incoming (2 capacity, D), valid (2 capacity,), dropped)``, the rows
    from the left neighbour first, and the number of senders past the
    capacity (a 0-dim tensor)."""
    rows_l, valid_l = _pack(payload, send_left, capacity)
    rows_r, valid_r = _pack(payload, send_right, capacity)
    incoming, valid = migrate_edge_bands(rows_l, valid_l, rows_r, valid_r,
                                         group)
    dropped = (send_left.sum() - valid_l.sum()
               + send_right.sum() - valid_r.sum())
    return incoming, valid, dropped


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """``psum`` / ``pmax`` of the JAX step: ``t`` reduced over the ranks
    (a new tensor; ``t`` itself at world size 1)."""
    if world(group)[1] == 1:
        return t
    all_reduce.calls += 1
    all_reduce.bytes += t.numel() * t.element_size()
    with span("all_reduce"):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=group)
    return out


all_reduce.calls = 0
all_reduce.bytes = 0
