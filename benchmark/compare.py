"""The comparison of the program's particles with the reference's, blind to
the order in which either holds them.

The particles of each side are binned by the cell of their position (the
grid's rounding, clipped to the box), and each cell's count and the means
of its particles' position and fields are compared.  The order of the
particles is the program's own business: its sort, its ranks and its
migration may hold them in any order, and a correct change to any of those
still compares alike.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.grid import cround

# how a field's gap is read: "rel", the L2 norm of the cells' mean gaps over
# the reference's; "entry", the RMS gap of a mean entry
KINDS = ("rel", "entry")


def binned_gaps(prog: dict, want: dict, bound: int, fields) -> dict:
    """The compared numbers of one state: ``moved_share``, the particles
    binned in another cell than the reference's over the reference's
    particles; ``pos_gap_cells``, the RMS distance of the cells' mean
    positions (cells); and a ``<name>`` for each ``(name, key, kind)`` of
    ``fields``, over the cells that both sides occupy."""
    n = 2 * bound + 1
    widths = [math.prod(prog[key].shape[1:]) for _name, key, _kind in fields]

    def binned(s):
        pos = s["pos"].double()
        cell = torch.clamp(cround(pos).long() + bound, 0, n - 1)
        ids = (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]
        cols = [torch.ones_like(pos[:, :1]), pos]
        cols += [s[key].double().reshape(pos.shape[0], -1)
                 for _name, key, _kind in fields]
        cols = torch.cat(cols, 1)
        return torch.zeros((n ** 3, cols.shape[1]), dtype=torch.float64,
                           device=pos.device).index_add_(0, ids, cols)

    got, ref = binned(prog), binned(want)
    both = (got[:, 0] > 0) & (ref[:, 0] > 0)
    mean_ref = ref[both, 1:] / ref[both, :1]
    d = got[both, 1:] / got[both, :1] - mean_ref
    out = {"moved_share": float(torch.sum(torch.abs(got[:, 0] - ref[:, 0])))
           / max(want["pos"].shape[0], 1),
           "pos_gap_cells": float(torch.sqrt(torch.mean(
               torch.sum(d[:, :3] ** 2, 1))))}
    col = 3
    for (name, _key, kind), w in zip(fields, widths):
        part = d[:, col:col + w]
        if kind == "rel":
            out[name] = float(torch.linalg.vector_norm(part)) / max(
                float(torch.linalg.vector_norm(mean_ref[:, col:col + w])),
                1e-30)
        elif kind == "entry":
            out[name] = float(torch.sqrt(torch.mean(part ** 2)))
        else:
            raise ValueError(f"{name}: kind {kind!r} is not one of {KINDS}")
        col += w
    return out


def grid_gap(prog: torch.Tensor, want: torch.Tensor) -> float:
    """A grid field's gap: L2 norm of the difference over the reference's;
    grids of another shape compare as infinitely far."""
    if prog.shape != want.shape:
        return float("inf")
    d = prog.double() - want.double()
    return float(torch.linalg.vector_norm(d)) / max(
        float(torch.linalg.vector_norm(want.double())), 1e-30)
