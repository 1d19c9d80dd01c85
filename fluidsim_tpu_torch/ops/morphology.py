"""Binary mask morphology — the counterpart of
``fluidsim_tpu/ops/morphology.py`` (``openvdb/tools/Morphology.h``:
``tools::dilateVoxels`` / ``tools::erodeVoxels`` with the ``NN_FACE`` = 6,
``NN_FACE_EDGE`` = 18 and ``NN_FACE_EDGE_VERTEX`` = 26 neighborhoods).

Dense bool tensors; each step is a handful of shifted ORs / ANDs.
Out-of-box neighbors read the background (inactive), as on an unbounded
OpenVDB tree clipped to the dense box.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch.core.gridspec import shift_to_minus, shift_to_plus

__all__ = ["dilate", "erode", "opening", "closing", "NN_FACE",
           "NN_FACE_EDGE", "NN_FACE_EDGE_VERTEX"]

NN_FACE = 6
NN_FACE_EDGE = 18
NN_FACE_EDGE_VERTEX = 26


def _neighbor_reduce(m, pattern: int, is_or: bool):
    """OR (``is_or``) or AND of the neighborhood of each cell, the cell
    itself excluded for the face pattern.  Face+edge+vertex (26) is a 3^3
    box; face+edge (18) is the union (intersection) of the three axis-plane
    3x3 boxes through the cell."""
    if pattern not in (NN_FACE, NN_FACE_EDGE, NN_FACE_EDGE_VERTEX):
        raise ValueError(f"unknown neighborhood pattern {pattern}")
    op = torch.logical_or if is_or else torch.logical_and

    def axis3(a, d):
        return op(op(a, shift_to_plus(a, d)), shift_to_minus(a, d))

    if pattern == NN_FACE:
        out = torch.zeros_like(m) if is_or else torch.ones_like(m)
        for d in range(3):
            out = op(op(out, shift_to_plus(m, d)), shift_to_minus(m, d))
        return out
    if pattern == NN_FACE_EDGE_VERTEX:
        return axis3(axis3(axis3(m, 0), 1), 2)
    xy = axis3(axis3(m, 0), 1)
    xz = axis3(axis3(m, 0), 2)
    yz = axis3(axis3(m, 1), 2)
    return op(op(xy, xz), yz)


def dilate(mask, iterations: int = 1, pattern: int = NN_FACE):
    """Grow an active mask by ``iterations`` topology steps
    (``tools::dilateVoxels``)."""
    m = mask.to(torch.bool)
    for _ in range(iterations):
        m = m | _neighbor_reduce(m, pattern, True)
    return m


def erode(mask, iterations: int = 1, pattern: int = NN_FACE):
    """Shrink an active mask (``tools::erodeVoxels``): a cell survives only
    if its whole neighborhood is active.  Dual of :func:`dilate`."""
    m = mask.to(torch.bool)
    for _ in range(iterations):
        m = m & _neighbor_reduce(m, pattern, False)
    return m


def opening(mask, iterations: int = 1, pattern: int = NN_FACE):
    """Erode then dilate — removes speckles smaller than the structuring
    element."""
    return dilate(erode(mask, iterations, pattern), iterations, pattern)


def closing(mask, iterations: int = 1, pattern: int = NN_FACE):
    """Dilate then erode — fills holes smaller than the structuring
    element."""
    return erode(dilate(mask, iterations, pattern), iterations, pattern)
