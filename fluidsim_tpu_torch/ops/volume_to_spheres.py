"""Sphere packing & closest surface points — the counterpart of
``fluidsim_tpu/ops/volume_to_spheres.py``
(``openvdb/tools/VolumeToSpheres.h`` analog).

``fill_with_spheres`` greedily drops up to N non-overlapping spheres inside
an iso-surface, each at the interior point with the largest remaining
clearance (distance to the surface AND to the spheres already placed),
stopping below a minimum radius.  The clearance field is the negated SDF,
updated after each placement with one ``min(d, |x−c|−r)`` pass: a fixed
loop of ``count`` argmax steps with no read of the device.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch.ops.advect_volume import _lattice, sample_trilinear
from fluidsim_tpu_torch.ops.gridops import gradient
from fluidsim_tpu_torch.ops.levelset import _norm

__all__ = ["fill_with_spheres", "closest_surface_points"]


def fill_with_spheres(phi, count: int, bound: int, min_radius: float = 1.0,
                      overlap: bool = False):
    """``tools::fillWithSpheres``: up to ``count`` spheres inside the zero
    iso-surface of SDF ``phi``.  Returns ``(centers (count,3),
    radii (count,))`` — unused slots have radius 0 (and NaN centers),
    the reference's "up to N" contract with static shapes.
    ``overlap=True`` only requires spheres to stay inside the surface.
    """
    pts = _lattice(bound, phi.dtype, phi.device)
    clear = (-phi).reshape(-1)  # distance to surface, >0 inside
    spheres = torch.zeros((count, 3), dtype=phi.dtype, device=phi.device)
    radii = torch.zeros((count,), dtype=phi.dtype, device=phi.device)
    for i in range(count):
        # argmax returns the first maximum, as jnp.argmax does; the index
        # stays a tensor, so nothing is read back
        k = torch.argmax(clear).reshape(1)
        r = clear.index_select(0, k)[0]
        ctr = pts.index_select(0, k)[0]
        ok = r >= min_radius
        spheres[i] = torch.where(ok, ctr, torch.nan)
        radii[i] = torch.where(ok, r, 0.0)
        # new clearance: spheres must stay inside the surface and (unless
        # overlap is allowed) outside every placed sphere
        d_new = _norm(pts - ctr) - (0.0 if overlap else r)
        clear = torch.where(ok, torch.minimum(clear, d_new), clear - torch.inf)
    return spheres, radii


def closest_surface_points(phi, pos, bound: int, dx: float = 1.0):
    """``tools::ClosestSurfacePoint::search``: for query points ``pos``
    (P,3, centered index coords), the closest point on the zero
    iso-surface and the distance to it: ``x − φ(x)·∇φ(x)/|∇φ|``, sampled
    trilinearly."""
    g = gradient(phi, dx)
    d = sample_trilinear(phi, pos, bound)
    nrm = torch.stack([sample_trilinear(g[..., i], pos, bound)
                       for i in range(3)], dim=-1)
    nrm = nrm / torch.clamp(_norm(nrm)[..., None], min=1e-12)
    closest = pos - d[..., None] * nrm
    return closest, torch.abs(d)
