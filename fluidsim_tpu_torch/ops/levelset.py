"""Level-set utilities — the counterpart of ``fluidsim_tpu/ops/levelset.py``
(the answers to ``openvdb/tools``' ``LevelSetSphere.h``,
``ParticlesToLevelSet.h``, ``LevelSetUtil`` fog conversion and
``LevelSetMeasure``): SDF construction, CSG, particle surface extraction
and fog conversion, as dense tensor code on the tensors' device.

``particles_to_levelset`` turns the solver's particle cloud into a
renderable signed-distance surface; the CLI's ``--surface`` exports its
fog volume.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch.core.splines import cround
from fluidsim_tpu_torch.ops.transfer import _OFFSETS


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _coords(bound: int, dtype, device) -> torch.Tensor:
    return torch.arange(-bound, bound + 1, dtype=dtype, device=device)


def sphere_sdf(spec_shape, bound: int, center, radius: float,
               dtype=torch.float32, device="cuda"):
    """Dense SDF of a sphere (``tools::createLevelSetSphere``)."""
    c = _coords(bound, dtype, device)
    x = c[:, None, None] - center[0]
    y = c[None, :, None] - center[1]
    z = c[None, None, :] - center[2]
    return torch.sqrt(x * x + y * y + z * z) - radius


def box_sdf(spec_shape, bound: int, lo, hi, dtype=torch.float32,
            device="cuda"):
    """Dense SDF of an axis-aligned box."""
    c = _coords(bound, dtype, device)
    grids = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), dim=-1)
    lo = torch.as_tensor(lo, dtype=dtype, device=device)
    hi = torch.as_tensor(hi, dtype=dtype, device=device)
    q = torch.abs(grids - (lo + hi) / 2) - (hi - lo) / 2
    outside = _norm(torch.clamp(q, min=0.0))
    inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    return outside + inside


def csg_union(a, b):
    return torch.minimum(a, b)


def csg_intersection(a, b):
    return torch.maximum(a, b)


def csg_difference(a, b):
    return torch.maximum(a, -b)


def offset(sdf, d: float):
    """Erode (d<0) / dilate (d>0) — ``tools::LevelSetFilter::offset``."""
    return sdf - d


def fracture(sdf, cutter):
    """Split a level set with a cutter level set —
    ``tools::LevelSetFracture::fracture``: the fragment is the part of
    ``sdf`` inside the cutter, the residual is what remains (CSG max/min
    fields, lower bounds of the distance off the surface).  Returns
    ``(fragment, residual)``."""
    return csg_intersection(sdf, cutter), csg_difference(sdf, cutter)


def particles_to_levelset(pos: torch.Tensor, bound: int, radius: float = 1.0,
                          background: float = 3.0) -> torch.Tensor:
    """Union-of-spheres SDF from a particle cloud
    (``tools::ParticlesToLevelSet``): for every grid cell within the 3^3
    neighbourhood of a particle's cell, keep the minimum of
    ``|x_cell - p| - radius``.  A scatter-min (``scatter_reduce`` with
    ``"amin"``): a minimum does not depend on the order, so no sort.

    Cells never touched stay at ``+background``.
    """
    n = 2 * bound + 1
    base = cround(pos).to(torch.int32)
    offs = torch.as_tensor(_OFFSETS, device=pos.device)
    cells = base[:, None, :] + offs[None]
    inb = torch.all(torch.abs(cells) <= bound, dim=-1)
    d = _norm(cells.to(pos.dtype) - pos[:, None, :]) - radius
    d = torch.where(inb, d, background)
    idx = torch.clamp(cells + bound, 0, n - 1).to(torch.int64)
    flat = ((idx[..., 0] * n + idx[..., 1]) * n + idx[..., 2]).reshape(-1)
    sdf = torch.full((n * n * n,), background, dtype=pos.dtype,
                     device=pos.device)
    sdf.scatter_reduce_(0, flat, d.reshape(-1), "amin", include_self=True)
    return sdf.reshape(n, n, n)


def sdf_to_fog(sdf, half_width: float = 1.5):
    """SDF -> fog volume density in [0,1] (``tools::sdfToFogVolume``):
    1 deep inside, linear ramp across the narrow band, 0 outside."""
    return torch.clamp(-sdf / half_width, 0.0, 1.0)


def levelset_volume(sdf, dx: float = 1.0):
    """Enclosed volume estimate (``tools::levelSetVolume``): sharp count of
    inside cells with a first-order interface correction."""
    inside = (sdf < 0).to(torch.float32)
    band = torch.clamp(0.5 - sdf, 0.0, 1.0) * (torch.abs(sdf) < 0.5)
    return (torch.sum(inside) + torch.sum(band * (1 - inside))) * dx ** 3
