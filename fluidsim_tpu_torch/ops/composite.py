"""Grid compositing, masking and topology utilities — the counterpart of
``fluidsim_tpu/ops/composite.py``:

  * ``openvdb/tools/Composite.h`` — ``compMax/compMin/compSum/compMul/
    compDiv/compReplace`` (the level-set CSG ops live in
    ``ops/levelset.py``);
  * ``openvdb/tools/Mask.h`` — ``interiorMask``;
  * ``openvdb/tools/Clip.h`` — ``clip`` by bbox or mask;
  * ``openvdb/tools/PointsToMask.h`` — particle positions → occupancy;
  * ``openvdb/tools/SignedFloodFill.h`` — propagate narrow-band signs to
    the far field (a fixed loop of sweeps, no read of the device);
  * ``openvdb/tools/TopologyToLevelSet.h`` — active mask → SDF;
  * ``openvdb/tools/ChangeBackground.h`` — swap the background value.

"Active" is an explicit bool mask — the dense stand-in for tree topology.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch.ops.levelset_tools import filter_mean, redistance
from fluidsim_tpu_torch.ops.morphology import NN_FACE, dilate

__all__ = [
    "comp_max", "comp_min", "comp_sum", "comp_mul", "comp_div",
    "comp_replace", "interior_mask", "clip_to_box", "clip_to_mask",
    "points_to_mask", "signed_flood_fill", "topology_to_levelset",
    "change_background",
]


# ---- Composite.h comp* family ------------------------------------------
# Combine grid b into grid a over the union of their active topologies;
# inactive cells contribute their background.

def _masked(a, b, a_active, b_active, op, background=0.0):
    if a_active is None and b_active is None:
        return op(a, b)
    if a_active is None:
        a_active = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    if b_active is None:
        b_active = torch.ones(b.shape, dtype=torch.bool, device=b.device)
    av = torch.where(a_active, a, background)
    bv = torch.where(b_active, b, background)
    out = op(av, bv)
    out = torch.where(a_active & ~b_active, a, out)
    out = torch.where(b_active & ~a_active, b, out)
    return torch.where(a_active | b_active, out, background)


def comp_max(a, b, a_active=None, b_active=None, background=0.0):
    """``tools::compMax`` — pointwise max over the topology union."""
    return _masked(a, b, a_active, b_active, torch.maximum, background)


def comp_min(a, b, a_active=None, b_active=None, background=0.0):
    """``tools::compMin``."""
    return _masked(a, b, a_active, b_active, torch.minimum, background)


def comp_sum(a, b, a_active=None, b_active=None, background=0.0):
    """``tools::compSum``."""
    return _masked(a, b, a_active, b_active, torch.add, background)


def comp_mul(a, b, a_active=None, b_active=None, background=0.0):
    """``tools::compMul``."""
    return _masked(a, b, a_active, b_active, torch.mul, background)


def _safe_div(x, y):
    out = x / torch.where(y == 0, 1.0, y)
    return torch.where(y == 0, 0.0, out)


def comp_div(a, b, a_active=None, b_active=None, background=0.0):
    """``tools::compDiv`` (divide-by-zero yields 0, like the reference's
    zeroVal fallback for non-finite results)."""
    return _masked(a, b, a_active, b_active, _safe_div, background)


def comp_replace(a, b, b_active=None):
    """``tools::compReplace`` — copy b's active values over a."""
    if b_active is None:
        return b
    return torch.where(b_active, b, a)


# ---- Mask.h / Clip.h / PointsToMask.h -----------------------------------

def interior_mask(grid, iso: float = 0.0, levelset: bool = True):
    """``tools::interiorMask``: bool mask of the interior — ``φ < iso``
    for level sets, ``value > iso`` for fog/density volumes."""
    return (grid < iso) if levelset else (grid > iso)


def clip_to_box(grid, lo, hi, bound: int, background=0.0):
    """``tools::clip`` by an index-space bbox (centered coordinates,
    inclusive): values outside become background."""
    c = torch.arange(-bound, bound + 1, device=grid.device)
    ok = [(c >= lo[d]) & (c <= hi[d]) for d in range(3)]
    inside = ok[0][:, None, None] & ok[1][None, :, None] & ok[2][None, None, :]
    if grid.dim() == 4:
        inside = inside[..., None]
    return torch.where(inside, grid, background)


def clip_to_mask(grid, mask, background=0.0):
    """``tools::clip`` by a mask grid."""
    m = mask.to(torch.bool)
    if grid.dim() == 4 and m.dim() == 3:
        m = m[..., None]
    return torch.where(m, grid, background)


def points_to_mask(pos, bound: int):
    """``tools::PointsToMask``: particle positions into a bool occupancy
    grid (nearest voxel, rounding half to even as the JAX package's
    ``jnp.round``)."""
    n = 2 * bound + 1
    cells = torch.clamp(torch.round(pos).to(torch.int64) + bound, 0, n - 1)
    flat = (cells[:, 0] * n + cells[:, 1]) * n + cells[:, 2]
    grid = torch.zeros(n * n * n, dtype=torch.bool, device=pos.device)
    grid[flat] = True
    return grid.reshape(n, n, n)


# ---- SignedFloodFill.h / TopologyToLevelSet.h / ChangeBackground.h ------

def signed_flood_fill(phi, band: float, iterations: int | None = None,
                      outside: float | None = None):
    """``tools::signedFloodFill``: a narrow-band SDF stores real values
    only where ``|φ| < band``; propagate consistent signs outward so the
    far field becomes ``±outside`` (default ``±band``).

    Dense sweep: each pass copies the sign of an already-signed neighbor
    into unsigned cells; ``iterations`` (default ``n + 1``) passes.
    """
    n = phi.shape[0]
    out_mag = band if outside is None else outside
    known = torch.abs(phi) < band
    sign = torch.where(phi < 0, -1.0, 1.0) * known  # 0 = unknown
    iters = iterations if iterations is not None else (n + 1)
    for _ in range(iters):
        neigh = torch.zeros_like(sign)
        for d in range(3):
            for shift in (1, -1):
                r = torch.roll(sign, shift, dims=d)
                r.select(d, 0 if shift == 1 else n - 1).zero_()
                # first nonzero neighbor wins (they agree away from the
                # band by construction)
                neigh = torch.where(neigh == 0, r, neigh)
        sign = torch.where(sign == 0, neigh, sign)
    sign = torch.where(sign == 0, 1.0, sign)  # isolated regions: outside
    return torch.where(known, phi, sign * out_mag)


def topology_to_levelset(mask, half_width: float = 3.0, dilation: int = 0,
                         smooth_iterations: int = 0, iterations: int = 30):
    """``tools::topologyToLevelSet``: convert an active mask to a
    narrow-band SDF whose zero crossing wraps the active voxels
    (optionally dilated / smoothed first, the reference tool's
    ``dilation``/``smoothingSteps`` knobs)."""
    m = mask.to(torch.bool)
    if dilation:
        m = dilate(m, dilation, NN_FACE)
    seed = torch.where(m, -0.5, 0.5)
    phi = redistance(seed, iterations=iterations)
    if smooth_iterations:
        for _ in range(smooth_iterations):
            phi = filter_mean(phi, 3)
        phi = redistance(phi, iterations=max(4, iterations // 4))
    return torch.clamp(phi, -half_width, half_width)


def change_background(grid, active, new_background, levelset: bool = False):
    """``tools::changeBackground``: rewrite inactive cells' value.  With
    ``levelset=True`` the cell's sign is kept and only the magnitude
    changes (``changeLevelSetBackground``)."""
    inactive = ~active.to(torch.bool)
    if levelset:
        newv = torch.where(grid < 0, -1.0, 1.0) * abs(new_background)
    else:
        newv = torch.full_like(grid, new_background)
    return torch.where(inactive, newv, grid)
