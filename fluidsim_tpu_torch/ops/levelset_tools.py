"""Level-set evolution tools: rebuild, filter, morph, track, measure — the
counterpart of ``fluidsim_tpu/ops/levelset_tools.py``
(``openvdb/tools/LevelSetRebuild.h``, ``LevelSetFilter.h``,
``LevelSetMorph.h``, ``LevelSetTracker.h``, ``LevelSetMeasure.h``).

Each tool is a dense whole-grid pass on the tensors' device, the "narrow
band" a cell mask that freezes far-field values.  The iterations are
Python loops of fixed count: no step reads the device.
"""

from __future__ import annotations

import math

import torch

from fluidsim_tpu_torch.core.gridspec import shift_to_minus, shift_to_plus
from fluidsim_tpu_torch.ops.advect_volume import advect_volume
from fluidsim_tpu_torch.ops.fd import advect_hj
# Edge-clamped shift (out-of-box reads repeat the boundary value —
# zero-background shifts would pin boundary cells of an SDF at 1/√3
# during redistancing); shared with the FD scheme family.
from fluidsim_tpu_torch.ops.fd import shift_edge as _shift_edge
from fluidsim_tpu_torch.ops.gridops import mean_curvature

__all__ = [
    "redistance", "rebuild_levelset", "filter_mean", "filter_gaussian",
    "filter_median", "filter_offset", "morph_levelset", "track_levelset",
    "levelset_area", "levelset_avg_curvature",
]


def _godunov_grad_norm(phi, speed_sign, dx: float):
    """Godunov upwind |∇φ| for motion with sign ``speed_sign`` (+1 grows
    the outside / moves the interface inward, per Hamilton-Jacobi
    convention φ_t + s|∇φ| = 0)."""
    g2 = torch.zeros_like(phi)
    for d in range(3):
        dm = (phi - _shift_edge(phi, d, -1)) / dx  # backward difference
        dp = (_shift_edge(phi, d, +1) - phi) / dx  # forward difference
        pos = torch.maximum(torch.clamp(dm, min=0.0) ** 2,
                            torch.clamp(dp, max=0.0) ** 2)
        neg = torch.maximum(torch.clamp(dm, max=0.0) ** 2,
                            torch.clamp(dp, min=0.0) ** 2)
        g2 = g2 + torch.where(speed_sign > 0, pos, neg)
    return torch.sqrt(g2)


def redistance(phi, iterations: int = 20, dx: float = 1.0,
               band: float | None = None):
    """PDE reinitialization: evolve ``φ_t = S(φ₀)(1 − |∇φ|)`` to restore
    the signed-distance property while preserving the zero level set
    (``tools::LevelSetRebuild`` / ``LevelSetTracker::normalize``):
    Sussman–Smereka–Osher relaxation with Godunov upwinding, fixed trip
    count, CFL ``dt = 0.3 dx``.

    ``band``: if given, cells with ``|φ| > band`` are frozen (narrow-band
    behavior) — they keep their input values.
    """
    s = phi / torch.sqrt(phi * phi + dx * dx)
    dt = 0.3 * dx
    frozen = None if band is None else (torch.abs(phi) > band)
    p = phi
    for _ in range(iterations):
        g = _godunov_grad_norm(p, s, dx)
        p_new = p - dt * s * (g - 1.0)
        p = p_new if frozen is None else torch.where(frozen, p, p_new)
    return p


def rebuild_levelset(field, iso: float = 0.0, half_width: float = 3.0,
                     iterations: int = 30, dx: float = 1.0,
                     fog: bool = False):
    """Rebuild a signed distance field from any scalar field's
    ``iso``-contour (``tools::levelSetRebuild``): seed with
    ``field − iso`` (``iso − field`` with ``fog=True``, for volumes whose
    interior is the high side), renormalize to unit gradient, clamp to
    ``±half_width·dx``.
    """
    seed = (iso - field) if fog else (field - iso)
    # a voxelized iso-contour lies midway between an inside and an outside
    # sample: normalize the seed's near-interface magnitude to dx/2
    g = torch.clamp(torch.amax(torch.abs(seed)), min=1e-12)
    seed = seed * (0.5 * dx / g)
    sdf = redistance(seed, iterations=iterations, dx=dx)
    w = half_width * dx
    return torch.clamp(sdf, -w, w)


def _box_blur_axis(a, d, width: int):
    """1-D box blur of odd ``width`` along axis ``d`` (edge-clamped, so
    filtering does not drag the far field toward zero at the box edge)."""
    acc = up = dn = a
    for _ in range(width // 2):
        up = _shift_edge(up, d, 1)
        dn = _shift_edge(dn, d, -1)
        acc = acc + up + dn
    return acc / float(width)


def _banded(phi, filtered, band: float | None, dx: float):
    if band is None:
        return filtered
    return torch.where(torch.abs(phi) > band * dx, phi, filtered)


def filter_mean(phi, width: int = 3, band: float | None = None,
                dx: float = 1.0):
    """Separable box (mean) filter — ``LevelSetFilter::mean``.  ``width``
    is the full odd stencil width in voxels; ``band`` (in voxels) freezes
    the far field."""
    if width % 2 != 1:
        raise ValueError("width must be odd")
    out = phi
    for d in range(3):
        out = _box_blur_axis(out, d, width)
    return _banded(phi, out, band, dx)


def filter_gaussian(phi, width: int = 3, iterations: int = 4,
                    band: float | None = None, dx: float = 1.0):
    """Gaussian filter as repeated box blurs — ``LevelSetFilter::gaussian``
    uses the same repeated-mean trick."""
    out = phi
    for _ in range(iterations):
        for d in range(3):
            out = _box_blur_axis(out, d, width)
    return _banded(phi, out, band, dx)


def filter_median(phi, band: float | None = None, dx: float = 1.0):
    """27-neighborhood median — ``LevelSetFilter::median`` with its default
    radius-1 box: the 14th of the 27 sorted values, out-of-box neighbors
    clamped to the edge value."""
    stack = []
    for sx in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sz in (-1, 0, 1):
                v = phi
                for d, s in enumerate((sx, sy, sz)):
                    v = _shift_edge(v, d, s)
                stack.append(v)
    med = torch.sort(torch.stack(stack, dim=-1), dim=-1).values[..., 13]
    return _banded(phi, med, band, dx)


def filter_offset(grid, offset, mask=None):
    """Add a constant to every voxel — ``tools::Filter::offset``
    (``openvdb/tools/Filter.h:166-168,419-433``); with ``mask`` (an alpha
    grid in [0,1]) the offset is alpha-blended per voxel."""
    if mask is None:
        return grid + offset
    return grid + mask * offset


def morph_levelset(phi, target, iterations: int = 20, dx: float = 1.0,
                   renorm_every: int = 5, speed_clamp: float = 3.0):
    """Morph one level set toward another — ``tools::LevelSetMorph``.

    Solves ``φ_t = α(x)|∇φ|`` with the speed ``α`` the target's signed
    distance clamped to ``±speed_clamp·dx``, Godunov upwinding, a band
    clamp, a 3-step renormalization every ``renorm_every`` steps and a
    final full redistance, as ``fluidsim_tpu``'s morph does.
    """
    cap = speed_clamp * dx
    speed = torch.clamp(target, -cap, cap)
    dt = 0.3 * dx / cap
    band = 3.0 * cap
    p = phi
    for i in range(iterations):
        g = _godunov_grad_norm(p, -speed, dx)
        p = torch.clamp(p + dt * speed * g, -band, band)
        if (i + 1) % renorm_every == 0:
            p = redistance(p, iterations=3, dx=dx)
    return redistance(p, iterations=int(band / (0.3 * dx)) + 2, dx=dx)


def track_levelset(phi, vc, dt, bound: int, order: int = 2,
                   redist_iterations: int = 5, half_width: float | None = None,
                   dx: float = 1.0, spatial: str = "semi"):
    """One tracked level-set advection step — ``tools::LevelSetAdvect`` +
    ``LevelSetTracker``: transport in the cell-centred ``(N,N,N,3)``
    velocity ``vc``, renormalization, optional truncation to
    ``±half_width·dx``.

    ``spatial``: ``"semi"`` (default) is the semi-Lagrangian path;
    ``"first"``/``"second"``/``"third"``/``"weno5"``/``"hjweno5"`` run
    Eulerian upwind HJ advection (``ops/fd.py``) with TVD-RK``order``.
    """
    if spatial == "semi":
        phi = advect_volume(phi, vc, dt, bound, order=order)
    else:
        # vc is index-space velocity in both paths, so the HJ gradient is
        # per voxel (dx=1); ``dx`` only scales the renormalization
        phi = advect_hj(phi, vc, dt, spatial=spatial,
                        temporal=min(order, 3), dx=1.0)
    phi = redistance(phi, iterations=redist_iterations, dx=dx)
    if half_width is not None:
        w = half_width * dx
        phi = torch.clamp(phi, -w, w)
    return phi


def _delta_weight(phi, dx: float, eps_voxels: float):
    """Surface-integral weight ``δ_ε(φ)|∇φ|``: smeared delta
    ``(1 + cos(πφ/ε)) / (2ε)`` on ``|φ| < ε`` times the central-difference
    gradient magnitude."""
    eps = eps_voxels * dx
    d = torch.where(torch.abs(phi) < eps,
                    (1.0 + torch.cos(math.pi * phi / eps)) / (2.0 * eps), 0.0)
    g2 = torch.zeros_like(phi)
    for ax in range(3):
        g = (shift_to_plus(phi, ax) - shift_to_minus(phi, ax)) / (2.0 * dx)
        g2 = g2 + g * g
    return d * torch.sqrt(g2)


def levelset_avg_curvature(phi, dx: float = 1.0, eps_voxels: float = 1.5):
    """Average mean curvature over the zero level set —
    ``tools::levelSetMeasure``'s third output
    (``openvdb/tools/LevelSetMeasure.h:95-108``); 1/r for a sphere."""
    w = _delta_weight(phi, dx, eps_voxels)
    kappa = mean_curvature(phi, dx)
    tot = torch.sum(w)
    return torch.sum(w * kappa) / torch.where(tot > 0, tot, 1.0)


def levelset_area(phi, dx: float = 1.0, eps_voxels: float = 1.5):
    """Surface area of the zero level set — ``tools::levelSetArea``
    (``LevelSetMeasure.h``): ``A = Σ δ_ε(φ) |∇φ| dx³``."""
    return torch.sum(_delta_weight(phi, dx, eps_voxels)) * dx ** 3
