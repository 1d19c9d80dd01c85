"""Dense grid differential operators — the counterpart of
``fluidsim_tpu/ops/gridops.py`` (``openvdb/tools/GridOperators.h`` /
``openvdb/math/Operators.h`` analogs: cpt, curl, divergence, gradient,
laplacian, meanCurvature, magnitude, normalize).

Conventions:
  * all operators are index-space (divide by ``dx`` powers as documented)
    and use 2nd-order central differences, matching the reference's
    ``CD_2ND`` default;
  * tensors are dense ``(N, N, N)`` scalar or ``(N, N, N, 3)`` vector
    fields; out-of-box neighbor reads see the OpenVDB background (zero),
    like the reference's ``ValueAccessor`` on an empty voxel.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch.core.gridspec import shift_to_minus, shift_to_plus

__all__ = [
    "gradient", "divergence", "curl", "laplacian", "mean_curvature",
    "magnitude", "normalize", "closest_point_transform",
]


def _central(a, d, dx: float):
    """(a[c+e_d] - a[c-e_d]) / (2 dx) — ``ISGradient<CD_2ND>``."""
    return (shift_to_plus(a, d) - shift_to_minus(a, d)) / (2.0 * dx)


def gradient(f, dx: float = 1.0):
    """Central-difference gradient of a scalar field -> ``(N,N,N,3)``
    (``tools::gradient``)."""
    return torch.stack([_central(f, d, dx) for d in range(3)], dim=-1)


def divergence(v, dx: float = 1.0):
    """Central-difference divergence of a collocated vector field
    (``tools::divergence``)."""
    return sum(_central(v[..., d], d, dx) for d in range(3))


def curl(v, dx: float = 1.0):
    """Central-difference curl of a collocated vector field
    (``tools::curl``)."""
    def ddx(comp, d):
        return _central(v[..., comp], d, dx)

    return torch.stack([
        ddx(2, 1) - ddx(1, 2),
        ddx(0, 2) - ddx(2, 0),
        ddx(1, 0) - ddx(0, 1),
    ], dim=-1)


def laplacian(f, dx: float = 1.0):
    """7-point Laplacian of a scalar field (``ISLaplacian<CD_SECOND>``,
    ``tools::laplacian``)."""
    acc = -6.0 * f
    for d in range(3):
        acc = acc + shift_to_plus(f, d) + shift_to_minus(f, d)
    return acc / (dx * dx)


def magnitude(v):
    """Per-cell Euclidean norm of a vector field (``tools::magnitude``)."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def normalize(v, eps: float = 1e-12):
    """Per-cell unit vectors; zero vectors stay zero (``tools::normalize``)."""
    return v / torch.clamp(magnitude(v), min=eps)[..., None]


def mean_curvature(f, dx: float = 1.0, eps: float = 1e-12):
    """Mean curvature ``κ = (κ₁+κ₂)/2`` of the level sets of ``f``
    (``tools::meanCurvature``): ``div(∇f/|∇f|) / 2`` from first and second
    central differences — a radius-``r`` sphere SDF gives ``1/r``."""
    fx = [_central(f, d, dx) for d in range(3)]
    fxx = [(shift_to_plus(f, d) + shift_to_minus(f, d) - 2.0 * f) / (dx * dx)
           for d in range(3)]
    # mixed derivatives: central difference of the central difference
    fxy = _central(fx[0], 1, dx)
    fxz = _central(fx[0], 2, dx)
    fyz = _central(fx[1], 2, dx)
    gx, gy, gz = fx
    g2 = gx * gx + gy * gy + gz * gz
    num = (gx * gx * (fxx[1] + fxx[2]) +
           gy * gy * (fxx[0] + fxx[2]) +
           gz * gz * (fxx[0] + fxx[1]) -
           2.0 * (gx * gy * fxy + gx * gz * fxz + gy * gz * fyz))
    return num / (2.0 * torch.clamp(g2, min=eps) ** 1.5)


def closest_point_transform(sdf, bound: int, dx: float = 1.0):
    """Closest-point transform of a signed distance field -> ``(N,N,N,3)``
    (``tools::cpt``): ``x - φ(x) ∇φ/|∇φ|`` for each cell centre, in grid
    coordinates ``[-B, B]``."""
    n = normalize(gradient(sdf, dx))
    c = torch.arange(-bound, bound + 1, dtype=sdf.dtype, device=sdf.device) * dx
    x = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), dim=-1)
    return x - sdf[..., None] * n
