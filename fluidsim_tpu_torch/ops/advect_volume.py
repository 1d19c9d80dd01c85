"""Semi-Lagrangian volume and point advection — the counterpart of
``fluidsim_tpu/ops/advect_volume.py`` (the capability answers to
``openvdb/tools/VolumeAdvect.h`` and ``openvdb/tools/PointAdvect.h``).

Dense formulation on the tensors' device: trilinear, nearest,
triquadratic and staggered sampling at index-space positions, and
RK1/RK2/RK3 integrators.
"""

from __future__ import annotations

import torch


def _lattice(bound: int, dtype, device) -> torch.Tensor:
    """(N^3, 3) cell-centre coordinates of the ``[-B, B]^3`` box, x slowest."""
    c = torch.arange(-bound, bound + 1, dtype=dtype, device=device)
    return torch.stack(torch.meshgrid(c, c, c, indexing="ij"),
                       dim=-1).reshape(-1, 3)


def sample_trilinear(field, pos, bound: int):
    """Trilinear sample of a cell-centred dense field at index-space
    positions (clamped at the box edge).

    field: (N,N,N) or (N,N,N,C); pos: (P,3) grid coordinates.
    """
    n = 2 * bound + 1
    p = torch.clamp(pos + bound, 0.0, n - 1.000001)
    i0 = torch.floor(p).to(torch.int32)
    f = p - i0
    i1 = torch.clamp(i0 + 1, max=n - 1)
    flat_field = field.reshape(n * n * n, -1)

    def gather(ix, iy, iz):
        return flat_field[((ix * n + iy) * n + iz).long()]

    fz, fy, fx = f[:, 2:3], f[:, 1:2], f[:, 0:1]
    c00 = (gather(i0[:, 0], i0[:, 1], i0[:, 2]) * (1 - fz)
           + gather(i0[:, 0], i0[:, 1], i1[:, 2]) * fz)
    c01 = (gather(i0[:, 0], i1[:, 1], i0[:, 2]) * (1 - fz)
           + gather(i0[:, 0], i1[:, 1], i1[:, 2]) * fz)
    c10 = (gather(i1[:, 0], i0[:, 1], i0[:, 2]) * (1 - fz)
           + gather(i1[:, 0], i0[:, 1], i1[:, 2]) * fz)
    c11 = (gather(i1[:, 0], i1[:, 1], i0[:, 2]) * (1 - fz)
           + gather(i1[:, 0], i1[:, 1], i1[:, 2]) * fz)
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    out = c0 * (1 - fx) + c1 * fx
    return out if field.dim() == 4 else out[:, 0]


def sample_nearest(field, pos, bound: int):
    """Nearest-neighbor sample — ``tools::PointSampler``
    (``openvdb/tools/Interpolation.h:191,816-821``).  Ties round
    half away from zero on the index-space coordinate, the reference's
    ``roundVec3`` (``::round``); ``torch.round`` rounds half to even and
    would pick the wrong voxel at every .5 tie with an even floor."""
    n = 2 * bound + 1
    r = torch.where(pos >= 0, torch.floor(pos + 0.5), torch.ceil(pos - 0.5))
    i = torch.clamp(r.to(torch.int32) + bound, 0, n - 1)
    flat = ((i[:, 0] * n + i[:, 1]) * n + i[:, 2]).long()
    vals = field.reshape(n * n * n, -1)[flat]
    return vals if field.dim() == 4 else vals[:, 0]


def sample_quadratic(field, pos, bound: int):
    """Triquadratic sample — ``tools::QuadraticSampler``
    (``openvdb/tools/Interpolation.h:189,802-846``): per axis, a parabola
    through the samples at offsets −1/0/+1 from the floored query,
    evaluated at the fractional part; separable tensor product.
    Out-of-box stencil taps clamp to the box edge."""
    n = 2 * bound + 1
    p = torch.clamp(pos + bound, 0.0, n - 1.000001)
    i0 = torch.floor(p).to(torch.int32)
    t = p - i0

    # quadratic Lagrange weights at nodes -1, 0, +1
    def wts(td):
        return (0.5 * td * (td - 1.0), 1.0 - td * td, 0.5 * td * (td + 1.0))

    wx, wy, wz = wts(t[:, 0:1]), wts(t[:, 1:2]), wts(t[:, 2:3])
    flat_field = field.reshape(n * n * n, -1)
    out = 0.0
    for dx in (-1, 0, 1):
        ix = torch.clamp(i0[:, 0] + dx, 0, n - 1)
        for dy in (-1, 0, 1):
            iy = torch.clamp(i0[:, 1] + dy, 0, n - 1)
            for dz in (-1, 0, 1):
                iz = torch.clamp(i0[:, 2] + dz, 0, n - 1)
                w = wx[dx + 1] * wy[dy + 1] * wz[dz + 1]
                out = out + w * flat_field[((ix * n + iy) * n + iz).long()]
    return out if field.dim() == 4 else out[:, 0]


def sample_staggered(field, pos, bound: int, order: int = 1):
    """Staggered sample of an ``(N,N,N,3)`` vector field whose component
    ``d`` at index ``i`` is stored on the cell's LOWER face ``i − 0.5·e_d``
    — ``tools::Staggered{Point,Box,Quadratic}Sampler``
    (``openvdb/tools/Interpolation.h:906-1007``): each component is
    sampled with the query shifted by +0.5 along its own axis.
    ``order``: 0 nearest, 1 trilinear, 2 triquadratic.
    """
    sampler = {0: sample_nearest, 1: sample_trilinear,
               2: sample_quadratic}[order]
    comps = []
    for d in range(3):
        shifted = pos.clone()
        shifted[:, d] += 0.5
        comps.append(sampler(field[..., d:d + 1], shifted, bound)[:, 0])
    return torch.stack(comps, dim=-1)


def advect_points(pos, vc, dt, bound: int, order: int = 2):
    """Advect positions through a cell-centred velocity field
    (``tools::PointAdvect``): RK1/2/3."""
    k1 = sample_trilinear(vc, pos, bound)
    if order == 1:
        return pos + dt * k1
    k2 = sample_trilinear(vc, pos + 0.5 * dt * k1, bound)
    if order == 2:
        return pos + dt * k2
    k3 = sample_trilinear(vc, pos + dt * (2.0 * k2 - k1), bound)
    return pos + dt * (k1 + 4.0 * k2 + k3) / 6.0


def advect_volume(field, vc, dt, bound: int, order: int = 2):
    """Semi-Lagrangian advection of a dense scalar field
    (``tools::VolumeAdvect``): sample the field at back-traced cell
    centres."""
    n = 2 * bound + 1
    grid_pos = _lattice(bound, vc.dtype, vc.device)
    back = advect_points(grid_pos, vc, -dt, bound, order=order)
    return sample_trilinear(field, back, bound).reshape(n, n, n)
