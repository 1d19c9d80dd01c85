"""Grid and particle helpers of the plain references: the box, the 27-cell
neighbourhoods, P2G and G2P by whole-array gathers and ``index_add_``,
conjugate gradients and advection with the walls' bounce.  Every floating
tensor keeps the dtype it is given.  Nothing of the program is imported.
"""

from __future__ import annotations

import torch

# the 27 neighbour offsets, x slowest
OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


def cround(x):
    """C ``round()``: half away from zero."""
    return torch.where(x >= 0, torch.floor(x + 0.5), -torch.floor(-x + 0.5))


def cround_out(x):
    """Away from zero: ceil above 0, floor otherwise."""
    return torch.where(x > 0, torch.ceil(x), torch.floor(x))


def bspline(a):
    """The cubic B-spline compressed to support ``a = |x| < 1``."""
    a2 = a * a
    a3 = a2 * a
    inner = 4.0 * a3 - 4.0 * a2 + 2.0 / 3.0
    outer = -4.0 / 3.0 * a3 + 4.0 * a2 - 4.0 * a + 4.0 / 3.0
    return torch.where(a < 0.5, inner,
                       torch.where(a < 1.0, outer, torch.zeros_like(a)))


def plus(a, d):
    """``a[c + e_d]`` along axis ``d`` of an (N,N,N) tensor, 0 past the edge."""
    out = torch.zeros_like(a)
    src, dst = [slice(None)] * 3, [slice(None)] * 3
    src[d], dst[d] = slice(1, None), slice(0, -1)
    out[tuple(dst)] = a[tuple(src)]
    return out


def minus(a, d):
    """``a[c - e_d]`` along axis ``d``, 0 past the edge."""
    out = torch.zeros_like(a)
    src, dst = [slice(None)] * 3, [slice(None)] * 3
    src[d], dst[d] = slice(0, -1), slice(1, None)
    out[tuple(dst)] = a[tuple(src)]
    return out


def within(bound: int, m: int, device):
    """(N,N,N) bool: ``|c| <= m`` on every axis."""
    ok = torch.arange(-bound, bound + 1, device=device).abs() <= m
    return ok[:, None, None] & ok[None, :, None] & ok[None, None, :]


def walls(bound: int, wall: int, device):
    """(N,N,N) bool: the box walls, ``|c| > wall`` on some axis."""
    return ~within(bound, wall, device)


def base_cells(pos, bound: int):
    """(P, 3) int64 array indices of each particle's nearest cell, clipped
    to the box."""
    n = 2 * bound + 1
    return torch.clamp(cround(pos).long() + bound, 0, n - 1)


def neighbours(bc, n: int):
    """Yield ``(o, ids, inside)`` per offset: the flat id of each particle's
    neighbour cell and whether it lies in the grid."""
    for o, off in enumerate(OFFSETS):
        cell = bc + torch.tensor(off, device=bc.device)
        inside = torch.all((cell >= 0) & (cell < n), dim=-1)
        cell = cell.clamp(0, n - 1)
        yield o, (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2], inside


def p2g(w27, vel, bc, n: int):
    """(4, N,N,N): the sums of ``w`` and ``w v`` over the particles whose
    neighbourhood holds each cell."""
    acc = torch.zeros((n ** 3, 4), dtype=vel.dtype, device=vel.device)
    vals = torch.cat([torch.ones_like(vel[:, :1]), vel], dim=1)
    for o, ids, inside in neighbours(bc, n):
        w = torch.where(inside, w27[o], torch.zeros_like(w27[o]))
        acc.index_add_(0, ids, w[:, None] * vals)
    return acc.T.reshape(4, n, n, n)


def g2p(w27, bc, fields, n: int, keep):
    """(P, C): ``sum w f / sum w`` of channel-major cell fields over each
    particle's neighbours in ``keep`` (0 where no weight lands there)."""
    flat = torch.where(keep, 1.0, 0.0).to(fields.dtype).reshape(-1)
    f = torch.where(keep[None], fields, torch.zeros_like(fields))
    f = f.reshape(fields.shape[0], -1)
    num = torch.zeros((fields.shape[0], bc.shape[0]), dtype=fields.dtype,
                      device=fields.device)
    den = torch.zeros((bc.shape[0],), dtype=fields.dtype, device=fields.device)
    for o, ids, inside in neighbours(bc, n):
        w = torch.where(inside, w27[o], torch.zeros_like(w27[o]))
        num = num + w[None] * f[:, ids]
        den = den + w * flat[ids]
    nz = den != 0
    return torch.where(nz[:, None], (num / torch.where(nz, den, 1.0)).T,
                       torch.zeros_like(num.T))


def cell_centre(v):
    """MAC face velocity (3,N,N,N) to cell centres."""
    return torch.stack([0.5 * (v[d] + plus(v[d], d)) for d in range(3)])


def dot(a, b):
    return torch.sum(a * b)


def norm(x):
    return torch.sqrt(torch.sum(x * x))


def ratio(num, den):
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))



def pcg(apply_a, b, x0, rtol: float, maxiter: int, precond=None):
    """Preconditioned CG (the identity without ``precond``); stops when
    ``r.r <= rtol^2 b.b`` or at ``maxiter``.  Returns (x, iterations,
    r.r)."""
    precond = precond or (lambda r: r)
    tol2 = rtol * rtol * dot(b, b)
    x = x0
    r = b - apply_a(x0)
    z = precond(r)
    p = z
    rz, rr = dot(r, z), dot(r, r)
    k = 0
    while k < maxiter and bool(rr > tol2):
        ap = apply_a(p)
        alpha = ratio(rz, dot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new, rr = dot(r, z), dot(r, r)
        p = z + ratio(rz_new, rz) * p
        rz = rz_new
        k += 1
    return x, k, rr


def advect(pos, vel, dt, bound: int, wall: int, rnd=cround):
    """Move by ``dt vel``; where the new cell (``rnd`` of the new position)
    is a wall, each axis whose probe (that axis moved, the others
    truncated) is a wall loses its velocity (restitution 0) and the
    particle moves by what is left."""
    def wall_at(c):
        inb = torch.all(torch.abs(c) <= bound, dim=-1)
        return torch.any(torch.abs(c) > wall, dim=-1) & inb

    pnew = pos + dt * vel
    r = rnd(pnew).long()
    hit = wall_at(r)
    trunc = torch.trunc(pos).long()
    vm = []
    for d in range(3):
        probe = trunc.clone()
        probe[:, d] = r[:, d]
        vm.append(torch.where(hit & wall_at(probe), torch.zeros_like(vel[:, d]),
                              vel[:, d]))
    vm = torch.stack(vm, dim=-1)
    return torch.where(hit[:, None], pos + vm * dt, pnew), vm


