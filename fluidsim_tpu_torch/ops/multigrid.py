"""Geometric multigrid V-cycle preconditioner for the pressure projection —
the counterpart of ``fluidsim_tpu/ops/multigrid.py``.

The cycle is damped-Jacobi smoothing (``omega = 0.8``), a masked 2x block
average for restriction and piecewise-constant prolongation (8 x the
restriction's transpose), over masked Laplacians rediscretised on each
coarser grid (``dx`` doubles per level).  Equal pre- and post-smoothing
keep the cycle symmetric, as PCG needs.

``mg_preconditioner_packed`` is what the frame runs, as the JAX package's
packed branch does: the fine level's sweeps and residual are K3
(``stencil_kernels.apply_laplacian``), the coarse levels plain PyTorch in
the JAX dense order (``pressure.apply_laplacian_dense``).  The TPU layout's
``pad``/``unpad`` are the identity on the port's dense layout and are
dropped.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

from fluidsim_tpu_torch.ops import pressure as pr


class MgLevel(NamedTuple):
    fluid: torch.Tensor     # (n,n,n) bool
    solid: torch.Tensor     # (n,n,n) bool
    adiag: torch.Tensor     # (n,n,n) diagonal of the level operator
    dt: torch.Tensor
    rho: float
    dx: float


def _pad_even(a: torch.Tensor, fill) -> torch.Tensor:
    """Pad the three grid axes of an odd-sized ``a`` by one cell of
    ``fill`` at the high end."""
    n = a.shape[0]
    if n % 2 == 0:
        return a
    out = torch.full((n + 1,) * 3 + tuple(a.shape[3:]), fill, dtype=a.dtype,
                     device=a.device)
    out[:n, :n, :n] = a
    return out


def _blocks(a: torch.Tensor) -> torch.Tensor:
    """(2m,2m,2m) -> (m,m,m,8), each 2^3 block's cells x-major."""
    m = a.shape[0] // 2
    return (a.reshape(m, 2, m, 2, m, 2).permute(0, 2, 4, 1, 3, 5)
            .reshape(m, m, m, 8))


def coarsen_masks(fluid: torch.Tensor, solid: torch.Tensor):
    """A coarse cell is solid iff all 8 fine cells are solid (the padding
    counts as solid), fluid iff any fine cell is fluid and it is not
    solid."""
    fb = _blocks(_pad_even(fluid, False))
    sb = _blocks(_pad_even(solid, True))
    solid_c = torch.all(sb, dim=-1)
    fluid_c = torch.any(fb, dim=-1) & ~solid_c
    return fluid_c, solid_c


def restrict(r: torch.Tensor) -> torch.Tensor:
    """Full-block average ``(1/8) * sum`` of the 2^3 fine cells, summed in
    block order (the JAX ``mean``'s order on the CPU)."""
    b = _blocks(_pad_even(r, 0.0))
    s = b[..., 0]
    for k in range(1, 8):
        s = s + b[..., k]
    return s / 8.0


def prolong(e_c: torch.Tensor, n_fine: int) -> torch.Tensor:
    """Piecewise-constant prolongation (8 x restrict^T)."""
    m = e_c.shape[0]
    e = (e_c[:, None, :, None, :, None].expand(m, 2, m, 2, m, 2)
         .reshape(2 * m, 2 * m, 2 * m))
    return e[:n_fine, :n_fine, :n_fine]


def build_hierarchy(fluid, solid, dt, rho: float, dx: float,
                    min_size: int = 9) -> List[MgLevel]:
    """The finest level and each coarser one down to the last of at least
    ``min_size`` cells a side (129 -> 65 -> 33 -> 17 -> 9)."""
    levels = [MgLevel(fluid, solid,
                      pr.laplacian_diag(fluid, solid, dt, rho, dx), dt, rho,
                      dx)]
    f, s, d = fluid, solid, dx
    while (f.shape[0] + 1) // 2 >= min_size:
        f, s = coarsen_masks(f, s)
        d = d * 2.0
        levels.append(MgLevel(f, s, pr.laplacian_diag(f, s, dt, rho, d),
                              dt, rho, d))
    return levels


def _smooth(level: MgLevel, x, b, sweeps: int, omega: float = 0.8):
    """``sweeps`` damped-Jacobi sweeps on a coarse level (dense order)."""
    safe = torch.where(level.adiag > 0, level.adiag, 1.0)
    for _ in range(sweeps):
        r = b - pr.apply_laplacian_dense(x, level.adiag, level.fluid,
                                         level.dt, level.rho, level.dx)
        x = torch.where(level.fluid, x + omega * r / safe, 0.0)
    return x


def v_cycle(levels: List[MgLevel], b, pre: int = 2, post: int = 2,
            coarse_sweeps: int = 24, start: int = 0):
    """One symmetric V-cycle approximating ``A^-1 b``, descending from level
    ``start`` (0 = finest)."""

    def cycle(li, b):
        lev = levels[li]
        if li == len(levels) - 1:
            return _smooth(lev, torch.zeros_like(b), b, coarse_sweeps)
        x = _smooth(lev, torch.zeros_like(b), b, pre)
        r = b - pr.apply_laplacian_dense(x, lev.adiag, lev.fluid, lev.dt,
                                         lev.rho, lev.dx)
        rc = restrict(torch.where(lev.fluid, r, 0.0))
        rc = torch.where(levels[li + 1].fluid, rc, 0.0)
        ec = cycle(li + 1, rc)
        x = x + torch.where(lev.fluid, prolong(ec, b.shape[0]), 0.0)
        return _smooth(lev, x, b, post)

    return cycle(start, b)


def mg_preconditioner(fluid, solid, dt, rho: float, dx: float,
                      pre: int = 2, post: int = 2) -> Callable:
    """The plain V-cycle preconditioner, every level in the dense order."""
    levels = build_hierarchy(fluid, solid, dt, rho, dx)

    def precond(r):
        return v_cycle(levels, torch.where(fluid, r, 0.0), pre=pre, post=post)

    return precond


def mg_preconditioner_packed(fluid, solid, dt, rho: float, dx: float,
                             apply_fine: Callable, adiag: torch.Tensor,
                             pre: int = 2, post: int = 2,
                             omega: float = 0.8) -> Callable:
    """The V-cycle with the fine level's damped-Jacobi sweeps and residual
    on ``apply_fine`` (the frame's K3 ``A @ q`` with ``adiag``), masked to
    ``adiag > 0`` as K3 is, and the coarse levels through ``v_cycle`` from
    level 1.  One application makes ``pre + 1 + post`` fine applies (``pre
    + post`` on a grid too small to coarsen)."""
    levels = build_hierarchy(fluid, solid, dt, rho, dx)
    mask = adiag > 0
    safe = torch.where(mask, adiag, 1.0)
    n_fine = fluid.shape[0]

    def smooth_fine(x, b, sweeps):
        for _ in range(sweeps):
            r = b - apply_fine(x)
            x = torch.where(mask, x + omega * r / safe, 0.0)
        return x

    if len(levels) == 1:
        def precond(r):
            b = torch.where(mask, r, 0.0)
            return smooth_fine(torch.zeros_like(b), b, pre + post)
        return precond

    def precond(r):
        b = torch.where(mask, r, 0.0)
        x = smooth_fine(torch.zeros_like(b), b, pre)
        rd = b - apply_fine(x)
        rc = restrict(torch.where(levels[0].fluid, rd, 0.0))
        rc = torch.where(levels[1].fluid, rc, 0.0)
        ec = v_cycle(levels, rc, pre=pre, post=post, start=1)
        x = x + torch.where(levels[0].fluid, prolong(ec, n_fine), 0.0)
        return smooth_fine(x, b, post)

    return precond
