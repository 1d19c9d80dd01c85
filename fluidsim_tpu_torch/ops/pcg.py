"""Preconditioned conjugate gradient over dense grid fields — the
counterpart of ``fluidsim_tpu/ops/pcg.py``.

The JAX solver runs in a ``lax.while_loop``; here the loop runs on the host
with the same predicate, ``(rr > tol2) & (k < maxiter)``, tested before every
iteration, so the iteration count matches.  Testing it reads one scalar
back from the device per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class PCGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor   # final ||r|| (unpreconditioned)


def _dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.sum((a * c).to(torch.float32))


def _safe_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` where ``den != 0``, else 0."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, 1.0), 0.0)


def pcg(apply_a: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
        precond: Callable | None = None, rtol: float = 1e-5,
        maxiter: int = 200) -> PCGResult:
    """Solve ``A x = b`` with preconditioned CG (``b`` already masked to the
    operator's range)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if precond is None:
        precond = lambda r: r

    bnorm2 = _dot(b, b)
    tol2 = rtol * rtol * bnorm2

    x = x0
    r = b - apply_a(x0)
    z = precond(r)
    p = z
    rz, rr = _dot(r, z), _dot(r, r)
    k = 0
    while k < maxiter and bool(rr > tol2):
        ap = apply_a(p)
        alpha = _safe_ratio(rz, _dot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new, rr = _dot(r, z), _dot(r, r)
        beta = _safe_ratio(rz_new, rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    return PCGResult(x=x, iters=k, residual=torch.sqrt(rr))


def chebyshev_preconditioner(apply_a: Callable, precond_d: Callable,
                             degree: int = 3, lam_max: float = 2.0,
                             ratio: float = 30.0):
    """Fixed-polynomial preconditioner: ``degree`` Chebyshev semi-iteration
    steps with Jacobi splitting (``precond_d`` = D^-1) on the interval
    [lam_max/ratio, lam_max] of D^-1 A.  For the masked pressure Laplacian,
    Gershgorin gives lam(D^-1 A) <= 2, so ``lam_max = 2`` is safe."""
    a, b = lam_max / ratio, lam_max
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma1 = theta / delta

    def precond(r):
        rho = 1.0 / sigma1
        d = precond_d(r) * (1.0 / theta)
        z = d
        for _ in range(degree - 1):
            resid = r - apply_a(z)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * precond_d(resid)
            z = z + d
            rho = rho_new
        return z

    return precond


def jacobi_preconditioner(diag: torch.Tensor, mask: torch.Tensor | None = None):
    """z = r / diag where diag > 0 (identity elsewhere), zeroed off ``mask``."""
    safe = torch.where(diag > 0, diag, 1.0)

    def apply(r):
        z = r / safe
        if mask is not None:
            z = torch.where(mask, z, 0.0)
        return z

    return apply
