"""Pressure-solve stencil kernels — the counterpart of
``fluidsim_tpu/ops/pallas_stencil.py``: the masked 7-point Laplacian (K3,
``apply_laplacian_padded``), the fused Chebyshev step (K4,
``cheb_step_padded``) and the preconditioner built on it
(``chebyshev_precond_fused``).

The CG state stays in the dense (N,N,N) layout; the TPU path's padded
(Npx, L) layout and its block and lane-halo choices fit VMEM and are not
needed here.  A cell is fluid exactly where ``adiag > 0``.

``apply_laplacian`` and ``cheb_step`` launch the CUDA kernels of
``csrc/stencil.cu`` for CUDA tensors and use their plain PyTorch versions
only for CPU tensors; anything else raises.  Each counts its kernel launches
in ``.launches``.  Both versions round every operation the same way (the
kernels are built without FMA contraction), so they agree bit for bit.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch import native
from fluidsim_tpu_torch.core.gridspec import shift_to_minus, shift_to_plus


def _masked_laplacian(q: torch.Tensor, adiag: torch.Tensor, scale: float):
    """``adiag*q - scale*(x- + x+ + y- + y+ + z- + z+)`` of an already
    masked ``q``, summed in that order (the TPU kernel's order)."""
    s = shift_to_minus(q, 0) + shift_to_plus(q, 0)
    s = s + shift_to_minus(q, 1)
    s = s + shift_to_plus(q, 1)
    s = s + shift_to_minus(q, 2)
    s = s + shift_to_plus(q, 2)
    return adiag * q - scale * s


# ---- K3: masked Laplacian -------------------------------------------------

def apply_laplacian_plain(p: torch.Tensor, adiag: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Plain PyTorch K3."""
    fluid = adiag > 0
    q = torch.where(fluid, p, 0.0)
    return torch.where(fluid, _masked_laplacian(q, adiag, scale), 0.0)


def apply_laplacian(p: torch.Tensor, adiag: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """K3: ``A @ p`` on (N,N,N) f32 — ``adiag*p - scale * (sum of the fluid
    neighbours of p)`` on fluid cells, 0 elsewhere.  CUDA tensors launch
    ``fs_apply_laplacian``; CPU tensors take ``apply_laplacian_plain``."""
    if p.device.type == "cpu":
        return apply_laplacian_plain(p, adiag, scale)
    native.require_cuda(p, "apply_laplacian")
    dev = p.device
    n = p.shape[0]
    for name, t in (("p", p), ("adiag", adiag)):
        native.check_tensor(name, t, torch.float32, (n, n, n), dev)
    out = torch.empty_like(p)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_apply_laplacian(p.data_ptr(), adiag.data_ptr(),
                                    out.data_ptr(), float(scale), n,
                                    native.stream_ptr(dev))
    native.check_launch("apply_laplacian", rc)
    apply_laplacian.launches += 1
    return out


apply_laplacian.launches = 0


# ---- K4: fused Chebyshev step ---------------------------------------------

def cheb_step_plain(z: torch.Tensor, adiag: torch.Tensor, r: torch.Tensor,
                    d: torch.Tensor, scale: float, c1: float, c2: float):
    """Plain PyTorch K4; returns (d_new, z_new)."""
    fluid = adiag > 0
    q = torch.where(fluid, z, 0.0)
    az = torch.where(fluid, _masked_laplacian(q, adiag, scale), 0.0)
    resid = r - az
    safe = torch.where(fluid, adiag, 1.0)
    pd = torch.where(fluid, resid / safe, 0.0)
    dn = c1 * d + c2 * pd
    return dn, q + dn


def cheb_step(z: torch.Tensor, adiag: torch.Tensor, r: torch.Tensor,
              d: torch.Tensor, scale: float, c1: float, c2: float):
    """K4: one Chebyshev inner step ``resid = r - A z; d' = c1*d +
    c2*resid/adiag (fluid only); z' = z + d'`` in one pass; returns
    (d', z').  CUDA tensors launch ``fs_cheb_step``; CPU tensors take
    ``cheb_step_plain``."""
    if z.device.type == "cpu":
        return cheb_step_plain(z, adiag, r, d, scale, c1, c2)
    native.require_cuda(z, "cheb_step")
    dev = z.device
    n = z.shape[0]
    for name, t in (("z", z), ("adiag", adiag), ("r", r), ("d", d)):
        native.check_tensor(name, t, torch.float32, (n, n, n), dev)
    dn = torch.empty_like(z)
    zn = torch.empty_like(z)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_cheb_step(z.data_ptr(), adiag.data_ptr(), r.data_ptr(),
                              d.data_ptr(), dn.data_ptr(), zn.data_ptr(),
                              float(scale), float(c1), float(c2), n,
                              native.stream_ptr(dev))
    native.check_launch("cheb_step", rc)
    cheb_step.launches += 1
    return dn, zn


cheb_step.launches = 0


CHEB_DEGREE = 3   # polynomial degree of the frame's preconditioner:
                  # CHEB_DEGREE - 1 fused steps per application


def chebyshev_precond_fused(adiag: torch.Tensor, scale: float,
                            degree: int = CHEB_DEGREE, lam_max: float = 2.0,
                            ratio: float = 30.0):
    """Chebyshev-Jacobi preconditioner with fused inner steps (K4): the
    polynomial of ``ops.pcg.chebyshev_preconditioner`` with each inner step
    one ``cheb_step``.  The rho recurrence is Python float arithmetic, so
    every step's (c1, c2) is a constant of the call."""
    a, b = lam_max / ratio, lam_max
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma1 = theta / delta
    fluid = adiag > 0
    safe_ad = torch.where(fluid, adiag, 1.0)

    def precond(r):
        rho = 1.0 / sigma1
        d = torch.where(fluid, r / safe_ad, 0.0) * (1.0 / theta)
        z = d
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d, z = cheb_step(z, adiag, r, d, scale, rho_new * rho,
                             2.0 * rho_new / delta)
            rho = rho_new
        return z

    return precond
