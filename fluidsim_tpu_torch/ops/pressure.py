"""Matrix-free pressure Poisson pieces — the counterpart of
``fluidsim_tpu/ops/pressure.py`` for channel-major (3,N,N,N) velocity.

* rows = fluid cells (occupancy > 0 and not solid);
* Neumann at solid cells, Dirichlet p = 0 at air cells;
* diag = scale * #non-solid 6-neighbours, off-diagonal -scale between
  fluid neighbours (scale = dt / (rho dx^2));
* the RHS carries the solid-wall terms with ``g*dt`` folded in, minus the
  masked divergence, with the reference's quirk of dropping a whole axis
  term where the plus-neighbour is solid;
* the velocity update applies the gradient at 1/10 strength and re-adds
  gravity on every outer pass — quirks of the reference kept on purpose
  (the clean projection applies it at full strength, without gravity).
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch.core.gridspec import shift_to_minus, shift_to_plus
from fluidsim_tpu_torch.ops.stencil_kernels import apply_laplacian_plain


def set_rhs(vel, fluid, solid, gravity, dt, dx):
    """Solid-wall RHS terms: per fluid cell and axis d, subtract
    ``(v[d, c] + g_d*dt)/dx`` if the minus-neighbour is solid and add
    ``(v[d, c+e_d] + g_d*dt)/dx`` if the plus-neighbour is solid.  Cells
    beyond the box read as non-solid."""
    scale = 1.0 / dx
    rhs = torch.zeros(fluid.shape, dtype=vel.dtype, device=vel.device)
    solid_f = solid.to(vel.dtype)
    for d in range(3):
        g_d = gravity[d] * dt
        vd = vel[d]
        sm = shift_to_minus(solid_f, d)
        sp = shift_to_plus(solid_f, d)
        vp = shift_to_plus(vd, d)
        rhs = rhs - scale * sm * (vd + g_d) + scale * sp * (vp + g_d)
    return torch.where(fluid, rhs, 0.0)


def divergence_rhs(vel, rhs, fluid, solid, dx):
    """``rhs - div(v)`` on fluid cells; the axis term
    ``(v[d, c+e_d] - v[d, c])/dx`` is dropped where the plus-neighbour is
    solid (reference quirk)."""
    div = torch.zeros(fluid.shape, dtype=vel.dtype, device=vel.device)
    for d in range(3):
        vd = vel[d]
        vp = shift_to_plus(vd, d)
        open_p = ~shift_to_plus(solid, d)
        div = div + torch.where(open_p, (vp - vd) / dx, 0.0)
    return torch.where(fluid, rhs - div, 0.0)


def laplacian_diag(fluid, solid, dt, rho, dx, dtype=torch.float32):
    """``scale * #non-solid neighbours`` on fluid cells, 0 elsewhere."""
    scale = dt / (rho * dx * dx)
    ns = (~solid).to(dtype)
    count = torch.zeros(fluid.shape, dtype=dtype, device=fluid.device)
    for d in range(3):
        count = count + shift_to_plus(ns, d) + shift_to_minus(ns, d)
    return torch.where(fluid, scale * count, 0.0)


def apply_laplacian(p, adiag, fluid, dt, rho, dx):
    """Matrix-free ``A @ p`` (plain): diagonal minus fluid-fluid couplings,
    with the reference's signature.  It is the plain K3 of
    ``stencil_kernels``, whose fluid mask is ``adiag > 0``: ``laplacian_diag``
    makes that every fluid cell with a non-solid neighbour, and a fluid cell
    walled in on all six sides gives 0 under either mask."""
    return apply_laplacian_plain(torch.where(fluid, p, 0.0), adiag,
                                 dt / (rho * dx * dx))


def apply_laplacian_dense(p, adiag, fluid, dt, rho, dx):
    """Matrix-free ``A @ p`` in the JAX package's dense order
    (``pressure.apply_laplacian``): ``adiag*p``, then minus
    ``scale*(x+ + x-)``, ``scale*(y+ + y-)`` and ``scale*(z+ + z-)``, masked
    to ``fluid``.  The multigrid coarse levels use it; K3 sums in another
    order."""
    scale = dt / (rho * dx * dx)
    pf = torch.where(fluid, p, 0.0)
    acc = adiag * pf
    for d in range(3):
        acc = acc - scale * (shift_to_plus(pf, d) + shift_to_minus(pf, d))
    return torch.where(fluid, acc, 0.0)


def vel_update(vel, p, fluid, solid, gravity, dt, rho, dx,
               gradient_scale: float = 0.1, add_gravity: bool = True):
    """Pressure gradient + gravity + solid boundary update of channel-major
    velocity (the reference's ``velUpdate`` called with ``dt/10``).  The
    clean projection calls it with ``gradient_scale=1.0,
    add_gravity=False``.

    Per fluid cell c: all three components at c get ``-= scale*p(c)`` (and
    ``+= g*dt`` with ``add_gravity``); component d at ``c+e_d`` gets
    ``+= scale*p(c)``.  Then component d is zeroed at solid cells and at
    cells whose minus-d neighbour is solid."""
    scale = (dt * gradient_scale) / (rho * dx)
    pf = torch.where(fluid, p, 0.0) * scale
    fl = fluid.to(vel.dtype)
    out = []
    for d in range(3):
        vd = vel[d] - pf + shift_to_minus(pf, d)
        if add_gravity:
            vd = vd + gravity[d] * dt * fl
        blocked = solid | shift_to_minus(solid, d)
        out.append(torch.where(blocked, 0.0, vd))
    return torch.stack(out, dim=0)
