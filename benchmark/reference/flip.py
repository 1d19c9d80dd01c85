"""The FLIP frame of ``water_cube_drop`` in plain PyTorch: a frozen copy of
the mathematics that the benchmark holds the program to.

One frame is

  sort by cell -> the 27 quadratic B-spline weights -> P2G of weight and
  momentum -> target-cell masks and fluid cells -> the reference's
  projection do-while (Chebyshev-Jacobi PCG on the masked 7-point
  Laplacian, the gradient at 1/10 strength, gravity on every pass) -> the
  FLIP delta gathered back -> CFL dt -> advection with the walls' bounce

with ``fluid.cc``'s quirks kept (the solid-wall RHS terms, the dropped
divergence term next to a solid, the outer error ``|b - b2| / |b|``).
Every step works on whole arrays with no kernel, cache or chunking, and
every floating tensor is of the ``dtype`` given, so the same code computed
in bfloat16 is the control that the comparison must fail.  It imports
nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark.reference.grid import (OFFSETS, advect, base_cells, bspline,
                                      cell_centre, cround, g2p, minus, norm,
                                      p2g, pcg, plus, ratio, walls, within)


def spline_flip(x):
    """The FLIP weight ``1.5 B(|x|)``."""
    return 1.5 * bspline(torch.abs(x))


def weights27(pos, bound: int):
    """(27, P) products of the per-axis weights of the offsets, 0 for a
    particle whose nearest cell lies outside the box."""
    base = cround(pos)
    valid = torch.all(torch.abs(base) <= bound, dim=-1)
    ax = [[spline_flip(pos[:, a] - (base[:, a] + (q - 1))) for q in range(3)]
          for a in range(3)]
    w = torch.stack([ax[0][i + 1] * ax[1][j + 1] * ax[2][k + 1]
                     for i, j, k in OFFSETS])
    return torch.where(valid[None], w, torch.zeros_like(w))


# ---- the projection -------------------------------------------------------

def set_rhs(v, fluid, solid, g, dt, dx):
    """The solid-wall terms: per axis, ``-(v_d + g_d dt)/dx`` where the
    minus neighbour is solid and ``+(v_d(c+e_d) + g_d dt)/dx`` where the plus
    neighbour is."""
    rhs = torch.zeros_like(v[0])
    s = solid.to(v.dtype)
    for d in range(3):
        gd = g[d] * dt
        rhs = (rhs - (1.0 / dx) * minus(s, d) * (v[d] + gd)
               + (1.0 / dx) * plus(s, d) * (plus(v[d], d) + gd))
    return torch.where(fluid, rhs, torch.zeros_like(rhs))


def div_rhs(v, rhs, fluid, solid, dx):
    """``rhs - div v`` on fluid cells, an axis term dropped where the plus
    neighbour is solid."""
    div = torch.zeros_like(v[0])
    for d in range(3):
        term = (plus(v[d], d) - v[d]) / dx
        div = div + torch.where(plus(solid, d), torch.zeros_like(term), term)
    out = rhs - div
    return torch.where(fluid, out, torch.zeros_like(out))


def laplacian(q, adiag, scale):
    """``adiag q - scale (sum of the six neighbours)`` on the cells with
    ``adiag > 0``, with q read there only."""
    act = adiag > 0
    q = torch.where(act, q, torch.zeros_like(q))
    s = minus(q, 0) + plus(q, 0) + minus(q, 1) + plus(q, 1) + minus(q, 2) \
        + plus(q, 2)
    out = adiag * q - scale * s
    return torch.where(act, out, torch.zeros_like(out))


def chebyshev(adiag, scale, degree: int, ratio: float, lam_max: float = 2.0):
    """The Chebyshev semi-iteration with Jacobi splitting on
    [lam_max/ratio, lam_max] of D^-1 A, ``degree`` terms."""
    a, b = lam_max / ratio, lam_max
    theta, delta = 0.5 * (b + a), 0.5 * (b - a)
    sigma1 = theta / delta
    act = adiag > 0
    safe = torch.where(act, adiag, torch.ones_like(adiag))

    def jacobi(r):
        return torch.where(act, r / safe, torch.zeros_like(r))

    def apply(r):
        rho = 1.0 / sigma1
        d = jacobi(r) * (1.0 / theta)
        z = d
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * jacobi(
                r - laplacian(z, adiag, scale))
            z = torch.where(act, z, torch.zeros_like(z)) + d
            rho = rho_new
        return z

    return apply


def vel_update(v, p, fluid, solid, g, dt, rho, dx):
    """The pressure gradient at 1/10 strength and gravity on fluid cells;
    then each component zeroed at solid cells and behind a solid minus
    neighbour."""
    scale = (dt * 0.1) / (rho * dx)
    pf = torch.where(fluid, p, torch.zeros_like(p)) * scale
    fl = fluid.to(v.dtype)
    out = []
    for d in range(3):
        vd = v[d] - pf + minus(pf, d) + g[d] * dt * fl
        out.append(torch.where(solid | minus(solid, d), torch.zeros_like(vd),
                               vd))
    return torch.stack(out)


def project(cfg, v, fluid, solid, dt, p0):
    """The reference's do-while: a pass always, more while the relative
    change of the divergence exceeds ``outer_tol``.  Returns (v, pressure,
    outer passes, CG iterations)."""
    g, dx, rho = cfg["gravity"], cfg["dx"], cfg["rho"]
    n = fluid.shape[0]
    rtol = cfg["pcg_rtol"] or (1e-5 if n <= 129 else 1e-3)
    scale = float(dt / (rho * dx * dx))
    ns = (~solid).to(v.dtype)
    count = torch.zeros_like(ns)
    for d in range(3):
        count = count + plus(ns, d) + minus(ns, d)
    adiag = torch.where(fluid, scale * count, torch.zeros_like(count))
    apply_a = lambda q: laplacian(q, adiag, scale)
    precond = chebyshev(adiag, scale, cfg["cheb_degree"], cfg["cheb_ratio"])
    p = torch.where(fluid, p0, torch.zeros_like(p0))

    def one_pass(v, x0):
        b = div_rhs(v, set_rhs(v, fluid, solid, g, dt, dx), fluid, solid, dx)
        x, iters, _ = pcg(apply_a, b, x0, rtol, cfg["pcg_maxiter"], precond)
        v2 = vel_update(v, x, fluid, solid, g, dt, rho, dx)
        b2 = div_rhs(v2, set_rhs(v2, fluid, solid, g, dt, dx), fluid, solid,
                     dx)
        bn = norm(b)
        err = ratio(norm(b - b2), bn)
        return v2, err, iters, x

    v, err, cg, p = one_pass(v, p)
    passes = 1
    while passes < cfg["max_outer"] and bool(err > cfg["outer_tol"]):
        v, err, iters, p = one_pass(v, p)
        passes += 1
        cg += iters
    return v, p, passes, cg


# ---- the frame --------------------------------------------------------------

def frame(cfg, state: dict) -> dict:
    """One FLIP frame of the state ``{pos, vel, dt, pressure}``, every float
    in the state's dtype; returns the next state with the frame's
    ``outer`` passes, ``cg`` iterations and ``fluid`` cells."""
    bound, wall = cfg["bound"], cfg["bound"] - 2
    n = 2 * bound + 1
    dev = state["pos"].device
    pos, vel, dt = state["pos"], state["vel"], state["dt"]
    solid = walls(bound, wall, dev)

    bc = base_cells(pos, bound)
    order = torch.sort((bc[:, 0] * n + bc[:, 1]) * n + bc[:, 2],
                       stable=True).indices
    pos, vel, bc = pos[order], vel[order], bc[order]
    w27 = weights27(pos, bound)

    acc = p2g(w27, vel, bc, n)
    target = within(bound, bound - 2, dev) & ~solid
    zero = torch.zeros_like(acc[0])
    mass = torch.where(target, acc[0], zero)
    mom = torch.where(target[None], acc[1:], torch.zeros_like(acc[1:]))
    occ = torch.where(~solid, acc[0], zero)
    heavy = mass > 0
    v0 = torch.where(heavy[None], mom / torch.where(heavy, mass, 1.0)[None],
                     mom)
    fluid = (occ > 0) & ~solid

    v1, pressure, outer, cg = project(cfg, v0, fluid, solid, dt,
                                      state["pressure"])
    dv = cell_centre(v1) - cell_centre(v0)
    vel = vel + g2p(w27, bc, dv, n, within(bound, wall, dev))

    vmax = torch.max(torch.sqrt(torch.sum(vel * vel, dim=-1)))
    cap = torch.tensor(cfg["max_dt"], dtype=vel.dtype, device=dev)
    dt_new = torch.where(vmax != 0, torch.minimum(cap, cfg["dx"] / vmax), cap)
    pos, vel = advect(pos, vel, dt_new, bound, wall)
    return {"pos": pos, "vel": vel, "dt": dt_new, "pressure": pressure,
            "outer": outer, "cg": cg, "fluid": int(fluid.sum())}


def run(cfg, state: dict, frames: int, dtype=torch.float32) -> dict:
    """``frames`` frames from ``state`` with every float cast to ``dtype``
    first; returns the last state and the per-frame counts."""
    s = {k: state[k].to(dtype) for k in ("pos", "vel", "dt", "pressure")}
    counts = {"outer": [], "cg": [], "fluid": []}
    for _ in range(frames):
        s = frame(cfg, s)
        for k, v in counts.items():
            v.append(s.pop(k))
    return {**s, **counts}
