"""The snow MPM frame of ``mpm_cone`` in plain PyTorch: a frozen copy of the
mathematics that the benchmark holds the program to.

One frame is

  sort by cell (FE, FP and the volume along) -> the MPM spline's 27
  weights and their 81 gradients -> P2G of mass and momentum -> grid
  velocity on the cells above the mass threshold -> the density gather
  (the volumes of frame 0) -> hardening -> the corotated stress and the
  explicit grid force -> the implicit velocity solve ``A v = b`` by CG,
  ``A v = v - beta dt^2 dforce(v) / m``: the exact corotated Hessian under
  an iteration cap, then its SPD Gauss-Newton part where that stops short
  ("hybrid") -> the velocity gradient, limited -> the deformation gradient
  with its singular values clamped (``mpm.cc``'s theta_c, theta_s) -> the
  FLIP delta -> CFL dt -> advection with the walls' bounce

in whole-array operations, the 3x3 algebra unrolled (the SVD by cyclic
Jacobi on F^T F, the polar rotation's differential by its skew system), in
the ``dtype`` of the state given.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark.reference.grid import (OFFSETS, advect, base_cells, bspline,
                                      cell_centre, cround, cround_out, g2p,
                                      neighbours, p2g, pcg, walls, within)

# ---- 3x3 algebra -----------------------------------------------------------


def mm(a, b):
    """Batched (..., 3, 3) product, each entry summed over k in order."""
    return torch.stack([torch.stack([a[..., i, 0] * b[..., 0, j]
                                     + a[..., i, 1] * b[..., 1, j]
                                     + a[..., i, 2] * b[..., 2, j]
                                     for j in range(3)], -1)
                        for i in range(3)], -2)


def tr(a):
    return a.transpose(-1, -2)


def mat(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def det(f):
    return (f[..., 0, 0] * (f[..., 1, 1] * f[..., 2, 2] - f[..., 1, 2] * f[..., 2, 1])
            - f[..., 0, 1] * (f[..., 1, 0] * f[..., 2, 2] - f[..., 1, 2] * f[..., 2, 0])
            + f[..., 0, 2] * (f[..., 1, 0] * f[..., 2, 1] - f[..., 1, 1] * f[..., 2, 0]))


def cofactor(f):
    """``det(F) F^-T``."""
    def c(i, j, k, l, m, n, o, q):
        return f[..., i, j] * f[..., k, l] - f[..., m, n] * f[..., o, q]
    return mat([[c(1, 1, 2, 2, 1, 2, 2, 1), c(1, 2, 2, 0, 1, 0, 2, 2),
                 c(1, 0, 2, 1, 1, 1, 2, 0)],
                [c(0, 2, 2, 1, 0, 1, 2, 2), c(0, 0, 2, 2, 0, 2, 2, 0),
                 c(0, 1, 2, 0, 0, 0, 2, 1)],
                [c(0, 1, 1, 2, 0, 2, 1, 1), c(0, 2, 1, 0, 0, 0, 1, 2),
                 c(0, 0, 1, 1, 0, 1, 1, 0)]])


def dcofactor(f, df):
    """The differential of ``cofactor`` at F along dF."""
    def e(i, j, k, l, m, n, o, q):
        return ((df[..., i, j] * f[..., k, l] + f[..., i, j] * df[..., k, l])
                - (df[..., m, n] * f[..., o, q] + f[..., m, n] * df[..., o, q]))
    return mat([[e(1, 1, 2, 2, 1, 2, 2, 1), e(1, 2, 2, 0, 1, 0, 2, 2),
                 e(1, 0, 2, 1, 1, 1, 2, 0)],
                [e(0, 2, 2, 1, 0, 1, 2, 2), e(0, 0, 2, 2, 0, 2, 2, 0),
                 e(0, 1, 2, 0, 0, 0, 2, 1)],
                [e(0, 1, 1, 2, 0, 2, 1, 1), e(0, 2, 1, 0, 0, 0, 1, 2),
                 e(0, 0, 1, 1, 0, 1, 1, 0)]])


def vec3(a, b, c):
    return torch.stack([a, b, c], -1)


def dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])[..., None]


def cross(a, b):
    return vec3(a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])


def unit(x, fallback):
    n = torch.sqrt(dot3(x, x))
    ok = n > 1e-20
    return torch.where(ok, x / torch.where(ok, n, torch.ones_like(n)),
                       fallback)


def eigh(a, sweeps: int = 5):
    """Symmetric 3x3 eigenpairs by ``sweeps`` cyclic Jacobi sweeps."""
    v = torch.eye(3, dtype=a.dtype, device=a.device).expand(a.shape)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            apq = a[..., p, q]
            nz = torch.abs(apq) > 0
            tau = (a[..., q, q] - a[..., p, p]) / (2.0 * torch.where(nz, apq, one))
            t = torch.where(tau >= 0, one, -one) / (torch.abs(tau)
                                                    + torch.sqrt(1.0 + tau * tau))
            t = torch.where(nz, t, torch.zeros_like(t))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            app, aqq = a[..., p, p], a[..., q, q]
            arp, arq = a[..., r, p], a[..., r, q]
            ent = {(p, p): c * c * app - 2.0 * s * c * apq + s * s * aqq,
                   (q, q): s * s * app + 2.0 * s * c * apq + c * c * aqq,
                   (r, r): a[..., r, r],
                   (p, q): torch.zeros_like(app), (q, p): torch.zeros_like(app)}
            ent[(r, p)] = ent[(p, r)] = c * arp - s * arq
            ent[(r, q)] = ent[(q, r)] = s * arp + c * arq
            a = mat([[ent[(i, j)] for j in range(3)] for i in range(3)])
            cols = [v[..., :, 0], v[..., :, 1], v[..., :, 2]]
            vp, vq = cols[p], cols[q]
            cols[p] = c[..., None] * vp - s[..., None] * vq
            cols[q] = s[..., None] * vp + c[..., None] * vq
            v = torch.stack(cols, -1)
    return vec3(a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]), v


def svd(f):
    """(U, s, V^T): s >= 0 descending, U, V rotations up to the sign of
    det F, from the eigenpairs of F^T F."""
    w, v = eigh(mm(tr(f), f))
    ws = [w[..., 0], w[..., 1], w[..., 2]]
    cols = [v[..., :, 0], v[..., :, 1], v[..., :, 2]]
    for i, j in ((0, 1), (0, 2), (1, 2)):
        sw = ws[i] < ws[j]
        ws[i], ws[j] = torch.where(sw, ws[j], ws[i]), torch.where(sw, ws[i], ws[j])
        cols[i], cols[j] = (torch.where(sw[..., None], cols[j], cols[i]),
                            torch.where(sw[..., None], cols[i], cols[j]))
    s = torch.sqrt(torch.clamp(vec3(*ws), min=0.0))
    one = torch.ones_like(ws[0])
    flip = torch.where(det(torch.stack(cols, -1)) < 0, -one, one)
    v = torch.stack([cols[0], cols[1], cols[2] * flip[..., None]], -1)
    fv = mm(f, v)
    eye = torch.eye(3, dtype=f.dtype, device=f.device).expand(f.shape)
    u0 = unit(fv[..., :, 0], eye[..., :, 0])
    f1 = fv[..., :, 1]
    g1 = f1 - dot3(u0, f1) * u0
    ek = torch.nn.functional.one_hot(torch.argmin(torch.abs(u0), -1),
                                     3).to(f.dtype)
    n1 = torch.sqrt(dot3(g1, g1))
    ok1 = n1 > 1e-12 * torch.clamp(s[..., 0:1], min=1e-30)
    u1 = torch.where(ok1, g1 / torch.where(ok1, n1, torch.ones_like(n1)),
                     unit(cross(u0, ek), eye[..., :, 1]))
    sgn = torch.where(det(f) < 0, -one, one)[..., None]
    u2 = sgn * unit(cross(u0, u1), eye[..., :, 2])
    return torch.stack([u0, u1, u2], -1), s, tr(v)


def piola(fe, mu, lam):
    """The corotated stress ``P0 = 2 mu (F - R) + lam (J - 1) cof F`` and its
    differentials, exact and Gauss-Newton."""
    u, s, vt = svd(fe)
    r = mm(u, vt)
    sym = mm(tr(vt), s[..., :, None] * vt)
    j = det(fe)
    cof = cofactor(fe)
    mu_, lam_ = mu[..., None, None], lam[..., None, None]
    p0 = 2.0 * mu_ * (fe - r) + (lam * (j - 1.0))[..., None, None] * cof

    def ddot(a, b):
        out = a[..., 0, 0] * b[..., 0, 0]
        for i, k in ((0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1),
                     (2, 2)):
            out = out + a[..., i, k] * b[..., i, k]
        return out[..., None, None]

    def drot(df):
        # R^T dR is skew; its entries solve a 3x3 system built from S
        rhs = mm(tr(r), df) - mm(tr(df), r)
        x = vec3(rhs[..., 0, 1], rhs[..., 0, 2], rhs[..., 1, 2])
        m = mat([[sym[..., 0, 0] + sym[..., 1, 1], sym[..., 1, 2], -sym[..., 0, 2]],
                 [sym[..., 1, 2], sym[..., 0, 0] + sym[..., 2, 2], sym[..., 0, 1]],
                 [-sym[..., 0, 2], sym[..., 0, 1], sym[..., 1, 1] + sym[..., 2, 2]]])
        dm = det(m)
        inv = tr(cofactor(m)) / torch.where(dm != 0, dm,
                                            torch.ones_like(dm))[..., None, None]
        y = torch.stack([inv[..., i, 0] * x[..., 0] + inv[..., i, 1] * x[..., 1]
                         + inv[..., i, 2] * x[..., 2] for i in range(3)], -1)
        z = torch.zeros_like(y[..., 0])
        return mm(r, mat([[z, y[..., 0], y[..., 1]],
                          [-y[..., 0], z, y[..., 2]],
                          [-y[..., 1], -y[..., 2], z]]))

    def dp_full(df):
        return (2.0 * mu_ * (df - drot(df))
                + lam_ * (ddot(cof, df) * cof
                          + (j - 1.0)[..., None, None] * dcofactor(fe, df)))

    def dp_spd(df):
        return 2.0 * mu_ * df + lam_ * ddot(cof, df) * cof

    return p0, dp_full, dp_spd


def clamp_singular(f, lo: float, hi: float):
    """``(U clamp(s) V^T, V clamp(s)^-1 U^T)``."""
    u, s, vt = svd(f)
    sc = torch.clamp(s, lo, hi)
    return mm(u, sc[..., :, None] * vt), mm(tr(vt), tr(u) / sc[..., :, None])


# ---- the frame -------------------------------------------------------------

def stencil(pos, bound: int):
    """(27, P) MPM weights ``B(|x - 0.5|)`` per axis (0 outside the box)
    and (27, P, 3) their gradients with respect to the node."""
    base = cround(pos)
    valid = torch.all(torch.abs(base) <= bound, dim=-1)
    wd, gd = [], []
    for a in range(3):
        s = [(pos[:, a] - (base[:, a] + (q - 1))) - 0.5 for q in range(3)]
        wd.append([bspline(torch.abs(x)) for x in s])
        gd.append([-dbspline(x) for x in s])
    w = torch.stack([wd[0][i + 1] * wd[1][j + 1] * wd[2][k + 1]
                     for i, j, k in OFFSETS])
    g = torch.stack([vec3(gd[0][i + 1] * wd[1][j + 1] * wd[2][k + 1],
                          wd[0][i + 1] * gd[1][j + 1] * wd[2][k + 1],
                          wd[0][i + 1] * wd[1][j + 1] * gd[2][k + 1])
                     for i, j, k in OFFSETS])
    return torch.where(valid[None], w, torch.zeros_like(w)), g, valid


def dbspline(x):
    """The signed derivative of ``B(|x|)``."""
    a = torch.abs(x)
    mag = torch.where(a < 0.5, 12.0 * a * a - 8.0 * a,
                      torch.where(a <= 1.0, -4.0 * a * a + 8.0 * a - 4.0,
                                  torch.zeros_like(a)))
    return torch.sign(x) * mag


def gather_grad(fields, grad, bc, n: int):
    """(P, 3, 3) ``g[p, c, k] = sum_o grad_k(p, o) f_c(base + off_o)``."""
    f = fields.reshape(3, -1)
    out = torch.zeros((bc.shape[0], 3, 3), dtype=fields.dtype,
                      device=fields.device)
    for o, ids, inside in neighbours(bc, n):
        vals = torch.where(inside[None], f[:, ids], torch.zeros_like(f[:, ids]))
        out = out + vals.T[:, :, None] * grad[o][:, None, :]
    return out


def scatter_grad(m, grad, bc, n: int):
    """(3, N,N,N) ``out[c, cell] = sum_{p, o: base + off_o = cell} sum_k
    M_p[c, k] grad_k(p, o)``."""
    acc = torch.zeros((n ** 3, 3), dtype=m.dtype, device=m.device)
    for o, ids, inside in neighbours(bc, n):
        v = torch.sum(m * grad[o][:, None, :], -1)
        acc.index_add_(0, ids, torch.where(inside[:, None], v,
                                           torch.zeros_like(v)))
    return acc.T.reshape(3, n, n, n)


def frame(cfg, state: dict) -> dict:
    """One MPM frame of ``{pos, vel, FE, FP, volume, dt, frame}``; returns
    the next state with the frame's CG iterations (``cg``), whether the SPD
    solve ran (``spd``) and its ``active`` cells."""
    bound = cfg["bound"]
    wall, n = bound - 2, 2 * bound + 1
    dev = state["pos"].device
    dt = state["dt"]
    solid = walls(bound, wall, dev)
    open_ = ~solid

    bc = base_cells(state["pos"], bound)
    order = torch.sort((bc[:, 0] * n + bc[:, 1]) * n + bc[:, 2],
                       stable=True).indices
    pos, vel, bc = state["pos"][order], state["vel"][order], bc[order]
    fe, fp, vol_in = state["FE"][order], state["FP"][order], \
        state["volume"][order]
    w27, grad, valid = stencil(pos, bound)

    acc = p2g(w27, vel, bc, n)
    mass = torch.where(open_, acc[0], torch.zeros_like(acc[0]))
    mom = torch.where(open_[None], acc[1:], torch.zeros_like(acc[1:]))
    heavy = mass > cfg["mass_threshold"]
    one = torch.ones_like(mass)
    v0 = torch.where(heavy[None], mom / torch.where(heavy, mass, one)[None],
                     torch.zeros_like(mom))
    # the density of the mass over the open cells: the volumes of frame 0
    dens = torch.zeros_like(vel[:, 0])
    mflat = mass.reshape(-1)
    for o, ids, inside in neighbours(bc, n):
        dens = dens + torch.where(inside, w27[o], torch.zeros_like(dens)) \
            * mflat[ids]
    vol0 = 1.0 / torch.where(dens > 0, dens, torch.ones_like(dens))
    volume = torch.where(state["frame"] == 0, vol0, vol_in)
    active = heavy & open_

    mu0 = cfg["E"] / (2.0 * (1.0 + cfg["nu"]))
    lam0 = cfg["E"] * cfg["nu"] / ((1.0 + cfg["nu"]) * (1.0 - 2.0 * cfg["nu"]))
    e = torch.clamp(cfg["hardening_eps"] * (1.0 - det(fp)),
                    -cfg["hardening_max"], cfg["hardening_max"])
    h = torch.exp(e)
    p0, dp_full, dp_spd = piola(fe, mu0 * h, lam0 * h)
    scale = torch.where(valid, -volume, torch.zeros_like(volume))

    def force(sigma):
        out = scatter_grad(scale[:, None, None] * sigma, grad, bc, n)
        return torch.where(open_[None], out, torch.zeros_like(out))

    def matvec_of(dp):
        def matvec(u):
            ua = torch.where(active[None], u, torch.zeros_like(u))
            g = gather_grad(ua, grad, bc, n)
            df = force(mm(dp(mm(g, fe)), tr(fe)))
            out = u + beta_dt2 * (-df) / mass_safe
            return torch.where(active[None], out, u)
        return matvec

    mass_safe = torch.where(active, mass, one)[None]
    grav = torch.tensor(cfg["gravity"], dtype=vel.dtype,
                        device=dev)[:, None, None, None]
    f0 = force(mm(p0, tr(fe)))
    b = torch.where(active[None], v0 + dt * (f0 / mass_safe + grav),
                    torch.zeros_like(v0))
    beta_dt2 = cfg["beta"] * dt * dt
    rtol = cfg["cg_rtol"]
    x, cg, rr = pcg(matvec_of(dp_full), b, b, rtol, cfg["cg_hybrid_cap"])
    spd = not bool(rr <= rtol * rtol * torch.sum(b * b))
    if spd:
        x, more, _ = pcg(matvec_of(dp_spd), b, b, rtol, cfg["cg_maxiter"])
        cg += more
    v1 = torch.where(active[None], x, torch.zeros_like(x))

    gradv = gather_grad(torch.where(open_[None], v1, torch.zeros_like(v1)),
                        grad, bc, n)
    gmax = torch.amax(torch.abs(gradv), dim=(-2, -1))
    gradv = gradv * torch.clamp(
        cfg["max_gradv_dt"] / torch.clamp(dt * gmax, min=1e-12), max=1.0
    )[:, None, None]
    eye = torch.eye(3, dtype=vel.dtype, device=dev)
    fe_t = mm(eye + dt * gradv, fe)
    fe_new, inv = clamp_singular(fe_t, 1.0 - cfg["theta_c"],
                                 1.0 + cfg["theta_s"])
    fp_new = mm(inv, mm(fe_t, fp))

    dv = cell_centre(v1) - cell_centre(v0)
    vel = vel + g2p(w27, bc, dv, n, within(bound, wall, dev))
    vmax = torch.max(torch.sqrt(torch.sum(vel * vel, dim=-1)))
    cap = torch.tensor(cfg["max_dt"], dtype=vel.dtype, device=dev)
    dt_new = torch.where(vmax != 0, torch.minimum(cap, cfg["dx"] / vmax), cap)
    pos, vel = advect(pos, vel, dt_new, bound, wall, cround_out)
    return {"pos": pos, "vel": vel, "FE": fe_new, "FP": fp_new,
            "volume": volume, "dt": dt_new, "frame": state["frame"] + 1,
            "cg": cg, "spd": spd, "active": int(active.sum())}


def run(cfg, state: dict, frames: int, dtype=torch.float32) -> dict:
    """``frames`` frames from ``state`` with every float cast to ``dtype``
    first; returns the last state and the per-frame counts."""
    s = {k: (v.to(dtype) if v.is_floating_point() else v)
         for k, v in state.items()}
    counts = {"cg": [], "spd": [], "active": []}
    for _ in range(frames):
        s = frame(cfg, s)
        for k, v in counts.items():
            v.append(s.pop(k))
    return {**s, **counts}
