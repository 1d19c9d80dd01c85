"""Semi-implicit snow Material Point Method frame on PyTorch — the
counterpart of ``fluidsim_tpu/models/mpm.py`` on its kernel path (the
Pallas transfer pipeline of ``ops/mpm_pallas.py``), and with
``kernel="flip"`` on its naive path, the one JAX path that honours it.

One ``mpm_step`` is

  sort by cell (with FE, FP, volume) -> stencil (w27, gradW) -> mass and
  momentum P2G (K1) -> density (K2; sets the volumes at frame 0) ->
  hardening -> explicit force (K1 fg) -> implicit velocity solve (CG on
  ``A v = v - beta dt^2 dforce(v) / m``, each apply a K2 gw gather and a
  K1 fg scatter; with ``precond="jacobi"`` preconditioned by a stiffness
  diagonal scattered through one more K1) -> velocity gradient (K2 gw) -> deformation-gradient
  update with the singular-value clamp -> FLIP delta (K2) -> CFL dt ->
  advection with solid bounce (restitution 0, ``cround_out``)

with every field a dense f32 tensor on one device, grid fields
channel-major.  The transfer spline (``kernel``) chooses the (27, P)
table of the mass and momentum P2G, the Jacobi stiffness P2G and the
FLIP delta; the density gather and gradW (K1 fg, K2 gw) always read the
MPM spline's, as in the JAX package.  The ``hybrid`` operator solves with the exact corotated
Hessian under an iteration cap and, where that stops short of the
tolerance, solves again with its SPD Gauss-Newton part (``spd_resolve``):
a host branch on the same test as the JAX package's ``lax.cond``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm
from fluidsim_tpu_torch.models.flip import (advect_bounce, require_f32,
                                            run_frames, stack_metrics)
from fluidsim_tpu_torch.ops import mpm_kernels as mk
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.pcg import PCGResult, pcg
from fluidsim_tpu_torch.ops.svd3 import clamp_singular, det3, hardening, mm3
from fluidsim_tpu_torch.scenes import Scene, get_scene
from fluidsim_tpu_torch.seeding import seed_particles
from fluidsim_tpu_torch.utils.profiling import host_wait, span


@dataclasses.dataclass(frozen=True)
class MpmParams:
    """Solver configuration: the JAX package's fields with its defaults —
    the reference's material and step constants, walls at ``|c| > 13``,
    and two stabilisers beyond the reference (``hardening_max`` caps the
    hardening exponent, ``max_gradv_dt`` the per-step deformation
    increment).

    ``hessian`` selects the implicit operator: "full" (the exact corotated
    Hessian), "spd" (its positive-semidefinite Gauss-Newton part),
    "hybrid" (full under ``cg_hybrid_cap`` iterations, then one SPD
    re-solve if that did not converge) or "auto" ("full" up to bound 15,
    else "hybrid"; ``MpmSim`` resolves it).  ``cg_rtol`` must stay tight:
    an under-converged implicit elasticity injects energy after impact.

    ``precond`` is "none" or "jacobi": the mass-lumped stiffness diagonal
    ``1 + beta dt^2 precond_gamma (2 mu0 + lam0) rho / m``, with ``rho``
    the P2G of ``volume * mu / mu0`` (one more K1 launch a frame).

    ``kernel`` is the transfer spline, "mpm" or "flip".  With "flip" the
    mass and momentum P2G, the Jacobi stiffness P2G and the FLIP delta
    read a second table, the FLIP spline's, under the JAX naive path's
    target masks (``mpm_kernels.p2g_flip_spline``); the density gather
    and gradW keep the MPM spline.  JAX's fast and Pallas schedules
    ignore the field; the port honours it on every schedule.
    ``fast_transfer``, ``pallas_transfer``, ``pallas_interpret`` and
    ``sort_particles`` choose among the JAX package's XLA and Pallas
    schedules; the port accepts and keeps them, but they change nothing on
    its path.  ``walls_only_solid`` is set by ``MpmSim``.
    """

    bound: int = 15
    wall: int = 13
    dx: float = 1.0
    E: float = 48000.0
    nu: float = 0.47
    beta: float = 0.5
    hardening_eps: float = 10.0
    theta_c: float = 0.025
    theta_s: float = 0.0075
    max_dt: float = 0.001
    gravity: Tuple[float, float, float] = (0.0, -10.0, 0.0)
    mass_threshold: float = 0.1
    hardening_max: float = 10.0
    max_gradv_dt: float = 0.5
    cg_rtol: float = 1e-6
    cg_maxiter: int = 1000
    precond: str = "none"            # "none" | "jacobi"
    precond_gamma: float = 1.0
    hessian: str = "auto"            # "auto" | "full" | "spd" | "hybrid"
    cg_hybrid_cap: int = 150
    kernel: str = "mpm"
    fast_transfer: bool = False
    pallas_transfer: bool | None = None
    pallas_interpret: bool = False
    sort_particles: bool = True
    walls_only_solid: bool = False

    def __post_init__(self):
        if self.hessian not in ("auto", "full", "spd", "hybrid"):
            raise ValueError(f"hessian {self.hessian!r}: expected 'auto', "
                             "'full', 'spd' or 'hybrid'")
        if self.precond not in ("none", "jacobi"):
            raise ValueError(f"precond {self.precond!r}: expected 'none' or "
                             "'jacobi'")
        if self.kernel not in ("mpm", "flip"):
            raise ValueError(f"kernel {self.kernel!r}: expected 'mpm' or "
                             "'flip'")

    @property
    def mu0(self) -> float:
        return self.E / (2.0 * (1.0 + self.nu))

    @property
    def lam0(self) -> float:
        return self.E * self.nu / ((1.0 + self.nu) * (1.0 - 2.0 * self.nu))

    @property
    def operator(self) -> str:
        """``hessian`` with "auto" resolved by the grid size."""
        if self.hessian != "auto":
            return self.hessian
        return "full" if self.bound <= 15 else "hybrid"


@dataclasses.dataclass
class MpmState:
    pos: torch.Tensor        # (P, 3)
    vel: torch.Tensor        # (P, 3)
    FE: torch.Tensor         # (P, 3, 3) elastic deformation gradient
    FP: torch.Tensor         # (P, 3, 3) plastic deformation gradient
    volume: torch.Tensor     # (P,) per-particle volume, set at frame 0
    dt: torch.Tensor         # ()
    t: torch.Tensor          # ()
    frame: torch.Tensor      # () int32


def spd_resolve(matvec, b: torch.Tensor, precond,
                params: MpmParams) -> PCGResult:
    """The hybrid operator's fallback: CG on the SPD Gauss-Newton operator
    ``matvec`` from ``x0 = b``, up to ``cg_maxiter`` iterations, in the span
    ``solve.spd``.  ``mpm_step`` calls it through this module's name."""
    with span("solve.spd"):
        return pcg(matvec, b, x0=b, precond=precond, rtol=params.cg_rtol,
                   maxiter=params.cg_maxiter)


def mpm_step(params: MpmParams, solid: torch.Tensor, state: MpmState):
    """One frame; returns (new_state, metrics).  ``cg_iters`` (the full
    operator's iterations plus the SPD re-solve's), ``spd_iters`` (the SPD
    operator's alone: the re-solve's, all of them under ``hessian="spd"``,
    else 0) and ``spd_fallback`` are Python ints.  The hybrid solve's exact
    CG runs in the span ``solve.full``, its fallback in ``solve.spd``."""
    B = params.bound
    n = 2 * B + 1
    dt = state.dt
    thr = params.mass_threshold
    hess = params.operator
    f32 = dict(dtype=state.pos.dtype, device=state.pos.device)

    with span("sort"):
        pos, vel, fe_in, fp_in, volume_in, flat = mk.sort_mpm(
            state.pos, state.vel, state.FE, state.FP, state.volume, B)
    with span("stencil"):
        w27t, gradw = mk.mpm_stencil(pos, B)
    with span("cell ranges"):
        cell_start = tk.cell_starts(flat, n)
    # one chunk plan for the frame's K1 and K1 fg launches (the card's only)
    with span("chunk plan"):
        plan = (tk.chunk_plan(cell_start, pos.shape[0]) if cell_start.is_cuda
                else None)
    with span("P2G"):
        if params.kernel == "flip":
            # the FLIP spline's table: the mass, momentum and stiffness P2G
            # and the FLIP delta read it, with the JAX naive path's masks
            wt = tk.masked_weights_cm(pos, B, "flip")
            mass, mom = mk.p2g_flip_spline(wt, vel, cell_start, solid, B,
                                           plan)
            momentum = mk.momentum_flip_spline
        else:
            wt = w27t
            mass, mom = mk.p2g_mpm(wt, vel, cell_start, solid, B, plan)
            momentum = lambda *args: mk.p2g_mpm(*args)[1]
        heavy = mass > thr
        velg = torch.where(heavy[None],
                           mom / torch.where(heavy, mass, 1.0)[None], 0.0)
    # the volumes come from the density of frame 0 only, but the gather
    # runs every frame, as in the JAX package
    with span("density"):
        dens = mk.density(mass, w27t, flat, solid)
        vol0 = 1.0 / torch.where(dens > 0, dens, 1.0)
        volume = torch.where(state.frame == 0, vol0, volume_in)

    active = heavy & ~solid
    velb = velg

    # explicit forces and the implicit solve
    with span("hardening"):
        mu, lam = hardening(params.mu0, params.lam0, params.hardening_eps,
                            det3(fp_in), exponent_cap=params.hardening_max)
    fns = mk.make_force_fns(pos, fe_in, volume, mu, lam, gradw, cell_start,
                            flat, active, solid, B, hessian=hess, plan=plan)
    with span("solve"):
        f0 = fns[0]()
        mass_safe = torch.where(active, mass, 1.0)[None]
        g = host_wait("upload.gravity", torch.tensor, params.gravity,
                      **f32)[:, None, None, None]
        b = torch.where(active[None], velg + dt * (f0 / mass_safe + g), 0.0)
        beta_dt2 = params.beta * dt * dt

        def matvec_of(dforce):
            def matvec(wv):
                df = dforce(torch.where(active[None], wv, 0.0))
                out = wv + beta_dt2 * (-df) / mass_safe
                return torch.where(active[None], out, wv)
            return matvec

        precond = None
        if params.precond == "jacobi":
            # the stiffness density rides in the first velocity channel of K1
            s = volume * (mu / params.mu0)
            zero = torch.zeros_like(s)
            mom_d = momentum(wt, torch.stack([s, zero, zero], dim=-1),
                             cell_start, solid, B, plan)
            dscale = params.precond_gamma * (2.0 * params.mu0 + params.lam0)
            diag = 1.0 + beta_dt2 * dscale * mom_d[0] / mass_safe[0]
            precond = lambda r: torch.where(active[None], r / diag[None], r)

        # CG starts at x0 = b: A = I + O(beta dt^2), so b is near the solution
        if hess == "hybrid":
            with span("solve.full"):
                res_f = pcg(matvec_of(fns[1]), b, x0=b, precond=precond,
                            rtol=params.cg_rtol, maxiter=params.cg_hybrid_cap)
            bnorm2 = torch.sum((b * b).to(torch.float32))
            rtol32 = host_wait("upload.cg_rtol", torch.tensor, params.cg_rtol,
                               dtype=torch.float32, device=b.device)
            ok = host_wait("solve.hybrid_check", bool,
                           res_f.residual.to(torch.float32) ** 2
                           <= rtol32 ** 2 * bnorm2)
            if ok:
                solve_x, cg_iters, cg_resid = (res_f.x, res_f.iters,
                                               res_f.residual)
                spd_iters = 0
            else:
                res = spd_resolve(matvec_of(fns[2]), b, precond, params)
                solve_x, cg_iters, cg_resid = (res.x, res_f.iters + res.iters,
                                               res.residual)
                spd_iters = res.iters
            spd_used = 0 if ok else 1
        else:
            res = pcg(matvec_of(fns[1]), b, x0=b, precond=precond,
                      rtol=params.cg_rtol, maxiter=params.cg_maxiter)
            solve_x, cg_iters, cg_resid = res.x, res.iters, res.residual
            spd_used = 1 if hess == "spd" else 0
            spd_iters = res.iters if hess == "spd" else 0
        velg = torch.where(active[None], solve_x, 0.0)

    # deformation gradient update, with the deformation-increment limiter
    with span("gradV"):
        gradv = mk.gradv_gather(velg, gradw, flat, solid)
    with span("F update"):
        gmax = torch.amax(torch.abs(gradv), dim=(-2, -1))
        scale_g = torch.clamp(params.max_gradv_dt
                              / torch.clamp(dt * gmax, min=1e-12), max=1.0)
        gradv = gradv * scale_g[:, None, None]
        eye = torch.eye(3, **f32)
        t_fe = mm3(eye + dt * gradv, fe_in)
        f_total = mm3(t_fe, fp_in)
        fe_new, v_sinv_ut = clamp_singular(t_fe, 1.0 - params.theta_c,
                                           1.0 + params.theta_s)
        fp_new = mm3(v_sinv_ut, f_total)

    # FLIP advection
    with span("FLIP delta"):
        dvc = cell_center_velocity_cm(velg) - cell_center_velocity_cm(velb)
        vel = vel + mk.flip_delta(wt, flat, dvc, B, params.wall)
    with span("advection"):
        speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
        max_speed = torch.max(speed)
        max_dt = host_wait("upload.max_dt", torch.tensor, params.max_dt,
                           **f32)
        dt_new = torch.where(max_speed != 0,
                             torch.minimum(max_dt, params.dx / max_speed),
                             max_dt)
        pos, vel = advect_bounce(
            pos, vel, dt_new, solid, B, e=0.0, rounding="out",
            analytic_wall=params.wall if params.walls_only_solid else None)

    new_state = MpmState(pos=pos, vel=vel, FE=fe_new, FP=fp_new,
                         volume=volume, dt=dt_new, t=state.t + dt_new,
                         frame=state.frame + 1)
    det_fp = det3(fp_new)
    metrics = {
        "cg_iters": cg_iters,
        "spd_iters": spd_iters,
        "cg_residual": cg_resid,
        "spd_fallback": spd_used,
        "dt": dt_new,
        "dt_used": dt,
        "max_speed": max_speed,
        "kinetic_energy": 0.5 * torch.sum((vel * vel).to(torch.float32)),
        "max_gradv": torch.max(torch.abs(gradv)),
        "max_det_fp": torch.max(det_fp),
        "min_det_fp": torch.min(det_fp),
        "max_det_fe": torch.max(det3(fe_new)),
        "num_active_cells": torch.sum(active),
        "occupancy": mass,
    }
    return new_state, metrics


def frame_solves(params: MpmParams, cg_iters: int,
                 spd_fallback: int) -> tuple[int, bool]:
    """(The CG solves of a frame with these metrics, whether the solve its
    velocity came from stopped before its cap.)"""
    if params.hessian == "hybrid" and spd_fallback == 0:
        return 1, cg_iters < params.cg_hybrid_cap
    spd_iters = cg_iters - (params.cg_hybrid_cap
                            if params.hessian == "hybrid" else 0)
    return 1 + spd_fallback, spd_iters < params.cg_maxiter


class MpmSim:
    """The MPM simulation: owns the state on one device and runs the frame
    loop.  ``device`` is "cuda" unless the caller asks for another (the
    tests pass "cpu"); without a card the default raises.

    The scene's default parameters detect a walls-only solid (the analytic
    bounce probe) and resolve ``hessian="auto"``.  ``seeder`` and ``dtype``
    (float32 only) as in ``FlipSim``; f32 throughout, TF32 switched off as
    there."""

    def __init__(self, scene: Scene | str = "mpm_cone",
                 params: MpmParams | None = None, seed: int = 0,
                 dtype=torch.float32, seeder=seed_particles, *,
                 device="cuda", **scene_kwargs):
        require_f32(dtype)
        if isinstance(scene, str):
            scene = get_scene(scene, **scene_kwargs)
        if params is None:
            params = MpmParams(bound=scene.spec.bound, wall=scene.spec.wall,
                               dx=scene.spec.dx, gravity=tuple(scene.gravity))
        if (not params.walls_only_solid
                and params.wall == scene.spec.wall
                and params.bound == scene.spec.bound
                and np.array_equal(np.asarray(scene.solid),
                                   scene.spec.wall_mask())):
            params = dataclasses.replace(params, walls_only_solid=True)
        params = dataclasses.replace(params, hessian=params.operator)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device(device)
        pos, vel = seeder(scene, seed=seed, dtype="float32")
        p = pos.shape[0]
        f32 = dict(dtype=torch.float32, device=device)
        eye = torch.eye(3, **f32).expand(p, 3, 3)
        self.scene = scene
        self.params = params
        self.device = device
        self.solid = torch.as_tensor(np.asarray(scene.solid), device=device)
        self.state = MpmState(
            pos=torch.as_tensor(pos, **f32), vel=torch.as_tensor(vel, **f32),
            FE=eye.clone(), FP=eye.clone(), volume=torch.zeros(p, **f32),
            dt=torch.tensor(params.max_dt, **f32), t=torch.zeros((), **f32),
            frame=torch.zeros((), dtype=torch.int32, device=device))

    @property
    def num_particles(self) -> int:
        return int(self.state.pos.shape[0])

    def step(self) -> Dict[str, Any]:
        with span("frame"):
            self.state, metrics = mpm_step(self.params, self.solid,
                                           self.state)
        return metrics

    def steps(self, k: int) -> Dict[str, Any]:
        """``k`` frames back to back, metrics stacked as
        ``FlipSim.steps``."""
        return stack_metrics([self.step() for _ in range(k)])

    def run(self, frames: int, callback=None, check: bool = True,
            chunk: int = 1):
        """Frame loop, as ``FlipSim.run``."""
        return run_frames(self, frames, callback, check, chunk)
