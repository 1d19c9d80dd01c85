"""Semi-implicit snow Material Point Method frame on PyTorch — the
counterpart of ``fluidsim_tpu/models/mpm.py`` on its kernel path (the
Pallas transfer pipeline of ``ops/mpm_pallas.py``).

One ``mpm_step`` is

  sort by cell (with FE, FP, volume) -> stencil (w27, gradW) -> mass and
  momentum P2G (K1) -> density (K2; sets the volumes at frame 0) ->
  hardening -> explicit force (K1 fg) -> implicit velocity solve (CG on
  ``A v = v - beta dt^2 dforce(v) / m``, each apply a K2 gw gather and a
  K1 fg scatter) -> velocity gradient (K2 gw) -> deformation-gradient
  update with the singular-value clamp -> FLIP delta (K2) -> CFL dt ->
  advection with solid bounce (restitution 0, ``cround_out``)

with every field a dense f32 tensor on one device, grid fields
channel-major.  The ``hybrid`` operator solves with the exact corotated
Hessian under an iteration cap and, where that stops short of the
tolerance, solves again with its SPD Gauss-Newton part: a host branch on
the same test as the JAX package's ``lax.cond``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm
from fluidsim_tpu_torch.models.flip import advect_bounce
from fluidsim_tpu_torch.ops import mpm_kernels as mk
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.pcg import pcg
from fluidsim_tpu_torch.ops.svd3 import clamp_singular, det3, hardening, mm3
from fluidsim_tpu_torch.scenes import Scene, get_scene
from fluidsim_tpu_torch.seeding import seed_particles
from fluidsim_tpu_torch.utils.profiling import check_finite


@dataclasses.dataclass(frozen=True)
class MpmParams:
    """Solver configuration, with the JAX package's defaults: the
    reference's material and step constants, walls at ``|c| > 13``, and two
    stabilisers beyond the reference (``hardening_max`` caps the hardening
    exponent, ``max_gradv_dt`` the per-step deformation increment).

    ``hessian`` selects the implicit operator: "full" (the exact corotated
    Hessian), "spd" (its positive-semidefinite Gauss-Newton part),
    "hybrid" (full under ``cg_hybrid_cap`` iterations, then one SPD
    re-solve if that did not converge) or "auto" ("full" up to bound 15,
    else "hybrid"; ``MpmSim`` resolves it).  ``cg_rtol`` must stay tight:
    an under-converged implicit elasticity injects energy after impact.
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
    hessian: str = "auto"            # "auto" | "full" | "spd" | "hybrid"
    cg_hybrid_cap: int = 150
    walls_only_solid: bool = False   # solid == box walls exactly: analytic
                                     # bounce probe (auto-detected by MpmSim)

    def __post_init__(self):
        if self.hessian not in ("auto", "full", "spd", "hybrid"):
            raise ValueError(f"hessian {self.hessian!r}: expected 'auto', "
                             "'full', 'spd' or 'hybrid'")

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


def mpm_step(params: MpmParams, solid: torch.Tensor, state: MpmState):
    """One frame; returns (new_state, metrics).  ``cg_iters`` (the full
    operator's iterations plus the SPD re-solve's) and ``spd_fallback``
    are Python ints."""
    B = params.bound
    n = 2 * B + 1
    dt = state.dt
    thr = params.mass_threshold
    hess = params.operator
    f32 = dict(dtype=state.pos.dtype, device=state.pos.device)

    pos, vel, fe_in, fp_in, volume_in, flat = mk.sort_mpm(
        state.pos, state.vel, state.FE, state.FP, state.volume, B)
    w27t, gradw = mk.mpm_stencil(pos, B)
    cell_start = tk.cell_starts(flat, n)
    # one chunk plan for the frame's K1 and K1 fg launches (the card's only)
    plan = (tk.chunk_plan(cell_start, pos.shape[0]) if cell_start.is_cuda
            else None)
    mass, mom = mk.p2g_mpm(w27t, vel, cell_start, solid, B, plan)
    heavy = mass > thr
    velg = torch.where(heavy[None], mom / torch.where(heavy, mass, 1.0)[None],
                       0.0)
    # the volumes come from the density of frame 0 only, but the gather
    # runs every frame, as in the JAX package
    dens = mk.density(mass, w27t, flat, solid)
    vol0 = 1.0 / torch.where(dens > 0, dens, 1.0)
    volume = torch.where(state.frame == 0, vol0, volume_in)

    active = heavy & ~solid
    velb = velg

    # explicit forces and the implicit solve
    mu, lam = hardening(params.mu0, params.lam0, params.hardening_eps,
                        det3(fp_in), exponent_cap=params.hardening_max)
    fns = mk.make_force_fns(pos, fe_in, volume, mu, lam, gradw, cell_start,
                            flat, active, solid, B, hessian=hess, plan=plan)
    f0 = fns[0]()
    mass_safe = torch.where(active, mass, 1.0)[None]
    g = torch.tensor(params.gravity, **f32)[:, None, None, None]
    b = torch.where(active[None], velg + dt * (f0 / mass_safe + g), 0.0)
    beta_dt2 = params.beta * dt * dt

    def matvec_of(dforce):
        def matvec(wv):
            df = dforce(torch.where(active[None], wv, 0.0))
            out = wv + beta_dt2 * (-df) / mass_safe
            return torch.where(active[None], out, wv)
        return matvec

    # CG starts at x0 = b: A = I + O(beta dt^2), so b is near the solution
    if hess == "hybrid":
        res_f = pcg(matvec_of(fns[1]), b, x0=b, rtol=params.cg_rtol,
                    maxiter=params.cg_hybrid_cap)
        bnorm2 = torch.sum((b * b).to(torch.float32))
        rtol32 = torch.tensor(params.cg_rtol, dtype=torch.float32,
                              device=b.device)
        ok = bool(res_f.residual.to(torch.float32) ** 2 <= rtol32 ** 2 * bnorm2)
        if ok:
            solve_x, cg_iters, cg_resid = res_f.x, res_f.iters, res_f.residual
        else:
            res = pcg(matvec_of(fns[2]), b, x0=b, rtol=params.cg_rtol,
                      maxiter=params.cg_maxiter)
            solve_x, cg_iters, cg_resid = res.x, res_f.iters + res.iters, \
                res.residual
        spd_used = 0 if ok else 1
    else:
        res = pcg(matvec_of(fns[1]), b, x0=b, rtol=params.cg_rtol,
                  maxiter=params.cg_maxiter)
        solve_x, cg_iters, cg_resid = res.x, res.iters, res.residual
        spd_used = 1 if hess == "spd" else 0
    velg = torch.where(active[None], solve_x, 0.0)

    # deformation gradient update, with the deformation-increment limiter
    gradv = mk.gradv_gather(velg, gradw, flat, solid)
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
    dvc = cell_center_velocity_cm(velg) - cell_center_velocity_cm(velb)
    vel = vel + mk.flip_delta(w27t, flat, dvc, B, params.wall)
    speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
    max_speed = torch.max(speed)
    max_dt = torch.tensor(params.max_dt, **f32)
    dt_new = torch.where(max_speed != 0,
                         torch.minimum(max_dt, params.dx / max_speed), max_dt)
    pos, vel = advect_bounce(
        pos, vel, dt_new, solid, B, e=0.0, rounding="out",
        analytic_wall=params.wall if params.walls_only_solid else None)

    new_state = MpmState(pos=pos, vel=vel, FE=fe_new, FP=fp_new,
                         volume=volume, dt=dt_new, t=state.t + dt_new,
                         frame=state.frame + 1)
    det_fp = det3(fp_new)
    metrics = {
        "cg_iters": cg_iters,
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


class MpmSim:
    """The MPM simulation: owns the state on one device and runs the frame
    loop.  ``device`` is "cuda" unless the caller asks for another (the
    tests pass "cpu"); without a card the default raises.

    The scene's default parameters detect a walls-only solid (the analytic
    bounce probe) and resolve ``hessian="auto"``.  f32 throughout, TF32
    switched off as in ``FlipSim``."""

    def __init__(self, scene: Scene | str = "mpm_cone",
                 params: MpmParams | None = None, seed: int = 0, *,
                 device="cuda", **scene_kwargs):
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
        pos, vel = seed_particles(scene, seed=seed)
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
        self.state, metrics = mpm_step(self.params, self.solid, self.state)
        return metrics

    def run(self, frames: int, callback=None, check: bool = True):
        """Frame loop; ``callback(frame, state, metrics)`` runs after each
        frame.  Returns the last frame's metrics."""
        out = None
        for _ in range(frames):
            metrics = self.step()
            frame = int(self.state.frame) - 1
            if check:
                check_finite(metrics, frame)
            if callback is not None:
                callback(frame, self.state, metrics)
            out = metrics
        return out
