"""FLIP incompressible liquid frame on PyTorch — the counterpart of
``fluidsim_tpu/models/flip.py`` on its kernel path (``mode="flip"`` with the
fused transfers and the packed, Chebyshev-preconditioned projection).

One ``flip_step`` is

  sort by cell -> P2G (K1) -> occupancy -> pressure projection do-while
  (PCG with K3 applies and K4 Chebyshev steps) -> FLIP delta G2P (K2) ->
  CFL dt -> advection with solid bounce

with every field a dense f32 tensor on one device.  The projection keeps
the reference's outer divergence-correction loop (relative error <= 0.1)
and its quirks (gradient at dt/10 strength, gravity re-applied per pass).
The JAX package's other modes and schedules (PIC, APIC, chunked and
sharded transfers, multigrid, the clean projection) are not ported here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm, flat_index
from fluidsim_tpu_torch.core.splines import cround, cround_out
from fluidsim_tpu_torch.ops import pressure as pr
from fluidsim_tpu_torch.ops import stencil_kernels as sk
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.pcg import pcg
from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm
from fluidsim_tpu_torch.scenes import Scene, get_scene
from fluidsim_tpu_torch.seeding import seed_particles
from fluidsim_tpu_torch.utils.profiling import check_finite


@dataclasses.dataclass(frozen=True)
class FlipParams:
    """Solver configuration.  Defaults mirror the reference constants: dt
    cap 0.1, rho = 1, dx = 1, gravity (0, -10, 0), outer tolerance 0.1.
    The frame is FLIP mode with the FLIP spline and a Chebyshev-Jacobi
    preconditioner of degree ``stencil_kernels.CHEB_DEGREE``."""

    bound: int = 60
    wall: int = 58
    dx: float = 1.0
    rho: float = 1.0
    max_dt: float = 0.1
    gravity: Tuple[float, float, float] = (0.0, -10.0, 0.0)
    outer_tol: float = 0.1
    max_outer: int = 100
    pcg_rtol: float = 0.0            # 0 = auto by grid size (auto_pcg_rtol)
    pcg_maxiter: int = 400
    walls_only_solid: bool = False   # solid == box walls exactly: analytic
                                     # bounce probe (auto-detected by FlipSim)


@dataclasses.dataclass
class FlipState:
    pos: torch.Tensor        # (P, 3) positions, index space
    vel: torch.Tensor        # (P, 3) velocities
    dt: torch.Tensor         # () CFL dt carried across frames
    t: torch.Tensor          # () accumulated simulation time
    frame: torch.Tensor      # () int32
    pressure: torch.Tensor   # (N,N,N) last pressure, warm-starts the next solve


def lookup_bool(grid: torch.Tensor, cells: torch.Tensor, bound: int):
    """Read a bool grid at integer coords; out-of-box reads False."""
    n = 2 * bound + 1
    inb = torch.all(torch.abs(cells) <= bound, dim=-1)
    idx = torch.clamp(cells + bound, 0, n - 1)
    return grid.reshape(-1)[flat_index(idx, n)] & inb


def advect_bounce(pos, vel, dt, solid, bound: int, e: float, rounding: str,
                  analytic_wall: int | None = None):
    """Advection with per-axis solid bounce.

    ``rounding``: "round" = C round(), "out" = ceil/floor away from zero.
    The per-axis probe mixes the rounded moved coordinate on the probed axis
    with the *truncated* original position on the others, as the reference
    does.  ``analytic_wall``: the scene's solid is exactly ``|c| > wall``,
    so the probes are coordinate tests instead of grid reads.
    """
    rnd = cround if rounding == "round" else cround_out

    if analytic_wall is not None:
        def probe_solid(c):
            inb = torch.all(torch.abs(c) <= bound, dim=-1)
            return torch.any(torch.abs(c) > analytic_wall, dim=-1) & inb
    else:
        def probe_solid(c):
            return lookup_bool(solid, c, bound)

    pnew = pos + dt * vel
    r = rnd(pnew).to(torch.int32)
    hit = probe_solid(r)

    ptrunc = torch.trunc(pos).to(torch.int32)
    velm = []
    for d in range(3):
        probe = ptrunc.clone()
        probe[:, d] = r[:, d]
        hit_d = probe_solid(probe)
        velm.append(torch.where(hit & hit_d, -e * vel[:, d], vel[:, d]))
    velm = torch.stack(velm, dim=-1)
    pos_out = torch.where(hit[:, None], pos + velm * dt, pnew)
    return pos_out, velm


def auto_pcg_rtol(n: int) -> float:
    """CG tolerance used when ``params.pcg_rtol == 0``: 1e-5 up to 129^3,
    1e-3 on larger grids."""
    return 1e-5 if n <= 129 else 1e-3


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum((x * x).to(torch.float32)))


def project(params: FlipParams, velg, fluid, solid, dt, p0=None):
    """Pressure projection of channel-major (3,N,N,N) grid velocity: the
    reference's do-while — one pass always, then more while the relative
    divergence change exceeds ``outer_tol`` and fewer than ``max_outer``
    passes ran.  Each pass solves with PCG (K3 apply, K4 Chebyshev steps),
    warm-started from the previous pass (the first from ``p0`` masked to
    fluid cells).

    Returns (velg', err, n_outer, cg_iters_total, div_rms, pressure), with
    ``n_outer`` and ``cg_iters_total`` Python ints.
    """
    g = params.gravity
    dx, rho = params.dx, params.rho
    pcg_rtol = params.pcg_rtol or auto_pcg_rtol(fluid.shape[0])
    adiag = pr.laplacian_diag(fluid, solid, dt, rho, dx, dtype=velg.dtype)
    scale = float(dt / (rho * dx * dx))     # f32 value, read once per frame
    apply_a = lambda q: sk.apply_laplacian(q, adiag, scale)
    precond = sk.chebyshev_precond_fused(adiag, scale)

    def one_pass(velg, x0):
        rhs = pr.set_rhs(velg, fluid, solid, g, dt, dx)
        b = pr.divergence_rhs(velg, rhs, fluid, solid, dx)
        res = pcg(apply_a, b, x0=x0, precond=precond, rtol=pcg_rtol,
                  maxiter=params.pcg_maxiter)
        velg2 = pr.vel_update(velg, res.x, fluid, solid, g, dt, rho, dx)
        rhs2 = pr.set_rhs(velg2, fluid, solid, g, dt, dx)
        b2 = pr.divergence_rhs(velg2, rhs2, fluid, solid, dx)
        bn = _norm(b)
        pos_bn = bn > 0
        err = torch.where(pos_bn, _norm(b - b2) / torch.where(pos_bn, bn, 1.0),
                          0.0)
        return velg2, err, res.iters, b2, res.x

    nfluid = torch.clamp(torch.sum(fluid), min=1)
    p = (torch.zeros(fluid.shape, dtype=velg.dtype, device=velg.device)
         if p0 is None else torch.where(fluid, p0, 0.0))

    velg, err, cg_tot, b2, p = one_pass(velg, p)
    n = 1
    while n < params.max_outer and bool(err > params.outer_tol):
        velg, err, iters, b2, p = one_pass(velg, p)
        n += 1
        cg_tot += iters
    div_rms = _norm(b2) / torch.sqrt(nfluid.to(torch.float32))
    return velg, err, n, cg_tot, div_rms, p


def flip_step(params: FlipParams, solid: torch.Tensor, state: FlipState):
    """One FLIP frame; returns (new_state, metrics)."""
    B, wall = params.bound, params.wall
    n = 2 * B + 1
    dt = state.dt

    pos, vel, flat = tk.sort_by_cell(state.pos, state.vel, B)
    w27t = tk.masked_weights_cm(pos, B)   # shared by P2G and G2P
    weights, mom, occ = tk.p2g(w27t, vel, tk.cell_starts(flat, n), solid, B)
    velg = normalize_velocity_cm(weights, mom)
    fluid = (occ > 0) & ~solid
    velb = velg

    velg, err, n_outer, cg_iters, div_rms, pressure = project(
        params, velg, fluid, solid, dt, p0=state.pressure)

    delta = tk.g2p(w27t, flat,
                   cell_center_velocity_cm(velg) - cell_center_velocity_cm(velb),
                   B, wall)
    vel = vel + delta

    # CFL
    speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
    max_speed = torch.max(speed)
    max_dt = torch.tensor(params.max_dt, dtype=vel.dtype, device=vel.device)
    dt_new = torch.where(max_speed != 0,
                         torch.minimum(max_dt, params.dx / max_speed), max_dt)

    pos, vel = advect_bounce(
        pos, vel, dt_new, solid, B, 0.0, rounding="round",
        analytic_wall=params.wall if params.walls_only_solid else None)

    new_state = FlipState(pos=pos, vel=vel, dt=dt_new, t=state.t + dt_new,
                          frame=state.frame + 1, pressure=pressure)
    metrics = {
        "error": err,
        "dt_used": dt,
        "outer_iters": n_outer,
        "cg_iters": cg_iters,
        "dt": dt_new,
        "max_speed": max_speed,
        "kinetic_energy": 0.5 * torch.sum((vel * vel).to(torch.float32)),
        "div_rms": div_rms,
        "num_fluid_cells": torch.sum(fluid),
        "transfer_overflow": torch.zeros((), dtype=torch.int32,
                                         device=vel.device),
        "occupancy": occ,
    }
    return new_state, metrics


def _auto_params(scene: Scene, params: FlipParams | None) -> FlipParams:
    """The scene's default parameters, with the analytic bounce probe
    switched on when the scene's solid is exactly the box walls."""
    if params is None:
        params = FlipParams(bound=scene.spec.bound, wall=scene.spec.wall,
                            dx=scene.spec.dx,
                            gravity=tuple(scene.gravity))
    # Walls-only scenes take the analytic bounce probe.
    if (not params.walls_only_solid
            and params.wall == scene.spec.wall
            and params.bound == scene.spec.bound
            and np.array_equal(np.asarray(scene.solid),
                               scene.spec.wall_mask())):
        params = dataclasses.replace(params, walls_only_solid=True)
    return params


class FlipSim:
    """The simulation: owns the state on one explicit device and runs the
    frame loop.

    f32 throughout.  TF32 is switched off for matmuls and cuDNN (both
    process-wide PyTorch flags) when a sim is built, so no f32 product on
    the card runs at reduced precision; the frame itself has no matmul.
    """

    def __init__(self, scene: Scene | str = "water_cube_drop",
                 params: FlipParams | None = None, seed: int = 0, *,
                 device, **scene_kwargs):
        if isinstance(scene, str):
            scene = get_scene(scene, **scene_kwargs)
        params = _auto_params(scene, params)
        device = torch.device(device)
        pos, vel = seed_particles(scene, seed=seed)
        f32 = dict(dtype=torch.float32, device=device)
        state = FlipState(
            pos=torch.as_tensor(pos, **f32), vel=torch.as_tensor(vel, **f32),
            dt=torch.tensor(params.max_dt, **f32), t=torch.zeros((), **f32),
            frame=torch.zeros((), dtype=torch.int32, device=device),
            pressure=torch.zeros(scene.spec.shape, **f32))
        self._setup(scene, params, state, device)

    @classmethod
    def from_state(cls, scene: Scene | str, state: FlipState,
                   params: FlipParams | None = None, *, device,
                   **scene_kwargs) -> "FlipSim":
        """A sim that continues from ``state`` (e.g. one carried over from
        the JAX package by ``interop.state_from_numpy``)."""
        if isinstance(scene, str):
            scene = get_scene(scene, **scene_kwargs)
        device = torch.device(device)
        sim = cls.__new__(cls)
        moved = FlipState(**{f.name: getattr(state, f.name).to(device)
                             for f in dataclasses.fields(FlipState)})
        sim._setup(scene, _auto_params(scene, params), moved, device)
        return sim

    def _setup(self, scene: Scene, params: FlipParams,
               state: FlipState, device: torch.device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.scene = scene
        self.params = params
        self.device = device
        self.solid = torch.as_tensor(np.asarray(scene.solid), device=device)
        self.state = state

    @property
    def num_particles(self) -> int:
        return int(self.state.pos.shape[0])

    def step(self) -> Dict[str, Any]:
        self.state, metrics = flip_step(self.params, self.solid, self.state)
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
