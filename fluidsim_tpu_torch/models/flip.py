"""FLIP / PIC / APIC incompressible liquid frame on PyTorch — the
counterpart of ``fluidsim_tpu/models/flip.py`` on its kernel path (the
fused transfers and the packed, Chebyshev-preconditioned projection).

One ``flip_step`` is

  sort by cell -> P2G (K1, or K1 aff in APIC) -> occupancy -> pressure
  projection do-while (PCG with K3 applies; the preconditioner K4
  Chebyshev steps, a multigrid V-cycle whose fine level is K3, or Jacobi)
  -> G2P
  (FLIP: the delta through K2; PIC: the new velocity through K2; APIC: the
  offset moments through K2 moments and the affine fit) -> CFL dt ->
  advection with solid bounce (restitution 0 in FLIP, 0.5 in PIC and APIC)

with every field a dense f32 tensor on one device.  With
``sort_method="bucket"`` the sort groups particles by 512-cell window only
(the bucket sort, K5; the full sort when its caps trip), and P2G is the
unfused pair K6a (base-cell scatter) and K6b (shift-reduce), which need no
more than that grouping; G2P reads each particle alone and takes either
order.  The projection keeps
the reference's outer divergence-correction loop (relative error <= 0.1)
and its quirks (gradient at dt/10 strength, gravity re-applied per pass),
unless ``compat_projection=False`` asks for the textbook projection.  The
JAX package's XLA and chunked transfer schedules select no other function
and have no counterpart here; the slab-sharded sims are in ``parallel/``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm, flat_index
from fluidsim_tpu_torch.core.splines import cround, cround_out
from fluidsim_tpu_torch.ops import apic
from fluidsim_tpu_torch.ops import multigrid as mg
from fluidsim_tpu_torch.ops import pressure as pr
from fluidsim_tpu_torch.ops import stencil_kernels as sk
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.pcg import pcg
from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm
from fluidsim_tpu_torch.scenes import Scene, get_scene
from fluidsim_tpu_torch.seeding import seed_particles
from fluidsim_tpu_torch.utils.profiling import check_finite, host_wait, span


@dataclasses.dataclass(frozen=True)
class FlipParams:
    """Solver configuration: the JAX package's fields with its defaults,
    which mirror the reference constants (dt cap 0.1, rho = 1, dx = 1,
    gravity (0, -10, 0), outer tolerance 0.1).

    Fields that change what the frame computes: ``mode`` ("flip", "pic" or
    "apic"), ``kernel`` (the transfer spline, "flip" or "mpm"),
    ``compat_projection`` (True: the reference's do-while with the gradient
    at 1/10 strength and gravity on every pass; False: gravity once, one
    full-strength solve), ``preconditioner`` ("chebyshev" with
    ``cheb_degree`` and ``cheb_ratio``, "jacobi" or "multigrid"),
    ``sort_method`` ("full": stable sort by cell and K1; "bucket":
    window-grouped bucket sort K5 and the unfused P2G K6a, K6b) and the
    solver tolerances.

    ``fast_transfer``, ``transfer_chunks``, ``pallas_transfer``,
    ``pallas_interpret``, ``transfer_window``, ``transfer_chunk`` and
    ``stencil_bx_cap`` choose among the JAX package's XLA and Pallas
    schedules of the same functions.  The port accepts and keeps them, but
    they change nothing on its path: the frame runs its kernels whatever
    they hold.  ``walls_only_solid`` (the analytic bounce probe) is set by
    ``FlipSim`` when the scene's solid is exactly the box walls.
    """

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
    mode: str = "flip"
    kernel: str = "flip"
    compat_projection: bool = True
    fast_transfer: bool = True
    transfer_chunks: int = 0
    pallas_transfer: bool | None = None
    pallas_interpret: bool = False
    sort_method: str = "full"
    walls_only_solid: bool = False
    transfer_window: int = 0
    transfer_chunk: int = 0
    preconditioner: str = "chebyshev"
    cheb_degree: int = 3             # Chebyshev: cheb_degree - 1 K4 steps
                                     # per application
    cheb_ratio: float = 30.0         # Chebyshev: lam_max / lam_min
    stencil_bx_cap: int = 0

    def __post_init__(self):
        choices = {"mode": ("flip", "pic", "apic"),
                   "kernel": ("flip", "mpm"),
                   "sort_method": ("full", "bucket"),
                   "preconditioner": ("jacobi", "chebyshev", "multigrid")}
        for name, allowed in choices.items():
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} {getattr(self, name)!r}: expected "
                                 f"one of {allowed}")


@dataclasses.dataclass
class FlipState:
    pos: torch.Tensor        # (P, 3) positions, index space
    vel: torch.Tensor        # (P, 3) velocities
    dt: torch.Tensor         # () CFL dt carried across frames
    t: torch.Tensor          # () accumulated simulation time
    frame: torch.Tensor      # () int32
    pressure: torch.Tensor   # (N,N,N) last pressure, warm-starts the next solve
    aff: torch.Tensor | None = None   # (P, 3, 3) APIC affine matrices
                                      # (mode="apic"), else None


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


def _preconditioner(params: FlipParams, adiag, scale: float, fluid, solid,
                    dt, apply_a):
    """The packed branch's preconditioner of ``params.preconditioner``."""
    if params.preconditioner == "chebyshev":
        return sk.chebyshev_precond_fused(adiag, scale,
                                          degree=params.cheb_degree,
                                          ratio=params.cheb_ratio)
    if params.preconditioner == "multigrid":
        return mg.mg_preconditioner_packed(fluid, solid, dt, params.rho,
                                           params.dx, apply_a, adiag)
    fluid_a = adiag > 0
    safe = torch.where(fluid_a, adiag, 1.0)
    return lambda r: torch.where(fluid_a, r / safe, 0.0)


def project(params: FlipParams, velg, fluid, solid, dt, p0=None):
    """Pressure projection of channel-major (3,N,N,N) grid velocity.

    ``compat_projection=True``: the reference's do-while — one pass always,
    then more while the relative divergence change exceeds ``outer_tol``
    and fewer than ``max_outer`` passes ran.  Each pass solves with PCG (K3
    applies and ``params.preconditioner``), warm-started from the previous
    pass (the first from ``p0`` masked to fluid cells).

    ``compat_projection=False``: the textbook projection — gravity added
    once on fluid cells, one solve, the full-strength gradient, and the
    error ``|b2| / |b|`` of the divergence left after it.

    Returns (velg', err, n_outer, cg_iters_total, div_rms, pressure), with
    ``n_outer`` and ``cg_iters_total`` Python ints.

    The JAX ``project`` caps the packed block size at 16 in APIC mode to fit
    the TPU's VMEM; the dense layout here has no block size, so every mode
    solves the same way.
    """
    g = params.gravity
    dx, rho = params.dx, params.rho
    pcg_rtol = params.pcg_rtol or auto_pcg_rtol(fluid.shape[0])
    adiag = pr.laplacian_diag(fluid, solid, dt, rho, dx, dtype=velg.dtype)
    # the f32 value, read once per frame
    scale = host_wait("project.scale", float, dt / (rho * dx * dx))
    apply_a = lambda q: sk.apply_laplacian(q, adiag, scale)
    precond = _preconditioner(params, adiag, scale, fluid, solid, dt, apply_a)

    def solve(b, x0):
        return pcg(apply_a, b, x0=x0, precond=precond, rtol=pcg_rtol,
                   maxiter=params.pcg_maxiter)

    def rel_norm(num, b):
        bn = _norm(b)
        pos_bn = bn > 0
        return torch.where(pos_bn, _norm(num) / torch.where(pos_bn, bn, 1.0),
                           0.0)

    nfluid = torch.clamp(torch.sum(fluid), min=1)
    p = (torch.zeros(fluid.shape, dtype=velg.dtype, device=velg.device)
         if p0 is None else torch.where(fluid, p0, 0.0))

    if not params.compat_projection:
        no_g = (0.0, 0.0, 0.0)
        gv = host_wait("upload.gravity", torch.tensor, g, dtype=velg.dtype,
                       device=velg.device)
        velg = velg + gv[:, None, None, None] * dt * fluid.to(velg.dtype)[None]
        b = pr.divergence_rhs(velg, pr.set_rhs(velg, fluid, solid, no_g, dt,
                                               dx), fluid, solid, dx)
        res = solve(b, p)
        velg = pr.vel_update(velg, res.x, fluid, solid, g, dt, rho, dx,
                             gradient_scale=1.0, add_gravity=False)
        b2 = pr.divergence_rhs(velg, pr.set_rhs(velg, fluid, solid, no_g, dt,
                                                dx), fluid, solid, dx)
        div_rms = _norm(b2) / torch.sqrt(nfluid.to(torch.float32))
        return velg, rel_norm(b2, b), 1, res.iters, div_rms, res.x

    def one_pass(velg, x0):
        rhs = pr.set_rhs(velg, fluid, solid, g, dt, dx)
        b = pr.divergence_rhs(velg, rhs, fluid, solid, dx)
        res = solve(b, x0)
        velg2 = pr.vel_update(velg, res.x, fluid, solid, g, dt, rho, dx)
        rhs2 = pr.set_rhs(velg2, fluid, solid, g, dt, dx)
        b2 = pr.divergence_rhs(velg2, rhs2, fluid, solid, dx)
        return velg2, rel_norm(b - b2, b), res.iters, b2, res.x

    velg, err, cg_tot, b2, p = one_pass(velg, p)
    n = 1
    while n < params.max_outer and host_wait("project.outer", bool,
                                             err > params.outer_tol):
        velg, err, iters, b2, p = one_pass(velg, p)
        n += 1
        cg_tot += iters
    div_rms = _norm(b2) / torch.sqrt(nfluid.to(torch.float32))
    return velg, err, n, cg_tot, div_rms, p


def flip_step(params: FlipParams, solid: torch.Tensor, state: FlipState):
    """One frame in ``params.mode``; returns (new_state, metrics)."""
    B, wall = params.bound, params.wall
    dt = state.dt
    aff = state.aff

    sort = params.sort_method
    fused = sort == "full"       # the bucket order feeds the unfused P2G
    if params.mode == "apic":
        with span("sort"):
            pos, vel, flat, aff_flat = tk.sort_by_cell(
                state.pos, state.vel, B, extra=aff.reshape(-1, 9),
                method=sort)
            aff = aff_flat.reshape(-1, 3, 3)
        with span("weights"):
            w27t = tk.masked_weights_cm(pos, B, params.kernel)  # P2G, G2P
        with span("P2G"):
            weights, mom, occ = apic.p2g_apic(w27t, pos, vel, aff, flat,
                                              solid, B, fused_scatter=fused)
    else:
        with span("sort"):
            pos, vel, flat = tk.sort_by_cell(state.pos, state.vel, B,
                                             method=sort)
        with span("weights"):
            w27t = tk.masked_weights_cm(pos, B, params.kernel)
        with span("P2G"):
            weights, mom, occ = tk.p2g(w27t, vel, flat, solid, B,
                                       fused_scatter=fused)
    with span("P2G"):
        velg = normalize_velocity_cm(weights, mom)
        fluid = (occ > 0) & ~solid
    velb = velg

    with span("projection"):
        velg, err, n_outer, cg_iters, div_rms, pressure = project(
            params, velg, fluid, solid, dt, p0=state.pressure)

    with span("G2P"):
        vc_new = cell_center_velocity_cm(velg)
        if params.mode == "apic":
            vel, aff = apic.g2p_apic(w27t, flat, pos, vc_new, B, wall)
            e = 0.5
        elif params.mode == "flip":
            vel = vel + tk.g2p(w27t, flat,
                               vc_new - cell_center_velocity_cm(velb), B, wall)
            e = 0.0
        else:
            vel = tk.g2p(w27t, flat, vc_new, B, wall)
            e = 0.5

    with span("advection"):
        # CFL
        speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
        max_speed = torch.max(speed)
        max_dt = host_wait("upload.max_dt", torch.tensor, params.max_dt,
                           dtype=vel.dtype, device=vel.device)
        dt_new = torch.where(max_speed != 0,
                             torch.minimum(max_dt, params.dx / max_speed),
                             max_dt)

        pos, vel = advect_bounce(
            pos, vel, dt_new, solid, B, e, rounding="round",
            analytic_wall=params.wall if params.walls_only_solid else None)

    new_state = FlipState(pos=pos, vel=vel, dt=dt_new, t=state.t + dt_new,
                          frame=state.frame + 1, pressure=pressure, aff=aff)
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


def require_f32(dtype) -> None:
    """Raise unless ``dtype`` (a torch or numpy dtype, or its name) is
    float32: the port's frames and kernels are f32 only."""
    if dtype is torch.float32:
        return
    try:
        ok = np.dtype(dtype) == np.float32
    except TypeError:
        ok = False
    if not ok:
        raise ValueError(f"dtype {dtype!r}: the port runs in float32 only")


def _auto_params(scene: Scene, params: FlipParams | None,
                 mode: str | None = None) -> FlipParams:
    """The scene's default parameters (``mode``, when given, replaces the
    mode of ``params``), with the analytic bounce probe switched on when the
    scene's solid is exactly the box walls."""
    if params is None:
        params = FlipParams(bound=scene.spec.bound, wall=scene.spec.wall,
                            dx=scene.spec.dx,
                            gravity=tuple(scene.gravity))
    if mode is not None:
        params = dataclasses.replace(params, mode=mode)
    # Walls-only scenes take the analytic bounce probe.
    if (not params.walls_only_solid
            and params.wall == scene.spec.wall
            and params.bound == scene.spec.bound
            and np.array_equal(np.asarray(scene.solid),
                               scene.spec.wall_mask())):
        params = dataclasses.replace(params, walls_only_solid=True)
    return params


class FlipSim:
    """The simulation: owns the state on one device and runs the frame loop.

    ``device`` is "cuda" unless the caller asks for another (the tests pass
    "cpu"); without a card the default raises.  ``mode`` ("flip", "pic" or
    "apic"), when given, replaces the mode of ``params``.  ``seeder`` places
    the particles (``seeding.seed_particles``, or
    ``compat.scatter.seed_particles_compat`` for the reference's own
    stream).

    f32 throughout: ``dtype`` accepts float32 only.  TF32 is switched off
    for matmuls and cuDNN (both process-wide PyTorch flags) when a sim is
    built, so no f32 product on the card runs at reduced precision; the
    frame itself has no matmul.
    """

    def __init__(self, scene: Scene | str = "water_cube_drop",
                 params: FlipParams | None = None, seed: int = 0,
                 dtype=torch.float32, seeder=seed_particles, *,
                 device="cuda", mode: str | None = None, **scene_kwargs):
        require_f32(dtype)
        if isinstance(scene, str):
            scene = get_scene(scene, **scene_kwargs)
        params = _auto_params(scene, params, mode)
        device = torch.device(device)
        pos, vel = seeder(scene, seed=seed, dtype="float32")
        f32 = dict(dtype=torch.float32, device=device)
        state = FlipState(
            pos=torch.as_tensor(pos, **f32), vel=torch.as_tensor(vel, **f32),
            dt=torch.tensor(params.max_dt, **f32), t=torch.zeros((), **f32),
            frame=torch.zeros((), dtype=torch.int32, device=device),
            pressure=torch.zeros(scene.spec.shape, **f32),
            aff=(torch.zeros((pos.shape[0], 3, 3), **f32)
                 if params.mode == "apic" else None))
        self._setup(scene, params, state, device)

    @classmethod
    def from_state(cls, scene: Scene | str, state: FlipState,
                   params: FlipParams | None = None, *, device="cuda",
                   mode: str | None = None, **scene_kwargs) -> "FlipSim":
        """A sim that continues from ``state`` (e.g. one carried over from
        the JAX package by ``interop.state_from_numpy``)."""
        if isinstance(scene, str):
            scene = get_scene(scene, **scene_kwargs)
        device = torch.device(device)
        sim = cls.__new__(cls)
        moved = FlipState(**{
            f.name: (None if getattr(state, f.name) is None
                     else getattr(state, f.name).to(device))
            for f in dataclasses.fields(FlipState)})
        sim._setup(scene, _auto_params(scene, params, mode), moved, device)
        return sim

    def _setup(self, scene: Scene, params: FlipParams,
               state: FlipState, device: torch.device):
        if params.mode == "apic" and state.aff is None:
            raise ValueError("mode='apic' needs a state with aff (P, 3, 3)")
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
        with span("frame"):
            self.state, metrics = flip_step(self.params, self.solid,
                                            self.state)
        return metrics

    def steps(self, k: int) -> Dict[str, Any]:
        """Run ``k`` frames back to back; returns their metrics stacked on a
        leading (k,) axis on the device, without the grid-sized
        ``occupancy`` (use ``step()`` where a frame's grid is needed, as for
        per-frame export).  The frames are ``k`` calls of ``step()``, bit
        for bit; the stacking adds no read of the device."""
        return stack_metrics([self.step() for _ in range(k)])

    def run(self, frames: int, callback=None, check: bool = True,
            chunk: int = 1):
        """Frame loop; ``callback(frame, state, metrics)`` runs after each
        frame, or with ``chunk`` > 1 once per ``steps(chunk)`` with the
        stacked metrics and the chunk's last state.  Returns the last
        frame's (or chunk's) metrics."""
        return run_frames(self, frames, callback, check, chunk)


def stack_metrics(frames) -> Dict[str, torch.Tensor]:
    """Per-frame metrics stacked on a leading (k,) axis, ``occupancy``
    left out.  Python numbers (the host-side iteration counts) become one
    int32 tensor on the frames' device, as the JAX package's stacked
    counts are int32; nothing is read from the device."""
    device = next(v.device for v in frames[0].values()
                  if isinstance(v, torch.Tensor))
    out = {}
    for key, v in frames[0].items():
        if key == "occupancy":
            continue
        if isinstance(v, torch.Tensor):
            out[key] = torch.stack([f[key] for f in frames])
        else:
            out[key] = torch.tensor([f[key] for f in frames],
                                    dtype=torch.int32, device=device)
    return out


def run_frames(sim, frames: int, callback, check: bool, chunk: int):
    """``FlipSim.run`` and ``MpmSim.run``: the JAX package's frame-loop
    contract."""
    out = None
    done = 0
    while done < frames:
        k = min(max(chunk, 1), frames - done)
        if chunk > 1:
            metrics = sim.steps(k)
            last = {m: v[-1] for m, v in metrics.items()}
        else:
            metrics = last = sim.step()
        done += k
        frame = int(sim.state.frame) - 1
        if check:
            check_finite(last, frame)
        if callback is not None:
            callback(frame, sim.state, metrics)
        out = metrics
    return out
