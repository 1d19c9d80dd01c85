"""Slab-sharded MPM over ``torch.distributed`` — the counterpart of
``fluidsim_tpu/parallel/mpm_sharded.py`` on its kernel path (the Pallas
slab pipeline, ``pallas_transfer=True``).

The decomposition of ``parallel.flip_sharded`` (slabs of the grid's x axis,
one per rank; particles owned by the slab of their base cell; the solid
replicated) carries the MPM frame (``models/mpm.py``):

  sort by slab cell (FE, FP and the volume along) -> mass and momentum P2G
  (K1, halo_reduce) -> density (K2 over the mass's 2-row halo; the volumes
  at frame 0) -> explicit force (K1 fg, halo_reduce) -> implicit solve (CG;
  each matvec exchanges the trial velocity's 2-row halo, gathers gradW
  with K2 gw, scatters the force differential with K1 fg and folds its
  halo back) -> velocity gradient (K2 gw) -> deformation update -> FLIP
  delta (K2) -> CFL dt -> advection -> migration of all 25 columns

The hybrid operator's fallback test and every CG test read all-reduced
values, so all ranks take the same branch.  Migration sizes its edge band
from the seed-time histogram of the boundary rows as the JAX sim does,
floored by the FLIP sim's uniform-density bound ``8 cap / nl``: the JAX
sizing alone can under-size the band for a scene whose dense rows reach a
slab edge later in the run.  The JAX preconditioner field (``precond``)
has no effect on the sharded solve, as there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm
from fluidsim_tpu_torch.core.splines import cround
from fluidsim_tpu_torch.models.flip import advect_bounce, require_f32
from fluidsim_tpu_torch.models.mpm import MpmParams
from fluidsim_tpu_torch.ops import mpm_kernels as mk
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.pcg import pcg
from fluidsim_tpu_torch.ops.svd3 import (clamp_singular, det3, hardening, mm3,
                                         piola_linearized)
from fluidsim_tpu_torch.parallel.flip_sharded import (
    SENTINEL, W, LostParticleMonitor, Slab, migrate, resolve_device,
    seed_owners, slab_gather, sort_slab)
from fluidsim_tpu_torch.scenes import Scene, get_scene
from fluidsim_tpu_torch.seeding import seed_particles
from fluidsim_tpu_torch.utils.profiling import host_wait, span


@dataclasses.dataclass
class ShardedMpmState:
    """One rank's part of the JAX ``ShardedMpmState``: its ``cap`` slots;
    ``dt``, ``t`` and ``frame`` are the same on every rank."""
    pos: torch.Tensor        # (cap, 3)
    vel: torch.Tensor        # (cap, 3)
    FE: torch.Tensor         # (cap, 3, 3)
    FP: torch.Tensor         # (cap, 3, 3)
    volume: torch.Tensor     # (cap,)
    alive: torch.Tensor      # (cap,) bool
    dt: torch.Tensor         # ()
    t: torch.Tensor          # ()
    frame: torch.Tensor      # () int32


def _gather_gw(fields_ext, mask_ext, gradw, flat, count):
    """(cap, 3, 3) ``g[p, c, k] = sum_o gradW_k(p, o) f_c(base + off_o)``
    of channel-major slab fields masked to ``mask_ext``, by K2 gw over the
    alive prefix (0 past it)."""
    out = tk.g2p_gather_gw(torch.where(mask_ext[None], fields_ext, 0.0),
                           gradw, flat, count)
    return out.reshape(3, 3, -1).permute(2, 0, 1)


def sharded_mpm_step(params: MpmParams, slab: Slab, cap: int, mig_cap: int,
                     tail_insert: bool, within_ext, state: ShardedMpmState):
    """One MPM frame on this rank's slab (every rank of the group calls
    it); returns (new_state, metrics), the metrics the JAX step's (plus
    ``min_det_fp`` over the alive particles), reduced over the ranks except
    ``occupancy`` (this slab's (nl, n, n) mass); ``cg_iters`` and
    ``spd_fallback`` are Python ints."""
    b, n = params.bound, slab.n
    dt = state.dt
    dev = state.pos.device
    f32 = dict(dtype=state.pos.dtype, device=dev)
    thr = params.mass_threshold
    with span("sort"):
        extra = torch.cat([state.FE.reshape(cap, 9),
                           state.FP.reshape(cap, 9), state.volume[:, None]],
                          dim=-1)
        pos, vel, alive, flat, extra = sort_slab(slab, state.pos, state.vel,
                                                 state.alive, extra)
        fe_in = extra[:, 0:9].reshape(cap, 3, 3)
        fp_in = extra[:, 9:18].reshape(cap, 3, 3)
        volume_in = extra[:, 18]

    with span("stencil"):
        w27t, gradw = mk.mpm_stencil(pos, b)
    with span("cell ranges"):
        cell_start = tk.cell_starts(flat, n, slab.rows)
        count = cell_start[-1:]              # the alive prefix, on the device
    # one chunk plan for the frame's K1 and K1 fg launches (the card's only)
    with span("chunk plan"):
        plan = tk.chunk_plan(cell_start, cap) if cell_start.is_cuda else None
    ns_loc, ns_ext = ~slab.solid_loc, ~slab.solid_ext
    with span("P2G"):
        acc = slab.fold(tk.p2g_scatter(w27t, vel, cell_start, n, plan), W,
                        dim=1)
        mass = torch.where(ns_loc, acc[0], 0.0)
        mom = torch.where(ns_loc[None], acc[1:4], 0.0)
        heavy = mass > thr
        velg = torch.where(heavy[None],
                           mom / torch.where(heavy, mass, 1.0)[None], 0.0)

    # the volumes come from the density of frame 0 only (gathered every
    # frame, as in the JAX package)
    with span("density"):
        fm = mk.density_fields(slab.halo(mass, W), slab.solid_ext)
        dens = tk.g2p_gather(fm, w27t, flat, count)[0]
        vol0 = 1.0 / torch.where(dens > 0, dens, 1.0)
        volume = torch.where(state.frame == 0, torch.where(alive, vol0, 0.0),
                             volume_in)

    active = heavy & ns_loc
    active_ext = slab.halo(active, W)
    velb = velg

    with span("hardening"):
        mu, lam = hardening(params.mu0, params.lam0, params.hardening_eps,
                            det3(fp_in), exponent_cap=params.hardening_max)
    fe_t = fe_in.transpose(-1, -2)
    vol_alive = torch.where(alive, volume, 0.0)
    hess = params.operator
    with span("stress"):
        p0, dp_full, dp_spd = piola_linearized(fe_in, mu, lam)
    valid = torch.all(torch.abs(cround(pos)) <= b, dim=-1)
    scale = torch.where(valid, -vol_alive, 0.0)

    def scatter_m9(m9):
        """K1 fg of the (cap, 9) rows ``m9`` on the transfer slab, masked
        to non-solid cells, its halo folded back: (3, nl, n, n)."""
        f = tk.p2g_scatter_force(gradw, m9, cell_start, n, plan)
        return slab.fold(torch.where(ns_ext[None], f, 0.0), W, dim=1)

    def explicit_force():
        with span("stress"):
            m9 = (scale[:, None]
                  * mm3(p0, fe_t).reshape(cap, 9)).contiguous()
        return scatter_m9(m9)

    def dforce_with(dp):
        def dforce(wv_loc):
            with span("apply.gather"):
                g9 = tk.g2p_gather_gw(
                    torch.where(active_ext[None], slab.halo(wv_loc, W, dim=1),
                                0.0), gradw, flat, count)
            with span("apply.stress"):
                m9 = dp.apply(g9, scale)
            with span("apply.scatter"):
                return scatter_m9(m9)
        return dforce

    with span("solve"):
        f0 = explicit_force()
        mass_safe = torch.where(active, mass, 1.0)[None]
        grav = host_wait("upload.gravity", torch.tensor, params.gravity,
                         **f32)[:, None, None, None]
        rhs = torch.where(active[None], velg + dt * (f0 / mass_safe + grav),
                          0.0)
        beta_dt2 = params.beta * dt * dt

        def matvec_of(dforce):
            def matvec(wv):
                df = dforce(torch.where(active[None], wv, 0.0))
                out = wv + beta_dt2 * (-df) / mass_safe
                return torch.where(active[None], out, wv)
            return matvec

        # CG from x0 = rhs, the dot products all-reduced
        if hess == "hybrid":
            res_f = pcg(matvec_of(dforce_with(dp_full)), rhs, x0=rhs,
                        rtol=params.cg_rtol, maxiter=params.cg_hybrid_cap,
                        reduce_fn=slab.psum)
            bnorm2 = slab.psum(torch.sum((rhs * rhs).to(torch.float32)))
            rtol32 = host_wait("upload.cg_rtol", torch.tensor, params.cg_rtol,
                               dtype=torch.float32, device=dev)
            ok = host_wait("solve.hybrid_check", bool,
                           res_f.residual.to(torch.float32) ** 2
                           <= rtol32 ** 2 * bnorm2)
            if ok:
                solve_x, cg_iters = res_f.x, res_f.iters
            else:
                res = pcg(matvec_of(dforce_with(dp_spd)), rhs, x0=rhs,
                          rtol=params.cg_rtol, maxiter=params.cg_maxiter,
                          reduce_fn=slab.psum)
                solve_x, cg_iters = res.x, res_f.iters + res.iters
            spd_used = 0 if ok else 1
        else:
            dp = dp_spd if hess == "spd" else dp_full
            res = pcg(matvec_of(dforce_with(dp)), rhs, x0=rhs,
                      rtol=params.cg_rtol, maxiter=params.cg_maxiter,
                      reduce_fn=slab.psum)
            solve_x, cg_iters = res.x, res.iters
            spd_used = 1 if hess == "spd" else 0
        velg = torch.where(active[None], solve_x, 0.0)

    # deformation gradient update, with the deformation-increment limiter
    with span("gradV"):
        gradv = _gather_gw(slab.halo(velg, W, dim=1), ns_ext, gradw, flat,
                           count)
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
        fe_new = torch.where(alive[:, None, None], fe_new, eye)
        fp_new = torch.where(alive[:, None, None], fp_new, eye)

    # FLIP advection
    with span("FLIP delta"):
        dvc = (cell_center_velocity_cm(slab.halo(velg, W, dim=1))
               - cell_center_velocity_cm(slab.halo(velb, W, dim=1)))
        delta = slab_gather(slab, w27t, flat, count, dvc, within_ext)
        vel = torch.where(alive[:, None], vel + delta, 0.0)
    with span("advection"):
        speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
        max_speed = slab.pmax(torch.max(torch.where(alive, speed, 0.0)))
        max_dt = host_wait("upload.max_dt", torch.tensor, params.max_dt,
                           **f32)
        dt_new = torch.where(max_speed != 0,
                             torch.minimum(max_dt, params.dx / max_speed),
                             max_dt)
        pos_new, vel_new = advect_bounce(
            pos, vel, dt_new, slab.solid_full, b, 0.0, rounding="out",
            analytic_wall=params.wall if params.walls_only_solid else None)
        pos = torch.where(alive[:, None], pos_new, SENTINEL)
        vel = torch.where(alive[:, None], vel_new, 0.0)

    # migration of the whole particle: position, velocity, FE, FP, volume
    with span("migrate"):
        eye9 = eye.reshape(9)
        dead_row = torch.cat([torch.full((3,), SENTINEL, **f32),
                              torch.zeros((3,), **f32), eye9, eye9,
                              torch.zeros((1,), **f32)])
        payload = torch.cat([pos, vel, fe_new.reshape(cap, 9),
                             fp_new.reshape(cap, 9), volume[:, None]], dim=-1)
        payload, alive, moved, lost = migrate(slab, payload, alive, dead_row,
                                              cap, mig_cap, tail_insert)
    new_state = ShardedMpmState(
        pos=payload[:, 0:3].contiguous(), vel=payload[:, 3:6].contiguous(),
        FE=payload[:, 6:15].reshape(cap, 3, 3).contiguous(),
        FP=payload[:, 15:24].reshape(cap, 3, 3).contiguous(),
        volume=payload[:, 24].contiguous(), alive=alive, dt=dt_new,
        t=state.t + dt_new, frame=state.frame + 1)
    vel = new_state.vel
    ke = slab.psum(0.5 * torch.sum((vel * vel).to(torch.float32)))
    counts = slab.psum(torch.stack([active.sum(), alive.sum(), moved.sum(),
                                    lost.to(torch.int64)]))
    det_fp = torch.where(alive, det3(new_state.FP), float("inf"))
    min_det_fp = -slab.pmax(-torch.min(det_fp))
    metrics = {
        "cg_iters": cg_iters,
        "spd_fallback": spd_used,
        "dt": dt_new,
        "dt_used": dt,
        "max_speed": max_speed,
        "kinetic_energy": ke,
        "num_active_cells": counts[0],
        "num_alive": counts[1],
        "migrated": counts[2],
        "lost": counts[3],
        "min_det_fp": min_det_fp,
        "occupancy": mass,
    }
    return new_state, metrics


def mpm_migration_sizing(owner: np.ndarray, xcell: np.ndarray, nl: int,
                         size: int, cap_factor: float, mig_frac: float):
    """``(cap, mig_cap, tail_insert)`` of the sharded MPM from the seeded
    particles' ranks and x rows.  As the JAX sim: a cap from the fullest
    rank, and an edge band sized from the seed-time population of the
    slab-boundary rows with 1.5x headroom, the cap grown to keep the tail
    insert's room (2 mig_cap <= cap - 1.15 count).  The band is also
    floored by the FLIP sim's uniform-density edge bound ``8 cap / nl``,
    which does not depend on where the particles start."""
    counts = np.bincount(owner, minlength=size)
    cap0 = int(math.ceil(max(counts.max(), 8) * cap_factor / 8) * 8)
    row_pop = np.bincount(xcell, minlength=nl * size)
    edge_rows = [r for d in range(1, size)
                 for r in (d * nl - 1, d * nl) if r < nl * size]
    edge_pop = int(row_pop[edge_rows].max()) if edge_rows else 0
    mig_cap = max(64, int(cap0 * mig_frac), min(int(1.5 * edge_pop), cap0),
                  min(cap0, 8 * (cap0 // max(nl, 1))))
    need = int(counts.max() * 1.15) + 2 * mig_cap
    cap = max(cap0, int(math.ceil(need / 8) * 8))
    tail_insert = 2 * min(mig_cap, cap) <= cap - int(counts.max() * 1.15)
    return cap, mig_cap, tail_insert


class ShardedMpmSim(LostParticleMonitor):
    """The slab-sharded MPM simulation, built by every rank of ``group``
    with the same arguments, as ``ShardedFlipSim``.  The scene's default
    parameters detect a walls-only solid and resolve ``hessian="auto"``
    as ``MpmSim`` does; the JAX schedule fields are accepted and change
    nothing.  ``params.kernel`` must be "mpm": no JAX sharded MPM path
    transfers on the FLIP spline (its slab step always takes the MPM
    weights), so there is no reference to hold that frame to."""

    def __init__(self, scene: Scene | str = "mpm_cone",
                 params: MpmParams | None = None, group=None, seed: int = 0,
                 cap_factor: float = 1.35, mig_frac: float = 0.06, *,
                 device="cuda", dtype=torch.float32, seeder=seed_particles,
                 **scene_kwargs):
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
        if params.kernel != "mpm":
            raise ValueError(f"kernel {params.kernel!r}: the sharded MPM "
                             "transfers on the MPM spline only")
        params = dataclasses.replace(params, hessian=params.operator)
        device = resolve_device(device, group)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.scene, self.params, self.group, self.device = (scene, params,
                                                            group, device)
        self.slab = Slab.build(np.asarray(scene.solid), params.bound, group,
                               device)
        size, nl = self.slab.size, self.slab.nl
        self.nl = nl

        pos, vel = seeder(scene, seed=seed, dtype="float32")
        xcell = np.clip(seed_owners(pos, scene.spec.bound, 1, nl * size), 0,
                        nl * size - 1)
        owner = np.clip(xcell // nl, 0, size - 1)
        self.cap, self.mig_cap, self.tail_insert = mpm_migration_sizing(
            owner, xcell, nl, size, cap_factor, mig_frac)

        mine = owner == self.slab.rank
        k = int(mine.sum())
        f32 = dict(dtype=torch.float32, device=device)
        cap = self.cap
        pos_l = torch.full((cap, 3), SENTINEL, **f32)
        vel_l = torch.zeros((cap, 3), **f32)
        alive = torch.zeros((cap,), dtype=torch.bool, device=device)
        pos_l[:k] = torch.as_tensor(pos[mine], **f32)
        vel_l[:k] = torch.as_tensor(vel[mine], **f32)
        alive[:k] = True
        eye = torch.eye(3, **f32).expand(cap, 3, 3)
        self.state = ShardedMpmState(
            pos=pos_l, vel=vel_l, FE=eye.clone(), FP=eye.clone(),
            volume=torch.zeros((cap,), **f32), alive=alive,
            dt=torch.tensor(params.max_dt, **f32), t=torch.zeros((), **f32),
            frame=torch.zeros((), dtype=torch.int32, device=device))
        self.within_ext = self.slab.within_ext(params.wall)
        self._init_lost_monitor()

    @property
    def num_particles(self) -> int:
        """Alive particles over all ranks (an all-reduce: every rank calls
        it together)."""
        return int(self.slab.psum(self.state.alive.sum()))

    def step(self) -> Dict[str, Any]:
        with span("frame"):
            self.state, metrics = sharded_mpm_step(
                self.params, self.slab, self.cap, self.mig_cap,
                self.tail_insert, self.within_ext, self.state)
            self._note_lost(metrics)
        return metrics

    def run(self, frames: int, callback=None):
        out = None
        for _ in range(frames):
            out = self.step()
            if callback is not None:
                callback(int(self.state.frame) - 1, self.state, out)
        self._flush_lost()
        return out
