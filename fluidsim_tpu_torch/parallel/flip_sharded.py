"""Slab-sharded FLIP over ``torch.distributed`` — the counterpart of
``fluidsim_tpu/parallel/flip_sharded.py`` on its kernel path (the Pallas
slab pipeline, ``pallas_transfer=True``).

The grid's x axis is cut into slabs of ``nl = ceil(n / world)`` rows, one
per rank of a process group, and every rank runs ``sharded_flip_step`` on
its own slab: NCCL with one process per GPU on the card, gloo on the CPU.
A rank keeps the particles whose base cell lies in its slab in ``cap``
fixed slots; dead slots are parked at ``SENTINEL``.  The only traffic
between ranks is

* the 2-row halo of the P2G sums (``halo_reduce``) and of the G2P's delta
  field (``exchange_halo``),
* the edge rows that K3 and K4 read beside the pressure solve's slab
  operands (one row of ``p`` per apply, the preconditioner's ``r`` per
  call, the diagonal per solve), and 1-row halos of the projection's
  fields,
* all-reduces of the CG dot products (two per iteration in one), of the
  outer pass's norms, of the CFL speed and of the metrics,
* the migration of the particles that crossed a slab edge.

A frame is the single-device frame (``models/flip.py``) on the slab:

  sort by slab cell (dead slots last) -> P2G (K1 on the (nl + 4, n, n)
  slab, then halo_reduce) -> projection do-while (PCG on the (nl, n, n)
  slab with K3 applies and one K4 launch per preconditioner call, each
  reading its operands' neighbour edge rows in place, or Jacobi) -> G2P
  (K2 on the slab, the alive prefix only) -> CFL dt -> advection with
  bounce -> migration (edge bands with a tail insert, or
  ``migrate_neighbors``)

At world size 1 the frame is the single-device frame's, bit for bit in
its state: the same sums in the same order, the solve's edge planes null,
read as the outside of the box.

Every predicate read on the host (the CG and outer-loop tests, the dt read
for the stencil scale) reads an all-reduced value, the same on every rank,
so no rank leaves a loop while another waits in a collective.

The TPU path's packed solve layout (8-row alignment, lane halos,
``pick_layout``) and its haloed ids are not needed here: the solve's
kernels take the neighbours' edge rows beside the dense (nl, n, n) slab,
and the ids are the slab's plain ``(x*n + y)*n + z``.  The ``upto``
profiling hook has no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from fluidsim_tpu_torch.core.gridspec import (cell_center_velocity_cm,
                                              shift_to_minus, shift_to_plus)
from fluidsim_tpu_torch.core.splines import cround
from fluidsim_tpu_torch.models.flip import (FlipParams, _auto_params,
                                            advect_bounce, auto_pcg_rtol,
                                            require_f32)
from fluidsim_tpu_torch.ops import pressure as pr
from fluidsim_tpu_torch.ops import stencil_kernels as sk
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.pcg import pcg
from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm
from fluidsim_tpu_torch.parallel.halo import (all_reduce, edge_rows,
                                              exchange_halo, halo_reduce,
                                              migrate_edge_bands,
                                              migrate_neighbors, world)
from fluidsim_tpu_torch.scenes import Scene, get_scene
from fluidsim_tpu_torch.seeding import seed_particles
from fluidsim_tpu_torch.utils.profiling import host_wait

W = 2             # transfer halo width (stencil 1 + cell-centre average 1)
SENTINEL = 1.0e6  # parking position of dead particle slots


@dataclasses.dataclass
class ShardedFlipState:
    """One rank's part of the JAX ``ShardedFlipState``: its ``cap`` slots
    and its slab of the pressure; ``dt``, ``t`` and ``frame`` are the same
    on every rank."""
    pos: torch.Tensor        # (cap, 3)
    vel: torch.Tensor        # (cap, 3)
    alive: torch.Tensor      # (cap,) bool
    dt: torch.Tensor         # ()
    t: torch.Tensor          # ()
    frame: torch.Tensor      # () int32
    pressure: torch.Tensor   # (nl, n, n) warm start of the next solve


@dataclasses.dataclass
class Slab:
    """The static geometry of one rank's slab: rank ``rank`` of ``size``
    owns grid rows [x0, x0 + nl) of the (n, n, n) box (the last slab may
    run past n: those rows are open, as in the JAX padding).  ``solid_ext``
    covers the transfer slab [x0 - W, x0 + nl + W), ``solid_loc`` the
    slab itself and ``solid_ext1`` its 1-row halo; rows outside the box
    are not solid."""
    group: Any
    rank: int
    size: int
    bound: int
    n: int
    nl: int
    x0: int
    solid_full: torch.Tensor
    solid_ext: torch.Tensor
    solid_loc: torch.Tensor
    solid_ext1: torch.Tensor

    @property
    def rows(self) -> int:
        return self.nl + 2 * W

    @classmethod
    def build(cls, solid_np: np.ndarray, bound: int, group, device,
              rank: int | None = None, size: int | None = None):
        """The slab of this process in ``group``; ``rank`` and ``size``
        given: that rank's slab geometry, for work on its arrays without
        the group (``chip_smoke.py``'s kernel checks)."""
        if rank is None:
            rank, size = world(group)
        n = 2 * bound + 1
        nl = math.ceil(n / size)
        pad = np.zeros((nl * size + 2 * W, n, n), bool)
        pad[W:W + n] = solid_np
        x0 = rank * nl
        ext = torch.as_tensor(pad[x0:x0 + nl + 2 * W], device=device)
        return cls(group=group, rank=rank, size=size, bound=bound, n=n, nl=nl,
                   x0=x0, solid_full=torch.as_tensor(solid_np, device=device),
                   solid_ext=ext, solid_loc=ext[W:W + nl],
                   solid_ext1=ext[W - 1:W + nl + 1])

    def within_ext(self, wall: int) -> torch.Tensor:
        """(nl + 2W, n, n) bool: the transfer slab's cells within
        ``|c| <= wall`` of the box (global coordinates)."""
        dev = self.solid_ext.device
        gx = torch.arange(self.rows, device=dev) + self.x0 - W - self.bound
        c = torch.arange(-self.bound, self.bound + 1, device=dev)
        ok = c.abs() <= wall
        return ((gx.abs() <= wall)[:, None, None] & ok[None, :, None]
                & ok[None, None, :])

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.group, "sum")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.group, "max")

    def halo(self, t: torch.Tensor, width: int, dim: int = 0):
        return exchange_halo(t, width, self.group, dim)

    def fold(self, t: torch.Tensor, width: int, dim: int = 0):
        return halo_reduce(t, width, self.group, dim)


def sort_slab(slab: Slab, pos, vel, alive, extra=None):
    """Stable sort of a rank's slots by the flat id of their clipped base
    cell on the transfer slab, ``(lx*n + y)*n + z`` with ``lx`` the row in
    [0, nl + 2W); dead slots take the id ``(nl + 2W) n^2`` and sort last,
    so the alive slots are a prefix.  ``extra``: an optional (cap, k)
    payload sorted along.  Returns ``(pos, vel, alive, flat)`` (and the
    sorted ``extra``).  The JAX sort (``lax.sort``, not stable) may order
    the particles of one cell otherwise."""
    b, n = slab.bound, slab.n
    base = cround(pos).to(torch.int32)
    lx = torch.clamp(base[:, 0] + b - slab.x0 + W, 0, slab.rows - 1)
    gy = torch.clamp(base[:, 1] + b, 0, n - 1)
    gz = torch.clamp(base[:, 2] + b, 0, n - 1)
    flat = torch.where(alive, (lx * n + gy) * n + gz, slab.rows * n * n)
    flat_s, perm = torch.sort(flat, stable=True)
    out = (pos[perm], vel[perm], alive[perm], flat_s)
    return out if extra is None else out + (extra[perm],)


def slab_gather(slab: Slab, w27t, flat_s, count, fields_ext, within_ext):
    """The G2P of channel-major cell fields (C <= 3, nl + 2W, n, n) on the
    transfer slab: K2 on the fields masked to ``within_ext`` plus the mask,
    the alive prefix only (``count``), then ``sum w f / sum w`` (0 where
    the sum is 0).  (cap, C)."""
    c = fields_ext.shape[0]
    chans = [torch.where(within_ext, fields_ext[d], 0.0) for d in range(c)]
    chans += [torch.zeros_like(chans[0])] * (3 - c)
    chans.append(within_ext.to(fields_ext.dtype))
    out = tk.g2p_gather(torch.stack(chans), w27t, flat_s, count)
    num, den = out[:c].T, out[3]
    nz = den != 0
    return torch.where(nz[:, None], num / torch.where(nz, den, 1.0)[:, None],
                       0.0)


def owners(slab: Slab, pos) -> torch.Tensor:
    """(cap,) int: the rank whose slab holds each position's rounded x."""
    ox = (cround(pos[:, 0]).to(torch.int32) + slab.bound) // slab.nl
    return torch.clamp(ox, 0, slab.size - 1)


def migrate(slab: Slab, payload, alive, dead_row, cap: int, mig_cap: int,
            tail_insert: bool):
    """Move the alive (cap, D) ``payload`` rows whose owner is a neighbour
    (``payload[:, 0]`` is the x position) to it and take in what the
    neighbours send.  Returns ``(payload, alive, moved, lost)``, ``lost``
    this rank's count of dropped arrivals and senders (a 0-dim tensor, not
    reduced).  Rows that leave become ``dead_row``.

    ``tail_insert``: the sorted-band migration of the JAX kernel path.  The
    step-start sort leaves the alive slots a prefix [0, A0), and the CFL
    bound moves a particle at most one row, so every left sender lies in
    the first F = min(mig_cap, cap) slots and every right sender in the
    last F of the prefix; those bands go to the neighbours with their
    sender masks, and the arrivals land in the dead tail [A0, A0 + 2F) (at
    cap - 2F when A0 is past it, the overwritten rows counted as lost).
    Otherwise ``migrate_neighbors``' fixed-capacity pack, with the arrivals
    in the first free slots (the JAX package's unsorted path)."""
    owner = owners(slab, payload)
    send_left = alive & (owner == slab.rank - 1)
    send_right = alive & (owner == slab.rank + 1)
    moved = send_left | send_right
    dev = payload.device
    if tail_insert:
        f = min(mig_cap, cap)
        a0 = alive.sum()
        band_r = torch.clamp(a0 - f, 0, cap - f) + torch.arange(f, device=dev)
        incoming, valid = migrate_edge_bands(
            payload[:f], send_left[:f], payload[band_r], send_right[band_r],
            slab.group)
        # senders outside their band are dropped: counted exactly here
        lost = (send_left.sum() - send_left[:f].sum()
                + send_right.sum() - send_right[band_r].sum())
        alive = alive & ~moved
        payload = torch.where(alive[:, None], payload, dead_row)
        a0c = torch.clamp(a0, 0, cap - 2 * f)
        tail = a0c + torch.arange(2 * f, device=dev)
        payload[tail] = torch.where(valid[:, None], incoming, dead_row)
        alive[tail] = valid
        lost = lost + (a0 - a0c)
        return payload, alive, moved, lost
    m2 = 2 * mig_cap
    incoming, valid, lost = migrate_neighbors(payload, send_left, send_right,
                                              mig_cap, slab.group)
    alive = alive & ~moved
    payload = torch.where(alive[:, None], payload, dead_row)
    # the valid arrivals first, then the dead slots they go to in order
    rank_in = torch.cumsum(valid.to(torch.int64), 0) - 1
    packed = incoming.new_zeros((m2 + 1, incoming.shape[1]))
    packed[torch.where(valid, rank_in, m2)] = incoming
    valid = torch.arange(m2, device=dev) < valid.sum()
    dead_rank = torch.cumsum((~alive).to(torch.int64), 0) - 1
    slot = torch.where(~alive & (dead_rank < m2), dead_rank, m2)
    free = torch.full((m2 + 1,), cap, dtype=torch.int64, device=dev)
    free[slot] = torch.arange(cap, device=dev)
    free = free[:m2]
    tgt = torch.where(valid & (free < cap), free, cap)
    payload = torch.cat([payload, payload.new_zeros((1, payload.shape[1]))])
    payload[tgt] = packed[:m2]
    alive = torch.cat([alive, alive.new_zeros(1)])
    alive[tgt] = True
    lost = lost + (valid & (free >= cap)).sum()
    return payload[:cap], alive[:cap], moved, lost


def _slab_solve(params: FlipParams, slab: Slab, adiag, scale: float):
    """The per-rank PCG of the projection, with all-reduced dot products.
    Preconditioner: Chebyshev on K4, or Jacobi.

    The CG vectors are the (nl, n, n) slab, so the dot products sum its
    rows once (at world size 1 as the single-device solve does).  K3 and K4
    read their operands' neighbour edge rows where they lie
    (``halo.edge_rows``; None, read as 0, at a domain end and at world size
    1): the diagonal's once per solve, one row for K3 and, inside the
    Chebyshev preconditioner, as deep as its launches' steps (so the
    kernels mask across the slab edges with the true fluid flags); one row
    of ``p`` per K3 apply; the preconditioner's ``r`` once per call (its
    ``z`` and ``d`` too before a second launch, above degree 4).  So a CG
    iteration exchanges twice: ``p``, then ``r``."""
    edges = lambda ts, width: edge_rows(ts, width, slab.group)
    (a_lo, a_hi), = edges([adiag], 1)
    row0 = lambda t: None if t is None else t[0]
    a_planes = (row0(a_lo), row0(a_hi))

    def apply_a(p):
        (p_lo, p_hi), = edges([p], 1)
        return sk.apply_laplacian(p, adiag, scale,
                                  ghost=(row0(p_lo), row0(p_hi), *a_planes))

    if params.preconditioner == "chebyshev":
        precond = sk.chebyshev_precond_fused(
            adiag, scale, degree=params.cheb_degree, ratio=params.cheb_ratio,
            edges=edges)
    else:
        fluid = adiag > 0
        safe = torch.where(fluid, adiag, 1.0)
        precond = lambda r: torch.where(fluid, r / safe, 0.0)

    def solve(b, x0):
        res = pcg(apply_a, b, x0=x0, precond=precond,
                  rtol=params.pcg_rtol or auto_pcg_rtol(slab.n),
                  maxiter=params.pcg_maxiter, reduce_fn=slab.psum)
        return res.x, res.iters

    return solve


def _project(params: FlipParams, slab: Slab, velg, fluid, dt, p_prev):
    """The reference's projection do-while on the slab (the JAX sharded
    step's ``one_pass`` loop): each pass solves from the previous pass's
    pressure and measures the relative divergence change with all-reduced
    norms.  Returns (velg, err, n_outer, cg_iters, pressure)."""
    g = params.gravity
    dx, rho = params.dx, params.rho
    solid1 = slab.solid_ext1
    adiag_scale = dt / (rho * dx * dx)
    ns = (~solid1).to(velg.dtype)
    count = torch.zeros_like(ns)
    for d in range(3):
        count = count + shift_to_plus(ns, d) + shift_to_minus(ns, d)
    adiag = torch.where(fluid, adiag_scale * count[1:-1], 0.0)
    # dt is the all-reduced CFL step, the same on every rank
    solve = _slab_solve(params, slab, adiag, float(adiag_scale))
    fluid_ext = slab.halo(fluid, 1)

    def divergence(vg_ext):
        rhs = pr.set_rhs(vg_ext, fluid_ext, solid1, g, dt, dx)[1:-1]
        return pr.divergence_rhs(vg_ext, slab.halo(rhs, 1), fluid_ext, solid1,
                                 dx)[1:-1]

    def one_pass(vg, px0):
        vg_ext = slab.halo(vg, 1, dim=1)
        b = divergence(vg_ext)
        x, iters = solve(b, px0)
        p_ext = slab.halo(torch.where(fluid, x, 0.0), 1)
        vg2 = pr.vel_update(vg_ext, p_ext, fluid_ext, solid1, g, dt, rho,
                            dx)[:, 1:-1]
        b2 = divergence(slab.halo(vg2, 1, dim=1))
        diff = b - b2
        sums = slab.psum(torch.stack([torch.sum((b * b).to(torch.float32)),
                                      torch.sum((diff * diff).to(torch.float32))]))
        bn, dn = torch.sqrt(sums[0]), torch.sqrt(sums[1])
        err = torch.where(bn > 0, dn / torch.where(bn > 0, bn, 1.0), 0.0)
        return vg2, err, iters, x

    velg, err, cg_tot, p = one_pass(velg, p_prev)
    n_outer = 1
    while n_outer < params.max_outer and bool(err > params.outer_tol):
        velg, err, iters, p = one_pass(velg, p)
        n_outer += 1
        cg_tot += iters
    return velg, err, n_outer, cg_tot, p


def sharded_flip_step(params: FlipParams, slab: Slab, cap: int, mig_cap: int,
                      tail_insert: bool, within_ext, state: ShardedFlipState):
    """One frame on this rank's slab (every rank of the group calls it);
    returns (new_state, metrics).  The metrics are the JAX step's, reduced
    over the ranks, except ``occupancy`` (this slab's (nl, n, n) weights);
    ``outer_iters`` and ``cg_iters`` are Python ints."""
    b, n = params.bound, slab.n
    dt = state.dt
    dev = state.pos.device
    pos, vel, alive, flat = sort_slab(slab, state.pos, state.vel, state.alive)

    # P2G on the transfer slab: K1 over the alive prefix, halos folded back
    w27t = tk.masked_weights_cm(pos, b, params.kernel)
    cell_start = tk.cell_starts(flat, n, slab.rows)
    count = cell_start[-1:]                  # the alive prefix, on the device
    acc = slab.fold(tk.p2g_scatter(w27t, vel, cell_start, n), W, dim=1)
    ns = ~slab.solid_loc
    # with the walls-only geometry the within-(B-2) and occupancy masks of
    # the single-device P2G both reduce to ~solid, as in the JAX slab step
    weights = torch.where(ns, acc[0], 0.0)
    velg = normalize_velocity_cm(weights, torch.where(ns[None], acc[1:4], 0.0))
    fluid = (weights > 0) & ns
    velb = velg

    p_prev = torch.where(fluid, state.pressure, 0.0)
    velg, err, n_outer, cg_iters, pressure = _project(params, slab, velg,
                                                      fluid, dt, p_prev)

    # G2P of the change of the cell-centred velocity (in both modes, as the
    # JAX sharded step: "pic" differs only in the bounce).  Each field is
    # centred on its 2-row halo, as the single-device frame and the JAX
    # sharded MPM do; the JAX sharded FLIP centres the difference once,
    # which moves the last bits
    dvc = (cell_center_velocity_cm(slab.halo(velg, W, dim=1))
           - cell_center_velocity_cm(slab.halo(velb, W, dim=1)))
    delta = slab_gather(slab, w27t, flat, count, dvc, within_ext)
    vel = torch.where(alive[:, None], vel + delta, 0.0)

    speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
    max_speed = slab.pmax(torch.max(torch.where(alive, speed, 0.0)))
    max_dt = torch.tensor(params.max_dt, dtype=vel.dtype, device=dev)
    dt_new = torch.where(max_speed != 0,
                         torch.minimum(max_dt, params.dx / max_speed), max_dt)

    e = 0.0 if params.mode == "flip" else 0.5
    pos_new, vel_new = advect_bounce(
        pos, vel, dt_new, slab.solid_full, b, e, rounding="round",
        analytic_wall=params.wall if params.walls_only_solid else None)
    pos = torch.where(alive[:, None], pos_new, SENTINEL)
    vel = torch.where(alive[:, None], vel_new, 0.0)

    dead_row = torch.tensor([SENTINEL] * 3 + [0.0] * 3, dtype=pos.dtype,
                            device=dev)
    payload, alive, moved, lost = migrate(
        slab, torch.cat([pos, vel], dim=-1), alive, dead_row, cap, mig_cap,
        tail_insert)
    pos, vel = payload[:, 0:3].contiguous(), payload[:, 3:6].contiguous()

    ke = slab.psum(0.5 * torch.sum((vel * vel).to(torch.float32)))
    counts = slab.psum(torch.stack([fluid.sum(), alive.sum(), moved.sum(),
                                    lost.to(torch.int64)]))
    new_state = ShardedFlipState(pos=pos, vel=vel, alive=alive, dt=dt_new,
                                 t=state.t + dt_new, frame=state.frame + 1,
                                 pressure=pressure)
    metrics = {
        "error": err,
        "dt": dt_new,
        "dt_used": dt,
        "outer_iters": n_outer,
        "cg_iters": cg_iters,
        "max_speed": max_speed,
        "kinetic_energy": ke,
        "num_fluid_cells": counts[0],
        "num_alive": counts[1],
        "migrated": counts[2],
        "lost": counts[3],
        "occupancy": weights,
    }
    return new_state, metrics


class LostParticleMonitor:
    """Surfaces the silent failure of fixed-capacity migration: the edge
    bands can drop migrants and a full tail can overwrite rows, which only
    raise the frame's ``lost`` metric.  ``step()`` checks the previous
    frame's count first (so its read waits on nothing new) and warns when
    it is positive, or raises with ``FLUIDSIM_STRICT_MIGRATION=1``;
    ``lost_total`` sums them.  As the JAX package's monitor."""

    def _init_lost_monitor(self):
        self._pending_lost = None
        self.lost_total = 0

    def _note_lost(self, metrics):
        prev, self._pending_lost = self._pending_lost, metrics.get("lost")
        if prev is None:
            return
        lost = host_wait("migrate.lost", int, prev)
        if lost > 0:
            self.lost_total += lost
            msg = (f"{type(self).__name__}: migration dropped {lost} "
                   f"particle(s) this step ({self.lost_total} total): "
                   "slab-boundary band overflow or shard capacity exhausted; "
                   "raise mig_frac / cap_factor")
            if os.environ.get("FLUIDSIM_STRICT_MIGRATION"):
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)

    def _flush_lost(self):
        """Check the last pending count (end of a run)."""
        if self._pending_lost is not None:
            self._note_lost({"lost": None})
            self._pending_lost = None


def resolve_device(device, group) -> torch.device:
    """The sim's device: "cuda" without an index is the current CUDA device
    (which a launcher sets from ``LOCAL_RANK``).  The group's backend must
    carry that device's tensors: NCCL for CUDA, gloo for the CPU; there is
    no staging of CUDA tensors through the host."""
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        backend = str(dist.get_backend(group)).lower()
        want = "nccl" if device.type == "cuda" else "gloo"
        if want not in backend:
            raise ValueError(f"a sim on {device} needs a {want} process "
                             f"group; this one is {backend}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed_owners(pos: np.ndarray, bound: int, nl: int, size: int) -> np.ndarray:
    """Each seeded particle's rank (numpy, as the JAX sims assign them)."""
    xcell = (np.floor(np.abs(pos[:, 0]) + 0.5) * np.sign(pos[:, 0])
             + bound).astype(int)
    return np.clip(xcell // nl, 0, size - 1)


class ShardedFlipSim(LostParticleMonitor):
    """The slab-sharded FLIP simulation: every rank of ``group`` (None: the
    default group, or this process alone without ``torch.distributed``)
    builds one with the same arguments.  Each seeds the whole scene in
    numpy, keeps the particles of its slab and sizes ``cap``, ``mig_cap``
    and ``tail_insert`` as the JAX sim does.  ``device`` is "cuda" (the
    current device) unless the caller asks for the CPU; the group's
    backend must match it (``resolve_device``).

    ``params.mode`` is "flip" or "pic" (which, as in the JAX sharded step,
    differs from "flip" only in the bounce's restitution), the
    preconditioner "chebyshev" or "jacobi", and ``params.kernel`` the
    transfer spline of the slab's P2G (K1) and delta gather (K2), "flip"
    or "mpm", as in ``FlipSim``.  The JAX schedule fields
    (``pallas_transfer``, ``pallas_interpret``, ``fast_transfer``) are
    accepted and change nothing; of the JAX sharded step's paths only its
    XLA one (``fast_transfer=False``) honours ``kernel``."""

    def __init__(self, scene: Scene | str = "water_cube_drop",
                 params: FlipParams | None = None, group=None, seed: int = 0,
                 cap_factor: float = 1.6, mig_frac: float | None = None, *,
                 device="cuda", dtype=torch.float32, seeder=seed_particles,
                 **scene_kwargs):
        require_f32(dtype)
        if isinstance(scene, str):
            scene = get_scene(scene, **scene_kwargs)
        params = _auto_params(scene, params)
        if params.mode not in ("flip", "pic"):
            raise ValueError(f"mode {params.mode!r}: the sharded FLIP runs "
                             "'flip' and 'pic'")
        if params.preconditioner not in ("chebyshev", "jacobi"):
            raise ValueError(f"preconditioner {params.preconditioner!r}: the "
                             "sharded solve takes 'chebyshev' or 'jacobi'")
        if params.sort_method != "full":
            raise ValueError(f"sort_method {params.sort_method!r}: the "
                             "sharded FLIP sorts fully")
        device = resolve_device(device, group)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.scene, self.params, self.group, self.device = (scene, params,
                                                            group, device)
        solid_np = np.asarray(scene.solid)
        self.slab = Slab.build(solid_np, params.bound, group, device)
        size, nl, n = self.slab.size, self.slab.nl, self.slab.n
        self.nl = nl

        pos, vel = seeder(scene, seed=seed, dtype="float32")
        owner = seed_owners(pos, scene.spec.bound, nl, size)
        counts = np.bincount(owner, minlength=size)
        self.cap = int(math.ceil(counts.max() * cap_factor / 8) * 8)
        # the CFL bound moves a particle at most one cell a frame, so only a
        # slab's edge rows migrate: 4x their uniform-density population
        if mig_frac is None:
            self.mig_cap = max(64, min(self.cap, 8 * (self.cap // max(nl, 1))))
        else:
            self.mig_cap = max(64, int(self.cap * mig_frac))
        self.tail_insert = (2 * min(self.mig_cap, self.cap)
                            <= self.cap - int(counts.max() * 1.15))

        mine = owner == self.slab.rank
        k = int(mine.sum())
        f32 = dict(dtype=torch.float32, device=device)
        pos_l = torch.full((self.cap, 3), SENTINEL, **f32)
        vel_l = torch.zeros((self.cap, 3), **f32)
        alive = torch.zeros((self.cap,), dtype=torch.bool, device=device)
        pos_l[:k] = torch.as_tensor(pos[mine], **f32)
        vel_l[:k] = torch.as_tensor(vel[mine], **f32)
        alive[:k] = True
        self.state = ShardedFlipState(
            pos=pos_l, vel=vel_l, alive=alive,
            dt=torch.tensor(params.max_dt, **f32), t=torch.zeros((), **f32),
            frame=torch.zeros((), dtype=torch.int32, device=device),
            pressure=torch.zeros((nl, n, n), **f32))
        self.within_ext = self.slab.within_ext(params.wall)
        self._init_lost_monitor()

    @property
    def num_particles(self) -> int:
        """Alive particles over all ranks (an all-reduce: every rank calls
        it together)."""
        return int(self.slab.psum(self.state.alive.sum()))

    def step(self) -> Dict[str, Any]:
        self.state, metrics = sharded_flip_step(
            self.params, self.slab, self.cap, self.mig_cap, self.tail_insert,
            self.within_ext, self.state)
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
