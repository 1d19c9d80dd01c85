"""The sharded FLIP at the flagship shape — the port's counterpart of
``scripts/validate_config5.py``: ``ShardedFlipSim`` on ``water_cube_drop``
at 257^3, density 16 (9,826,000 particles; ``FlipParams(bound=128,
wall=126)``) beside ``FlipSim`` on the same device.

    python -m fluidsim_tpu_torch.validation.validate_config5 [--frames 3]
    torchrun --nproc-per-node=4 -m \\
        fluidsim_tpu_torch.validation.validate_config5
    python -m fluidsim_tpu_torch.validation.validate_config5 --device cpu \\
        --bound 10 --density 2

Without a launcher the command runs at world size 1 (a process group of
this process alone: NCCL on the card, gloo on the CPU), held frame by
frame to ``FlipSim``: kinetic energy within rtol 1e-4, the same outer
passes, CG iterations and fluid cells, no particle lost, and after the
frames the state bit for bit ``FlipSim``'s.  Under a launcher every rank
runs its slab and rank 0 steps ``FlipSim``; the frames are held with the
four-card tolerances of ``parallel/dryrun.py`` (kinetic energy within
rtol 1e-4, the same outer passes, CG within one per outer pass, fluid
cells apart only where |occupancy| < ``NOISE_OCCUPANCY`` in both), no
particle lost.  Rank 0 prints the figures; every rank exits nonzero when
a check fails.  Nothing is appended to ``docs/``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from fluidsim_tpu_torch.models.flip import FlipParams, FlipSim
from fluidsim_tpu_torch.parallel import dryrun, halo
from fluidsim_tpu_torch.parallel.flip_sharded import ShardedFlipSim
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.seeding import seed_particles
from fluidsim_tpu_torch.validation import traces

FRAMES, BOUND, DENSITY = 3, 128, 16.0
KEYS = ("kinetic_energy", "outer_iters", "cg_iters", "num_fluid_cells")


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _step(sim, frames: int, keys, device, occupancy: bool):
    """Step ``frames`` frames.  Returns (per frame its ``keys`` as Python
    numbers, per frame its occupancy grid when ``occupancy``, per frame its
    host-clock seconds, the last frame's metrics)."""
    rows, occ, secs, m = [], [], [], None
    for _ in range(frames):
        t0 = time.perf_counter()
        m = sim.step()
        traces.sync(device)
        secs.append(time.perf_counter() - t0)
        rows.append({k: (m[k].item() if isinstance(m[k], torch.Tensor)
                         else m[k]) for k in keys})
        if occupancy:
            occ.append(m["occupancy"])
    return rows, occ, secs, m


def beside(name: str, scene, make_single, make_sharded, frames: int, device,
           keys, frame_fails, particle_fields, grid_fields=(),
           keep: bool = False):
    """The frames of a sharded sim beside its single-device sim of
    ``scene`` (stepped first, on rank 0), from one seeding; the checks
    every rank makes (no particle lost) and, at world size 1, the state bit
    for bit the single sim's in ``particle_fields`` (the alive prefix) and
    ``grid_fields``.  ``frame_fails(f, sharded_row, single_row, world, sim,
    occupancies)`` lists a frame's failed checks on rank 0.  Returns (the
    figures, and with ``keep`` the single sim and its last frame's
    metrics, else None and None)."""
    rank, world = halo.world()
    t0 = time.perf_counter()
    pos, vel = seed_particles(scene, seed=0, dtype="float32")
    seeder = traces.fixed_seeder(pos, vel)
    out = {"run": name, "device": str(torch.device(device)), "world": world,
           "grid": 2 * scene.spec.bound + 1, "frames": frames,
           "seed_secs": time.perf_counter() - t0}
    del pos, vel
    fails = []
    single = last = None
    ref, ref_occ = [], []
    if rank == 0:
        t0 = time.perf_counter()
        single = make_single(seeder)
        out["single_init_secs"] = time.perf_counter() - t0
        out["particles"] = single.num_particles
        ref, ref_occ, out["single_frame_secs"], last = _step(
            single, frames, keys, device, world > 1)
    t0 = time.perf_counter()
    sim = make_sharded(seeder)
    out["sharded_init_secs"] = time.perf_counter() - t0
    total = sim.num_particles
    out.update(particles_sharded=total, cap=sim.cap, mig_cap=sim.mig_cap,
               tail_insert=sim.tail_insert, slab_rows=sim.slab.rows)
    got, occ, out["sharded_frame_secs"], _ = _step(
        sim, frames, keys + ("lost", "num_alive", "migrated"), device,
        world > 1)
    for f, row in enumerate(got):
        if int(row["lost"]) != 0 or int(row["num_alive"]) != total:
            fails.append(f"frame {f}: rank {rank} lost particles")
        both = None
        if world > 1:
            parts = [torch.zeros_like(occ[f]) for _ in range(world)]
            dist.all_gather(parts, occ[f].contiguous())
            both = (torch.cat(parts)[:sim.slab.n], ref_occ[f] if ref_occ
                    else None)
        if rank == 0:
            fails += frame_fails(f, row, ref[f], world, sim, both)
    del occ, ref_occ
    if rank == 0:
        for k in keys:
            out[f"{k}_single"] = [r[k] for r in ref]
            out[f"{k}_sharded"] = [r[k] for r in got]
        out["ke_rel"] = traces.rel_err(out["kinetic_energy_sharded"],
                                       out["kinetic_energy_single"]).tolist()
        out["migrated"] = [int(r["migrated"]) for r in got]
        if total != out["particles"]:
            fails.append(f"{total} particles, the single sim "
                         f"{out['particles']}")
    if world == 1:
        same = {f: _bitwise(getattr(sim.state, f)[:total],
                            getattr(single.state, f))
                for f in particle_fields}
        same.update({f: _bitwise(getattr(sim.state, f),
                                 getattr(single.state, f))
                     for f in grid_fields})
        out["state_bitwise"] = same
        fails += [f"{f} after {frames} frames differs from the single sim's"
                  for f, ok in same.items() if not ok]
    out["max_memory_bytes"] = traces.peak_memory(device)
    del sim
    if world > 1:
        flag = torch.tensor([len(fails)], device=device)
        dist.all_reduce(flag)
        if int(flag) and not fails:
            fails.append("a check failed on another rank")
    out["failures"] = fails
    out["pass"] = not fails
    return (out, single, last) if keep else (out, None, None)


def _flip_frame_fails(f, got, ref, world, sim, occupancies) -> list[str]:
    ke, ke_s = got["kinetic_energy"], ref["kinetic_energy"]
    fails = []
    if abs(ke - ke_s) > 1e-4 * abs(ke_s):
        fails.append(f"frame {f}: kinetic energy {ke} against {ke_s}")
    if got["outer_iters"] != ref["outer_iters"]:
        fails.append(f"frame {f}: outer passes {got['outer_iters']} "
                     f"against {ref['outer_iters']}")
    if world == 1:
        if (got["cg_iters"] != ref["cg_iters"]
                or got["num_fluid_cells"] != ref["num_fluid_cells"]):
            fails.append(f"frame {f}: CG {got['cg_iters']} fluid "
                         f"{got['num_fluid_cells']} against "
                         f"{ref['cg_iters']}, {ref['num_fluid_cells']}")
        return fails
    if abs(got["cg_iters"] - ref["cg_iters"]) > got["outer_iters"]:
        fails.append(f"frame {f}: CG {got['cg_iters']} against "
                     f"{ref['cg_iters']}")
    occ_s, occ_r = occupancies
    apart = (occ_s > 0) != ((occ_r > 0) & ~sim.slab.solid_full)
    loud = apart & ((occ_s.abs() >= dryrun.NOISE_OCCUPANCY)
                    | (occ_r.abs() >= dryrun.NOISE_OCCUPANCY))
    if bool(loud.any()):
        fails.append(f"frame {f}: {int(loud.sum())} fluid cells apart with "
                     f"|occupancy| >= {dryrun.NOISE_OCCUPANCY}")
    return fails


def run(bound: int = BOUND, density: float = DENSITY, frames: int = FRAMES,
        device="cuda", keep: bool = False):
    """The sharded FLIP beside ``FlipSim`` in the current process group
    (none: world size 1).  Returns ``beside``'s (figures, ``FlipSim``, its
    last metrics)."""
    scene = get_scene("water_cube_drop", bound=bound, density=density)
    params = FlipParams(bound=bound, wall=bound - 2, dx=scene.spec.dx,
                        gravity=tuple(scene.gravity))
    return beside(
        "validate_config5", scene,
        lambda seeder: FlipSim(scene, params=params, seeder=seeder,
                               device=device),
        lambda seeder: ShardedFlipSim(scene, params=params, seeder=seeder,
                                      device=device),
        frames, device, KEYS, _flip_frame_fails, ("pos", "vel"),
        ("pressure",), keep)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bound", type=int, default=BOUND)
    ap.add_argument("--density", type=float, default=DENSITY)
    ap.add_argument("--frames", type=int, default=FRAMES)
    a = traces.common_args(ap).parse_args(argv)
    with dryrun.process_group(a.device) as (rank, _):
        figs, _, _ = run(a.bound, a.density, a.frames, a.device)
        if rank == 0:
            return traces.report(figs, a.out)
        return 0 if figs["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
