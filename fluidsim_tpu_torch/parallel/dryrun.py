"""Multi-rank dry run of the sharded sims, and the process plumbing that the
tests share — the counterpart of ``__graft_entry__.py:dryrun_multichip``.

    python -m fluidsim_tpu_torch.parallel.dryrun --world 4 --device cpu
    torchrun --nproc-per-node=1 -m fluidsim_tpu_torch.parallel.dryrun

The first spawns ``--world`` gloo ranks on the CPU; the second runs as
one of the ranks a launcher started (``RANK``, ``WORLD_SIZE`` and
``MASTER_ADDR`` in the environment; NCCL with the device from
``LOCAL_RANK`` on the card).  Either way every rank runs

* the sharded FLIP on ``water_cube_drop`` at bound 10, density 2, for 3
  frames against ``FlipSim`` (rank 0 steps it): kinetic energy within rtol
  2e-3, the same number of fluid cells, no particle lost;
* the sharded MPM on ``mpm_cone`` for 2 frames against ``MpmSim``: kinetic
  energy within rtol 2e-3, no particle lost,

and rank 0 prints ``dryrun OK`` when they hold.  With ``--full`` the ranks
run the chip_smoke.py phases 32 and 33 at their sizes instead
(``full_rank``): the sharded FLIP on ``water_cube_drop`` at 129^3
(1,987,675 particles), 2 warm-up and 10 timed frames, and the sharded MPM
on ``mpm_cone`` at 127^3 (473,798 particles), 2 warm-up and 6 timed
frames, against ``FlipSim`` and ``MpmSim`` stepped by rank 0:

    torchrun --nproc-per-node=4 -m fluidsim_tpu_torch.parallel.dryrun --full

Rank 0 prints each frame, the ms/frame of both (the host clock, the
devices synchronised) and every rank's kernel launches in the timed
frames.

Every process group is made with a ``timeout``, so a collective that one
rank never joins fails instead of hanging.  The rank functions live here:
children of ``torch.multiprocessing.spawn`` import this module by name,
and it imports only torch, numpy and the port.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fluidsim_tpu_torch.utils import card_inputs as ci

TIMEOUT_S = 300          # default limit of one collective, and of a run


def init_rank(rank: int, world: int, store: str, device: str,
              timeout_s: float = TIMEOUT_S) -> str:
    """Join the process group of ``world`` ranks at ``store`` (a
    ``file://`` or ``tcp://`` init method) as ``rank``: NCCL for a CUDA
    ``device`` (the current device set from ``rank``), gloo for the CPU,
    with every collective limited to ``timeout_s``.  Pins torch to one
    thread on the CPU.  Returns the device the rank runs on."""
    if device.startswith("cuda"):
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(backend, init_method=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def _rank_main(rank: int, fn, world: int, store: str, device: str,
               timeout_s: float, args: tuple):
    init_rank(rank, world, store, device, timeout_s)
    try:
        fn(rank, world, device, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, device: str = "cuda", args: tuple = (),
              timeout_s: float = TIMEOUT_S):
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned
    processes joined in one process group (a ``file://`` store in a
    temporary directory), on the card unless ``device`` is ``"cpu"``
    (gloo there, NCCL on the card).  ``fn`` must be a module-level
    function of a module the children can import without the caller's.
    Raises if a rank fails or the run takes longer than ``timeout_s``;
    every child is gone when it returns."""
    with tempfile.TemporaryDirectory(prefix="fluidsim_ranks_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        ctx = mp.spawn(_rank_main, args=(fn, world, store, device, timeout_s,
                                         args),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join()


def launched() -> bool:
    """Whether a launcher started this process as one of its ranks."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


@contextlib.contextmanager
def process_group(device: str | torch.device,
                  timeout_s: float = TIMEOUT_S):
    """The process group a command runs in, destroyed on leaving: the
    launcher's (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` in the
    environment, as ``torchrun`` sets them; the GPU from ``LOCAL_RANK``;
    one torch thread a rank on the CPU), or without one a group of this
    process alone on a ``file://`` store in a temporary directory.  NCCL
    on the card, gloo on the CPU; every collective limited to
    ``timeout_s``.  ``device`` is a name or a ``torch.device``.  Yields
    (rank, world size)."""
    cuda = torch.device(device).type == "cuda"
    timeout = datetime.timedelta(seconds=timeout_s)
    with tempfile.TemporaryDirectory(prefix="fluidsim_group_") as tmp:
        if launched():
            rank, world = (int(os.environ["RANK"]),
                           int(os.environ["WORLD_SIZE"]))
            init = "env://"
            if cuda:
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            else:
                torch.set_num_threads(1)
        else:
            rank, world = 0, 1
            init = "file://" + os.path.join(tmp, "store")
        dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                                rank=rank, world_size=world, timeout=timeout)
        try:
            yield rank, world
        finally:
            dist.destroy_process_group()


def _check(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def dryrun_rank(rank: int, world: int, device: str):
    """The dry run's checks on one rank (see the module docstring)."""
    from fluidsim_tpu_torch import FlipSim, MpmSim, get_scene
    from fluidsim_tpu_torch.parallel.flip_sharded import ShardedFlipSim
    from fluidsim_tpu_torch.parallel.mpm_sharded import ShardedMpmSim

    scene = get_scene("water_cube_drop", bound=10, density=2.0)
    ref = []
    if rank == 0:
        single = FlipSim(scene, device=device)
        ref = [single.step() for _ in range(3)]
    sim = ShardedFlipSim(scene, device=device)
    total = sim.num_particles
    for f in range(3):
        m = sim.step()
        ke = float(m["kinetic_energy"])
        _check(np.isfinite(ke), "sharded FLIP: non-finite energy")
        _check(int(m["lost"]) == 0, "sharded FLIP: particles lost")
        _check(int(m["num_alive"]) == total, "sharded FLIP: particles lost")
        if rank == 0:
            ke_s = float(ref[f]["kinetic_energy"])
            _check(abs(ke - ke_s) <= 2e-3 * abs(ke_s),
                   f"sharded FLIP frame {f}: ke {ke} against {ke_s}")
            _check(int(m["num_fluid_cells"]) == int(ref[f]["num_fluid_cells"]),
                   f"sharded FLIP frame {f}: fluid cells differ")
            print(f"flip frame {f}: ke {ke:.7g} (single {ke_s:.7g}), cg "
                  f"{m['cg_iters']} ({ref[f]['cg_iters']}), migrated "
                  f"{int(m['migrated'])}", flush=True)

    mref = []
    if rank == 0:
        msingle = MpmSim("mpm_cone", device=device)
        mref = [msingle.step() for _ in range(2)]
    msim = ShardedMpmSim(get_scene("mpm_cone"), device=device)
    for f in range(2):
        m = msim.step()
        ke = float(m["kinetic_energy"])
        _check(np.isfinite(ke), "sharded MPM: non-finite energy")
        _check(int(m["lost"]) == 0, "sharded MPM: particles lost")
        if rank == 0:
            ke_s = float(mref[f]["kinetic_energy"])
            _check(abs(ke - ke_s) <= 2e-3 * abs(ke_s),
                   f"sharded MPM frame {f}: ke {ke} against {ke_s}")
            print(f"mpm frame {f}: ke {ke:.7g} (single {ke_s:.7g}), cg "
                  f"{m['cg_iters']} ({mref[f]['cg_iters']})", flush=True)


# chip_smoke.py's sizes
FULL_FLIP = dict(bound=ci.FLIP_BOUND, density=ci.FLIP_DENSITY)
FULL_MPM = dict(bound=ci.MPM_BOUND)
NOISE_OCCUPANCY = 1e-6


def _sync(device: str):
    """Every rank here and its device idle: a collective, then a wait."""
    dist.all_reduce(torch.zeros(1, device=device))
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _counted():
    from fluidsim_tpu_torch.ops import stencil_kernels as sk
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    return (tk.p2g_scatter, tk.chunk_fill, tk.g2p_gather, sk.apply_laplacian,
            sk.cheb_steps, tk.p2g_scatter_force, tk.g2p_gather_gw)


def _timed_frames(sim, warm: int, frames: int, device: str):
    """``warm`` frames, then ``frames`` timed ones; returns (metrics of
    all, ms per timed frame, this rank's launches in the timed frames)."""
    got = [sim.step() for _ in range(warm)]
    counted = _counted()
    for fn in counted:
        fn.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    got += [sim.step() for _ in range(frames)]
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / frames
    return got, ms, {fn.__name__: fn.launches for fn in counted}


def _all_launches(launches: dict, world: int, device: str):
    """Every rank's launches, by rank (on every rank)."""
    mine = torch.tensor(list(launches.values()), dtype=torch.int64,
                        device=device)
    every = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    return [dict(zip(launches, t.tolist())) for t in every]


def full_rank(rank: int, world: int, device: str, flip_kw: dict = FULL_FLIP,
              mpm_kw: dict = FULL_MPM, warm: int = 2, frames: int = 10,
              mpm_frames: int = 6):
    """The sharded FLIP and MPM of ``--full`` on one rank (see the module
    docstring), held per frame against the single-device sims on rank 0:
    FLIP kinetic energy within rtol 1e-4, the same outer passes, CG
    iterations within one per outer pass (the dot products sum the ranks'
    parts in another order), the same particles, and fluid cells apart
    only where |occupancy| < ``NOISE_OCCUPANCY`` in both (the spline's
    rounding noise near the edge of its support, whose sign moves with the
    positions' last bits: ``ROADMAP.md``, near-zero occupancy); MPM
    kinetic energy within rtol 1e-4, CG iterations within one per solve,
    det FP > 0; neither loses a particle.  Every frame is held and
    printed before the first failure raises."""
    from fluidsim_tpu_torch import FlipSim, MpmSim, get_scene
    from fluidsim_tpu_torch.parallel.flip_sharded import ShardedFlipSim
    from fluidsim_tpu_torch.parallel.mpm_sharded import ShardedMpmSim

    fails = []

    def check(ok: bool, msg: str):
        if not ok:
            fails.append(msg)
            print(f"rank {rank}: FAILED {msg}", flush=True)

    scene = get_scene("water_cube_drop", **flip_kw)
    ref, ref_ms, ref_total = [], 0.0, None
    if rank == 0:
        single = FlipSim(scene, seed=0, device=device)
        ref_total = single.num_particles
        ref = [single.step() for _ in range(warm)]
        _sync_local(device)
        t0 = time.perf_counter()
        ref += [single.step() for _ in range(frames)]
        _sync_local(device)
        ref_ms = 1e3 * (time.perf_counter() - t0) / frames
        del single
    sim = ShardedFlipSim(scene, seed=0, device=device)
    total = sim.num_particles
    check(rank != 0 or total == ref_total,
          f"sharded FLIP: {total} particles, FlipSim {ref_total}")
    got, ms, launches = _timed_frames(sim, warm, frames, device)
    every = _all_launches(launches, world, device)
    n = sim.slab.n
    for f, m in enumerate(got):
        check(int(m["lost"]) == 0 and int(m["num_alive"]) == total,
              f"sharded FLIP frame {f}: particles lost")
        parts = [torch.zeros_like(m["occupancy"]) for _ in range(world)]
        dist.all_gather(parts, m["occupancy"].contiguous())
        if rank == 0:
            r = ref[f]
            ke, ke_s = float(m["kinetic_energy"]), float(r["kinetic_energy"])
            occ_s, occ_r = torch.cat(parts)[:n], r["occupancy"]
            apart = (occ_s > 0) != ((occ_r > 0) & ~sim.slab.solid_full)
            loud = apart & ((occ_s.abs() >= NOISE_OCCUPANCY)
                            | (occ_r.abs() >= NOISE_OCCUPANCY))
            print(f"flip frame {f}: ke {ke:.7g} (single {ke_s:.7g}) outer "
                  f"{m['outer_iters']} ({r['outer_iters']}) cg "
                  f"{m['cg_iters']} ({r['cg_iters']}) fluid "
                  f"{int(m['num_fluid_cells'])} "
                  f"({int(r['num_fluid_cells'])}), {int(apart.sum())} apart, "
                  f"{int(loud.sum())} of them with |occupancy| >= "
                  f"{NOISE_OCCUPANCY}, migrated {int(m['migrated'])}",
                  flush=True)
            check(abs(ke - ke_s) <= 1e-4 * abs(ke_s)
                  and m["outer_iters"] == r["outer_iters"]
                  and abs(m["cg_iters"] - r["cg_iters"]) <= m["outer_iters"]
                  and not bool(loud.any()),
                  f"sharded FLIP frame {f}: differs from FlipSim")
    if rank == 0:
        timed = got[warm:]
        print(f"flip: {world} ranks, slab {sim.slab.rows} rows, cap "
              f"{sim.cap}, tail_insert {sim.tail_insert}, {total} particles;"
              f" ms/frame {ms:.3f} against FlipSim's {ref_ms:.3f} on rank "
              f"0's device; CG iterations/frame "
              f"{sum(m['cg_iters'] for m in timed) / frames:.1f} ({frames} "
              "frames, host clock, synchronised)", flush=True)
        for r, counts in enumerate(every):
            print(f"flip: rank {r} launches in the timed frames: "
                  f"{json.dumps(counts)}", flush=True)
    del sim, got, ref

    cone = get_scene("mpm_cone", **mpm_kw)
    mref, mref_ms, ref_total = [], 0.0, None
    if rank == 0:
        msingle = MpmSim(cone, seed=0, device=device)
        ref_total = msingle.num_particles
        mref = [msingle.step() for _ in range(warm)]
        _sync_local(device)
        t0 = time.perf_counter()
        mref += [msingle.step() for _ in range(mpm_frames)]
        _sync_local(device)
        mref_ms = 1e3 * (time.perf_counter() - t0) / mpm_frames
        del msingle
    msim = ShardedMpmSim(cone, seed=0, device=device)
    total = msim.num_particles
    check(rank != 0 or total == ref_total,
          f"sharded MPM: {total} particles, MpmSim {ref_total}")
    got, ms, launches = _timed_frames(msim, warm, mpm_frames, device)
    every = _all_launches(launches, world, device)
    params = msim.params
    for f, m in enumerate(got):
        check(int(m["lost"]) == 0 and int(m["num_alive"]) == total,
              f"sharded MPM frame {f}: particles lost")
        check(float(m["min_det_fp"]) > 0, f"sharded MPM frame {f}: det FP")
        if rank == 0:
            r = mref[f]
            ke, ke_s = float(m["kinetic_energy"]), float(r["kinetic_energy"])
            hybrid = params.hessian == "hybrid"
            solves = (1 if hybrid and m["spd_fallback"] == 0
                      else 1 + int(m["spd_fallback"]))
            print(f"mpm frame {f}: ke {ke:.7g} (single {ke_s:.7g}) cg "
                  f"{m['cg_iters']} ({r['cg_iters']}) spd "
                  f"{m['spd_fallback']} min det FP "
                  f"{float(m['min_det_fp']):.6g} migrated "
                  f"{int(m['migrated'])}", flush=True)
            check(abs(ke - ke_s) <= 1e-4 * abs(ke_s)
                   and abs(m["cg_iters"] - r["cg_iters"]) <= solves,
                   f"sharded MPM frame {f}: differs from MpmSim")
    if rank == 0:
        timed = got[warm:]
        print(f"mpm: {world} ranks, slab {msim.slab.rows} rows, cap "
              f"{msim.cap}, mig_cap {msim.mig_cap}, {total} particles, "
              f"operator {params.hessian}; ms/frame {ms:.3f} against "
              f"MpmSim's {mref_ms:.3f} on rank 0's device; CG "
              f"iterations/frame "
              f"{sum(m['cg_iters'] for m in timed) / mpm_frames:.1f} "
              f"({mpm_frames} frames, host clock, synchronised)", flush=True)
        for r, counts in enumerate(every):
            print(f"mpm: rank {r} launches in the timed frames: "
                  f"{json.dumps(counts)}", flush=True)
    _check(not fails, f"rank {rank}: {len(fails)} checks failed: {fails}")


def _sync_local(device: str):
    if device.startswith("cuda"):
        torch.cuda.synchronize()


# ---- rank functions of the tests (tests/test_torch_*.py) ------------------

def halo_rank(rank: int, world: int, device: str, path: str):
    """Apply the halo primitives to this rank's block of the arrays in
    ``path`` (npz: ``slab`` (world*nl, ...), ``ext`` (world*(nl+2w), ...),
    ``payload``, ``send_left``, ``send_right`` (world*P, ...), ``width``,
    ``capacity``) and write the results to ``path`` + ``.rank<r>.npz``."""
    from fluidsim_tpu_torch.parallel import halo

    d = np.load(path)
    block = lambda a: torch.as_tensor(np.split(d[a], world)[rank])
    w, cap = int(d["width"]), int(d["capacity"])
    pay, sl, sr = block("payload"), block("send_left"), block("send_right")
    ext = halo.exchange_halo(block("slab"), w)
    red = halo.halo_reduce(block("ext"), w)
    f = cap
    inc_b, val_b = halo.migrate_edge_bands(pay[:f], sl[:f], pay[-f:], sr[-f:])
    inc_n, val_n, dropped = halo.migrate_neighbors(pay, sl, sr, cap)
    (lo, hi), = halo.edge_rows([block("slab")], w)
    none = np.zeros((0,), np.float32)
    np.savez(f"{path}.rank{rank}.npz", exchange=ext.numpy(),
             edge_lo=none if lo is None else lo.numpy(),
             edge_hi=none if hi is None else hi.numpy(),
             reduce=red.numpy(), bands=inc_b.numpy(), bands_valid=val_b.numpy(),
             neighbours=inc_n.numpy(), neighbours_valid=val_n.numpy(),
             dropped=int(dropped))


def _load_state(path: str, rank: int, world: int, cap: int, device: str):
    from fluidsim_tpu_torch import interop

    d = dict(np.load(path))
    if "FE" in d:
        return interop.sharded_mpm_state_from_numpy(d, rank, world, cap=cap,
                                                    device=device)
    return interop.sharded_state_from_numpy(d, rank, world, cap=cap,
                                            device=device)


_FLIP_KEYS = ("kinetic_energy", "outer_iters", "cg_iters", "num_fluid_cells",
              "num_alive", "migrated", "lost", "dt", "error")
_MPM_KEYS = ("kinetic_energy", "cg_iters", "spd_fallback", "num_active_cells",
             "num_alive", "migrated", "lost", "dt", "min_det_fp")


def sim_rank(rank: int, world: int, device: str, kind: str, frames: int,
             state_path: str, out_path: str, sim_kwargs: dict,
             drift: float = 0.0):
    """Build the sharded ``kind`` ("flip" or "mpm") sim from ``sim_kwargs``,
    start it from the global numpy state in ``state_path`` (none: the
    seeded one, with ``drift`` added to every particle's x velocity), step
    ``frames`` frames and write, on rank 0, the metrics per frame and the
    final global state to ``out_path`` (npz; the state's keys prefixed
    ``state_``, plus ``cap``, ``mig_cap`` and ``tail_insert``)."""
    from fluidsim_tpu_torch import interop
    from fluidsim_tpu_torch.parallel.flip_sharded import ShardedFlipSim
    from fluidsim_tpu_torch.parallel.mpm_sharded import ShardedMpmSim

    cls = ShardedFlipSim if kind == "flip" else ShardedMpmSim
    sim = cls(device=device, **sim_kwargs)
    if state_path:
        sim.state = _load_state(state_path, rank, world, sim.cap, device)
    sim.state.vel[sim.state.alive, 0] += drift
    keys = _FLIP_KEYS if kind == "flip" else _MPM_KEYS
    rows = {k: [] for k in keys}
    for _ in range(frames):
        m = sim.step()
        for k in keys:
            rows[k].append(float(m[k]))
    to_numpy = (interop.sharded_state_to_numpy if kind == "flip"
                else interop.sharded_mpm_state_to_numpy)
    state = to_numpy(sim.state)
    if rank == 0:
        np.savez(out_path, cap=sim.cap, mig_cap=sim.mig_cap,
                 tail_insert=sim.tail_insert,
                 **{k: np.asarray(v) for k, v in rows.items()},
                 **{f"state_{k}": v for k, v in state.items()})


def trace_rank(rank: int, world: int, device: str, out_path: str,
               sim_kwargs: dict):
    """Step the sharded MPM built from ``sim_kwargs`` for two frames, the
    second (the first whose step reads the previous frame's lost count)
    under a CPU ``torch.profiler`` with the program's spans traced, and
    write on rank 0 to ``out_path`` (npz) what that frame did:
    its ``fs:`` ranges (``names``, ``starts``, ``ends``), the host waits
    by site (``wait_<site>``) and the collectives' calls and bytes
    (``shift_pair.calls`` ...) made in it, its ``cg_iters`` and
    ``spd_fallback``, and the sim's ``cap``, ``mig_cap``, ``tail_insert``,
    ``n`` and ``nl``."""
    from torch.profiler import ProfilerActivity, profile

    from fluidsim_tpu_torch.parallel import halo
    from fluidsim_tpu_torch.parallel.mpm_sharded import ShardedMpmSim
    from fluidsim_tpu_torch.utils import profiling

    def counts():
        out = {f"wait_{k}": v for k, v in profiling.host_wait.counts.items()}
        for fn in (halo.shift_pair, halo.all_reduce):
            out[f"{fn.__name__}.calls"] = fn.calls
            out[f"{fn.__name__}.bytes"] = fn.bytes
        return out

    sim = ShardedMpmSim(device=device, **sim_kwargs)
    sim.step()
    before = counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.tracing():
        m = sim.step()
    made = {k: v - before.get(k, 0) for k, v in counts().items()}
    if rank != 0:
        return
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith(profiling.PREFIX)]
    np.savez(out_path, names=np.array([r[0] for r in ranges]),
             starts=np.array([r[1] for r in ranges]),
             ends=np.array([r[2] for r in ranges]),
             cg_iters=m["cg_iters"], spd_fallback=m["spd_fallback"],
             cap=sim.cap, mig_cap=sim.mig_cap, tail_insert=sim.tail_insert,
             n=sim.slab.n, nl=sim.nl, **made)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4,
                    help="ranks to spawn (ignored under a launcher)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one GPU per rank) or cpu (gloo)")
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S,
                    help="seconds a collective, and a spawned run, may take")
    ap.add_argument("--full", action="store_true",
                    help="phases 32 and 33 of chip_smoke.py at their sizes "
                    "across the ranks instead of the dry run")
    a = ap.parse_args(argv)
    rank_fn = full_rank if a.full else dryrun_rank
    if launched():
        with process_group(a.device, a.timeout) as (rank, world):
            try:
                rank_fn(rank, world, a.device)
            except Exception:
                traceback.print_exc()
                return 1
        if rank == 0:
            print("dryrun OK")
        return 0
    run_ranks(rank_fn, a.world, a.device, timeout_s=a.timeout)
    print("dryrun OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
