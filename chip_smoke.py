#!/usr/bin/env python3
"""Drive the PyTorch port's FLIP, APIC, MPM and bucket-sort paths, the
materialised G2P, the span and unhaloed shift entry points, the
row-layout transfers, config-driven runs (multigrid, the clean
projection, MPM Jacobi), the slab-sharded FLIP and MPM, the MPM frame
on the FLIP transfer spline and the reference-scale validation runs on one
NVIDIA GPU and check them.

    python3 chip_smoke.py   # water_cube_drop at 129^3 (~1.99M particles),
                            # mpm_cone at 127^3 (473,798 particles)

and the run-time layer: the command line with export, checkpoints,
resume, metrics, the particle surface and a trace, and ``steps(k)``;
and the tools suite: ray tracing, the ``raytrace`` and ``view`` commands,
the grid operators, the level-set tools and meshes.

Phases, each of which raises on failure (nonzero exit):

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from ``fluidsim_tpu_torch/csrc`` and time the build;
3. compare each FLIP kernel (K1 P2G, K2 G2P, K3 Laplacian, K4 Chebyshev
   steps) with its plain PyTorch version on the card at the main path's
   shapes, and time both with CUDA events (median of the runs); K3 and K4
   on a 129^3 frame's fields, bit for bit (their bound counts p, z and r at
   the fluid cells alone, which is all they need): K4 as the preconditioner's one
   launch at degrees 3 and 4 (2 and 3 steps from the Jacobi term) and as
   one step from a given (z, d), and a degree-8 preconditioner split into
   ceil(7 / S_MAX) launches; K1 with
   its chunk plan given, the plan timed apart (its device work, and the
   card's idle time after its host read), K1 bit for bit against its
   summation order in PyTorch (``p2g_scatter_chunked``) and a rerun, a
   plan of another ``cell_start`` refused, and the plan's chunk lists
   (``chunk_fill``) against their plain version; K2 bit for bit against its
   plain version there and on ``utils/synthetic.gather_edge_cases`` (tiles
   across rows and planes, box faces, live counts of 0, P and one inside a
   tile, a window-grouped order, a slab; 1 to 100,003 rows at 13^3, 25^3
   and 129^3), and K2 moments on those without a count, each state's share
   of tiles that staged their fields counted by the kernel (``paths``) and
   printed, both paths of each kernel required across the edge cases; the
   bound of each gather of fields (K2, K2 moments, K2 gw) counts the fields
   at the cells in the live rows' neighbourhoods, which is all it must
   read;
4. run ``FlipSim`` (FLIP) for warm-up and timed frames: finite energy,
   particles in the box, the projection's outer tolerance met, every
   kernel launched by the timed frames the number of times the frame's CG
   iterations call for, and one K1 chunk plan built per frame; print
   ms/frame;
5. determinism: the first frames rerun from the same seed give bit-identical
   kinetic energies;
6. the APIC kernels (K1 aff, K2 moments) against their plain versions at the
   APIC configuration's shapes, timed as in phase 3, K1 aff with the
   checks of K1 in phase 3 (``p2g_scatter_affine_chunked``), K2 moments
   bit for bit with its count of staged tiles;
7. ``FlipSim(mode="apic")`` at the same size: warm-up and timed frames with
   the checks of phase 4 and the launch counts of all six kernels, every
   frame's kinetic energy printed (two checkouts compare on them); then K2
   moments bit for bit on the bucket sort of the final state, the
   window-grouped order a bucket APIC frame gives it;
8. determinism of the APIC frames, as phase 5;
9. reference: a small scene stepped on the card in FLIP, APIC and PIC mode
   matches the same scene stepped on the CPU, where every kernel wrapper
   runs its plain version (APIC: the affine matrices too);
10. the MPM kernels (K1, K1 fg, K2 gw, and K2 on the density gather's
   fields, bit for bit) against their plain versions on the sorted state,
   stress and grid velocity of ``MpmSim("mpm_cone")`` after its 2 warm-up
   frames, timed as in phase 3, K1 and K1 fg with the
   checks of K1 in phase 3 (``p2g_scatter_force_chunked``); all three K1
   modes again on skewed synthetic states
   (``utils/synthetic.skewed_force_state``, ``skewed_wv_state``: 20,000
   particles in one cell);
11. the MPM main path: 10 timed frames with finite energy and deformation
   gradients, particles in the box, det(FP) > 0, every implicit solve
   converged, the launch counts of all nine kernels and one K1 chunk plan
   per frame, shared by the frame's K1 and K1 fg launches; ms/frame and CG
   iterations per frame;
12. determinism of the MPM frames, as phase 5;
13. reference: ``mpm_cone`` at bound 15 with the "full" operator and with
   a forced SPD fallback ("hybrid", cap 1), card against CPU;
14. the bucket path's kernels (K5 bucket move, K6a base-cell scatter, K6b
   shift-reduce) against their plain versions on the window-grouped state
   of ``FlipSim(sort_method="bucket")`` after its 2 warm-up frames, timed
   as in phase 3, each beside one PyTorch call that computes the same
   function (``index_select``, ``index_add_``, ``conv3d``); K5 also bit
   for bit on synthetic run tables (``utils/synthetic.bucket_tables``);
   K6a bit for bit against its summation order in PyTorch
   (``p2g_scatter_base_ordered``) and a rerun, there, in its APIC instance
   on phase 6's APIC state shuffled inside each window (timed), and in both
   instances on ``utils/synthetic.skewed_window_state`` (20,000 particles
   in one cell, a span of 2,560 ids, the ragged last window occupied); K2
   bit for bit against its plain version on the window-grouped order;
15. the bucket path at 129^3: 10 timed frames with the checks of phase 4,
   the launch counts (K5 once per frame that kept the bucket order, K6a
   and K6b once per frame, K1 never), how many frames fell back to the
   full sort, and ms/frame beside the full path's;
16. determinism of the bucket frames, as phase 5;
17. reference: FLIP, APIC and PIC on the bucket path at bound 16 (10,648
   particles), card against CPU, as phase 9;
18. the materialised G2P's kernels (K7b neighbourhood table, K7a gather in
   its 4-row and 22-moment modes) against their plain versions on the
   sorted state of ``FlipSim`` after its 2 warm-up frames, timed as in
   phase 3, K7b beside ``conv3d`` and K7a beside the time of its gather
   half (``index_select``), and K7a against K2 and K2 moments, bit for bit;
19. ``g2p`` and ``g2p_apic`` with ``fused_table=False`` on that state, with
   their launch counts, bit for bit against ``fused_table=True``, both
   timed;
20. the span kernels (K9a, K9b) on that state: what the old route spent
   (the host order check, then K6a or K7a); each against its plain version
   (K9a also beside ``index_add_``), timed as in phase 3; K9a bit for bit
   against K6a, ``p2g_scatter_base_ordered`` and a rerun, its tile plan
   against ``span_tile_starts_plain``, there, on phase 6's APIC state, on
   ``utils/synthetic.skewed_window_state`` sorted by cell (timed) and on
   random states at 25^3 and 45^3; K9b and K9b moments bit for bit against
   K7a and K2 (K2 moments) there and on random states at 25^3 and 45^3,
   where every full block spans more than 32 cells and so reads the table
   directly instead of staging it; what
   each wrapper queues before its host wait within 0.02 ms of its kernels
   alone (``_queued_ms``); an unsorted order and an id of n^3 raising
   ``ValueError``, each flag matching ``span_order_flag_plain``, and a
   sorted call after them still bit for bit; then the unhaloed shift entry
   points (K10a, K10b) against K6b and K7b, their plain versions and
   ``conv3d`` (K10a bit for bit against both of its plain versions and
   K6b; K10b bit for bit against both of its plain versions and K7b's
   table transposed, at 129^3 and again at 25^3 and 45^3 on random
   fields), the transposes (K10c, K10d) of a (129^3, 108) matrix against
   ``.T.contiguous()``, and the launch counts of one call of each entry
   point (K9 no longer launches K6a or K7a);
21. the row-layout transfer kernels (K8a row gather, K8b row scatter-add)
   against their plain versions and one PyTorch call (``index_select``,
   ``index_add_``) on that state, timed as in phase 3; the row P2G (K8b,
   then K6b) against K6a and K6b and the row G2P (K7b, K8a, the
   contraction) against K7a and K2, bit for bit; K8b's tile plan against
   ``scatter_tile_starts_plain`` and K8b against its rerun, bit for bit;
   K8b on ``utils/synthetic.skewed_row_state`` (20,000 rows in one cell)
   timed, and bit for bit against its plain version on the CPU (each
   cell's rows in array order); one K8b call on the state's rows in an
   order that is not sorted, which must not fault; both kernels again on
   sweep_transfer's 127-lane rows and table of ones;
22. ``utils/transfer_parts`` at 129^3 on the 3-frame state: one pass of the
   row P2G and G2P with the launch counts of every kernel, the row P2G
   against K1 and the row G2P against K2, then each part's time;
23. ``config.make_sim`` of a JSON config with ``water_cube_drop``'s cube
   (the particles of phase 4), a solid block under it (the grid bounce
   probe) and ``preconditioner="multigrid"``: 10 timed frames with the
   checks of phase 4, 6 K3 launches per CG iteration (the CG apply and the
   V-cycle's 5 fine-level sweeps and residual) and no K4 launch; ms/frame,
   CG iterations and outer passes per frame;
24. the same config with ``compat_projection=False, cheb_degree=4,
   cheb_ratio=50``: one outer pass a frame, one K4 launch (3 steps) per
   preconditioner application; ms/frame and CG iterations;
25. ``mpm_cone`` at 127^3 with ``precond="jacobi"``: 10 timed frames with
   the checks of phase 11 and one more K1 launch a frame (the stiffness
   scatter); CG iterations per frame beside phase 11's;
26. card against CPU: the small config (bound 8, an obstacle) with the
   Jacobi and multigrid preconditioners, the clean projection and the MPM
   spline, as phase 9; ``mpm_cone`` at bound 15 with ``precond="jacobi"``,
   as phase 13; ``extrapolate`` of phase 23's last grid velocity and fluid
   mask at 129^3, within 1e-6 x max|v|;
27. the command line, ``fluid`` at 129^3 (``cli.run``, as ``python -m
   fluidsim_tpu_torch.cli fluid --bound 64 --density 25`` runs it): 12
   frames with ``--no-vdb``, then 12 with export, a checkpoint every 6
   and ``--metrics`` (the launch counts of this run, checked against its
   metrics as in phase 4), then export on and off again; ms/frame of
   frames 2-11 of each run beside phase 4's; the exporter's counters (no
   dense fallback, no Python writer); each ``mygrids<i>.vdb`` read back bit for bit equal to
   ``occupancy * ~solid`` of frame i of a direct ``FlipSim`` rerun;
   ``mygrids.vdb`` holding 12 grids; ``pack_active`` on the card equal to
   the CPU's buffer for the same grid; ``--resume ckpt_5.npz --frames 6``
   into a second directory writing frames 6-11 bit for bit as the first
   run did;
28. ``mpm`` at 127^3 (473,798 particles), 6 frames with ``--no-vdb``, then
   6 with export and ``--metrics`` (launch counts checked as in phase
   11), then export on and off again; each file equal to the MPM persistence rule (cells > 0.1, kept
   across frames) recomputed in numpy from a direct ``MpmSim`` rerun;
29. ``FlipSim.steps(4)`` at 129^3 and ``MpmSim.steps(2)`` at 127^3 bit for
   bit equal to as many ``step()`` calls (state and stacked metrics);
   ``run(6, chunk=3)`` calling back once per chunk;
30. last, since a process runs slower after a profile: ``fluid --surface
   --trace-dir`` for 2 frames at 129^3, the fog grids within 1e-6 of
   ``sdf_to_fog(particles_to_levelset(pos))`` on the CPU for the same
   positions, and a Chrome trace holding the frames' kernels.

Phases 31-34, run after phase 29 and before phase 30, each in a process
group of this process alone (NCCL, a ``file://`` store, destroyed after):

31. the slab shapes of the sharded paths: K1 and K2 on the FLIP scene's
   transfer slab of world size 1 (133 rows at 129^3) and of rank 1 of a
   4-way cut (37 rows, its 1,062,973 particles alive and the rest of the
   slots dead), K3 and K4 on their solve slabs (129 rows with null edge
   planes, and 33 rows with the neighbouring slabs' edge rows beside them,
   cut out of phase 3's frame fields), K1 fg, K2 gw and K2 (the density
   gather) on the cone's (131 and 36 rows at 127^3); each against its plain
   version as in phase 3
   (timed, with the bound of the slab's bytes: the live particles' inputs,
   the edge rows read, the whole output; K3 and K4 read p, z and r only at
   fluid cells, the gathers the fields only in the live particles'
   neighbourhoods), then bit for bit against its
   order function (K1: ``p2g_scatter_chunked``, K1 fg:
   ``p2g_scatter_force_chunked``, K2 gw: ``g2p_gather_gw_ordered``) or
   plain version (K2, K3, K4 at degrees 3 and 4 and one step); and on each
   solve slab a degree-5 preconditioner in two K4 launches, the second
   from the given (z, d) with the neighbours' edge rows of z and d, bit for
   bit the cube's 4 steps on the slab's rows;
32. ``ShardedFlipSim`` at world size 1 on ``water_cube_drop`` at 129^3
   (1,987,675 particles), 2 warm-up and 10 timed frames against
   ``FlipSim`` on the card frame by frame: kinetic energy within rtol
   1e-4, the same outer and CG counts, fluid cells and particles, none
   lost, and after the 12 frames the state bit for bit ``FlipSim``'s; per
   timed frame one K1, one plan, one K2 and K3/K4 as in phase 4; ms/frame
   beside phase 4's;
33. ``ShardedMpmSim`` at world size 1 on ``mpm_cone`` at 127^3 (473,798
   particles), 2 warm-up and 6 timed frames against ``MpmSim``: kinetic
   energy within rtol 1e-4, CG iterations within one per solve, det FP >
   0, none lost, the state bit for bit ``MpmSim``'s; the launch counts
   of phase 11; ms/frame beside phase 11's;
34. card against CPU: the sharded FLIP at bound 8 and the sharded MPM at
   bound 15 (density 40), world size 1, 3 frames on the card against 3 on
   the CPU (a gloo group of the same process), as phases 9 and 13.

Phase 35, run after phase 34 and before phase 30: the tools suite (no
kernel of its own: plain PyTorch on the card) on the level set of phase
4's final FLIP state at 129^3 (``particles_to_levelset`` of its 1,987,675
particles): ``raytrace_levelset`` at the CLI's 512x512, in perspective and
orthographic with 4 samples, against the same call on the CPU under the
image rule of ``tests/test_torch_raytrace.py``; ``redistance`` (20
iterations, within 1e-4 of the field's scale), ``filter_median``,
``signed_flood_fill``, ``dilate``/``erode``, ``histogram`` and
``partition_by_cell`` of the positions bit for bit the CPU's, ``stats``,
``volume_to_mesh`` (equal counts, the quads bit for bit) and
``fill_with_spheres`` of the redistanced field; ``mesh_to_sdf`` of a
512-triangle ``icosphere`` and ``platonic_sdf`` (icosahedron) against the
CPU at bound 16 and timed at 129^3; the level set written as a ``.vdb``
and ``cli raytrace`` / ``cli view --orbit 4`` run on it with the default
device, each PNG bit for bit the direct call's.  Each tool's median
host-clock ms of 3 synchronised calls is printed on a ``tool`` line, with
the PyTorch operators that the tracer, the flood fill and
``mesh_to_sdf`` dispatch per call.

Phase 36, run after phase 35 and before phase 30: the transfer-spline
choice.  (a) ``MpmSim`` of ``mpm_cone`` at 127^3 (473,798 particles) with
``MpmParams(kernel="flip")``: 2 warm-up and 10 timed frames with the
checks of phase 11 (finite energy and F, particles in the box, det FP >
0, every solve converged before its cap, one chunk plan a frame) and its
launch counts, with two K1 launches a frame for the mass and momentum
(the mass on the positive weights); ms/frame, CG iterations and SPD
fallbacks per frame beside phase 11's.  (b) On the sorted state after
the warm-up and its FLIP-spline table: K1 against its plain version with
the checks of phase 3, and on the positive weights bit for bit against
its order, and K2 (as the FLIP delta launches it) bit for bit against
its plain version, both timed with their bounds.  (c) ``mpm_cone`` at
bound 15 on the FLIP spline, "full" and "hybrid" with cap 1, card against
CPU as phase 13.  (d) ``ShardedFlipSim`` with ``kernel="mpm"`` at world
size 1 on NCCL, ``water_cube_drop`` at 129^3, 3 frames against
``FlipSim(kernel="mpm")`` with phase 32's checks and launch counts, the
state bit for bit ``FlipSim``'s.

Phase 37, run after phase 36 and before phase 30: the validation runs
(``fluidsim_tpu_torch/validation``), each through its module's functions
with its oracle, the launches of its frames counted from 0 and checked.
(a) ``soak_500`` for 60 frames at 121^3 (689,210 compat-seeded
particles) against ``docs/ke_trace_500frames.json``, and frames 0-39 of
that run against the C++ record ``docs/parity_full_121cube.json`` as
``ke_parity flip`` holds them (free fall < 5%, median < 25%, correlation
> 0.99).  (b) ``soak_mpm`` for 60 frames of the compat-seeded 31^3 cone
against ``docs/mpm_trace_500frames.json``; ``ke_parity mpm`` for 60
frames (median < 5e-4, max < 5e-3, dt within 1e-4 of
``docs/mpm_parity_cone.json``), and again on the CPU: the card's
energies within 5e-3 of the CPU's, the CPU's within the same gates;
``soak_mpm_scaled`` at 127^3 for 20
frames (finite, confined, det FP > 0).  (c) ``validate_config5`` at
257^3 (9,826,000 particles) for 3 frames in a process group of this
process alone: ``ShardedFlipSim`` against ``FlipSim`` frame by frame,
none lost, the state bit for bit.  (d) ``validate_mpm_shape`` at 255^3
(3,939,805 particles) for 2 frames, the same for ``ShardedMpmSim``
against ``MpmSim``.  (e) On (c)'s ``FlipSim`` after its frames K1 and K2
(its particles sorted, random velocities) and K3 and K4 (its last
frame's fields), on (d)'s ``MpmSim`` K1 fg and K2 gw, each against its
plain version as in phase 3 and bit for bit against its order function
or plain version, timed with its bound: entries ``<kernel>_257`` and
``<kernel>_255`` with the launches of (c) and (d).

Phase 38, run after phase 37 and before phase 30: the MPM 3x3 chain's
kernels (``csrc/mat3.cu``: ``piola_linearized``'s polar stress and its
factor rows, the implicit apply ``StressDifferential.apply`` "full" and
"spd", ``clamp_singular``, ``mm3``), each bit for bit against its plain
version on the card: on the
``synthetic.mat3_cases`` kinds (the CPU tests' random, near-singular,
rotation and inverted matrices; the zero matrix, ranks 1 and 2, det < 0,
equal singular values, exact zeros off the diagonal), and on the 255^3
cone's own FE, FP, mu, lam and gathered g at frame 0 and after the fall's
10 frames, ``mm3`` also with each operand transposed; there each timed
beside its byte and operation bounds (the plain chain's f32 operations
counted on the CPU) and its plain version.  ``MpmSim`` and
``ShardedMpmSim`` (world size 1) at 255^3 run 2 frames with the kernels
and 2 with the plain chain, the states bit for bit; their frames' launches
are held to 1 polar stress, one apply of each variant per CG iteration and
solve of that operator, 1 clamp and 4 ``mm3`` a frame; ptxas's register
and spill lines for the four kernels, from the log kept beside the built
library (none found, or a spill, fails).  Their entries in the JSON line
below have ``replaces`` null and each its own launches a frame by path.

The line before the last is a JSON object with one entry per kernel (and
one per slab shape of phase 31, ``<kernel>_slab<rows>``, with the
launches of the sharded path at world size 1 and the slab in ``slab``:
"rank 0 of 1" is the shape that path launches, "rank 1 of 4" one rank's
of a 4-way run, which ``python -m fluidsim_tpu_torch.parallel.dryrun
--full`` drives on four cards; and one per shape of phase 37e, with its
path's launches and the shape in ``shape``); the last line is
``{"ok": true, "device": {...}}``.  An entry's ``ms`` is its
wrapper's time, except for K9a and K9b: theirs is the time of their kernels
alone (``*_launch``), without the wrapper's wait on the host for the order
flag, which their ``wrapper_ms`` includes.  K8b's ``ms`` still includes
its wrapper's copy of the end ids to the host and its wait on it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

# ~10 ms of spinning at the H100's clocks: longer than the host takes to
# enqueue any timed call below
_SPIN_CYCLES = 20_000_000
_REPS = 20          # timed runs per kernel and per plain version

# the main paths' configuration (the JAX package's bench scene at 129^3 and
# its scaled MPM bench row at 127^3, uncut; the MPM scene's density of 400
# particles per seeded voxel; the "hybrid" operator), phase 31's 4-way cut,
# and the card's rates that a kernel's least time is counted at
from fluidsim_tpu_torch.utils.card_inputs import (  # noqa: E402
    F32_OPS_PER_S, FLIP_BOUND as BOUND, FLIP_DENSITY as DENSITY,
    HBM_BYTES_PER_S, MPM_BOUND, SEED, SLAB_RANK, SLAB_WORLD)

FRAMES = 10         # timed frames per mode, after 2 warm-up frames
MPM_SMALL = dict(bound=15, density=40.0)   # phase 13's reference scene
CLI_FRAMES = 12     # phase 27's frames, a checkpoint every CLI_FRAMES // 2
MPM_CLI_FRAMES = 6  # phase 28's
MPM_SHARD_FRAMES = 6   # phase 33's timed frames, after 2 warm-up frames
# phase 17's reference scene: more than one 512-row chunk of particles, so
# the bucket order differs from the cell order
BUCKET_SMALL = dict(bound=16, density=8.0)


def _cuda_ms(fn, torch):
    """Median device time of ``fn()`` in ms over ``_REPS`` runs.

    Each run queues a spin kernel first, then the start event, ``fn()``'s
    launches and the end event: the host enqueues all of them while the card
    spins, so the events time the launches back to back on the device, not
    the host's Python between them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _queued_ms(fn, torch):
    """Median device time in ms of what ``fn()`` queues before it waits on
    the host: each run queues a spin kernel, the start event, then runs
    ``fn()`` on another host thread and records the end event from this
    one 5 ms later, while the card still spins.  A wrapper that reads from
    the card before its launch is still waiting then, so the events hold
    only what came before the read; one that reads after its launch has
    queued all of its kernels between them.  The spin is 4x ``_cuda_ms``'s
    (~40 ms): the end event must be queued before the spin ends, and on a
    loaded host the 5 ms sleep and the thread's start can take over 10."""
    import threading

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4 * _SPIN_CYCLES)
        start.record()
        worker = threading.Thread(target=fn)
        worker.start()
        time.sleep(0.005)
        end.record()
        worker.join()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _compare(name, kernel, plain, rel_tol, inputs, ops, torch, library=None,
             extra_bytes=0):
    """Run a kernel and its plain version on the same inputs; require
    ``max|kernel - plain| <= rel_tol * max|plain|`` of each output (a
    kernel may return a tuple of outputs to hold each to its own scale).
    Returns the kernel's line fields: the error, both times (and
    ``library``'s, one PyTorch call of the same function, where there is
    one), and the bound — the larger of the compulsory bytes (``inputs``
    read once, the outputs written once, plus ``extra_bytes`` that depend on
    the data) over the HBM rate and ``ops`` f32 operations over the f32
    rate."""
    out_k, out_p = kernel(), plain()
    torch.cuda.synchronize()
    if not isinstance(out_k, tuple):
        out_k, out_p = (out_k,), (out_p,)
    errs = [_max_err(k, p) for k, p in zip(out_k, out_p)]
    scales = [float(p.abs().max()) for p in out_p]
    err = max(errs)
    ok = (all(e <= rel_tol * sc for e, sc in zip(errs, scales))
          and all(bool(torch.isfinite(k).all()) for k in out_k))
    for e, sc in zip(errs, scales):
        print(f"compare {name}: max_abs_err {e:.3e} (bound {rel_tol * sc:.3e} "
              f"= {rel_tol:g} x max|plain| {sc:.4g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    ms = _cuda_ms(kernel, torch)
    plain_ms = _cuda_ms(plain, torch)
    library_ms = None if library is None else _cuda_ms(library, torch)
    nbytes = _nbytes(inputs) + _nbytes(out_k) + extra_bytes
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    lib = "" if library is None else f", library {library_ms:.4f} ms"
    print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib} "
          f"(median of {_REPS}); bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} Gop)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def _require_bitwise(name, a, b, torch):
    """Raise unless the tensors (or tuples of tensors) ``a`` and ``b`` hold
    the same bits."""
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    same = all(x.shape == y.shape and torch.equal(
        x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))
        for x, y in zip(a, b))
    if not same:
        raise AssertionError(f"{name}: not bit for bit equal")
    print(f"bitwise {name}: equal")


def _k2_staged(label, fm, w27t, flat, count, torch, moments=False):
    """K2 (with ``moments`` K2 moments, which takes no count) on the inputs
    once more, bit for bit against its plain version, with the kernel
    counting its tiles (``paths``); print and return ``[staged, tiles]``:
    of its tiles with a live row, how many staged their fields."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    paths = torch.zeros(2, dtype=torch.int32, device=fm.device)
    if moments:
        name = "K2 moments"
        got = tk.g2p_moments(fm, w27t, flat, paths=paths)
        want = tk.g2p_moments_plain(fm, w27t, flat)
    else:
        name = "K2"
        got = tk.g2p_gather(fm, w27t, flat, count, paths=paths)
        want = tk.g2p_gather_plain(fm, w27t, flat, count)
    _require_bitwise(f"{name} ({label}): against its plain version", got,
                     want, torch)
    staged, tiles = paths.tolist()
    print(f"{name} ({label}): {staged} of {tiles} tiles with a live row "
          f"staged their fields ({staged / max(tiles, 1):.1%}, the kernel's "
          "count)")
    return [staged, tiles]


def _field_bytes(flat, nx, n, channels, live=None):
    """The bytes of (channels, nx, n, n) f32 fields that a gather of the
    ids ``flat[:live]`` must read: every cell in their 27-cell
    neighbourhoods (``card_inputs.read_cells``), once."""
    from fluidsim_tpu_torch.utils.card_inputs import read_cells

    return 4 * channels * read_cells(flat, nx, n, live)


def _k2_edge_cases(torch):
    """K2 and K2 moments bit for bit against their plain versions on
    ``utils/synthetic.gather_edge_cases`` at 13^3, 25^3 and 129^3, with
    particle counts of 1, 127, 129, 255, 257, 1001, 4099 and 100,003 (most
    not a multiple of 4, two on either side of a 128-row tile); K2 moments
    on the cases without a live count (its entry refuses one).  Across
    them each kernel must count tiles of both of its paths (staged tiles
    and the direct reads)."""
    from fluidsim_tpu_torch.utils import synthetic

    totals = {False: [0, 0], True: [0, 0]}
    for p, n in ((1, 13), (127, 13), (129, 13), (255, 13), (257, 13),
                 (1001, 13), (4099, 25), (100_003, 129)):
        for name, fm, w27t, flat, count in synthetic.gather_edge_cases(
                p, n, seed=SEED, device="cuda"):
            for moments in (False, True) if count is None else (False,):
                s, t = _k2_staged(f"edge case {name}, {p} rows at {n}^3", fm,
                                  w27t, flat, count, torch, moments)
                totals[moments][0] += s
                totals[moments][1] += t
    for moments, (staged, tiles) in totals.items():
        name = "K2 moments" if moments else "K2"
        print(f"{name} edge cases: {staged} of {tiles} tiles staged")
        if not 0 < staged < tiles:
            raise AssertionError(f"{name} edge cases: {staged} of {tiles} "
                                 "tiles stage: a path of the kernel went "
                                 "untested")


def _moments_bucket_order(sim, torch):
    """K2 moments bit for bit against its plain version on the
    window-grouped order that a bucket APIC frame gives its G2P: the
    bucket sort (``sort_by_cell(method="bucket")``) of the APIC ``sim``'s
    state, random fields.  Raises if the bucket sort fell back to the full
    sort."""
    from fluidsim_tpu_torch.ops import bucket_sort as bs
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    st, B = sim.state, sim.params.bound
    n = 2 * B + 1
    fallbacks = bs.bucket_or_sort.fallbacks
    pos_b, _, flat_b, _ = tk.sort_by_cell(st.pos, st.vel, B,
                                          extra=st.aff.reshape(-1, 9),
                                          method="bucket")
    if bs.bucket_or_sort.fallbacks != fallbacks:
        raise AssertionError("K2 moments, window-grouped: the bucket sort "
                             "fell back to the full sort")
    descents = int((flat_b[1:] < flat_b[:-1]).sum())
    print(f"K2 moments, window-grouped: the bucket order of the APIC state "
          f"after its frames, {flat_b.shape[0]} particles, {descents} ids "
          "below their predecessor")
    fm = torch.rand((4, n, n, n), device=flat_b.device,
                    generator=torch.Generator(device=flat_b.device)
                    .manual_seed(SEED))
    return _k2_staged("the APIC state in the bucket order", fm,
                      tk.masked_weights_cm(pos_b, B), flat_b, None, torch,
                      moments=True)


def _k6a_case(name, w27t, vel, flat, n, aff, torch):
    """K6a on one window-grouped state (``aff``: its APIC instance) against
    its plain version and ``index_add_`` of the prebuilt (P, 108) rows,
    timed as in phase 3, then bit for bit against its summation order in
    PyTorch (``p2g_scatter_base_ordered``) and a rerun.  Returns the line's
    numbers."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    p = flat.shape[0]
    ws = tk.window_starts(flat, n)
    u108 = tk._wv_values(w27t, vel, aff).reshape(p, 108)
    flat64 = flat.to(torch.int64)
    launch = lambda: tk.p2g_scatter_base(w27t, vel, flat, ws, n, aff)
    res = _compare(
        name, launch, lambda: tk.p2g_scatter_base_plain(w27t, vel, flat, n, aff),
        1e-5, (w27t, vel, flat, ws) + (() if aff is None else (aff,)),
        27 * (7 if aff is None else 25) * p, torch,
        library=lambda: torch.zeros((n ** 3, 108), device=flat.device)
        .index_add_(0, flat64, u108))
    out = launch()
    _require_bitwise(f"{name}: against p2g_scatter_base_ordered", out,
                     tk.p2g_scatter_base_ordered(w27t, vel, flat, n, aff),
                     torch)
    _require_bitwise(f"{name}: against its rerun", out, launch(), torch)
    return res


def _k6a_more_states(w27t, vel_s, flat, apic_state, bound, n, dev, torch):
    """K6a's APIC instance on the frame-2 bucket state (``w27t``, ``vel_s``,
    ``flat``) with random C and on phase 6's APIC state (the seeded cube,
    random v and C) with its particles shuffled inside each window, then
    both instances on ``utils/synthetic.skewed_window_state`` at n^3
    (20,000 particles in one cell, a window of 2,560 ids, the ragged last
    window occupied), each with ``_k6a_case``.  Returns their numbers."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.utils import synthetic

    g = torch.Generator(device=dev).manual_seed(SEED)
    aff = 0.5 * torch.randn((flat.shape[0], 9), generator=g, device=dev)
    out = {"apic_bucket_state": _k6a_case(
        "K6a APIC p2g_scatter_base, the frame-2 bucket state with random C",
        w27t, vel_s, flat, n, aff, torch)}
    del aff
    pos_s, veff, flat_a, aff_s = apic_state
    p = flat_a.shape[0]
    key = (flat_a.to(torch.int64) // tk.WINDOW) * p + torch.randperm(
        p, generator=g, device=dev)
    perm = torch.sort(key)[1]
    pos_s, veff, flat_a, aff_s = (t[perm].contiguous()
                                  for t in (pos_s, veff, flat_a, aff_s))
    out["apic_shuffled_state"] = _k6a_case(
        "K6a APIC p2g_scatter_base, the APIC state shuffled inside each "
        "window", tk.masked_weights_cm(pos_s, bound), veff, flat_a, n, aff_s,
        torch)
    del pos_s, veff, flat_a, aff_s, key, perm
    w27t, vel, aff, flat, counts = synthetic.skewed_window_state(
        SEED, n, 20_000, device=dev)
    ws = tk.window_starts(flat, n)
    spans = ws[1:] - ws[:-1]
    print(f"skewed window state: {flat.shape[0]} particles at {n}^3, the "
          f"fullest cell {int(counts.max())}, the longest span "
          f"{int(spans.max())} ids, {int((spans > 0).sum())} of "
          f"{spans.shape[0]} windows occupied, the last one "
          f"{int(spans[-1])} ids")
    for mode, a in (("flip", None), ("apic", aff)):
        out[f"skewed_state_{mode}"] = _k6a_case(
            f"K6a {mode} p2g_scatter_base, the skewed window state", w27t,
            vel, flat, n, a, torch)
    return out


def _k1_order_checks(name, launch, chunked, cs, n, p, torch):
    """A K1 mode on one state: its chunk plan's counts; the plan's device
    time (the work queued before its host read), and how much longer a
    launch that builds its own plan takes than one given the plan, less
    that device time: the card's idle time after the read; the kernels
    against their order in PyTorch (``chunked(plan)``) and a rerun, bit for
    bit; a plan of another ``cell_start`` refused.  ``launch(cs, plan)``
    runs the wrapper.  Returns the plan's times."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    plan = tk.chunk_plan(cs, p)
    per_cell = cs[1:] - cs[:-1]
    chunks = plan.chunk_start[1:] - plan.chunk_start[:-1]
    nch = plan.chunk_first.shape[0] - 1
    nc = launch(cs, plan).shape[0]
    lists_ms = _cuda_ms(lambda: tk._chunk_lists(cs, p), torch)
    given_ms = _cuda_ms(lambda: launch(cs, plan), torch)
    built_ms = _cuda_ms(lambda: launch(cs, None), torch)
    idle_ms = built_ms - given_ms - lists_ms
    print(f"{name}: {p} particles in {int((per_cell > 0).sum())} occupied "
          f"cells (at most {int(per_cell.max())} in one), {nch} chunks of at "
          f"most {tk.CHUNK} ({int((chunks > 1).sum())} cells of several, at "
          f"most {int(chunks.max())} in one; scratch "
          f"{27 * nc * 4 * nch / 1e6:.1f} MB); plan: {lists_ms:.4f} ms of "
          f"device work before its read; a launch building its plan "
          f"{built_ms:.4f} ms against {given_ms:.4f} given it, so the card "
          f"idles {idle_ms:.4f} ms after the read (medians of {_REPS})")
    out = launch(cs, plan)
    _require_bitwise(f"{name}: kernels == their order in PyTorch", out,
                     chunked(plan), torch)
    _require_bitwise(f"{name}: rerun", out, launch(cs, plan), torch)
    try:
        launch(cs.clone(), plan)
    except ValueError:
        print(f"{name}: a plan of another cell_start refused")
    else:
        raise AssertionError(f"{name}: took a plan of another cell_start")
    return {"plan_ms": lists_ms, "plan_idle_ms": idle_ms,
            "with_plan_build_ms": built_ms}


def _flip_sim(dev, mode="flip", sort_method="full", bound=BOUND,
              density=DENSITY):
    """``FlipSim`` of ``water_cube_drop`` from ``SEED`` with the scene's own
    parameters, in ``mode`` with ``sort_method``."""
    from fluidsim_tpu_torch.models.flip import FlipParams, FlipSim
    from fluidsim_tpu_torch.scenes import get_scene

    scene = get_scene("water_cube_drop", bound=bound, density=density)
    params = FlipParams(bound=bound, wall=scene.spec.wall, dx=scene.spec.dx,
                        gravity=tuple(scene.gravity), mode=mode,
                        sort_method=sort_method)
    return FlipSim(scene, params=params, seed=SEED, device=dev)


def _stencil_launches(params):
    """(K3, K4) launches per CG solve start and per CG iteration of the
    frame's projection: one K3 apply, plus the preconditioner's — the
    Chebyshev polynomial's ``cheb_degree - 1`` steps in launches of up to
    ``S_MAX`` (one launch at degrees 3 and 4), or the V-cycle's pre + 1 +
    post = 5 fine-level K3 applies (on a grid that coarsens, as every grid
    here does), or nothing for Jacobi."""
    from fluidsim_tpu_torch.ops import stencil_kernels as sk

    if params.preconditioner == "chebyshev":
        return 1, math.ceil((params.cheb_degree - 1) / sk.S_MAX)
    if params.preconditioner == "multigrid":
        return 6, 0
    return 1, 0


def _run_frames(sim, counted, torch, label=None):
    """Step ``FRAMES`` frames with every launch count set to 0 just before;
    check them and their launch counts; return (energies, launches,
    ms/frame, CG iterations per frame, outer passes per frame)."""
    from fluidsim_tpu_torch.ops import bucket_sort as bs
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    bucket = sim.params.sort_method == "bucket"
    mode = label or (sim.params.mode + ("-bucket" if bucket else ""))
    for fn in counted:
        fn.launches = 0
    tk.chunk_plan.builds = 0
    fallbacks = bs.bucket_or_sort.fallbacks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = [sim.step() for _ in range(FRAMES)]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    fallbacks = bs.bucket_or_sort.fallbacks - fallbacks
    print(f"{mode}: launches in the timed frames:", json.dumps(launches),
          f"K1 chunk plans built: {tk.chunk_plan.builds}")
    if bucket:
        print(f"{mode}: {fallbacks} of {FRAMES} timed frames fell back to "
              "the full sort")
        if fallbacks == FRAMES:
            raise AssertionError(f"{mode}: every timed frame fell back")

    ke = [float(f["kinetic_energy"]) for f in frames]
    cg = [f["cg_iters"] for f in frames]
    outer = [f["outer_iters"] for f in frames]
    print(f"{mode} frames: ke {ke[0]:.6g} .. {ke[-1]:.6g}, cg_iters {cg}, "
          f"outer_iters {outer}, error(last) {float(frames[-1]['error']):.4g}")
    pos = sim.state.pos
    if not all(math.isfinite(k) for k in ke):
        raise AssertionError(f"{mode}: non-finite kinetic energy")
    if not bool(torch.isfinite(pos).all()) or float(pos.abs().max()) >= BOUND:
        raise AssertionError(f"{mode}: particles left the box or went non-finite")
    if sim.state.aff is not None and not bool(torch.isfinite(sim.state.aff).all()):
        raise AssertionError(f"{mode}: non-finite affine matrices")
    last = frames[-1]
    if not (float(last["error"]) <= sim.params.outer_tol
            or last["outer_iters"] < sim.params.max_outer):
        raise AssertionError(f"{mode}: projection did not meet its outer tolerance")
    # PCG: one apply for the initial residual plus one per iteration, and the
    # preconditioner as often
    solves = sum(cg) + sum(outer)
    k3, k4 = _stencil_launches(sim.params)
    gather = "g2p_moments" if sim.params.mode == "apic" else "g2p_gather"
    if bucket:
        scatters = {"p2g_scatter_base": FRAMES, "shift_reduce": FRAMES,
                    "bucket_move": FRAMES - fallbacks}
    elif sim.params.mode == "apic":
        scatters = {"p2g_scatter_affine": FRAMES, "chunk_fill": FRAMES}
    else:
        scatters = {"p2g_scatter": FRAMES, "chunk_fill": FRAMES}
    want = {name: 0 for name in launches}
    want.update({gather: FRAMES, **scatters, "apply_laplacian": k3 * solves,
                 "cheb_steps": k4 * solves})
    if launches != want:
        raise AssertionError(f"{mode}: kernel launches {launches}, expected {want}")
    # one chunk plan per frame, shared by the frame's K1 launch
    if tk.chunk_plan.builds != (0 if bucket else FRAMES):
        raise AssertionError(f"{mode}: {tk.chunk_plan.builds} K1 chunk plans "
                             f"built in {FRAMES} frames")
    print(f"{mode}: per CG iteration (and per solve start) "
          f"{launches['apply_laplacian'] / solves} K3 and "
          f"{launches['cheb_steps'] / solves} K4 launches")
    ms = 1e3 * wall_s / FRAMES
    print(f"{mode}: ms/frame {ms:.3f}  steps/s {FRAMES / wall_s:.3f}  "
          f"CG iterations/frame {sum(cg) / FRAMES:.1f}  outer passes/frame "
          f"{sum(outer) / FRAMES:.1f} ({FRAMES} frames, host clock, "
          "synchronised)")
    return ke, launches, ms, cg, outer


def _rerun(mode, kes, dev, sort_method="full"):
    """Determinism: the first frames rerun from the seed give the same
    kinetic energies, bit for bit."""
    k = min(3, len(kes))
    rerun = _flip_sim(dev, mode, sort_method)
    ke2 = [float(rerun.step()["kinetic_energy"]) for _ in range(k)]
    if ke2 != kes[:k]:
        raise AssertionError(f"{mode} {sort_method}: rerun energies {ke2} "
                             f"!= {kes[:k]}")
    print(f"{mode} {sort_method} determinism: {k} frames rerun from seed "
          f"{SEED}: bit-identical kinetic energy {ke2}")


def _small_scene(mode, dev, sort_method="full", bound=8, density=3.0):
    """A small scene, 3 frames on the card against 3 on the CPU."""
    _card_against_cpu(
        f"{mode} {sort_method}", bound,
        lambda d: _flip_sim(d, mode, sort_method, bound, density), dev)


def _card_against_cpu(mode, bound, make_sim, dev):
    """3 frames of ``make_sim(dev)`` against 3 of ``make_sim("cpu")``."""
    gpu_sim, cpu_sim = make_sim(dev), make_sim("cpu")
    # f32 sums in another order may move CG's stopping test by one iteration
    # in a pass; the outer passes, the energy and the positions must agree
    for f in range(3):
        mg, mc = gpu_sim.step(), cpu_sim.step()
        kg, kc = float(mg["kinetic_energy"]), float(mc["kinetic_energy"])
        print(f"reference {mode} frame {f}: card ke {kg:.7g} outer "
              f"{mg['outer_iters']} cg {mg['cg_iters']} | cpu ke {kc:.7g} "
              f"outer {mc['outer_iters']} cg {mc['cg_iters']}")
        if (abs(kg - kc) > 1e-4 * abs(kc)
                or mg["outer_iters"] != mc["outer_iters"]
                or abs(mg["cg_iters"] - mc["cg_iters"]) > mc["outer_iters"]):
            raise AssertionError(f"small scene {mode} frame {f}: card and "
                                 "cpu differ")
    pos_err = _max_err(gpu_sim.state.pos.cpu(), cpu_sim.state.pos)
    if pos_err > 1e-3:
        raise AssertionError(f"small scene {mode}: positions differ by {pos_err}")
    msg = f"max pos diff card vs cpu {pos_err:.3e}"
    if cpu_sim.params.mode == "apic":
        aff_err = _max_err(gpu_sim.state.aff.cpu(), cpu_sim.state.aff)
        if aff_err > 1e-3:
            raise AssertionError(f"small scene apic: aff differs by {aff_err}")
        msg += f", max aff diff {aff_err:.3e}"
    print(f"reference {mode}: bound {bound}, {cpu_sim.num_particles} "
          f"particles, 3 frames, {msg}")


def _cone_inputs(sim, label, torch):
    """What phase 10's kernels read on the sorted state of the MPM sim
    ``sim``: (sorted velocities, cell ids, the (27, P) weights, the (81, P)
    gradW, cell starts, the mass grid, the grid velocity, the force
    scatter's per-particle (P, 9) matrices -V P0 FE^T)."""
    from fluidsim_tpu_torch.core.splines import cround
    from fluidsim_tpu_torch.ops import mpm_kernels as mk
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.ops.svd3 import (det3, hardening, mm3,
                                             piola_linearized)

    prm, st = sim.params, sim.state
    B, n, P = prm.bound, 2 * prm.bound + 1, sim.num_particles
    pos_s, vel_s, fe, fp, vol, flat = mk.sort_mpm(st.pos, st.vel, st.FE,
                                                  st.FP, st.volume, B)
    w27t, gradw = mk.mpm_stencil(pos_s, B)
    cs = tk.cell_starts(flat, n)
    mass, mom = mk.p2g_mpm(w27t, vel_s, cs, sim.solid, B)
    heavy = mass > prm.mass_threshold
    velg = torch.where(heavy[None], mom / torch.where(heavy, mass, 1.0)[None],
                       0.0)
    mu, lam = hardening(prm.mu0, prm.lam0, prm.hardening_eps, det3(fp),
                        exponent_cap=prm.hardening_max)
    p0, _, _ = piola_linearized(fe, mu, lam)
    valid = torch.all(torch.abs(cround(pos_s)) <= B, dim=-1)
    m9 = (torch.where(valid, -vol, 0.0)[:, None]
          * mm3(p0, fe.transpose(-1, -2)).reshape(P, 9)).contiguous()
    print(f"{label}: {int(heavy.sum())} cells above the mass threshold, "
          f"max|M| {float(m9.abs().max()):.4g}, "
          f"max|velg| {float(velg.abs().max()):.4g}")
    return vel_s, flat, w27t, gradw, cs, mass, velg, m9


def _mpm_solves(m, params):
    """The number of CG solves of an MPM frame, and whether the solve its
    velocity came from converged before its cap."""
    from fluidsim_tpu_torch.models.mpm import frame_solves

    return frame_solves(params, m["cg_iters"], m["spd_fallback"])


def _run_mpm_frames(sim, counted, torch, label="mpm"):
    """Step ``FRAMES`` MPM frames with every launch count set to 0 just
    before; check them and their launch counts; return (energies,
    launches, CG iterations per frame, ms/frame, SPD fallbacks per
    frame)."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    for fn in counted:
        fn.launches = 0
    tk.chunk_plan.builds = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = [sim.step() for _ in range(FRAMES)]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"{label}: launches in the timed frames:", json.dumps(launches),
          f"K1 chunk plans built: {tk.chunk_plan.builds}")

    ke = [float(f["kinetic_energy"]) for f in frames]
    cg = [f["cg_iters"] for f in frames]
    spd = [f["spd_fallback"] for f in frames]
    print(f"{label} frames: ke {ke[0]:.6g} .. {ke[-1]:.6g}, cg_iters {cg}, "
          f"spd_fallback {spd}, min_det_fp(last) "
          f"{float(frames[-1]['min_det_fp']):.6g}")
    st = sim.state
    if not all(math.isfinite(k) for k in ke):
        raise AssertionError(f"{label}: non-finite kinetic energy")
    if (not bool(torch.isfinite(st.pos).all())
            or float(st.pos.abs().max()) >= MPM_BOUND):
        raise AssertionError(f"{label}: particles left the box or went non-finite")
    if not all(bool(torch.isfinite(f).all()) for f in (st.FE, st.FP)):
        raise AssertionError(f"{label}: non-finite deformation gradients")
    if not all(float(f["min_det_fp"]) > 0 for f in frames):
        raise AssertionError(f"{label}: det(FP) <= 0")
    applies = 0
    for f, m in enumerate(frames):
        solves, converged = _mpm_solves(m, sim.params)
        if not converged:
            raise AssertionError(f"{label} frame {f}: the solve stopped at its cap")
        # one apply for each solve's initial residual plus one per iteration
        applies += m["cg_iters"] + solves
    want = {name: 0 for name in launches}
    # the FLIP spline's mass and momentum are two K1 a frame (the mass on
    # the positive weights); the Jacobi preconditioner's stiffness scatter
    # is one more
    k1 = ((2 if sim.params.kernel == "flip" else 1)
          + (1 if sim.params.precond == "jacobi" else 0))
    want.update({"p2g_scatter": k1 * FRAMES, "g2p_gather": 2 * FRAMES,
                 "p2g_scatter_force": FRAMES + applies,
                 "g2p_gather_gw": applies + FRAMES, "chunk_fill": FRAMES})
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {want}")
    # K1 and every K1 fg launch of a frame share the frame's one plan
    if tk.chunk_plan.builds != FRAMES:
        raise AssertionError(f"{label}: {tk.chunk_plan.builds} K1 chunk plans "
                             f"built in {FRAMES} frames")
    print(f"{label}: ms/frame {1e3 * wall_s / FRAMES:.3f}  steps/s "
          f"{FRAMES / wall_s:.3f}  CG iterations/frame {sum(cg) / FRAMES:.1f} "
          f"({FRAMES} frames, host clock, synchronised)")
    return ke, launches, cg, 1e3 * wall_s / FRAMES, spd


def _mpm_small_scene(hessian, dev, precond="none", kernel="mpm"):
    """``mpm_cone`` at bound 15, 3 frames on the card against 3 on the CPU,
    on the transfer spline ``kernel``."""
    from fluidsim_tpu_torch.models.mpm import MpmParams, MpmSim

    params = MpmParams(hessian=hessian, precond=precond, kernel=kernel,
                       cg_hybrid_cap=1 if hessian == "hybrid" else 150)
    name = (f"mpm {hessian}" + ("" if precond == "none" else f" {precond}")
            + ("" if kernel == "mpm" else f" {kernel} spline"))
    gpu_sim = MpmSim("mpm_cone", params=params, seed=SEED, device=dev,
                     **MPM_SMALL)
    cpu_sim = MpmSim("mpm_cone", params=params, seed=SEED, device="cpu",
                     **MPM_SMALL)
    fallbacks = 0
    for f in range(3):
        mg, mc = gpu_sim.step(), cpu_sim.step()
        kg, kc = float(mg["kinetic_energy"]), float(mc["kinetic_energy"])
        print(f"reference {name} frame {f}: card ke {kg:.7g} cg "
              f"{mg['cg_iters']} spd {mg['spd_fallback']} | cpu ke {kc:.7g} "
              f"cg {mc['cg_iters']} spd {mc['spd_fallback']}")
        solves, _ = _mpm_solves(mc, params)
        # on the FLIP spline the solve's count moves with last-bit
        # differences in the sums (66 here against 68 on the CPU at frame
        # 2), so it is held within 5%, as tests/test_torch_mpm_spline.py
        # holds the CPU to JAX
        cg_tol = (solves if kernel == "mpm"
                  else max(solves, math.ceil(0.05 * mc["cg_iters"])))
        if (abs(kg - kc) > 1e-4 * abs(kc)
                or int(mg["num_active_cells"]) != int(mc["num_active_cells"])
                or mg["spd_fallback"] != mc["spd_fallback"]
                or abs(mg["cg_iters"] - mc["cg_iters"]) > cg_tol):
            raise AssertionError(f"{name} frame {f}: card and cpu differ")
        fallbacks += mc["spd_fallback"]
    if hessian == "hybrid" and fallbacks == 0:
        raise AssertionError("mpm hybrid cap 1: no frame took the SPD fallback")
    pos_err = _max_err(gpu_sim.state.pos.cpu(), cpu_sim.state.pos)
    fe_err = _max_err(gpu_sim.state.FE.cpu(), cpu_sim.state.FE)
    if pos_err > 1e-4 or fe_err > 1e-5:
        raise AssertionError(f"{name}: positions differ by {pos_err}, "
                             f"FE by {fe_err}")
    print(f"reference {name}: bound 15, 3 frames, max pos diff card vs "
          f"cpu {pos_err:.3e}, max FE diff {fe_err:.3e}")


def _shift_onehots(dev, torch):
    """The one-hot conv3d weights of the 27-offset stencils (conv3d is a
    cross-correlation): expand (108, 4, 3, 3, 3), ``out[4o + g, cell] =
    in[g, cell + off_o]``, and reduce (4, 108, 3, 3, 3), ``out[g, cell] =
    sum_o in[4o + g, cell - off_o]``."""
    from fluidsim_tpu_torch.ops.transfer import _OFFSETS

    expand = torch.zeros((108, 4, 3, 3, 3), device=dev)
    for o, off in enumerate(_OFFSETS):
        for g in range(4):
            expand[4 * o + g, g, 1 + off[0], 1 + off[1], 1 + off[2]] = 1.0
    return expand, expand.transpose(0, 1).flip(2, 3, 4).contiguous()


def _k10b_bitwise(fm_rows, n, torch):
    """K10b on the (n, n, n, 4) field ``fm_rows``, bit for bit against both
    of its plain versions and K7b's (27, 4, n, n, n) table transposed."""
    from fluidsim_tpu_torch.ops import shift
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    out = shift.g2p_table_expand(fm_rows, n)
    k7b = tk.shift_expand(fm_rows.permute(3, 0, 1, 2).contiguous())
    for name, ref in (
            ("g2p_table_expand_rows_plain",
             shift.g2p_table_expand_rows_plain(fm_rows, n)),
            ("g2p_table_expand_plain", shift.g2p_table_expand_plain(fm_rows, n)),
            ("K7b's table transposed", k7b.view(108, n ** 3).T)):
        _require_bitwise(f"K10b at {n}^3 against {name}", out, ref, torch)


def _k9a_case(name, w27t, vel, flat, n, aff, torch, timed=True):
    """K9a on one fully sorted state (``aff``: its APIC instance): against
    its plain version and ``index_add_`` of the prebuilt (P, 108) rows,
    timed as in phase 3 (``timed``), then bit for bit against K6a, its
    summation order in PyTorch (``p2g_scatter_base_ordered``) and a rerun;
    its tile plan against ``span_tile_starts_plain`` and its flag 0.
    Returns the line's numbers (with ``timed``; ``ms`` is its kernels'
    time, ``_kernels_ms``)."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    p = flat.shape[0]
    launch = lambda: tk.p2g_scatter_spans(w27t, vel, flat, n, aff)
    res = None
    if timed:
        u108 = tk._wv_values(w27t, vel, aff).reshape(p, 108)
        flat64 = flat.to(torch.int64)
        res = _compare(
            name, launch,
            lambda: tk.p2g_scatter_base_plain(w27t, vel, flat, n, aff), 1e-5,
            (w27t, vel, flat) + (() if aff is None else (aff,)),
            27 * (7 if aff is None else 25) * p, torch,
            library=lambda: torch.zeros((n ** 3, 108), device=flat.device)
            .index_add_(0, flat64, u108))
        _kernels_ms(name, res, lambda: tk.p2g_scatter_spans_launch(
            w27t, vel, flat, n, aff), torch)
        del u108, flat64
    out = launch()
    k6a = tk.p2g_scatter_base(w27t, vel, flat, tk.window_starts(flat, n), n,
                              aff)
    _require_bitwise(f"{name}: against K6a", out, k6a, torch)
    del k6a
    _require_bitwise(f"{name}: against p2g_scatter_base_ordered", out,
                     tk.p2g_scatter_base_ordered(w27t, vel, flat, n, aff),
                     torch)
    again, tile_start, flag = tk.p2g_scatter_spans_launch(w27t, vel, flat, n,
                                                          aff)
    _require_bitwise(f"{name}: against its rerun", out, again, torch)
    _require_bitwise(f"{name}: tile plan against span_tile_starts_plain",
                     tile_start, tk.span_tile_starts_plain(flat, n ** 3),
                     torch)
    if int(flag) != 0 or int(tk.span_order_flag_plain(flat, n ** 3)) != 0:
        raise AssertionError(f"{name}: order flag set on a sorted state")
    tiles = tile_start[1:] - tile_start[:-1]
    print(f"{name}: {p} particles at {n}^3, {int((tiles > 0).sum())} of "
          f"{tiles.numel()} tiles occupied, the fullest {int(tiles.max())} "
          "particles")
    return res


def _kernels_ms(name, res, launch, torch):
    """Make ``res["ms"]`` the time of a K9 wrapper's kernels alone
    (``launch`` queues them and reads nothing) and keep the wrapper's, which
    ends with its wait on the host, as ``res["wrapper_ms"]``."""
    res["wrapper_ms"] = res["ms"]
    res["ms"] = _cuda_ms(launch, torch)
    print(f"time {name}: its kernels {res['ms']:.4f} ms, the wrapper with its "
          f"wait on the host {res['wrapper_ms']:.4f} ms (medians of {_REPS})")


def _k9b_staged_blocks(flat, torch) -> int:
    """How many of K9b's 256-particle blocks of the sorted ids ``flat`` span
    at most 32 cells and so stage their table columns (kSpanStageCells in
    csrc/transfer.cu)."""
    first = flat[::256]
    ends = torch.arange(1, first.shape[0] + 1, device=flat.device) * 256
    last = flat[ends.clamp(max=flat.shape[0]) - 1]
    return int((last - first < 32).sum())


def _k9_refusals(w27t, vel, flat, table, n, torch):
    """K9a and K9b on an order that is not sorted and on an id outside the
    box: each raises ValueError on the card, its flag matching
    ``span_order_flag_plain``; a correct call right after each still gives
    the sorted state's result bit for bit."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    n3 = n ** 3
    good_a = tk.p2g_scatter_spans(w27t, vel, flat, n)
    good_b = tk.g2p_gather_spans(table, w27t, flat)
    g = torch.Generator(device=flat.device).manual_seed(SEED)
    shuffled = flat[torch.randperm(flat.shape[0], generator=g,
                                   device=flat.device)]
    outside = flat.clone()
    outside[-1] = n3
    for tag, bad in (("an unsorted order", shuffled),
                     ("an id of n^3", outside)):
        flags = (tk.p2g_scatter_spans_launch(w27t, vel, bad, n)[2],
                 tk.g2p_gather_spans_launch(table, w27t, bad)[1])
        torch.cuda.synchronize()
        want = int(tk.span_order_flag_plain(bad, n3))
        if want != 1 or any(int(f) != want for f in flags):
            raise AssertionError(f"K9 on {tag}: flags "
                                 f"{[int(f) for f in flags]}, plain {want}")
        for name, call, good in (
                ("K9a", lambda: tk.p2g_scatter_spans(w27t, vel, bad, n),
                 (lambda: tk.p2g_scatter_spans(w27t, vel, flat, n), good_a)),
                ("K9b", lambda: tk.g2p_gather_spans(table, w27t, bad),
                 (lambda: tk.g2p_gather_spans(table, w27t, flat), good_b))):
            try:
                call()
            except ValueError as e:
                print(f"{name} on {tag}: raised ValueError ({e})")
            else:
                raise AssertionError(f"{name} on {tag}: no ValueError")
            _require_bitwise(f"{name}, a sorted call after {tag}", good[0](),
                             good[1], torch)


def _k9_phase(state, apic_state, dev, torch):
    """Phase 20's span kernels on the frame-2 FLIP state (``state``): what
    the old route spent (the host check, then K6a or K7a), K9a and K9b
    against their plain versions, K6a and K7a, K2 and K2 moments, what each
    wrapper queues before its host wait against its kernels, K9a on phase
    6's APIC
    state, on ``utils/synthetic.skewed_window_state`` sorted by cell and on
    random states at 25^3 and 45^3, K9b there too, and both refusing bad
    orders.  Returns the two kernels' results."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.utils import synthetic

    w27t, vel_s, flat, fm = (state[k] for k in ("w27t", "vel_s", "flat", "fm"))
    B = state["bound"]
    n, P = 2 * B + 1, flat.shape[0]
    table = tk.shift_expand(fm)
    ws = tk.window_starts(flat, n)
    old = {"host check and read": lambda: bool((flat[1:] >= flat[:-1]).all()),
           "window_starts + K6a": lambda: tk.p2g_scatter_base(
               w27t, vel_s, flat, tk.window_starts(flat, n), n),
           "K6a": lambda: tk.p2g_scatter_base(w27t, vel_s, flat, ws, n),
           "K7a": lambda: tk.g2p_gather_table(table, w27t, flat),
           "K7a moments": lambda: tk.g2p_moments_table(table, w27t, flat)}
    for name, fn in old.items():
        print(f"time the old K9 route's {name}: {_cuda_ms(fn, torch):.4f} ms "
              f"(median of {_REPS})")
    res_a = _k9a_case("K9a p2g_scatter_spans", w27t, vel_s, flat, n, None,
                      torch)
    res_b = _compare(
        "K9b g2p_gather_spans", lambda: tk.g2p_gather_spans(table, w27t, flat),
        lambda: tk.g2p_gather_table_plain(table, w27t, flat), 1e-5,
        (w27t, flat), 27 * 8 * P, torch, extra_bytes=432 * state["cells"])
    _kernels_ms("K9b g2p_gather_spans", res_b,
                lambda: tk.g2p_gather_spans_launch(table, w27t, flat), torch)
    res_b["moments"] = _compare(
        "K9b moments g2p_gather_spans",
        lambda: tk.g2p_gather_spans(table, w27t, flat, True),
        lambda: tk.g2p_moments_table_plain(table, w27t, flat), 1e-5,
        (w27t, flat), 27 * 44 * P, torch, extra_bytes=432 * state["cells"])
    _kernels_ms("K9b moments g2p_gather_spans", res_b["moments"],
                lambda: tk.g2p_gather_spans_launch(table, w27t, flat, True),
                torch)
    for tag, mom, k7a, k2 in (("", False, tk.g2p_gather_table, tk.g2p_gather),
                              (" moments", True, tk.g2p_moments_table,
                               tk.g2p_moments)):
        out = tk.g2p_gather_spans(table, w27t, flat, mom)
        _require_bitwise(f"K9b{tag}: against K7a{tag}", out,
                         k7a(table, w27t, flat), torch)
        _require_bitwise(f"K9b{tag}: against K2{tag}", out, k2(fm, w27t, flat),
                         torch)
    print(f"K9b: {_k9b_staged_blocks(flat, torch)} of {-(-P // 256)} blocks "
          "of the frame-2 FLIP state stage their table columns")
    # the wrappers' host read comes after the launch: what each queues
    # before it waits on the host takes its kernels' time
    for name, res, wrapper in (
            ("K9a", res_a, lambda: tk.p2g_scatter_spans(w27t, vel_s, flat, n)),
            ("K9b", res_b, lambda: tk.g2p_gather_spans(table, w27t, flat)),
            ("K9b moments", res_b["moments"],
             lambda: tk.g2p_gather_spans(table, w27t, flat, True))):
        res["queued_ms"] = _queued_ms(wrapper, torch)
        gap = abs(res["queued_ms"] - res["ms"])
        print(f"time {name}: the wrapper queues {res['queued_ms']:.4f} ms "
              f"before its wait, its kernels take {res['ms']:.4f} ms "
              f"(medians of {_REPS})")
        if gap > 0.02:
            raise AssertionError(f"{name}: the wrapper queues {gap:.4f} ms "
                                 "apart from its kernels before it waits "
                                 "(limit 0.02): a host read before the launch")
    _k9_refusals(w27t, vel_s, flat, table, n, torch)
    del table, ws

    pos_a, veff, flat_a, aff_a = apic_state
    res_a["apic_state"] = _k9a_case(
        "K9a APIC p2g_scatter_spans, the APIC state",
        tk.masked_weights_cm(pos_a, B), veff, flat_a, n, aff_a, torch)
    w_k, v_k, aff_k, flat_k, counts = synthetic.skewed_window_state(
        SEED, n, 20_000, device=dev)
    flat_k, perm = torch.sort(flat_k, stable=True)
    w_k, v_k, aff_k = (w_k[:, perm].contiguous(), v_k[perm].contiguous(),
                       aff_k[perm].contiguous())
    print(f"skewed state sorted by cell: {flat_k.shape[0]} particles at "
          f"{n}^3, the fullest cell {int(counts.max())}")
    for mode, a in (("flip", None), ("apic", aff_k)):
        res_a[f"skewed_state_{mode}"] = _k9a_case(
            f"K9a {mode} p2g_scatter_spans, the skewed state", w_k, v_k,
            flat_k, n, a, torch)
    del w_k, v_k, aff_k, flat_k, perm
    g = torch.Generator(device=dev).manual_seed(SEED)
    for m in (25, 45):         # m^3 not a multiple of the tile
        p = 2 * m ** 3
        flat_r = torch.sort(torch.randint(0, m ** 3, (p,), generator=g,
                                          device=dev, dtype=torch.int32))[0]
        w_r = torch.rand((27, p), generator=g, device=dev)
        v_r = torch.randn((p, 3), generator=g, device=dev)
        aff_r = 0.5 * torch.randn((p, 9), generator=g, device=dev)
        for mode, a in (("flip", None), ("apic", aff_r)):
            _k9a_case(f"K9a {mode}, random at {m}^3", w_r, v_r, flat_r, m, a,
                      torch, timed=False)
        # 2 particles a cell: a full block of 256 spans about 128 cells, so
        # K9b reads the table directly in all but a short last block
        staged, blocks = _k9b_staged_blocks(flat_r, torch), -(-p // 256)
        if staged > 1:
            raise AssertionError(f"K9b at {m}^3: {staged} of {blocks} random "
                                 "blocks stage; the direct reads go untested")
        fm_r = torch.randn((4, m, m, m), generator=g, device=dev)
        table_r = tk.shift_expand(fm_r)
        for tag, mom, k7a, k2 in (("", False, tk.g2p_gather_table,
                                   tk.g2p_gather),
                                  (" moments", True, tk.g2p_moments_table,
                                   tk.g2p_moments)):
            out = tk.g2p_gather_spans(table_r, w_r, flat_r, mom)
            _require_bitwise(f"K9b{tag}, random at {m}^3: against K7a{tag}",
                             out, k7a(table_r, w_r, flat_r), torch)
            _require_bitwise(f"K9b{tag}, random at {m}^3: against K2{tag}",
                             out, k2(fm_r, w_r, flat_r), torch)
        print(f"K9b, random at {m}^3: {blocks - staged} of {blocks} blocks "
              "read the table directly, equal to K7a and K2 (and moments) "
              "bit for bit")
    return {"p2g_scatter_spans": res_a, "g2p_gather_spans": res_b}


def _materialised_phases(dev, counted, torch, apic_state):
    """Phases 18-20 on the sorted state of ``FlipSim`` after its 2 warm-up
    frames: the materialised G2P's kernels (K7b, K7a), the materialised G2P
    against the fused one, and the span and unhaloed shift entry points
    (K9, K10; K9a also on phase 6's sorted APIC state ``apic_state``).
    Returns (results, launches of the materialised G2P,
    launches of the entry points)."""
    from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm
    from fluidsim_tpu_torch.ops import apic, shift
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm

    F = torch.nn.functional
    torch.backends.cudnn.allow_tf32 = False
    sim = _flip_sim(dev)
    for _ in range(2):
        sim.step()
    st = sim.state
    B, wall, P = sim.params.bound, sim.params.wall, sim.num_particles
    n = 2 * B + 1
    n3 = n ** 3
    del sim
    pos_s, vel_s, flat = tk.sort_by_cell(st.pos, st.vel, B)
    w27t = tk.masked_weights_cm(pos_s, B)
    acc = tk.p2g_scatter(w27t, vel_s, tk.cell_starts(flat, n), n)
    vc = cell_center_velocity_cm(normalize_velocity_cm(acc[0], acc[1:4]))
    fm = tk.gather_fields(vc, B, wall)
    cells = int(torch.unique_consecutive(flat).numel())
    print(f"materialised G2P state: frame-2 FLIP state, {P} particles in "
          f"{cells} distinct base cells of {n}^3")
    results = {}

    # ---- 18. K7b and K7a against their plain versions ---------------------
    onehot, onehot_r = _shift_onehots(dev, torch)
    conv = lambda: F.conv3d(fm.view(1, 4, n, n, n), onehot, padding=1)
    results["shift_expand"] = _compare(
        "K7b shift_expand", lambda: tk.shift_expand(fm),
        lambda: tk.shift_expand_plain(fm), 0.0, (fm,), 0, torch,
        library=conv)
    table = tk.shift_expand(fm)
    print(f"K7b library conv3d: max |conv3d - kernel| "
          f"{_max_err(conv()[0], table.view(108, n, n, n)):.3e}")
    # the sorted particles of one cell read its 108 table values once
    per_cell = 432 * cells
    results["g2p_gather_table"] = _compare(
        "K7a g2p_gather_table", lambda: tk.g2p_gather_table(table, w27t, flat),
        lambda: tk.g2p_gather_table_plain(table, w27t, flat), 1e-5,
        (w27t, flat), 27 * 8 * P, torch, extra_bytes=per_cell)
    results["g2p_moments_table"] = _compare(
        "K7a moments g2p_moments_table",
        lambda: tk.g2p_moments_table(table, w27t, flat),
        lambda: tk.g2p_moments_table_plain(table, w27t, flat), 1e-5,
        (w27t, flat), 27 * 44 * P, torch, extra_bytes=per_cell)
    flat64 = flat.to(torch.int64)
    gather_half = _cuda_ms(
        lambda: table.view(108, n3).index_select(1, flat64), torch)
    print(f"K7a gather half: index_select of the 108 table rows at the "
          f"particles' base cells {gather_half:.4f} ms (median of {_REPS})")
    for name, k2, k7 in (
            ("K2", tk.g2p_gather(fm, w27t, flat),
             tk.g2p_gather_table(table, w27t, flat)),
            ("K2 moments", tk.g2p_moments(fm, w27t, flat),
             tk.g2p_moments_table(table, w27t, flat))):
        if not torch.equal(k2, k7):
            raise AssertionError(f"K7a differs from {name}: "
                                 f"{_max_err(k2, k7):.3e}")
    print("K7a: equal to K2 and K2 moments on the same state, bit for bit")
    del table, flat64

    # ---- 19. the materialised G2P against the fused one -------------------
    for fn in counted:
        fn.launches = 0
    mat = (tk.g2p(w27t, flat, vc, B, wall, fused_table=False),
           *apic.g2p_apic(w27t, flat, pos_s, vc, B, wall, fused_table=False))
    torch.cuda.synchronize()
    table_launches = {fn.__name__: fn.launches for fn in counted}
    print("g2p_materialised: launches:", json.dumps(table_launches))
    want = {name: 0 for name in table_launches}
    want.update({"shift_expand": 2, "g2p_gather_table": 1,
                 "g2p_moments_table": 1})
    if table_launches != want:
        raise AssertionError(f"g2p_materialised: launches {table_launches}, "
                             f"expected {want}")
    fused = (tk.g2p(w27t, flat, vc, B, wall),
             *apic.g2p_apic(w27t, flat, pos_s, vc, B, wall))
    for name, a, b in zip(("g2p velocity", "g2p_apic velocity",
                           "g2p_apic C"), mat, fused):
        if not (torch.equal(a, b) and bool(torch.isfinite(a).all())):
            raise AssertionError(f"{name}: fused_table=False differs from "
                                 f"fused_table=True by {_max_err(a, b):.3e}")
    print(f"g2p_materialised: g2p and g2p_apic with fused_table=False equal "
          f"fused_table=True bit for bit on {P} particles at {n}^3")
    for mode, fn in (
            ("g2p", lambda t: tk.g2p(w27t, flat, vc, B, wall, fused_table=t)),
            ("g2p_apic", lambda t: apic.g2p_apic(w27t, flat, pos_s, vc, B,
                                                 wall, fused_table=t))):
        ms = {t: _cuda_ms(lambda: fn(t), torch) for t in (True, False)}
        print(f"time {mode}: fused_table=True {ms[True]:.4f} ms, "
              f"fused_table=False {ms[False]:.4f} ms (median of {_REPS})")
    del mat, fused, acc, vc

    # ---- 20. the span and unhaloed shift entry points ---------------------
    results.update(_k9_phase(dict(w27t=w27t, vel_s=vel_s, flat=flat, fm=fm,
                                  cells=cells, bound=B), apic_state, dev,
                             torch))
    d = tk.p2g_scatter_base(w27t, vel_s, flat, tk.window_starts(flat, n), n)
    table = tk.shift_expand(fm)

    d_rows = d.view(108, n3).T.contiguous()                     # (n^3, 108)
    conv_in = d_rows.view(1, n, n, n, 108).permute(0, 4, 1, 2, 3)
    results["p2g_shift_reduce"] = _compare(
        "K10a p2g_shift_reduce", lambda: shift.p2g_shift_reduce(d_rows, n),
        lambda: shift.p2g_shift_reduce_plain(d_rows, n), 0.0, (d_rows,),
        27 * 4 * n3, torch,
        library=lambda: F.conv3d(conv_in, onehot_r, padding=1))
    red = shift.p2g_shift_reduce(d_rows, n)
    for name, ref in (
            ("p2g_shift_reduce_rows_plain",
             shift.p2g_shift_reduce_rows_plain(d_rows, n)),
            ("p2g_shift_reduce_plain", shift.p2g_shift_reduce_plain(d_rows, n)),
            ("K6b", tk.shift_reduce(d).permute(1, 2, 3, 0))):
        _require_bitwise(f"K10a against {name}", red, ref, torch)
    fm_rows = fm.permute(1, 2, 3, 0).contiguous()               # (n, n, n, 4)
    fm_in = fm_rows.view(1, n, n, n, 4).permute(0, 4, 1, 2, 3)
    results["g2p_table_expand"] = _compare(
        "K10b g2p_table_expand", lambda: shift.g2p_table_expand(fm_rows, n),
        lambda: shift.g2p_table_expand_plain(fm_rows, n), 0.0, (fm_rows,), 0,
        torch, library=lambda: F.conv3d(fm_in, onehot, padding=1))
    _k10b_bitwise(fm_rows, n, torch)
    g = torch.Generator(device=dev).manual_seed(SEED)
    for m in (25, 45):          # m^3 not a multiple of the kernel's block
        _k10b_bitwise(torch.randn((m, m, m, 4), generator=g, device=dev), m,
                      torch)
    print("K10a, K10b: equal to K6b and K7b in the row layout, bit for bit")
    del red, table, d, conv_in, fm_in

    results["to_channel_major"] = _compare(
        "K10c to_channel_major", lambda: shift.to_channel_major(d_rows),
        lambda: shift.to_channel_major_plain(d_rows), 0.0, (d_rows,), 0,
        torch, library=lambda: d_rows.T.contiguous())
    y = shift.to_channel_major(d_rows)
    if not (torch.equal(y[:, :n3], d_rows.T) and not y[:, n3:].any()):
        raise AssertionError("K10c differs from .T.contiguous()")
    results["from_channel_major"] = _compare(
        "K10d from_channel_major", lambda: shift.from_channel_major(y, n3),
        lambda: shift.from_channel_major_plain(y, n3), 0.0, (y,), 0, torch,
        library=lambda: y.T.contiguous())
    if not torch.equal(shift.from_channel_major(y, n3), d_rows):
        raise AssertionError("K10d differs from .T.contiguous()")
    print(f"K10c, K10d: a ({n3}, 108) matrix to ({y.shape[0]}, {y.shape[1]}) "
          "and back, equal to .T.contiguous() bit for bit")
    table = tk.shift_expand(fm)

    for fn in counted:
        fn.launches = 0
    tk.p2g_scatter_spans(w27t, vel_s, flat, n)
    tk.g2p_gather_spans(table, w27t, flat)
    shift.p2g_shift_reduce(d_rows, n)
    shift.g2p_table_expand(fm_rows, n)
    shift.from_channel_major(shift.to_channel_major(d_rows), n3)
    torch.cuda.synchronize()
    entry_launches = {fn.__name__: fn.launches for fn in counted}
    print("shift_entry_points: launches:", json.dumps(entry_launches))
    want = {name: 0 for name in entry_launches}
    want.update({"p2g_scatter_spans": 1, "g2p_gather_spans": 1,
                 "p2g_shift_reduce": 1, "g2p_table_expand": 1,
                 "to_channel_major": 1, "from_channel_major": 1})
    if entry_launches != want:
        raise AssertionError(f"shift_entry_points: launches {entry_launches}, "
                             f"expected {want}")
    state = dict(pos_s=pos_s, vel_s=vel_s, flat=flat, w27t=w27t, fm=fm,
                 bound=B, wall=wall, cells=cells)
    return results, table_launches, entry_launches, state


def _k8b_more_states(u_rows, flat, n, dev, torch):
    """K8b on ``utils/synthetic.skewed_row_state`` at n^3 (20,000 rows in
    one cell) against its plain version and ``index_add_``, timed as in
    phase 3, and bit for bit against the plain version on the CPU, whose
    ``index_add_`` adds each cell's rows in array order; then one call on
    ``u_rows`` with ``flat`` shuffled, which must not fault (the result is
    undefined).  Returns the skewed state's numbers."""
    from fluidsim_tpu_torch.ops import rows as rw
    from fluidsim_tpu_torch.utils import synthetic

    n3 = n ** 3
    rows, flat_k, counts = synthetic.skewed_row_state(SEED, n, 20_000,
                                                      device=dev)
    p = flat_k.shape[0]
    print(f"skewed row state: {p} rows at {n}^3, the fullest cell "
          f"{int(counts.max())}, {int((counts > 0).sum())} cells occupied")
    flat64 = flat_k.to(torch.int64)
    res = _compare(
        "K8b scatter_rows_cm, the skewed row state",
        lambda: rw.scatter_rows_cm(rows, flat_k, n3),
        lambda: rw.scatter_rows_cm_plain(rows, flat_k, n3), 1e-5,
        (rows[:p], flat_k), 128 * p, torch,
        library=lambda: torch.zeros((128, n3), device=dev).t().index_add_(
            0, flat64, rows[:p]))
    _require_bitwise(
        "K8b, the skewed row state: against the plain version on the CPU",
        rw.scatter_rows_cm(rows, flat_k, n3).cpu(),
        rw.scatter_rows_cm_plain(rows.cpu(), flat_k.cpu(), n3), torch)
    del rows, flat_k, flat64
    g = torch.Generator(device=dev).manual_seed(SEED)
    shuffled = flat[torch.randperm(flat.shape[0], generator=g, device=dev)]
    rw.scatter_rows_cm(u_rows, shuffled, n3)
    torch.cuda.synchronize()
    print("K8b on an order that is not sorted: no fault")
    return {"skewed_state": res}


def _row_phases(dev, torch, state):
    """Phase 21 on the frame-2 FLIP state of phases 18-20: K8a and K8b
    against their plain versions and one PyTorch call, the row transfers
    against K6a, K6b, K7a and K2 bit for bit, and both kernels on
    sweep_transfer's inputs.  Returns the kernels' results."""
    from fluidsim_tpu_torch.ops import rows as rw
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.utils import transfer_parts as tparts

    st = tparts.RowState(state["pos_s"], state["vel_s"], state["flat"],
                         state["w27t"], state["bound"], state["wall"])
    flat, fm = st.flat, state["fm"]
    n, P = st.n, st.flat.shape[0]
    n3 = n ** 3
    flat64 = flat.to(torch.int64)
    u_rows = tparts.row_build(st)
    # K8a reads one 512 B table column per distinct cell and the tail rows
    gather_extra = 512 * state["cells"] + 512 * (u_rows.shape[0] - P)
    print(f"row transfers: ({u_rows.shape[0]}, 128) rows, {P} particles, "
          f"(128, {n3}) table")
    results = {}

    def lanes(d):      # the payload, and the id sums of lane 127
        return d[:127], d[127]

    def compare_pair(tag, rows, table_cm):
        res_s = _compare(
            f"K8b scatter_rows_cm{tag}",
            lambda: lanes(rw.scatter_rows_cm(rows, flat, n3)),
            lambda: lanes(rw.scatter_rows_cm_plain(rows, flat, n3)), 1e-5,
            (rows[:P], flat), 128 * P, torch,
            library=lambda: torch.zeros((128, n3), device=dev).t().index_add_(
                0, flat64, rows[:P]))
        res_g = _compare(
            f"K8a gather_rows_cm{tag}",
            lambda: rw.gather_rows_cm(table_cm, rows, flat),
            lambda: rw.gather_rows_cm_plain(table_cm, rows, flat), 0.0,
            (flat,), 0, torch, extra_bytes=gather_extra,
            library=lambda: table_cm.t().index_select(0, flat64))
        return res_s, res_g

    # ---- 21. K8a, K8b against their plain versions and the library --------
    table_cm = tparts.row_table(fm)
    results["scatter_rows_cm"], results["gather_rows_cm"] = compare_pair(
        "", u_rows, table_cm)

    d, acc = tparts.row_p2g(st, u_rows)
    base = tk.p2g_scatter_base(st.w27t, st.vel_s, flat,
                               tk.window_starts(flat, n), n)
    if not torch.equal(d[:108].view(27, 4, n, n, n), base):
        raise AssertionError(f"K8b differs from K6a: "
                             f"{_max_err(d[:108], base.view(108, n3)):.3e}")
    if not torch.equal(acc, tk.shift_reduce(base)):
        raise AssertionError("K6b of K8b differs from K6b of K6a")
    del acc, base
    d1, tile_start = rw.scatter_rows_cm_launch(u_rows, flat, n3)
    _require_bitwise("K8b tile plan against scatter_tile_starts_plain",
                     tile_start, rw.scatter_tile_starts_plain(flat, n3), torch)
    _require_bitwise("K8b against its rerun", d1, d, torch)
    tiles = tile_start[1:] - tile_start[:-1]
    print(f"K8b tiles: {int((tiles > 0).sum())} of {tiles.numel()} occupied, "
          f"the fullest {int(tiles.max())} rows")
    del d, d1, tile_start, tiles
    results["scatter_rows_cm"].update(_k8b_more_states(u_rows, flat, n, dev,
                                                       torch))
    rows, out = tparts.row_g2p(st, table_cm, u_rows)
    k7a = tk.g2p_gather_table(tk.shift_expand(fm), st.w27t, flat)
    k2 = tk.g2p_gather(fm, st.w27t, flat)
    if not (torch.equal(out, k7a) and torch.equal(out, k2)):
        raise AssertionError(f"row G2P differs from K7a/K2: "
                             f"{_max_err(out, k7a):.3e}, {_max_err(out, k2):.3e}")
    if not torch.equal(rows[P:], u_rows[P:]):
        raise AssertionError("K8a changed the tail rows")
    print(f"row transfers: K8b == K6a, K6b(K8b) == K6b(K6a), row G2P == K7a "
          f"== K2, bit for bit on {P} particles at {n}^3")
    del rows, out, k7a, k2, table_cm, u_rows

    s_rows, ones = tparts.sweep_inputs(st)
    compare_pair(" (sweep: 127-lane rows, ones table)", s_rows, ones)
    return results


def _row_transfers(dev, counted, torch):
    """Phase 22: ``utils/transfer_parts`` at the main paths' size; returns
    the launches of one pass of the row P2G and G2P."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.utils import transfer_parts as tparts

    st = tparts.frame_state(BOUND, DENSITY, dev)
    n, P = st.n, st.flat.shape[0]
    print(f"transfer_parts: water_cube_drop bound {BOUND} frame "
          f"{tparts.FRAMES}: {P} particles, {n}^3 cells")
    ones = torch.ones((3, n, n, n), device=dev)
    for fn in counted:
        fn.launches = 0
    u_rows = tparts.row_build(st)
    _, acc = tparts.row_p2g(st, u_rows)
    fm = tparts.field_build(st, ones)
    _, out = tparts.row_g2p(st, tparts.row_table(fm), u_rows)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    print("row_transfers: launches:", json.dumps(launches))
    want = {name: 0 for name in launches}
    want.update({"scatter_rows_cm": 1, "shift_reduce": 1, "shift_expand": 1,
                 "gather_rows_cm": 1})
    if launches != want:
        raise AssertionError(f"row_transfers: launches {launches}, "
                             f"expected {want}")
    # what came out: the row P2G is K1's sums in another f32 order, the
    # row G2P K2's sums bit for bit
    k1 = tk.p2g_scatter(st.w27t, st.vel_s, tk.cell_starts(st.flat, n), n)
    err, scale = _max_err(acc, k1), float(k1.abs().max())
    if err > 1e-5 * scale:
        raise AssertionError(f"row_transfers: row P2G differs from K1 by {err}")
    if not torch.equal(out, tk.g2p_gather(fm, st.w27t, st.flat)):
        raise AssertionError("row_transfers: row G2P differs from K2")
    print(f"row_transfers: row P2G within {err:.3e} of K1 (max {scale:.4g}), "
          "row G2P equal to K2 bit for bit")
    del u_rows, acc, out, k1, fm
    for name, ms in tparts.time_parts(st).items():
        print(f"time transfer_parts {name}: {ms:.4f} ms (median of "
              f"{tparts.REPS})")
    return launches


def _config_cube(params):
    """Phases 23-24's config: ``water_cube_drop``'s cube at bound 64 and
    density 25 with a solid block under it that the seed does not touch."""
    return {"kind": "flip", "bound": BOUND, "density": DENSITY,
            "seed": [{"box": [[-21, -21, -21], [21, 21, 21]]}],
            "solid": [{"box": [[-8, -62, -8], [8, -30, 8]]}],
            "params": params}


def _config_phases(dev, counted, torch, flip_particles, flip_ms, flip_cg,
                   mpm_particles, mpm_launches, mpm_cg):
    """Phases 23-26; returns the launch counts of phases 23-25's timed
    frames by path."""
    from fluidsim_tpu_torch import config
    from fluidsim_tpu_torch.models.mpm import MpmParams, MpmSim
    from fluidsim_tpu_torch.ops import extrapolate as ex
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm
    from fluidsim_tpu_torch.scenes import get_scene

    def config_sim(params):
        sim = config.make_sim(_config_cube(params), seed=SEED, device=dev)
        if sim.num_particles != flip_particles:
            raise AssertionError(f"config {params}: {sim.num_particles} "
                                 f"particles, phase 4 had {flip_particles}")
        if sim.params.walls_only_solid:
            raise AssertionError("config with an obstacle took the walls-"
                                 "only bounce probe")
        for _ in range(2):
            sim.step()
        return sim

    # ---- 23. multigrid FLIP at full width, through make_sim ------------
    sim = config_sim({"preconditioner": "multigrid"})
    print(f"config multigrid: bound {BOUND}, {sim.num_particles} particles "
          "(phase 4's), one solid block, the grid bounce probe")
    _, mg_launches, mg_ms, mg_cg, _ = _run_frames(sim, counted, torch,
                                                  "flip-multigrid")
    print(f"flip-multigrid: ms/frame {mg_ms:.3f} against phase 4's "
          f"{flip_ms:.3f}; CG iterations/frame {sum(mg_cg) / FRAMES:.1f} "
          f"against {sum(flip_cg) / FRAMES:.1f}")
    # phase 26's extrapolation input: the P2G of the last state
    st, B, n = sim.state, sim.params.bound, 2 * sim.params.bound + 1
    pos_s, vel_s, flat = tk.sort_by_cell(st.pos, st.vel, B)
    w, mom, occ = tk.p2g(tk.masked_weights_cm(pos_s, B), vel_s, flat,
                         sim.solid, B)
    velg = normalize_velocity_cm(w, mom).permute(1, 2, 3, 0).contiguous()
    fluid = (occ > 0) & ~sim.solid
    del sim, st, pos_s, vel_s, flat, w, mom, occ

    # ---- 24. the clean projection at full width -------------------------
    sim = config_sim({"compat_projection": False, "cheb_degree": 4,
                      "cheb_ratio": 50.0})
    _, clean_launches, clean_ms, clean_cg, clean_outer = _run_frames(
        sim, counted, torch, "flip-clean")
    if clean_outer != [1] * FRAMES:
        raise AssertionError(f"flip-clean: outer passes {clean_outer}")
    if clean_launches["cheb_steps"] != sum(clean_cg) + FRAMES:
        raise AssertionError("flip-clean: not one K4 launch (3 steps) per "
                             "preconditioner application")
    print(f"flip-clean: ms/frame {clean_ms:.3f}, CG iterations/frame "
          f"{sum(clean_cg) / FRAMES:.1f}, 1 outer pass a frame, one K4 "
          "launch of 3 steps per preconditioner application")
    del sim

    # ---- 25. MPM with the Jacobi preconditioner at full width -----------
    scene = get_scene("mpm_cone", bound=MPM_BOUND)
    sim = MpmSim(scene, seed=SEED, device=dev, params=MpmParams(
        bound=MPM_BOUND, wall=scene.spec.wall, dx=scene.spec.dx,
        gravity=tuple(scene.gravity), precond="jacobi"))
    if sim.num_particles != mpm_particles:
        raise AssertionError(f"mpm-jacobi: {sim.num_particles} particles, "
                             f"phase 10 had {mpm_particles}")
    for _ in range(2):
        sim.step()
    _, jac_launches, jac_cg, *_ = _run_mpm_frames(sim, counted, torch,
                                                  "mpm-jacobi")
    if jac_launches["p2g_scatter"] != mpm_launches["p2g_scatter"] + FRAMES:
        raise AssertionError("mpm-jacobi: not one more K1 launch a frame "
                             "than phase 11")
    print(f"mpm-jacobi: CG iterations per frame {jac_cg} against phase "
          f"11's {mpm_cg}")
    del sim

    # ---- 26. card against CPU on small scenes ---------------------------
    small = {"kind": "flip", "bound": 8, "density": 3,
             "seed": [{"box": [[-3, -3, -3], [3, 3, 3]]}],
             "solid": [{"box": [[-2, -6, -2], [2, -5, 2]]}]}
    for params in ({"preconditioner": "jacobi"},
                   {"preconditioner": "multigrid"},
                   {"compat_projection": False}, {"kernel": "mpm"}):
        _card_against_cpu(
            f"config {json.dumps(params)}", 8,
            lambda d: config.make_sim(dict(small, params=params), seed=SEED,
                                      device=d), dev)
    _mpm_small_scene("full", dev, precond="jacobi")
    # the extrapolation is elementwise and sums the 26 neighbours in one
    # order on both devices: it must agree within 1e-6 x max|v|
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v_card, d_card = ex.extrapolate(velg, fluid)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    v_cpu, d_cpu = ex.extrapolate(velg.cpu(), fluid.cpu())
    cpu_s = time.perf_counter() - t0
    err = _max_err(v_card.cpu(), v_cpu)
    scale = float(v_cpu.abs().max())
    bitwise = torch.equal(v_card.cpu(), v_cpu)
    print(f"extrapolate at {n}^3 from {int(fluid.sum())} fluid cells: "
          f"{int(d_cpu.sum())} cells defined, max |card - cpu| {err:.3e} "
          f"(bound {1e-6 * scale:.3e}), bitwise {bitwise}; card "
          f"{card_s:.3f} s, cpu {cpu_s:.3f} s (host clock)")
    if not torch.equal(d_card.cpu(), d_cpu) or err > 1e-6 * scale:
        raise AssertionError("extrapolate: card and cpu differ")
    return {"flip_multigrid": mg_launches, "flip_clean": clean_launches,
            "mpm_jacobi": jac_launches}


def _cli(argv, dev, counted, torch):
    """Run the port's command line on ``argv`` and ``--device dev``
    (``cli.run``, what ``cli.main`` runs for ``fluid`` and ``mpm``) with
    every launch count set to 0 just before.  Returns (summary, launches,
    K1 plans built, the JSONL metrics it wrote, seconds)."""
    from fluidsim_tpu_torch import cli
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    args = cli.build_parser().parse_args(argv + ["--device", str(dev)])
    for fn in counted:
        fn.launches = 0
    tk.chunk_plan.builds = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = cli.run("flip" if argv[0] == "fluid" else "mpm", args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    lines = []
    if args.metrics:
        with open(args.metrics) as f:
            lines = [json.loads(ln) for ln in f]
    return summary, launches, tk.chunk_plan.builds, lines, secs


def _on_box(path, bound, read_vdb, np):
    """The one grid of a frame file on the sim's (n, n, n) box (the file
    holds a leaf-aligned block around the active cells)."""
    (g,) = read_vdb(path)
    n = 2 * bound + 1
    out = np.zeros((n, n, n), np.float32)
    lo = [int(o) + bound for o in g.origin]
    src = tuple(slice(max(0, -lo[d]), min(g.values.shape[d], n - lo[d]))
                for d in range(3))
    dst = tuple(slice(lo[d] + src[d].start, lo[d] + src[d].stop)
                for d in range(3))
    out[dst] = g.values[src]
    return out


def _frame_ms(summary, first=2):
    """Mean host ms of the run's frames from ``first`` on (step, metrics
    and export submit; checkpoints apart)."""
    return statistics.mean(summary["frame_ms"][first:])


def _export_cost(label, off, on, argv, tmp, dev, counted, torch):
    """Export off, on (the path's run, given), then on and off again: the
    host ms/frame of each run from frame 2 on, and on minus off for each
    adjacent pair (a run's time moves with the host, so pairs compare)."""
    out = os.path.join(tmp, label.replace(" ", "_"))
    on2 = _cli(argv + ["--out", out + "_on2", "--no-accum"], dev, counted,
               torch)[0]
    off2 = _cli(argv + ["--out", out + "_off2", "--no-vdb"], dev, counted,
                torch)[0]
    ms = [_frame_ms(r) for r in (off, on, on2, off2)]
    print(f"{label}: ms/frame from frame 2 (host clock: step, metrics, "
          f"export submit) off {ms[0]:.3f}, on {ms[1]:.3f}, on {ms[2]:.3f}, "
          f"off {ms[3]:.3f}; on - off {ms[1] - ms[0]:+.3f}, "
          f"{ms[2] - ms[3]:+.3f}")
    for name, r in zip(("off", "on", "on", "off"), (off, on, on2, off2)):
        print(f"{label}: frame ms export {name} {r['frame_ms']}")
    ex = on2["exporter"]
    print(f"{label}: second export run's exporter", json.dumps(ex))
    if ex["python_fallbacks"] or ex["fallback_frames"] or ex["tail_fetches"]:
        raise AssertionError(f"{label}: the exporter fell back")


def _same_bits(a, b, np) -> bool:
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint32),
        np.ascontiguousarray(b).view(np.uint32))


def _flip_cli_phase(dev, counted, torch, np, tmp, flip_particles, flip_ms):
    """Phase 27; returns the export run's launch counts and ms/frame."""
    from fluidsim_tpu_torch.io.export import pack_active
    from fluidsim_tpu_torch.io.vdb import open_vdb, read_vdb
    from fluidsim_tpu_torch.models.flip import FlipSim
    from fluidsim_tpu_torch.scenes import get_scene

    t_phase = time.perf_counter()
    base = ["fluid", "--bound", str(BOUND), "--density", str(DENSITY),
            "--seed", str(SEED), "--echo-every", "1000"]
    out = os.path.join(tmp, "fluid")
    every = CLI_FRAMES // 2
    frames = ["--frames", str(CLI_FRAMES)]
    off = _cli(base + frames + ["--out", os.path.join(tmp, "fluid_off"),
                                "--no-vdb"], dev, counted, torch)[0]
    on, launches, builds, lines, secs = _cli(
        base + frames + ["--out", out, "--checkpoint-every", str(every),
                         "--metrics", os.path.join(tmp, "fluid.jsonl")],
        dev, counted, torch)
    _export_cost("cli fluid", off, on, base + frames, tmp, dev, counted,
                 torch)
    print("cli fluid: launches:", json.dumps(launches),
          f"K1 chunk plans built: {builds}")
    if on["particles"] != flip_particles or len(lines) != CLI_FRAMES:
        raise AssertionError(f"cli fluid: {on['particles']} particles, "
                             f"{len(lines)} metrics lines")
    # the launches the frames' CG iterations call for, as in phase 4
    sim = FlipSim(get_scene("water_cube_drop", bound=BOUND, density=DENSITY),
                  seed=SEED, device=dev)
    solves = sum(m["cg_iters"] + m["outer_iters"] for m in lines)
    k3, k4 = _stencil_launches(sim.params)
    want = {name: 0 for name in launches}
    want.update({"p2g_scatter": CLI_FRAMES, "chunk_fill": CLI_FRAMES,
                 "g2p_gather": CLI_FRAMES, "apply_laplacian": k3 * solves,
                 "cheb_steps": k4 * solves})
    _require_launches("cli fluid", launches, want, builds, CLI_FRAMES)
    ex = on["exporter"]
    print("cli fluid: exporter", json.dumps(ex))
    if ex["python_fallbacks"] or ex["fallback_frames"] or ex["tail_fetches"]:
        raise AssertionError("cli fluid: the exporter fell back")
    print(f"cli fluid: phase 4 {flip_ms:.3f} ms/frame; checkpoints "
          f"{on['checkpoint_s']:.3f} s for {CLI_FRAMES // every}; the export "
          f"run {secs:.2f} s in all with the flush and mygrids.vdb")

    # each frame file against a direct rerun's occupancy * ~solid
    cap = max(1, sim.solid.numel() // 4)       # the exporter's default cap
    want_grids = []
    for i in range(CLI_FRAMES):
        occ = sim.step()["occupancy"]
        want_grids.append(torch.where(sim.solid, 0.0, occ).cpu().numpy())
    card = pack_active(occ, sim.solid.reshape(-1), cap).cpu()
    host = pack_active(occ.cpu(), sim.solid.reshape(-1).cpu(), cap)
    if not torch.equal(card, host):
        raise AssertionError("pack_active: card and cpu buffers differ")
    print(f"bitwise pack_active card vs cpu: equal ({card.numel()} B, "
          f"{int(host[:4].view(torch.int32))} active cells, cap {cap})")
    del sim, occ, card, host
    for i, grid in enumerate(want_grids):
        got = _on_box(os.path.join(out, f"mygrids{i}.vdb"), BOUND, read_vdb,
                      np)
        if not _same_bits(got, grid, np):
            raise AssertionError(f"cli fluid: mygrids{i}.vdb differs from "
                                 "occupancy * ~solid of a direct rerun")
    accum = open_vdb(os.path.join(out, "mygrids.vdb"))
    if len(accum) != CLI_FRAMES:
        raise AssertionError(f"mygrids.vdb holds {len(accum)} grids")
    print(f"cli fluid: mygrids0-{CLI_FRAMES - 1}.vdb bit for bit equal to a "
          f"direct rerun's occupancy * ~solid; mygrids.vdb holds "
          f"{len(accum)} grids")
    del want_grids, accum

    # resume from the middle checkpoint into a second directory
    ck = os.path.join(out, f"ckpt_{every - 1}.npz")
    out2 = os.path.join(tmp, "fluid_resumed")
    res, *_ = _cli(base + ["--frames", str(CLI_FRAMES - every), "--out",
                           out2, "--resume", ck, "--no-accum"],
                   dev, counted, torch)
    if res["first_frame"] != every:
        raise AssertionError(f"resume started at frame {res['first_frame']}")
    for i in range(every, CLI_FRAMES):
        a = read_vdb(os.path.join(out, f"mygrids{i}.vdb"))[0]
        b = read_vdb(os.path.join(out2, f"mygrids{i}.vdb"))[0]
        if (a.origin != b.origin or not _same_bits(a.values, b.values, np)
                or not np.array_equal(a.active, b.active)):
            raise AssertionError(f"resume: mygrids{i}.vdb differs")
    print(f"cli fluid: --resume {os.path.basename(ck)} --frames "
          f"{CLI_FRAMES - every}: mygrids{every}-{CLI_FRAMES - 1}.vdb bit for "
          "bit equal to the first run's")
    print(f"phase 27: {time.perf_counter() - t_phase:.2f} s")
    return launches, _frame_ms(on)


def _mpm_cli_phase(dev, counted, torch, np, tmp, mpm_particles):
    """Phase 28; returns the export run's launch counts."""
    from fluidsim_tpu_torch.io.vdb import read_vdb
    from fluidsim_tpu_torch.models.mpm import MpmSim
    from fluidsim_tpu_torch.scenes import get_scene

    t_phase = time.perf_counter()
    base = ["mpm", "--bound", str(MPM_BOUND), "--seed", str(SEED),
            "--echo-every", "1000", "--frames", str(MPM_CLI_FRAMES)]
    out = os.path.join(tmp, "mpm")
    off = _cli(base + ["--out", os.path.join(tmp, "mpm_off"), "--no-vdb"],
               dev, counted, torch)[0]
    on, launches, builds, lines, secs = _cli(
        base + ["--out", out, "--metrics", os.path.join(tmp, "mpm.jsonl")],
        dev, counted, torch)
    _export_cost("cli mpm", off, on, base, tmp, dev, counted, torch)
    print("cli mpm: launches:", json.dumps(launches),
          f"K1 chunk plans built: {builds}")
    sim = MpmSim(get_scene("mpm_cone", bound=MPM_BOUND), seed=SEED,
                 device=dev)
    if on["particles"] != mpm_particles or len(lines) != MPM_CLI_FRAMES:
        raise AssertionError(f"cli mpm: {on['particles']} particles, "
                             f"{len(lines)} metrics lines")
    applies = sum(m["cg_iters"] + _mpm_solves(m, sim.params)[0]
                  for m in lines)
    want = {name: 0 for name in launches}
    want.update({"p2g_scatter": MPM_CLI_FRAMES,
                 "g2p_gather": 2 * MPM_CLI_FRAMES,
                 "p2g_scatter_force": MPM_CLI_FRAMES + applies,
                 "g2p_gather_gw": applies + MPM_CLI_FRAMES,
                 "chunk_fill": MPM_CLI_FRAMES})
    _require_launches("cli mpm", launches, want, builds, MPM_CLI_FRAMES)
    ex = on["exporter"]
    print("cli mpm: exporter", json.dumps(ex))
    if ex["python_fallbacks"] or ex["fallback_frames"] or ex["tail_fetches"]:
        raise AssertionError("cli mpm: the exporter fell back")
    print(f"cli mpm: the export run {secs:.2f} s in all; CG iterations "
          f"{[m['cg_iters'] for m in lines]}")
    solid = sim.solid.cpu().numpy()
    persistent = np.zeros(solid.shape, np.float32)
    for i in range(MPM_CLI_FRAMES):
        mass = sim.step()["occupancy"].cpu().numpy()
        upd = ~solid & (mass > 0.1)
        persistent[upd] = mass[upd]
        got = _on_box(os.path.join(out, f"mygrids{i}.vdb"), MPM_BOUND,
                      read_vdb, np)
        if not _same_bits(got, persistent, np):
            raise AssertionError(f"cli mpm: mygrids{i}.vdb differs from the "
                                 "persistence rule on a direct rerun")
    print(f"cli mpm: mygrids0-{MPM_CLI_FRAMES - 1}.vdb bit for bit equal to "
          "the persistence rule (cells > 0.1 kept across frames) on a direct "
          "rerun")
    print(f"phase 28: {time.perf_counter() - t_phase:.2f} s")
    return launches


def _require_same_bits(name, a, b, torch):
    """Raise unless tensors ``a`` and ``b`` have one shape, one dtype and
    the same bytes."""
    if (a.shape != b.shape or a.dtype != b.dtype or not torch.equal(
            a.contiguous().reshape(-1).view(torch.uint8),
            b.contiguous().reshape(-1).view(torch.uint8))):
        raise AssertionError(f"{name}: not bit for bit equal")


def _require_same_frames(label, stacked, frames, a, b, torch):
    """``stacked`` (``steps(k)``'s metrics) against the per-frame metrics
    ``frames``, and state ``a`` against state ``b``, bit for bit."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is not None or y is not None:
            _require_same_bits(f"{label} state.{f.name}", x, y, torch)
    if set(stacked) != set(frames[0]) - {"occupancy"}:
        raise AssertionError(f"{label}: keys {sorted(stacked)}")
    for key, v in stacked.items():
        want = [m[key] for m in frames]
        if isinstance(want[0], torch.Tensor):
            _require_same_bits(f"{label} {key}", v, torch.stack(want), torch)
        elif v.dtype != torch.int32 or v.tolist() != want:
            raise AssertionError(f"{label}: stacked {key} differs")
    print(f"bitwise {label}: state and {len(stacked)} stacked metrics equal")


def _require_launches(label, launches, want, builds, frames):
    """Raise unless a run's launch counts are ``want`` and it built one K1
    chunk plan a frame."""
    if launches != want or builds != frames:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want}; {builds} K1 chunk plans in {frames} "
                             "frames")


def _steps_phase(dev, torch):
    """Phase 29."""
    from fluidsim_tpu_torch.models.flip import FlipSim
    from fluidsim_tpu_torch.models.mpm import MpmSim

    t_phase = time.perf_counter()
    a, b = (FlipSim("water_cube_drop", bound=BOUND, density=DENSITY,
                    seed=SEED, device=dev) for _ in range(2))
    stacked = a.steps(4)
    _require_same_frames("FlipSim.steps(4) vs 4 step()", stacked,
                         [b.step() for _ in range(4)], a.state, b.state,
                         torch)
    del b
    calls = []
    a.run(6, callback=lambda fr, st, m: calls.append(
        (fr, int(st.frame), tuple(m["kinetic_energy"].shape))), chunk=3)
    if calls != [(6, 7, (3,)), (9, 10, (3,))]:
        raise AssertionError(f"run(6, chunk=3): callbacks {calls}")
    print(f"FlipSim.run(6, chunk=3): one callback per chunk {calls}")
    del a
    a, b = (MpmSim("mpm_cone", bound=MPM_BOUND, seed=SEED, device=dev)
            for _ in range(2))
    stacked = a.steps(2)
    _require_same_frames("MpmSim.steps(2) vs 2 step()", stacked,
                         [b.step() for _ in range(2)], a.state, b.state,
                         torch)
    print(f"phase 29: {time.perf_counter() - t_phase:.2f} s")


def _surface_trace_phase(dev, counted, torch, np, tmp, on_ms):
    """Phase 30: ``--surface`` and ``--trace-dir``, the run's last phase."""
    from fluidsim_tpu_torch.io.vdb import read_vdb
    from fluidsim_tpu_torch.models.flip import FlipSim
    from fluidsim_tpu_torch.ops.levelset import (particles_to_levelset,
                                                 sdf_to_fog)
    from fluidsim_tpu_torch.scenes import get_scene
    from fluidsim_tpu_torch.utils.profiling import TRACE_FILE

    t_phase = time.perf_counter()
    out, trace_dir = os.path.join(tmp, "surface"), os.path.join(tmp, "trace")
    run, *_ = _cli(["fluid", "--bound", str(BOUND), "--density", str(DENSITY),
                    "--seed", str(SEED), "--echo-every", "1000", "--frames",
                    "2", "--out", out, "--no-accum", "--surface",
                    "--trace-dir", trace_dir], dev, counted, torch)
    print(f"cli fluid --surface --trace-dir: frame ms {run['frame_ms']} "
          f"(traced; phase 27's export run: {on_ms:.3f} ms/frame)")
    sim = FlipSim(get_scene("water_cube_drop", bound=BOUND, density=DENSITY),
                  seed=SEED, device=dev)
    solid = sim.solid.cpu()
    worst = 0.0
    for i in range(2):
        sim.step()
        fog = sdf_to_fog(particles_to_levelset(sim.state.pos.cpu(), BOUND))
        want = torch.where(solid, 0.0, fog).numpy()
        got = _on_box(os.path.join(out, f"mygrids{i}.vdb"), BOUND, read_vdb,
                      np)
        err = float(np.abs(got.astype(np.float64) - want).max())
        worst = max(worst, err)
        if err > 1e-6:
            raise AssertionError(f"--surface frame {i}: max |card - cpu| "
                                 f"{err:.3e} > 1e-6")
    print(f"cli fluid --surface: 2 fog grids within {worst:.3e} (<= 1e-6) of "
          "sdf_to_fog(particles_to_levelset(pos)) on the CPU")
    path = os.path.join(trace_dir, TRACE_FILE)
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"trace: {path} {size} B, {len(events)} events, {kernels} kernel "
          "events")
    if size == 0 or kernels == 0:
        raise AssertionError("--trace-dir: no kernel in the trace")
    print(f"phase 30: {time.perf_counter() - t_phase:.2f} s")


# ---- phases 31-34: the slab-sharded sims (run before phase 30) -----------

SHARD_SMALL = dict(bound=8, density=3.0)   # phase 34's FLIP scene


def _slab_kernels(where, path, results, cases, torch, field="slab"):
    """``_compare`` each case (key, label, kernel, plain, tolerance,
    inputs, ops, order function or None[, bytes read past the inputs]) of
    the path ``path`` (by default a sharded one's slab ``where``) and hold
    it bit for bit to its order function, or with None to its plain
    version."""
    for key, label, kernel, plain, tol, inputs, ops, order, *extra in cases:
        results[key] = _compare(f"{label} ({where})", kernel, plain, tol,
                                inputs, ops, torch, extra_bytes=sum(extra))
        results[key].update({field: where, "path": path})
        _require_bitwise(f"{label} ({where}): against its "
                         f"{'order function' if order else 'plain version'}",
                         kernel(), (order or plain)(), torch)


def _flip_slab_cases(scene, rank, size, rng, g, dev, torch, np):
    """K1 and K2 on one rank's FLIP transfer slab."""
    from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm
    from fluidsim_tpu_torch.utils.card_inputs import rank_arrays

    n = 2 * BOUND + 1
    slab, pos_s, vel_s, flat, a = rank_arrays(scene, BOUND, rank, size, rng,
                                              dev)
    w27t = tk.masked_weights_cm(pos_s, BOUND)
    cs = tk.cell_starts(flat, n, slab.rows)
    count = cs[-1:]
    plan = tk.chunk_plan(cs, flat.shape[0])
    acc = tk.p2g_scatter(w27t, vel_s, cs, n, plan)
    within = slab.within_ext(scene.spec.wall)
    vc = cell_center_velocity_cm(normalize_velocity_cm(acc[0], acc[1:4]))
    fm = torch.stack([torch.where(within, vc[d], 0.0) for d in range(3)]
                     + [within.to(torch.float32)])
    tag = f"slab{slab.rows}"
    print(f"{scene.name}, rank {rank} of {size}: transfer slab "
          f"{tuple(acc.shape[1:])}, {a} of {flat.shape[0]} slots alive")
    _k2_staged(f"{scene.name}, {tag}", fm, w27t, flat, count, torch)
    live = (w27t[:, :a], vel_s[:a], flat[:a])
    return [
        (f"p2g_scatter_{tag}", f"K1 p2g_scatter {tag}",
         lambda: tk.p2g_scatter(w27t, vel_s, cs, n, plan),
         lambda: tk.p2g_scatter_plain(w27t, vel_s, cs, n), 1e-5,
         (live[0], live[1], cs), 27 * 7 * a,
         lambda: tk.p2g_scatter_chunked(w27t, vel_s, plan, n)),
        (f"g2p_gather_{tag}", f"K2 g2p_gather {tag}",
         lambda: tk.g2p_gather(fm, w27t, flat, count),
         lambda: tk.g2p_gather_plain(fm, w27t, flat, count), 1e-5,
         (live[0], live[2], count), 27 * 8 * a, None,
         _field_bytes(flat, slab.rows, n, 4, a))]


def _solve_slab(fields, size, rank, depth, torch):
    """Rank ``rank``'s slab of a ``size``-way cut of the cube solve fields
    (z, adiag, r, d) and, under ``<name>_edges``, the ``depth`` rows of the
    neighbouring slabs on either side, None at a domain end: what the
    sharded solve's kernels read on that rank.  The last slab runs past
    the box on zero rows, as ``Slab`` cuts it."""
    n = fields["r"].shape[0]
    nl = math.ceil(n / size)
    x0 = rank * nl
    out = {}
    for name in ("z", "adiag", "r", "d"):
        t = fields[name]
        t = torch.cat([t, t.new_zeros((size * nl - n,) + tuple(t.shape[1:]))])
        out[name] = t[x0:x0 + nl].contiguous()
        out[name + "_edges"] = (
            t[x0 - depth:x0].contiguous() if rank > 0 else None,
            t[x0 + nl:x0 + nl + depth].contiguous() if rank < size - 1
            else None)
    return out


def _stencil_cases(where, fields, cut, torch):
    """K3 and K4 on the solve ``fields`` (the cube's, or with ``cut = (size,
    rank)`` that rank's slab and its neighbours' edge rows, as
    ``_solve_slab`` cuts them): each against its plain version as in phase
    3 (timed) and bit for bit.  K4 is the preconditioner's launch at degree
    3 (2 steps from the Jacobi term, the entry's own numbers) and 4 (3
    steps, ``degree4_*``), and one step from a given (z, d), the TPU
    kernel's function (``one_step_*``).  Returns the entries, keyed
    ``<kernel>`` or ``<kernel>_slab<rows>``."""
    from fluidsim_tpu_torch.ops import stencil_kernels as sk

    size, rank = cut or (1, 0)
    sl = _solve_slab(fields, size, rank, sk.S_MAX, torch)
    scale = fields["scale"]
    z, a, r, d = (sl[k] for k in ("z", "adiag", "r", "d"))
    cells = r.numel()
    tag = "" if cut is None else f"_slab{r.shape[0]}"
    near = lambda name, depth: tuple(
        None if t is None else (t[-depth:] if side == 0 else t[:depth])
        for side, t in enumerate(sl[name + "_edges"]))
    ghost = lambda names, depth: None if cut is None else {
        k: near(k, depth) for k in names}
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms")

    def read(depth, at_fluid, everywhere=()):
        """(inputs read in full, bytes read at fluid cells only): adiag and
        ``everywhere`` on the slab and its ``depth`` edge rows, and
        ``at_fluid`` fields (p, z, r) where adiag > 0.  The kernels need
        no other value of those fields: a cell outside the fluid reads them
        as 0."""
        names = ("adiag", *everywhere)
        g = ghost(names, depth) or {}
        full = [sl[k] for k in names] + [t for pair in g.values()
                                         for t in pair if t is not None]
        a_rows = [a] + [t for t in g.get("adiag", ()) if t is not None]
        fluid = sum(int((t > 0).sum()) for t in a_rows)
        return full, 4 * len(at_fluid) * fluid

    def case(name, kernel, plain, reads, ops):
        full, extra = reads
        res = _compare(name, kernel, plain, 1e-6, full, ops, torch,
                       extra_bytes=extra)
        _require_bitwise(f"{name}: against its plain version", kernel(),
                         plain(), torch)
        return res

    g3 = ghost(("z", "adiag"), 1)
    g3 = None if g3 is None else tuple(None if t is None else t[0] for t in (
        *g3["z"], *g3["adiag"]))
    out = {"apply_laplacian" + tag: case(
        f"K3 apply_laplacian ({where})",
        lambda: sk.apply_laplacian(z, a, scale, ghost=g3),
        lambda: sk.apply_laplacian_plain(z, a, scale, ghost=g3),
        read(1, ("p",)), 9 * cells)}
    for degree in (3, 4):
        theta, coefs = sk.cheb_coefs(degree)
        steps = len(coefs)
        g = ghost(("adiag", "r"), steps)
        res = case(f"K4 cheb_steps, degree {degree}: {steps} steps from the "
                   f"Jacobi term ({where})",
                   lambda: sk.cheb_steps(a, r, scale, coefs, theta, ghost=g),
                   lambda: sk.cheb_steps_plain(a, r, scale, coefs, theta,
                                               ghost=g),
                   read(steps, ("r",)), (3 + 15 * steps) * cells)
        if degree == 3:
            entry = res
        else:
            entry.update({f"degree4_{k}": res[k] for k in keep})
    g = ghost(("z", "d", "r", "adiag"), 1)
    res = case(f"K4 cheb_steps, one step from (z, d) ({where})",
               lambda: sk.cheb_steps(a, r, scale, [(0.61, 1.07)], z=z, d=d,
                                     ghost=g, want_d=True),
               lambda: sk.cheb_steps_plain(a, r, scale, [(0.61, 1.07)], z=z,
                                           d=d, ghost=g, want_d=True),
               read(1, ("z", "r"), ("d",)), 15 * cells)
    entry.update({f"one_step_{k}": res[k] for k in keep})
    out["cheb_steps" + tag] = entry
    if cut is not None:
        for v in out.values():
            v["slab"] = where
        _split_on_slab(where, fields, sl, size, rank, torch)
    return out


def _split_on_slab(where, fields, sl, size, rank, torch):
    """A degree-5 preconditioner on the slab ``sl`` (``_solve_slab``'s cut
    of ``fields``): its 4 steps in two launches of 2, the second from the
    given (z, d) with the neighbours' edge rows of z and d, which are the
    cube's after 2 steps.  Bit for bit the cube's 4 steps on the slab's
    rows."""
    from fluidsim_tpu_torch.ops import stencil_kernels as sk

    deg, scale = 5, fields["scale"]
    theta, coefs = sk.cheb_coefs(deg)
    adiag, r = fields["adiag"], fields["r"]
    z2, d2 = sk.cheb_steps_plain(adiag, r, scale, coefs[:2], theta,
                                 want_d=True)
    mid = _solve_slab(dict(z=z2, d=d2, adiag=adiag, r=r), size, rank, 2,
                      torch)
    # the exchanges the preconditioner makes, in order
    plan = [(sl, ("adiag",)), (sl, ("r",)), (mid, ("z", "d"))]

    def edges(tensors, width):
        rows, names = plan.pop(0)
        if len(names) != len(tensors):
            raise AssertionError(f"{where}: exchange of {len(tensors)} "
                                 f"fields, expected {names}")
        return [tuple(None if t is None else
                      (t[t.shape[0] - width:] if side == 0 else t[:width])
                      for side, t in enumerate(rows[k + "_edges"]))
                for k in names]

    before = sk.cheb_steps.launches
    got = sk.chebyshev_precond_fused(sl["adiag"], scale, degree=deg,
                                     edges=edges)(sl["r"])
    launches = sk.cheb_steps.launches - before
    if launches != 2 or plan:
        raise AssertionError(f"{where}: degree {deg} in {launches} launches, "
                             f"{len(plan)} exchanges not made")
    nl, x0 = sl["r"].shape[0], rank * sl["r"].shape[0]
    cube = sk.cheb_steps_plain(adiag, r, scale, coefs, theta)
    cube = torch.cat([cube, cube.new_zeros((size * nl - cube.shape[0],) +
                                           tuple(cube.shape[1:]))])
    _require_bitwise(f"K4 preconditioner, degree {deg} in 2 launches on the "
                     f"{nl}-row slab ({where}), the second from (z, d) with "
                     "edge rows, against the cube's steps", got,
                     cube[x0:x0 + nl], torch)


def _cone_slab_cases(scene, rank, size, rng, g, dev, torch, np):
    """K1 fg, K2 gw and K2 (the density gather) on one rank's transfer slab
    of the cone."""
    from fluidsim_tpu_torch.ops import mpm_kernels as mk
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.utils.card_inputs import rank_arrays

    n = 2 * MPM_BOUND + 1
    slab, pos_s, vel_s, flat, a = rank_arrays(scene, MPM_BOUND, rank, size,
                                              rng, dev)
    w27t, gradw = mk.mpm_stencil(pos_s, MPM_BOUND)
    cs = tk.cell_starts(flat, n, slab.rows)
    count = cs[-1:]
    p = flat.shape[0]
    plan = tk.chunk_plan(cs, p)
    m9 = torch.randn((p, 9), generator=g, device=dev)
    acc = tk.p2g_scatter(w27t, vel_s, cs, n, plan)
    heavy = acc[0] > 0.1
    velg = torch.where(heavy[None],
                       acc[1:4] / torch.where(heavy, acc[0], 1.0)[None], 0.0)
    fm3 = torch.where(~slab.solid_ext[None], velg, 0.0).contiguous()
    fm = mk.density_fields(acc[0], slab.solid_ext)
    tag = f"slab{slab.rows}"
    print(f"{scene.name}, rank {rank} of {size}: transfer slab "
          f"{tuple(acc.shape[1:])}, {a} of {p} slots alive")
    _k2_staged(f"{scene.name}, {tag}", fm, w27t, flat, count, torch)
    return [
        (f"g2p_gather_{tag}", f"K2 g2p_gather {tag} (density)",
         lambda: tk.g2p_gather(fm, w27t, flat, count),
         lambda: tk.g2p_gather_plain(fm, w27t, flat, count), 1e-5,
         (w27t[:, :a], flat[:a], count), 27 * 8 * a, None,
         _field_bytes(flat, slab.rows, n, 4, a)),
        (f"p2g_scatter_force_{tag}", f"K1 fg p2g_scatter_force {tag}",
         lambda: tk.p2g_scatter_force(gradw, m9, cs, n, plan),
         lambda: tk.p2g_scatter_force_plain(gradw, m9, cs, n), 1e-5,
         (gradw[:, :a], m9[:a], cs), 27 * 18 * a,
         lambda: tk.p2g_scatter_force_chunked(gradw, m9, plan, n)),
        (f"g2p_gather_gw_{tag}", f"K2 gw g2p_gather_gw {tag}",
         lambda: tk.g2p_gather_gw(fm3, gradw, flat, count),
         lambda: tk.g2p_gather_gw_plain(fm3, gradw, flat, count), 1e-5,
         (gradw[:, :a], flat[:a], count), 27 * 18 * a,
         lambda: tk.g2p_gather_gw_ordered(fm3, gradw, flat, count),
         _field_bytes(flat, slab.rows, n, 3, a))]


def _slab_phase(dev, torch, np, solve_fields):
    """Phase 31 (see the module docstring).  Returns the kernels' numbers
    by ``<kernel>_slab<rows>``."""
    from fluidsim_tpu_torch.parallel import dryrun
    from fluidsim_tpu_torch.scenes import get_scene

    t_phase = time.perf_counter()
    results = {}
    rng = np.random.default_rng(SEED)
    g = torch.Generator(device=dev).manual_seed(SEED)
    flip_scene = get_scene("water_cube_drop", bound=BOUND, density=DENSITY)
    cone = get_scene("mpm_cone", bound=MPM_BOUND)
    with dryrun.process_group(dev):
        for size in (1, SLAB_WORLD):
            rank = 0 if size == 1 else SLAB_RANK
            where = f"rank {rank} of {size}"
            for cases, scene, path in (
                    (_flip_slab_cases, flip_scene, "sharded_flip"),
                    (_cone_slab_cases, cone, "sharded_mpm")):
                _slab_kernels(where, path, results,
                              cases(scene, rank, size, rng, g, dev, torch,
                                    np), torch)
            results.update(_stencil_cases(where, solve_fields, (size, rank),
                                          torch))
    print(f"phase 31: {time.perf_counter() - t_phase:.2f} s")
    return results


def _zero_counts(counted):
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    for fn in counted:
        fn.launches = 0
    tk.chunk_plan.builds = 0


def _sharded_flip_phase(dev, counted, torch, flip_ms):
    """Phase 32: the sharded FLIP at world size 1 on NCCL, ``water_cube_drop``
    at 129^3, 2 warm-up and ``FRAMES`` timed frames, against ``FlipSim`` on
    the card frame by frame.  Returns the timed frames' launches."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.parallel import dryrun
    from fluidsim_tpu_torch.parallel.flip_sharded import ShardedFlipSim

    t_phase = time.perf_counter()
    with dryrun.process_group(dev):
        ref = _flip_sim(dev)
        sim = ShardedFlipSim("water_cube_drop", bound=BOUND, density=DENSITY,
                             seed=SEED)
        p = sim.num_particles
        if p != ref.num_particles:
            raise AssertionError(f"sharded flip: {p} particles, FlipSim "
                                 f"{ref.num_particles}")
        print(f"sharded flip: world 1, slab {sim.slab.rows} rows (solve "
              f"slab {sim.slab.nl} rows, null edge planes), cap "
              f"{sim.cap}, mig_cap {sim.mig_cap}, tail_insert "
              f"{sim.tail_insert}, {p} particles, device {sim.device}")
        want = [ref.step() for _ in range(2 + FRAMES)]
        got = [sim.step() for _ in range(2)]
        _zero_counts(counted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got += [sim.step() for _ in range(FRAMES)]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        builds = tk.chunk_plan.builds
        for f, (m, r) in enumerate(zip(got, want)):
            kg, kr = float(m["kinetic_energy"]), float(r["kinetic_energy"])
            print(f"sharded flip frame {f}: ke {kg:.7g} outer "
                  f"{m['outer_iters']} cg {m['cg_iters']} fluid "
                  f"{int(m['num_fluid_cells'])} | FlipSim ke {kr:.7g} outer "
                  f"{r['outer_iters']} cg {r['cg_iters']} fluid "
                  f"{int(r['num_fluid_cells'])}")
            if (abs(kg - kr) > 1e-4 * abs(kr)
                    or m["outer_iters"] != r["outer_iters"]
                    or m["cg_iters"] != r["cg_iters"]
                    or int(m["num_fluid_cells"]) != int(r["num_fluid_cells"])
                    or int(m["num_alive"]) != p or int(m["lost"]) != 0):
                raise AssertionError(f"sharded flip frame {f}: differs from "
                                     "FlipSim or lost particles")
        timed = got[2:]
        solves = sum(m["cg_iters"] + m["outer_iters"] for m in timed)
        k3, k4 = _stencil_launches(sim.params)
        want_l = {name: 0 for name in launches}
        want_l.update({"p2g_scatter": FRAMES, "chunk_fill": FRAMES,
                       "g2p_gather": FRAMES, "apply_laplacian": k3 * solves,
                       "cheb_steps": k4 * solves})
        print("sharded flip: launches in the timed frames:",
              json.dumps(launches), f"K1 chunk plans built: {builds}")
        if launches != want_l or builds != FRAMES:
            raise AssertionError(f"sharded flip: launches {launches}, "
                                 f"expected {want_l}")
        pos = sim.state.pos[sim.state.alive]
        if not bool(torch.isfinite(pos).all()) or float(pos.abs().max()) >= BOUND:
            raise AssertionError("sharded flip: particles left the box")
        # one rank holds the box: its alive prefix is FlipSim's state
        for field in ("pos", "vel"):
            _require_bitwise(f"sharded flip: {field} after {2 + FRAMES} "
                             "frames against FlipSim's",
                             getattr(sim.state, field)[:p],
                             getattr(ref.state, field), torch)
        _require_bitwise("sharded flip: pressure against FlipSim's",
                         sim.state.pressure, ref.state.pressure, torch)
        ms = 1e3 * wall_s / FRAMES
        print(f"sharded flip: ms/frame {ms:.3f} against phase 4's "
              f"{flip_ms:.3f} (FlipSim), CG iterations/frame "
              f"{sum(m['cg_iters'] for m in timed) / FRAMES:.1f} ({FRAMES} "
              "frames, host clock, synchronised)")
        del ref, sim, want, got
    print(f"phase 32: {time.perf_counter() - t_phase:.2f} s")
    return launches


def _sharded_mpm_phase(dev, counted, torch, mpm_ms):
    """Phase 33: the sharded MPM at world size 1 on NCCL, ``mpm_cone`` at
    127^3, 2 warm-up and ``MPM_SHARD_FRAMES`` timed frames, against
    ``MpmSim`` on the card.  Returns the timed frames' launches."""
    from fluidsim_tpu_torch.models.mpm import MpmSim
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.parallel import dryrun
    from fluidsim_tpu_torch.parallel.mpm_sharded import ShardedMpmSim

    t_phase = time.perf_counter()
    frames = MPM_SHARD_FRAMES
    with dryrun.process_group(dev):
        ref = MpmSim("mpm_cone", bound=MPM_BOUND, seed=SEED, device=dev)
        sim = ShardedMpmSim("mpm_cone", bound=MPM_BOUND, seed=SEED)
        p = sim.num_particles
        if p != ref.num_particles:
            raise AssertionError(f"sharded mpm: {p} particles, MpmSim "
                                 f"{ref.num_particles}")
        print(f"sharded mpm: world 1, slab {sim.slab.rows} rows, cap "
              f"{sim.cap}, mig_cap {sim.mig_cap}, {p} particles, operator "
              f"{sim.params.hessian}")
        want = [ref.step() for _ in range(2 + frames)]
        got = [sim.step() for _ in range(2)]
        _zero_counts(counted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got += [sim.step() for _ in range(frames)]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        builds = tk.chunk_plan.builds
        applies = 0
        for f, (m, r) in enumerate(zip(got, want)):
            kg, kr = float(m["kinetic_energy"]), float(r["kinetic_energy"])
            solves, converged = _mpm_solves(m, sim.params)
            print(f"sharded mpm frame {f}: ke {kg:.7g} cg {m['cg_iters']} "
                  f"spd {m['spd_fallback']} min det FP "
                  f"{float(m['min_det_fp']):.6g} | MpmSim ke {kr:.7g} cg "
                  f"{r['cg_iters']}")
            if (abs(kg - kr) > 1e-4 * abs(kr) or not converged
                    or abs(m["cg_iters"] - r["cg_iters"]) > solves
                    or float(m["min_det_fp"]) <= 0
                    or int(m["num_alive"]) != p or int(m["lost"]) != 0):
                raise AssertionError(f"sharded mpm frame {f}: differs from "
                                     "MpmSim or lost particles")
            if f >= 2:
                applies += m["cg_iters"] + solves
        want_l = {name: 0 for name in launches}
        want_l.update({"p2g_scatter": frames, "chunk_fill": frames,
                       "g2p_gather": 2 * frames,
                       "p2g_scatter_force": frames + applies,
                       "g2p_gather_gw": applies + frames})
        print("sharded mpm: launches in the timed frames:",
              json.dumps(launches), f"K1 chunk plans built: {builds}")
        if launches != want_l or builds != frames:
            raise AssertionError(f"sharded mpm: launches {launches}, "
                                 f"expected {want_l}")
        st = sim.state
        if not all(bool(torch.isfinite(t[st.alive]).all())
                   for t in (st.pos, st.FE, st.FP)):
            raise AssertionError("sharded mpm: non-finite state")
        for field in ("pos", "vel", "FE", "FP", "volume"):
            _require_bitwise(f"sharded mpm: {field} after {2 + frames} "
                             "frames against MpmSim's",
                             getattr(st, field)[:p], getattr(ref.state, field),
                             torch)
        timed = got[2:]
        print(f"sharded mpm: ms/frame {1e3 * wall_s / frames:.3f} against "
              f"phase 11's {mpm_ms:.3f} (MpmSim), CG iterations/frame "
              f"{sum(m['cg_iters'] for m in timed) / frames:.1f} ({frames} "
              "frames, host clock, synchronised)")
        del ref, sim, want, got
    print(f"phase 33: {time.perf_counter() - t_phase:.2f} s")
    return launches


def _sharded_card_against_cpu(dev, torch):
    """Phase 34: the sharded FLIP at bound 8 and the sharded MPM at bound
    15 (density 40), world size 1, 3 frames on the card (NCCL) against 3 on
    the CPU (a gloo group of the same process), as phases 9 and 13."""
    import torch.distributed as dist

    from fluidsim_tpu_torch.parallel import dryrun
    from fluidsim_tpu_torch.parallel.flip_sharded import ShardedFlipSim
    from fluidsim_tpu_torch.parallel.mpm_sharded import ShardedMpmSim

    with dryrun.process_group(dev):
        gloo = dist.new_group([0], backend="gloo")
        for kind in ("flip", "mpm"):
            if kind == "flip":
                make = lambda d, grp: ShardedFlipSim(
                    "water_cube_drop", seed=SEED, device=d, group=grp,
                    **SHARD_SMALL)
            else:
                make = lambda d, grp: ShardedMpmSim(
                    "mpm_cone", seed=SEED, device=d, group=grp, **MPM_SMALL)
            gpu_sim, cpu_sim = make(dev, None), make("cpu", gloo)
            for f in range(3):
                mg, mc = gpu_sim.step(), cpu_sim.step()
                kg, kc = (float(mg["kinetic_energy"]),
                          float(mc["kinetic_energy"]))
                outer = mc.get("outer_iters", 1)
                print(f"reference sharded {kind} frame {f}: card ke {kg:.7g} "
                      f"cg {mg['cg_iters']} | cpu ke {kc:.7g} cg "
                      f"{mc['cg_iters']}")
                if (abs(kg - kc) > 1e-4 * abs(kc)
                        or mg.get("outer_iters") != mc.get("outer_iters")
                        or abs(mg["cg_iters"] - mc["cg_iters"]) > outer
                        or int(mg["lost"]) != 0 or int(mc["lost"]) != 0):
                    raise AssertionError(f"sharded {kind} frame {f}: card "
                                         "and cpu differ")
            alive = cpu_sim.state.alive
            if not torch.equal(gpu_sim.state.alive.cpu(), alive):
                raise AssertionError(f"sharded {kind}: alive slots differ")
            pos_err = _max_err(gpu_sim.state.pos.cpu()[alive],
                               cpu_sim.state.pos[alive])
            tol = 1e-3 if kind == "flip" else 1e-4
            msg = f"max pos diff card vs cpu {pos_err:.3e}"
            if pos_err > tol:
                raise AssertionError(f"sharded {kind}: positions differ by "
                                     f"{pos_err}")
            if kind == "mpm":
                fe_err = _max_err(gpu_sim.state.FE.cpu()[alive],
                                  cpu_sim.state.FE[alive])
                if fe_err > 1e-5:
                    raise AssertionError(f"sharded mpm: FE differs by {fe_err}")
                msg += f", max FE diff {fe_err:.3e}"
            print(f"reference sharded {kind}: world 1, {int(alive.sum())} "
                  f"particles, 3 frames, {msg}")


def _sharded_phases(dev, counted, torch, np, flip_ms, mpm_ms, solve_fields):
    """Phases 31-34; returns (the slab kernels' numbers, launches of the
    sharded FLIP and MPM paths)."""
    results = _slab_phase(dev, torch, np, solve_fields)
    flip = _sharded_flip_phase(dev, counted, torch, flip_ms)
    mpm = _sharded_mpm_phase(dev, counted, torch, mpm_ms)
    _sharded_card_against_cpu(dev, torch)
    return results, {"sharded_flip": flip, "sharded_mpm": mpm}


# ---- phase 35: the tools suite at the main path's width (before phase 30) -

TOOL_RUNS = 3          # host-clock runs per tool, after one warm-up
TOOL_MESH_BOUND = 16   # mesh_to_sdf's card-against-CPU size (129^3 is timed)
IMG_TOL = 1e-3         # the image rule of tests/test_torch_raytrace.py
DEPTH_TOL = 0.02


def _host_ms(fn, torch):
    """Median host-clock ms of a synchronised ``fn()`` over ``TOOL_RUNS``
    runs after a warm-up, and its last result."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TOOL_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), out


def _aten_ops(fn):
    """The PyTorch operators one call of ``fn`` dispatches (each one or a
    few kernel launches on the card), counted by a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _same_image(name, got, want, np):
    """The card's (img, hit, depth) against the CPU's under the image rule
    of ``tests/test_torch_raytrace.py``: at most 0.5% of the pixels (at
    least 2) differ in hit or by more than ``IMG_TOL`` in colour; depths
    of the other rays that both hit within ``DEPTH_TOL``."""
    img, hit, depth = (x.cpu().numpy() for x in got)
    cimg, chit, cdepth = (x.numpy() for x in want)
    bad = (hit != chit) | (np.abs(img - cimg).max(axis=-1) > IMG_TOL)
    flips = max(2, hit.size // 200)
    both = hit & chit & ~bad
    derr = float(np.abs(depth[both] - cdepth[both]).max()) if both.any() else 0
    print(f"{name}: card vs CPU {int(bad.sum())} of {hit.size} pixels apart "
          f"(<= {flips}), max depth diff {derr:.3e} (<= {DEPTH_TOL}), "
          f"coverage {hit.mean():.1%}")
    if bad.sum() > flips or derr > DEPTH_TOL:
        raise AssertionError(f"{name}: card and CPU images differ")


def _require_close(name, got, want, tol, torch):
    """``got`` (card) within ``tol`` times ``want``'s (CPU) scale, or bit
    for bit with ``tol`` 0."""
    got = got.cpu()
    if tol == 0:
        _require_same_bits(name, got, want, torch)
        print(f"{name}: card equals the CPU bit for bit")
        return
    scale = max(1.0, float(want.abs().max()))
    err = float((got.double() - want.double()).abs().max())
    print(f"{name}: max |card - CPU| {err:.3e} (<= {tol * scale:.3e})")
    if not err <= tol * scale:
        raise AssertionError(f"{name}: card differs from the CPU by {err}")


def _tools_phase(dev, torch, np, flip_pos):
    """Phase 35: the tools on phase 4's final FLIP state at 129^3, each
    against the CPU and timed on the card; the ``raytrace`` and ``view``
    commands on its ``.vdb``."""
    import tempfile

    from fluidsim_tpu_torch import cli
    from fluidsim_tpu_torch.io.render import write_image
    from fluidsim_tpu_torch.io.vdb import VdbGrid, read_vdb, write_vdb
    from fluidsim_tpu_torch.ops import (composite, levelset_tools, mesh,
                                        morphology, partition, platonic,
                                        statistics as st, volume_to_mesh,
                                        volume_to_spheres)
    from fluidsim_tpu_torch.ops.levelset import particles_to_levelset
    from fluidsim_tpu_torch.ops.raytrace import raytrace_levelset

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    b = BOUND
    sdf = particles_to_levelset(flip_pos, b)
    sdf_c, pos_c = sdf.cpu(), flip_pos.cpu()
    print(f"tools: the level set of phase 4's final state, {flip_pos.shape[0]} "
          f"particles, {2 * b + 1}^3, {int((sdf_c < 0).sum())} cells inside")
    ms, ops = {}, {}   # host-clock ms, PyTorch operators a call

    # the sphere tracer at the CLI's 512x512 and default camera
    eye, look = (0.0, 0.3 * b, -2.2 * b), (0.0, 0.0, 0.0)
    cams = {"raytrace": dict(width=512, height=512),
            "raytrace_ortho_ss4": dict(width=512, height=512,
                                       camera="orthographic", samples=4)}
    for name, kw in cams.items():
        ms[name], got = _host_ms(
            lambda: raytrace_levelset(sdf, b, eye, look, **kw), torch)
        ops[name] = _aten_ops(
            lambda: raytrace_levelset(sdf, b, eye, look, **kw))
        _same_image(name, got, raytrace_levelset(sdf_c, b, eye, look, **kw),
                    np)

    # the grid tools, each against the same call on the CPU; the flood
    # fill's input keeps the band |phi| < 0.5 and loses the signs beyond
    def flood(g):
        return composite.signed_flood_fill(
            torch.where(g.abs() < 0.5, g, 0.5), 0.5)

    cases = (
        ("redistance", lambda g: levelset_tools.redistance(g, 20), 1e-4),
        ("filter_median", levelset_tools.filter_median, 0),
        ("signed_flood_fill", flood, 0),
        ("dilate", lambda g: morphology.dilate(g < 0, 2,
                                               morphology.NN_FACE_EDGE), 0),
        ("erode", lambda g: morphology.erode(g < 0, 2, morphology.NN_FACE),
         0),
        ("histogram", lambda g: st.histogram(g, 64, -3.0, 3.0), 0))
    for name, fn, tol in cases:
        ms[name], got = _host_ms(lambda: fn(sdf), torch)
        _require_close(name, got, fn(sdf_c), tol, torch)
    ops["signed_flood_fill"] = _aten_ops(lambda: flood(sdf))
    ms["stats"], got = _host_ms(lambda: st.stats(sdf), torch)
    want = st.stats(sdf_c)
    for key, a, c in zip(want._fields, got, want):
        # the variance is E[v^2] - mean^2: its noise scales with E[v^2]
        tol = {"min": 0, "max": 0, "count": 0, "mean": 1e-5}.get(key, 1e-4)
        _require_close(f"stats.{key}", a.reshape(1).double(),
                       c.reshape(1).double(), tol, torch)
    ms["partition_by_cell"], part = _host_ms(
        lambda: partition.partition_by_cell(flip_pos, b), torch)
    for key, a, c in zip(part._fields, part,
                         partition.partition_by_cell(pos_c, b)):
        _require_close(f"partition_by_cell.{key}", a, c, 0, torch)

    ms["volume_to_mesh"], (verts, quads) = _host_ms(
        lambda: volume_to_mesh.volume_to_mesh(sdf, bound=b), torch)
    cverts, cquads = volume_to_mesh.volume_to_mesh(sdf_c, bound=b)
    if verts.shape != cverts.shape or not np.array_equal(quads, cquads):
        raise AssertionError("volume_to_mesh: card and CPU meshes differ")
    verr = float(np.abs(verts - cverts).max())
    print(f"volume_to_mesh: {len(verts)} vertices, {len(quads)} quads, the "
          f"quads bit for bit the CPU's, vertices within {verr:.3e} (<= 1e-5)")
    if verr > 1e-5:
        raise AssertionError("volume_to_mesh: vertices differ")

    # spheres in the redistanced level set (the particles' union of unit
    # spheres is at most one cell deep): the card's field on both sides
    count = 16
    deep = levelset_tools.redistance(sdf, 20)
    deep_c = deep.cpu()
    ms["fill_with_spheres"], (ctr, rad) = _host_ms(
        lambda: volume_to_spheres.fill_with_spheres(deep, count, b, 0.5),
        torch)
    cctr, crad = volume_to_spheres.fill_with_spheres(deep_c, count, b, 0.5)
    rerr = float((rad.cpu() - crad).abs().max())
    moved = int(((ctr.cpu() != cctr).any(dim=1) & (crad > 0)).sum())
    print(f"fill_with_spheres: {int((rad > 0).sum())} of {count} placed, max "
          f"radius {float(rad.max()):.4g}, radii within {rerr:.3e} (<= 1e-4) "
          f"of the CPU's, {moved} centres elsewhere (a tie of clearances)")
    if rerr > 1e-4 or not torch.equal(torch.isnan(ctr.cpu()),
                                      torch.isnan(cctr)):
        raise AssertionError("fill_with_spheres: card and CPU differ")

    # meshes -> SDF: card against CPU at a small bound, timed at 129^3
    v, t = mesh.icosphere((0.0, 0.0, 0.0), 0.6 * b, subdivisions=3)
    for name, fn in (
            ("mesh_to_sdf", lambda bb, d: mesh.mesh_to_sdf(
                v * bb / b, t, bb, device=d)),
            ("platonic_sdf", lambda bb, d: platonic.platonic_sdf(
                20, bb, 0.7 * bb, device=d))):
        got = fn(TOOL_MESH_BOUND, dev).cpu()
        want = fn(TOOL_MESH_BOUND, cpu)
        err = float((got.abs() - want.abs()).abs().max())
        # a sign may differ only on the surface, where |d| is f32 noise
        flips = int(((torch.sign(got) != torch.sign(want))
                     & (want.abs() > 1e-4)).sum())
        print(f"{name} at bound {TOOL_MESH_BOUND}: |d| within {err:.3e} "
              f"(<= 1e-5) of the CPU's, {flips} signs apart off the surface")
        if err > 1e-5 or flips > 0:
            raise AssertionError(f"{name}: card and CPU differ")
        ms[name], out = _host_ms(lambda: fn(b, dev), torch)
        if not bool(torch.isfinite(out).all()) or float(out.min()) >= 0:
            raise AssertionError(f"{name}: no interior at 129^3")
    ops["mesh_to_sdf"] = _aten_ops(lambda: mesh.mesh_to_sdf(v, t, b,
                                                            device=dev))
    print(f"mesh_to_sdf: {len(t)} triangles at {2 * b + 1}^3")

    # the level set as a .vdb; the commands on it with the default device
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix="_tools_smoke_") as tmp:
        path = os.path.join(tmp, "levelset.vdb")
        write_vdb(path, [VdbGrid(values=sdf_c.numpy(), origin=(-b,) * 3,
                                 background=3.0)])
        g = read_vdb(path)[0]
        lo = [-b - o for o in g.origin]
        block = g.values[lo[0]:lo[0] + 2 * b + 1, lo[1]:lo[1] + 2 * b + 1,
                         lo[2]:lo[2] + 2 * b + 1]
        if not np.array_equal(block, sdf_c.numpy()):
            raise AssertionError("levelset.vdb: read back differs")
        cube, cb, off = cli._levelset_cube(g)
        cube = torch.as_tensor(cube, device=dev)

        def direct(png, size, eye):
            img, _, _ = raytrace_levelset(
                cube, cb, tuple(np.asarray(eye) - off), tuple(-off),
                width=size, height=size)
            write_image(png, img.cpu().numpy() * 255.0)
            with open(png, "rb") as f:
                return f.read()

        ray = os.path.join(tmp, "ray.png")
        t0 = time.perf_counter()
        if cli.main(["raytrace", path, "-o", ray]) != 0:
            raise AssertionError("cli raytrace failed")
        ms["cli_raytrace"] = 1e3 * (time.perf_counter() - t0)
        pairs = [(ray, direct(os.path.join(tmp, "d.png"), 512,
                              (0.0, 0.3 * cb, -2.2 * cb)))]
        t0 = time.perf_counter()
        if cli.main(["view", path, "--orbit", "4", "-o",
                     os.path.join(tmp, "v.png")]) != 0:
            raise AssertionError("cli view failed")
        ms["cli_view_orbit4"] = 1e3 * (time.perf_counter() - t0)
        for k in range(4):
            th = 2.0 * np.pi * k / 4
            r = 2.2 * cb
            pairs.append((os.path.join(tmp, f"v_{k:04d}.png"), direct(
                os.path.join(tmp, f"d{k}.png"), 384,
                [r * np.sin(th), 0.4 * cb, -r * np.cos(th)])))
        for png, want in pairs:
            with open(png, "rb") as f:
                if f.read() != want:
                    raise AssertionError(f"{os.path.basename(png)}: the "
                                         "command's PNG differs from the "
                                         "direct call's")
        print(f"cli raytrace and view --orbit 4: {len(pairs)} PNGs bit for "
              f"bit the direct calls' ({2 * cb + 1}^3 cube from the .vdb)")
    for name, val in ms.items():
        extra = f", {ops[name]} aten ops a call" if name in ops else ""
        print(f"tool {name}: {val:.3f} ms (host clock){extra}")
    print(f"phase 35: {time.perf_counter() - t_phase:.2f} s")


# ---- phase 36: the transfer-spline choice (after 35, before phase 30) ----

SPLINE_SHARD_FRAMES = 3  # phase 36d's frames


def _flip_spline_kernels(sim, torch):
    """Phase 36b: K1 (the mass and momentum P2G) and K2 (the FLIP delta's
    gather) on the sorted particles of ``sim`` after its warm-up frames and
    their FLIP-spline table, as in phase 10; returns the two kernels' line
    fields."""
    from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm
    from fluidsim_tpu_torch.ops import mpm_kernels as mk
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    prm, st = sim.params, sim.state
    B, n, P = prm.bound, 2 * prm.bound + 1, sim.num_particles
    pos_s, vel_s, *_, flat = mk.sort_mpm(st.pos, st.vel, st.FE, st.FP,
                                         st.volume, B)
    wt = tk.masked_weights_cm(pos_s, B, "flip")
    print(f"mpm flip spline, frame-2 state: {int((wt < 0).sum())} of "
          f"{27 * P} FLIP-spline weights round below 0 (least "
          f"{float(wt.min()):.3e}), which the mass drops")
    cs = tk.cell_starts(flat, n)
    plan = tk.chunk_plan(cs, P)
    k1 = _compare(
        "K1 p2g_scatter (cone, FLIP spline)",
        lambda: tk.p2g_scatter(wt, vel_s, cs, n, plan),
        lambda: tk.p2g_scatter_plain(wt, vel_s, cs, n), 1e-5,
        (wt, vel_s, cs), 27 * 7 * P, torch)
    k1.update(_k1_order_checks(
        "K1, the cone state on the FLIP spline",
        lambda c, pl: tk.p2g_scatter(wt, vel_s, c, n, pl),
        lambda pl: tk.p2g_scatter_chunked(wt, vel_s, pl, n), cs, n, P,
        torch))
    # the mass's launch reads the positive weights alone
    wpos = torch.where(wt > 0, wt, 0.0)
    _require_bitwise("K1 on the positive FLIP-spline weights (the mass): "
                     "kernels == their order in PyTorch",
                     tk.p2g_scatter(wpos, vel_s, cs, n, plan),
                     tk.p2g_scatter_chunked(wpos, vel_s, plan, n), torch)
    mass, mom = mk.p2g_flip_spline(wt, vel_s, cs, sim.solid, B, plan)
    heavy = mass > prm.mass_threshold
    velg = torch.where(heavy[None], mom / torch.where(heavy, mass, 1.0)[None],
                       0.0)
    # K2 as the FLIP delta launches it (mpm_kernels.flip_delta), on a
    # cell-centred velocity of this state
    fm = tk.gather_fields(cell_center_velocity_cm(velg), B, prm.wall)
    k2 = _compare(
        "K2 g2p_gather (cone FLIP delta, FLIP spline)",
        lambda: tk.g2p_gather(fm, wt, flat),
        lambda: tk.g2p_gather_plain(fm, wt, flat), 1e-5,
        (wt, flat), 27 * 8 * P, torch,
        extra_bytes=_field_bytes(flat, n, n, 4))
    k2["staged_tiles"] = _k2_staged("the cone state, FLIP spline", fm, wt,
                                    flat, None, torch)
    return k1, k2


def _sharded_flip_mpm_spline(dev, counted, torch):
    """Phase 36d: ``ShardedFlipSim(kernel="mpm")`` at world size 1 on NCCL,
    ``water_cube_drop`` at 129^3, ``SPLINE_SHARD_FRAMES`` frames against
    ``FlipSim(kernel="mpm")`` with phase 32's checks; returns the frames'
    launches."""
    from fluidsim_tpu_torch.models.flip import FlipParams, FlipSim
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.parallel import dryrun
    from fluidsim_tpu_torch.parallel.flip_sharded import ShardedFlipSim
    from fluidsim_tpu_torch.scenes import get_scene

    frames = SPLINE_SHARD_FRAMES
    scene = get_scene("water_cube_drop", bound=BOUND, density=DENSITY)
    params = FlipParams(bound=BOUND, wall=scene.spec.wall, dx=scene.spec.dx,
                        gravity=tuple(scene.gravity), kernel="mpm")
    with dryrun.process_group(dev):
        ref = FlipSim(scene, params=params, seed=SEED, device=dev)
        sim = ShardedFlipSim(scene, params=params, seed=SEED)
        p = sim.num_particles
        if p != ref.num_particles or sim.params.kernel != "mpm":
            raise AssertionError(f"sharded flip, MPM spline: {p} particles, "
                                 f"FlipSim {ref.num_particles}")
        want = [ref.step() for _ in range(frames)]
        _zero_counts(counted)
        got = [sim.step() for _ in range(frames)]
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        builds = tk.chunk_plan.builds
        for f, (m, r) in enumerate(zip(got, want)):
            kg, kr = float(m["kinetic_energy"]), float(r["kinetic_energy"])
            print(f"sharded flip, MPM spline, frame {f}: ke {kg:.7g} outer "
                  f"{m['outer_iters']} cg {m['cg_iters']} fluid "
                  f"{int(m['num_fluid_cells'])} | FlipSim ke {kr:.7g} outer "
                  f"{r['outer_iters']} cg {r['cg_iters']} fluid "
                  f"{int(r['num_fluid_cells'])}")
            if (abs(kg - kr) > 1e-4 * abs(kr)
                    or m["outer_iters"] != r["outer_iters"]
                    or m["cg_iters"] != r["cg_iters"]
                    or int(m["num_fluid_cells"]) != int(r["num_fluid_cells"])
                    or int(m["num_alive"]) != p or int(m["lost"]) != 0):
                raise AssertionError(f"sharded flip, MPM spline, frame {f}: "
                                     "differs from FlipSim or lost particles")
        solves = sum(m["cg_iters"] + m["outer_iters"] for m in got)
        k3, k4 = _stencil_launches(sim.params)
        want_l = {name: 0 for name in launches}
        want_l.update({"p2g_scatter": frames, "chunk_fill": frames,
                       "g2p_gather": frames, "apply_laplacian": k3 * solves,
                       "cheb_steps": k4 * solves})
        print("sharded flip, MPM spline: launches in its frames:",
              json.dumps(launches), f"K1 chunk plans built: {builds}")
        if launches != want_l or builds != frames:
            raise AssertionError(f"sharded flip, MPM spline: launches "
                                 f"{launches}, expected {want_l}")
        for field in ("pos", "vel"):
            _require_bitwise(f"sharded flip, MPM spline: {field} after "
                             f"{frames} frames against FlipSim's",
                             getattr(sim.state, field)[:p],
                             getattr(ref.state, field), torch)
        _require_bitwise("sharded flip, MPM spline: pressure against "
                         "FlipSim's", sim.state.pressure, ref.state.pressure,
                         torch)
        del ref, sim, want, got
    return launches


def _spline_phase(dev, counted, torch, mpm_particles, mpm_ms, mpm_cg,
                  mpm_spd):
    """Phase 36 (see the module docstring).  Returns (the K1 and K2 line
    fields of 36b, the launches of 36a's timed frames and of 36d's)."""
    from fluidsim_tpu_torch.models.mpm import MpmParams, MpmSim
    from fluidsim_tpu_torch.scenes import get_scene

    t_phase = time.perf_counter()
    # ---- 36a. the MPM frame on the FLIP spline at 127^3 -----------------
    scene = get_scene("mpm_cone", bound=MPM_BOUND)
    sim = MpmSim(scene, seed=SEED, device=dev, params=MpmParams(
        bound=MPM_BOUND, wall=scene.spec.wall, dx=scene.spec.dx,
        gravity=tuple(scene.gravity), kernel="flip"))
    if sim.num_particles != mpm_particles:
        raise AssertionError(f"mpm-flip-spline: {sim.num_particles} "
                             f"particles, phase 10 had {mpm_particles}")
    print(f"mpm-flip-spline: mpm_cone bound {MPM_BOUND}, {mpm_particles} "
          f"particles, operator {sim.params.hessian}, kernel "
          f"{sim.params.kernel}")
    warm = [sim.step() for _ in range(2)]
    print("mpm-flip-spline warm-up: cg_iters "
          f"{[m['cg_iters'] for m in warm]}, spd_fallback "
          f"{[m['spd_fallback'] for m in warm]}")
    # ---- 36b. K1 and K2 on that state's FLIP-spline table ---------------
    k1, k2 = _flip_spline_kernels(sim, torch)
    _, launches, cg, ms, spd = _run_mpm_frames(sim, counted, torch,
                                               "mpm-flip-spline")
    print(f"mpm-flip-spline: ms/frame {ms:.3f} against phase 11's "
          f"{mpm_ms:.3f}; CG iterations per frame {cg} against {mpm_cg}; "
          f"SPD fallbacks {spd} against {mpm_spd}")
    del sim
    # ---- 36c. card against CPU at bound 15 ------------------------------
    for hessian in ("full", "hybrid"):
        _mpm_small_scene(hessian, dev, kernel="flip")
    # ---- 36d. the sharded FLIP on the MPM spline at world size 1 --------
    shard = _sharded_flip_mpm_spline(dev, counted, torch)
    print(f"phase 36: {time.perf_counter() - t_phase:.2f} s")
    return ({"p2g_scatter": k1, "g2p_gather": k2},
            {"mpm_flip_spline": launches, "sharded_flip_mpm_spline": shard})


# ---- phase 37: the validation runs (after 36, before phase 30) -----------

VALID_FRAMES = 60          # 37a's FLIP soak and 37b's MPM runs
PARITY_FRAMES = 40         # 37a's frames held to the C++ record
CONFIG5_FRAMES = 3         # 37c
MPM_SHAPE_FRAMES = 2       # 37d
SCALED_BOUND, SCALED_FRAMES = 63, 20   # soak_mpm_scaled's run at 127^3


def _quiet(figures):
    """A validation run's figures without its per-frame lists."""
    return {k: v for k, v in figures.items() if not isinstance(v, list)
            or k == "failures"}


def _col(rows, key):
    return [r[key] for r in rows]


def _require_pass(label, figures):
    print(f"{label}: {json.dumps(_quiet(figures))}")
    if not figures["pass"]:
        raise AssertionError(f"{label}: the oracle failed")


def _path_launches(label, counted, want):
    """The launches since the counts were set to 0, against ``want``
    (kernel -> count, or None where any positive count will do; every
    other kernel 0)."""
    got = {fn.__name__: fn.launches for fn in counted}
    print(f"{label}: launches {json.dumps(got)}")
    bad = [k for k, v in got.items()
           if (v != want[k] if want.get(k) is not None
               else (v > 0) != (k in want))]
    if bad:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    return got


def _flip_want(params, outer, cg):
    """A FLIP path's launches from its frames' outer passes and CG
    iterations (as phase 4 counts them)."""
    k3, k4 = _stencil_launches(params)
    solves = sum(outer) + sum(cg)
    frames = len(outer)
    return {"p2g_scatter": frames, "chunk_fill": frames,
            "g2p_gather": frames, "apply_laplacian": k3 * solves,
            "cheb_steps": k4 * solves}


def _mpm_want(params, cg, spd):
    """An MPM path's launches from its frames' CG iterations and SPD
    fallbacks (as phase 11 counts them)."""
    applies = sum(c + _mpm_solves({"cg_iters": c, "spd_fallback": s},
                                  params)[0] for c, s in zip(cg, spd))
    frames = len(cg)
    return {"p2g_scatter": frames, "chunk_fill": frames,
            "g2p_gather": 2 * frames, "p2g_scatter_force": frames + applies,
            "g2p_gather_gw": frames + applies}


def _mpm_path_want():
    return {k: None for k in ("p2g_scatter", "chunk_fill", "g2p_gather",
                              "p2g_scatter_force", "g2p_gather_gw")}


def _kernels_257(sim, last, torch):
    """Phase 37e on ``validate_config5``'s ``FlipSim`` after its frames: K1
    and K2 on its particles sorted with random velocities, K3 and K4 on its
    last frame's fields, as phase 3 holds them; entries ``<kernel>_257``."""
    import numpy as np

    from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm
    from fluidsim_tpu_torch.ops import pressure as pr
    from fluidsim_tpu_torch.ops import stencil_kernels as sk
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm

    B, wall = sim.params.bound, sim.params.wall
    n, P = 2 * B + 1, sim.num_particles
    where = f"{n}^3, {P} particles"
    dev = sim.state.pos.device
    vel = torch.as_tensor(np.random.default_rng(SEED).normal(
        scale=3.0, size=(P, 3)).astype(np.float32), device=dev)
    pos_s, vel_s, flat = tk.sort_by_cell(sim.state.pos, vel, B)
    del vel
    w27t = tk.masked_weights_cm(pos_s, B)
    cs = tk.cell_starts(flat, n)
    plan = tk.chunk_plan(cs, P)
    acc = tk.p2g_scatter(w27t, vel_s, cs, n, plan)
    fm = tk.gather_fields(cell_center_velocity_cm(
        normalize_velocity_cm(acc[0], acc[1:4])), B, wall)
    del acc
    results = {}
    _slab_kernels(where, "validate_config5", results, [
        ("p2g_scatter_257", "K1 p2g_scatter",
         lambda: tk.p2g_scatter(w27t, vel_s, cs, n, plan),
         lambda: tk.p2g_scatter_plain(w27t, vel_s, cs, n), 1e-5,
         (w27t, vel_s, cs), 27 * 7 * P,
         lambda: tk.p2g_scatter_chunked(w27t, vel_s, plan, n)),
        ("g2p_gather_257", "K2 g2p_gather",
         lambda: tk.g2p_gather(fm, w27t, flat),
         lambda: tk.g2p_gather_plain(fm, w27t, flat), 1e-5, (w27t, flat),
         27 * 8 * P, None, _field_bytes(flat, n, n, 4))], torch, "shape")
    results["p2g_scatter_257"].update(_k1_order_checks(
        f"K1, {where}", lambda c, pl: tk.p2g_scatter(w27t, vel_s, c, n, pl),
        lambda pl: tk.p2g_scatter_chunked(w27t, vel_s, pl, n), cs, n, P,
        torch))
    results["g2p_gather_257"]["staged_tiles"] = _k2_staged(
        where, fm, w27t, flat, None, torch)
    del pos_s, vel_s, flat, w27t, cs, plan, fm
    fluid = (last["occupancy"] > 0) & ~sim.solid
    dt = last["dt_used"]
    adiag = pr.laplacian_diag(fluid, sim.solid, dt, 1.0, 1.0)
    z = torch.where(fluid, sim.state.pressure, 0.0)
    fields = dict(z=z, adiag=adiag, d=0.5 * z, scale=float(dt),
                  r=sk.apply_laplacian_plain(z, adiag, float(dt)))
    print(f"{where}: last frame's {int(fluid.sum())} fluid cells, dt "
          f"{float(dt):.6g}, max|p| {float(z.abs().max()):.4g}")
    for key, entry in _stencil_cases(f"the {n}^3 frame", fields, None,
                                     torch).items():
        entry.update(shape=where, path="validate_config5")
        results[f"{key}_257"] = entry
    return results


def _kernels_255(sim, torch):
    """Phase 37e on ``validate_mpm_shape``'s ``MpmSim`` after its frames:
    K1 fg and K2 gw as phase 10 runs them; entries ``<kernel>_255``."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    n, P = 2 * sim.params.bound + 1, sim.num_particles
    where = f"{n}^3, {P} particles"
    vel_s, flat, w27t, gradw, cs, mass, velg, m9 = _cone_inputs(
        sim, where, torch)
    del vel_s, w27t, mass
    plan = tk.chunk_plan(cs, P)
    fm = torch.where(~sim.solid[None], velg, 0.0)
    results = {}
    _slab_kernels(where, "validate_mpm_shape", results, [
        ("p2g_scatter_force_255", "K1 fg p2g_scatter_force",
         lambda: tk.p2g_scatter_force(gradw, m9, cs, n, plan),
         lambda: tk.p2g_scatter_force_plain(gradw, m9, cs, n), 1e-5,
         (gradw, m9, cs), 27 * 18 * P,
         lambda: tk.p2g_scatter_force_chunked(gradw, m9, plan, n)),
        ("g2p_gather_gw_255", "K2 gw g2p_gather_gw",
         lambda: tk.g2p_gather_gw(fm, gradw, flat),
         lambda: tk.g2p_gather_gw_plain(fm, gradw, flat), 1e-5,
         (gradw, flat), 27 * 18 * P,
         lambda: tk.g2p_gather_gw_ordered(fm, gradw, flat),
         _field_bytes(flat, n, n, 3))], torch, "shape")
    results["p2g_scatter_force_255"].update(_k1_order_checks(
        f"K1 fg, {where}",
        lambda c, pl: tk.p2g_scatter_force(gradw, m9, c, n, pl),
        lambda pl: tk.p2g_scatter_force_chunked(gradw, m9, pl, n), cs, n, P,
        torch))
    return results


def _validation_phase(dev, counted, torch):
    """Phase 37 (see the module docstring).  Returns (the kernels' entries
    at 257^3 and 255^3, the launches of each validation path)."""
    from fluidsim_tpu_torch.parallel import dryrun
    import numpy as np

    from fluidsim_tpu_torch.validation import (
        ke_parity, soak_500, soak_mpm, soak_mpm_scaled, traces,
        validate_config5, validate_mpm_shape)

    t_phase = time.perf_counter()
    launches = {}
    # ---- 37a. FLIP at 121^3: the soak's first frames, the C++ record ----
    _zero_counts(counted)
    sim, rows, secs = soak_500.run(VALID_FRAMES, device=dev)
    launches["soak_500"] = _path_launches(
        "soak_500", counted,
        _flip_want(sim.params, _col(rows, "outer_iters"), _col(rows, "cg_iters")))
    _require_pass(f"soak_500, {VALID_FRAMES} frames",
                  soak_500.figures(sim, rows, secs, dev, recorded=True))
    _require_pass(f"ke_parity flip, frames 0-{PARITY_FRAMES - 1} of that run",
                  ke_parity.flip(PARITY_FRAMES, ke=_col(rows, "kinetic_energy"),
                                 device=dev))
    del sim, rows
    # ---- 37b. MPM at 31^3, and the scaled soak's first frames at 127^3 --
    _zero_counts(counted)
    sim, rows, secs = soak_mpm.run(VALID_FRAMES, device=dev)
    launches["soak_mpm"] = _path_launches(
        "soak_mpm", counted,
        _mpm_want(sim.params, _col(rows, "cg_iters"), _col(rows, "spd_fallback")))
    _require_pass(f"soak_mpm, {VALID_FRAMES} frames",
                  soak_mpm.figures(sim, rows, secs, dev, recorded=True))
    _zero_counts(counted)
    parity = ke_parity.mpm(VALID_FRAMES, device=dev)
    launches["ke_parity_mpm"] = _path_launches("ke_parity mpm", counted,
                                               _mpm_path_want())
    _require_pass(f"ke_parity mpm, {VALID_FRAMES} frames", parity)
    # the same run on the CPU: how far the card's frames part from it, and
    # the CPU run's own distance from the C++ record
    on_cpu = ke_parity.mpm(VALID_FRAMES, device="cpu")
    apart = traces.rel_err(parity["ke"], on_cpu["ke"])
    print("ke_parity mpm, card against CPU: " + json.dumps({
        "rel_max": float(apart.max()), "rel_median": float(np.median(apart)),
        "rel_every10": apart[::10].tolist(),
        "cpu_parity": on_cpu["parity"], "cpu_frames_secs":
        on_cpu["frames_secs"]}))
    if not (on_cpu["pass"] and apart.max() < 5e-3):
        raise AssertionError("ke_parity mpm: the card's frames part from the "
                             "CPU's by more than the record's 5e-3 gate")
    _zero_counts(counted)
    sim, rows, seed_secs, cum = soak_mpm_scaled.run(SCALED_FRAMES,
                                                    SCALED_BOUND, dev)
    launches["soak_mpm_scaled"] = _path_launches(
        "soak_mpm_scaled", counted,
        _mpm_want(sim.params, [int(c) for c in _col(rows, "cg_iters")],
                  [int(s) for s in _col(rows, "spd_fallback")]))
    # too short for the trajectory test: held to finite, confined, det FP > 0
    label = f"soak_mpm_scaled --bound {SCALED_BOUND}, {SCALED_FRAMES} frames"
    scaled = soak_mpm_scaled.figures(sim, rows, seed_secs, cum, dev)
    print(f"{label}: {json.dumps(_quiet(scaled))}")
    if not scaled["sound"]:
        raise AssertionError(f"{label}: not finite, not confined or det FP "
                             "<= 0")
    del sim, rows
    results = {}
    # ---- 37c. FLIP at 257^3 beside the sharded FLIP at world size 1 -----
    with dryrun.process_group(dev):
        _zero_counts(counted)
        torch.cuda.reset_peak_memory_stats()
        figs, sim, last = validate_config5.run(frames=CONFIG5_FRAMES,
                                               device=dev, keep=True)
        want = _flip_want(sim.params, figs["outer_iters_single"]
                          + figs["outer_iters_sharded"],
                          figs["cg_iters_single"] + figs["cg_iters_sharded"])
        launches["validate_config5"] = _path_launches("validate_config5",
                                                      counted, want)
        _require_pass(f"validate_config5, world 1, {CONFIG5_FRAMES} frames",
                      figs)
        # ---- 37e. K1-K4 at 257^3 -----------------------------------------
        results.update(_kernels_257(sim, last, torch))
        del sim, last
    # ---- 37d. MPM at 255^3 beside the sharded MPM at world size 1 -------
    with dryrun.process_group(dev):
        _zero_counts(counted)
        torch.cuda.reset_peak_memory_stats()
        figs, sim, _ = validate_mpm_shape.run(frames=MPM_SHAPE_FRAMES,
                                              device=dev, keep=True)
        launches["validate_mpm_shape"] = _path_launches(
            "validate_mpm_shape", counted,
            _mpm_want(sim.params, figs["cg_iters_single"]
                      + figs["cg_iters_sharded"], figs["spd_fallback_single"]
                      + figs["spd_fallback_sharded"]))
        _require_pass(f"validate_mpm_shape, world 1, {MPM_SHAPE_FRAMES} "
                      "frames", figs)
        # ---- 37e. K1 fg and K2 gw at 255^3 -------------------------------
        results.update(_kernels_255(sim, torch))
        del sim
    print(f"phase 37: {time.perf_counter() - t_phase:.2f} s")
    return results, launches


# ---- phase 38: the MPM 3x3 chain's kernels (after 37, before phase 30) ---

MAT3_ROWS = 100_003        # matrices of each synthetic kind: past a block edge
MAT3_BOUND = 127           # mpm255.fall's cone: 255^3, 3,939,805 particles
MAT3_FALL = 10             # the fall's frames
MAT3_PLAIN_FRAMES = 2      # frames held to the plain chain bit for bit
MAT3_SLAB_FRAMES = 2       # a slab rank's frames counted
# the ATen calls that count as f32 operations of the plain chain
_ARITH = frozenset(("add", "sub", "mul", "div", "sqrt", "abs", "neg",
                    "reciprocal", "clamp", "clamp_min", "where", "gt", "lt",
                    "ge", "ne", "argmin"))


def _plain_ops(rows, fn, *args) -> float:
    """f32 operations a row of the plain chain ``fn(*args)`` takes, on CPU
    tensors of ``rows`` rows: the elements each arithmetic ATen call
    writes (selects and compares included), over the rows."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in _ARITH:
                Count.ops += out.numel()
            return out

    with Count():
        fn(*args)
    return Count.ops / rows


def _mat3_ops(torch):
    """Each kernel's plain chain's f32 operations a particle."""
    from fluidsim_tpu_torch.ops import svd3 as sv
    from fluidsim_tpu_torch.utils import synthetic

    rows = 64
    f = torch.as_tensor(synthetic.mat3_cases("near_identity", rows))
    mu = lam = torch.ones(rows)
    g9, scale = torch.ones(9, rows), torch.ones(rows)
    _, dfull, dspd = sv.piola_linearized_plain(f, mu, lam)
    return {"piola_linearized": _plain_ops(rows, sv.piola_linearized_plain,
                                           f, mu, lam),
            "stress_apply": _plain_ops(rows, dfull.apply_plain, g9, scale),
            "stress_apply_spd": _plain_ops(rows, dspd.apply_plain, g9, scale),
            "clamp_singular": _plain_ops(rows, sv.clamp_singular_plain, f,
                                         0.975, 1.0075),
            "mm3": _plain_ops(rows, sv.mm3_plain, f, f)}


def _mat3_frame_inputs(sim, torch):
    """What the 3x3 chain reads in a frame of the MPM sim ``sim`` from its
    state: FE and FP as the sort's payload views, mu and lam, the K2 gw
    gather ``g9`` of the grid velocity over the active cells, the force
    scatter's scale (the frame-0 volumes at frame 0) and the F update's
    ``I + dt gradV``."""
    from fluidsim_tpu_torch.core.splines import cround
    from fluidsim_tpu_torch.ops import mpm_kernels as mk
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.ops.svd3 import det3, hardening

    prm, st = sim.params, sim.state
    B, n = prm.bound, 2 * prm.bound + 1
    pos_s, vel_s, fe, fp, vol, flat = mk.sort_mpm(st.pos, st.vel, st.FE,
                                                  st.FP, st.volume, B)
    w27t, gradw = mk.mpm_stencil(pos_s, B)
    cs = tk.cell_starts(flat, n)
    mass, mom = mk.p2g_mpm(w27t, vel_s, cs, sim.solid, B)
    heavy = mass > prm.mass_threshold
    velg = torch.where(heavy[None], mom / torch.where(heavy, mass, 1.0)[None],
                       0.0)
    dens = mk.density(mass, w27t, flat, sim.solid)
    vol = torch.where(st.frame == 0, 1.0 / torch.where(dens > 0, dens, 1.0),
                      vol)
    mu, lam = hardening(prm.mu0, prm.lam0, prm.hardening_eps, det3(fp),
                        exponent_cap=prm.hardening_max)
    valid = torch.all(torch.abs(cround(pos_s)) <= B, dim=-1)
    g9 = tk.g2p_gather_gw(torch.where((heavy & ~sim.solid)[None], velg, 0.0),
                          gradw, flat)
    gradv = g9.reshape(3, 3, -1).permute(2, 0, 1)
    return dict(fe=fe, fp=fp, mu=mu, lam=lam, g9=g9,
                scale=torch.where(valid, -vol, 0.0),
                lhs=torch.eye(3, device=fe.device) + st.dt * gradv)


def _mat3_synthetic(kind, dev, torch):
    """``synthetic.mat3_cases(kind)`` as FE, with random FP, mu, lam, g9,
    scale and ``I + 0.05 N`` for the F update's first factor."""
    import numpy as np

    from fluidsim_tpu_torch.ops.svd3 import hardening
    from fluidsim_tpu_torch.utils import synthetic

    rng = np.random.default_rng(SEED)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    rows = MAT3_ROWS
    mu, lam = hardening(16326.5, 255782.0, 10.0,
                        t(rng.uniform(0.9, 1.1, rows)))
    return dict(fe=t(synthetic.mat3_cases(kind, rows, SEED)),
                fp=t(synthetic.mat3_cases("random", rows, SEED + 1)),
                mu=mu, lam=lam, g9=t(rng.normal(size=(9, rows))),
                scale=t(-rng.uniform(0.0, 2.0, rows)),
                lhs=t(synthetic.mat3_cases("near_identity", rows, SEED + 2)))


def _mat3_checks(label, inp, torch, ops=None):
    """Each kernel against its plain version bit for bit on ``inp``, as the
    frame calls them (and ``mm3`` with each operand transposed, the clamp
    on FE itself too); with ``ops`` also timed beside its bounds, as
    ``_compare`` does.  Returns the timed entries."""
    from fluidsim_tpu_torch.ops import svd3 as sv

    fe, fp, mu, lam = inp["fe"], inp["fp"], inp["mu"], inp["lam"]
    g9, scale, lhs = inp["g9"], inp["scale"], inp["lhs"]
    rows = fe.shape[0]
    lo, hi = 1.0 - 0.025, 1.0 + 0.0075        # theta_c, theta_s

    def polar():
        p0, d, _ = sv.piola_linearized(fe, mu, lam)
        return p0, d.factors

    def polar_plain():
        p0, d, _ = sv.piola_linearized_plain(fe, mu, lam)
        return p0, sv.factor_rows(*d.factors)

    _require_bitwise(f"polar stress ({label}): P0 and the factor rows (R, "
                     "six of S, cof, J)", polar(), polar_plain(), torch)
    p0, dfull, dspd = sv.piola_linearized(fe, mu, lam)
    _, qfull, qspd = sv.piola_linearized_plain(fe, mu, lam)
    for tag, d, q in (("full", dfull, qfull), ("spd", dspd, qspd)):
        _require_bitwise(f"apply {tag} ({label})", d.apply(g9, scale),
                         q.apply_plain(g9, scale), torch)
    t_fe = sv.mm3(lhs, fe)
    f_total = sv.mm3(t_fe, fp)
    pairs = {"P0 FE^T": (p0, fe.transpose(-1, -2)), "(I + dt gradV) FE":
             (lhs, fe), "T FP": (t_fe, fp), "FE^T FP": (fe.transpose(-1, -2),
                                                       fp),
             "FE^T FP^T": (fe.transpose(-1, -2), fp.transpose(-1, -2))}
    for f in (t_fe, fe):
        _require_bitwise(f"clamp ({label})", sv.clamp_singular(f, lo, hi),
                         sv.clamp_singular_plain(f, lo, hi), torch)
    inv = sv.clamp_singular(t_fe, lo, hi)[1]
    pairs["V s^-1 U^T F"] = (inv, f_total)
    for name, (a, b) in pairs.items():
        _require_bitwise(f"mm3 {name} ({label})", sv.mm3(a, b),
                         sv.mm3_plain(a, b), torch)
    if ops is None:
        return {}
    b4 = 4 * rows
    res = {"piola_linearized": _compare(
        f"polar stress piola_linearized ({label})", polar, polar_plain, 0.0,
        (fe, mu, lam), ops["piola_linearized"] * rows, torch)}
    # the factors an apply reads: R, six of S, cof, J ("full"); cof ("spd")
    for key, d, q, fac_rows in (("stress_apply", dfull, qfull, 25),
                                ("stress_apply_spd", dspd, qspd, 9)):
        res[key] = _compare(
            f"apply {key} ({label})", lambda d=d: d.apply(g9, scale),
            lambda q=q: q.apply_plain(g9, scale), 0.0,
            (g9, fe, mu, lam, scale), ops[key] * rows, torch,
            extra_bytes=fac_rows * b4)
    res["clamp_singular"] = _compare(
        f"clamp clamp_singular ({label})",
        lambda: sv.clamp_singular(t_fe, lo, hi),
        lambda: sv.clamp_singular_plain(t_fe, lo, hi), 0.0, (t_fe,),
        ops["clamp_singular"] * rows, torch)
    res["mm3"] = _compare(f"mm3 T FP ({label})", lambda: sv.mm3(t_fe, fp),
                          lambda: sv.mm3_plain(t_fe, fp), 0.0, (t_fe, fp),
                          ops["mm3"] * rows, torch)
    for key in res:
        res[key]["ops_per_particle"] = ops[key]
    return res


@contextlib.contextmanager
def _plain_chain():
    """The MPM frames' 3x3 chain on its plain versions: every wrapper the
    frames call swapped for its plain version while the block runs."""
    from fluidsim_tpu_torch.models import mpm
    from fluidsim_tpu_torch.ops import mpm_kernels as mk
    from fluidsim_tpu_torch.ops import svd3 as sv
    from fluidsim_tpu_torch.parallel import mpm_sharded as ms

    swaps = [(m, "mm3", sv.mm3_plain) for m in (mk, mpm, ms)]
    swaps += [(m, "piola_linearized", sv.piola_linearized_plain)
              for m in (mk, ms)]
    swaps += [(m, "clamp_singular", sv.clamp_singular_plain)
              for m in (mpm, ms)]
    swaps.append((sv.StressDifferential, "apply",
                  sv.StressDifferential.apply_plain))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, plain in swaps:
        setattr(obj, name, plain)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def _same_state(label, a, b, torch):
    """Raise unless the two states' tensors hold the same bits."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype == torch.float32:
            x, y = x.contiguous().view(torch.int32), y.contiguous().view(
                torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: {f.name} not bit for bit equal")
    print(f"bitwise {label}: equal")


def _mat3_applies(m, params):
    """An MPM frame's implicit applies by variant, from its metrics: one
    per CG iteration and solve of each operator (a hybrid fallback's SPD
    solve after ``cg_hybrid_cap`` iterations of the full one)."""
    if params.hessian == "hybrid" and m["spd_fallback"]:
        full = params.cg_hybrid_cap + 1
        return full, m["cg_iters"] + _mpm_solves(m, params)[0] - full
    applies = m["cg_iters"] + 1
    return (0, applies) if params.hessian == "spd" else (applies, 0)


def _mat3_frames(label, sim, frames, torch):
    """Step ``frames`` frames with the mat3 launch counts set to 0 before
    each; hold each frame's counts to 1 polar stress, the frame's applies
    of each variant (``_mat3_applies``), 1 clamp and 4 ``mm3``.  Returns
    the counts a frame, under the kernels' entry names, and the frames' CG
    iterations."""
    from fluidsim_tpu_torch.ops import svd3 as sv

    wrappers = (sv.piola_linearized, sv.clamp_singular, sv.mm3)
    applies = sv.StressDifferential.launches
    per_frame, cg = [], []
    for f in range(frames):
        for fn in wrappers:
            fn.launches = 0
        applies.update(full=0, spd=0)
        m = sim.step()
        got = {fn.__name__: fn.launches for fn in wrappers}
        got.update(stress_apply=applies["full"],
                   stress_apply_spd=applies["spd"])
        full, spd = _mat3_applies(m, sim.params)
        want = {"piola_linearized": 1, "clamp_singular": 1, "mm3": 4,
                "stress_apply": full, "stress_apply_spd": spd}
        if got != want:
            raise AssertionError(f"{label} frame {f}: launches {got}, "
                                 f"expected {want}")
        per_frame.append(got)
        cg.append(m["cg_iters"])
    print(f"{label}: launches a frame {json.dumps(per_frame[-1])}, CG "
          f"iterations {cg}")
    return per_frame[-1], cg


def _mat3_against_plain(label, sim, frames, torch):
    """``frames`` frames from the sim's state with the kernels and again
    with the plain chain, the two states bit for bit; the sim is left at
    its start."""
    import dataclasses

    copy = lambda s: dataclasses.replace(s, **{
        f.name: getattr(s, f.name).clone() for f in dataclasses.fields(s)})
    start = copy(sim.state)
    for _ in range(frames):
        sim.step()
    got = sim.state
    sim.state = copy(start)
    with _plain_chain():
        for _ in range(frames):
            sim.step()
    _same_state(f"{label}: {frames} frames with the kernels against the "
                "plain chain", got, sim.state, torch)
    sim.state = start


def _mat3_ptxas():
    """ptxas's lines for the four kernels of ``csrc/mat3.cu`` from the
    build log kept beside the library; raise if a kernel has none, or on a
    spill."""
    from fluidsim_tpu_torch import native

    names = ("polar_stress_kernel", "stress_apply_kernel",
             "clamp_singular_kernel", "mm3_kernel")
    lines, keep, out = native.build_log().splitlines(), False, []
    for line in lines:
        if "Compiling entry function" in line:
            keep = any(k in line for k in names)
        if keep:
            out.append(line.strip())
    missing = [k for k in names
               if not any("Compiling entry function" in x and k in x
                          for x in out)]
    if missing:
        raise AssertionError(f"no ptxas lines for {missing} in the build "
                             f"log of {native.library_path().name}")
    for line in out:
        print("ptxas mat3:", line)
    spills = [x for x in out if "spill" in x and (
        "0 bytes spill stores" not in x or "0 bytes spill loads" not in x)]
    if spills:
        raise AssertionError(f"mat3 kernels spill: {spills}")
    return out


def _mat3_phase(dev, torch):
    """Phase 38 (see the module docstring).  Returns (the kernels' entries,
    their launches a frame by path)."""
    from fluidsim_tpu_torch.models.mpm import MpmSim
    from fluidsim_tpu_torch.parallel import dryrun
    from fluidsim_tpu_torch.parallel.mpm_sharded import ShardedMpmSim
    from fluidsim_tpu_torch.utils import synthetic

    t_phase = time.perf_counter()
    ptxas = _mat3_ptxas()
    ops = _mat3_ops(torch)
    print(f"mat3: plain chain's f32 operations a particle {json.dumps(ops)}")
    for kind in synthetic.MAT3_KINDS:
        _mat3_checks(f"{kind}, {MAT3_ROWS} rows",
                     _mat3_synthetic(kind, dev, torch), torch)
    sim = MpmSim("mpm_cone", bound=MAT3_BOUND, seed=SEED, device=dev)
    P = sim.num_particles
    where = f"{2 * MAT3_BOUND + 1}^3, {P} particles"
    _mat3_checks(f"{where}, frame 0", _mat3_frame_inputs(sim, torch), torch)
    _mat3_against_plain(f"MpmSim {where}", sim, MAT3_PLAIN_FRAMES, torch)
    launches = {}
    launches["mpm255"], _ = _mat3_frames(f"MpmSim {where}", sim, MAT3_FALL,
                                        torch)
    results = _mat3_checks(f"{where}, after frame {MAT3_FALL - 1}",
                           _mat3_frame_inputs(sim, torch), torch, ops)
    del sim
    with dryrun.process_group(dev):
        sim = ShardedMpmSim("mpm_cone", bound=MAT3_BOUND, seed=SEED,
                            device=dev)
        label = f"ShardedMpmSim world 1, {where}"
        _mat3_against_plain(label, sim, MAT3_PLAIN_FRAMES, torch)
        launches["slab_rank"], _ = _mat3_frames(label, sim, MAT3_SLAB_FRAMES,
                                                torch)
        del sim
    for entry in results.values():
        entry.update(shape=where, ptxas=[x for x in ptxas if "Used" in x
                                         or "spill" in x])
    print(f"phase 38: {time.perf_counter() - t_phase:.2f} s")
    return results, launches


def _runtime_phases(dev, counted, torch, flip_particles, flip_ms,
                    mpm_particles, before_last):
    """Phases 27-30, in a scratch directory inside the checkout that is
    removed afterwards, with ``before_last()`` run before phase 30;
    returns the CLI runs' launch counts by path."""
    import tempfile

    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root,
                                     prefix="_runtime_smoke_") as tmp:
        fluid, on_ms = _flip_cli_phase(dev, counted, torch, np, tmp,
                                       flip_particles, flip_ms)
        mpm = _mpm_cli_phase(dev, counted, torch, np, tmp, mpm_particles)
        _steps_phase(dev, torch)
        before_last()
        _surface_trace_phase(dev, counted, torch, np, tmp, on_ms)
    return {"cli_fluid": fluid, "cli_mpm": mpm}


def _shape_suffix(key: str) -> str:
    """The shape a kernel's entry was taken at past its main path's:
    ``_slab<rows>`` (phase 31) or ``_257`` / ``_255`` (phase 37), else
    ""."""
    if "_slab" in key:
        return "_slab" + key.rsplit("_slab", 1)[1]
    return next((s for s in ("_257", "_255") if key.endswith(s)), "")


def _base_kernel(key: str) -> str:
    suffix = _shape_suffix(key)
    return key[:-len(suffix)] if suffix else key


def main() -> int:
    import numpy as np
    import torch

    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from fluidsim_tpu_torch import native
    from fluidsim_tpu_torch.models.flip import FlipSim
    from fluidsim_tpu_torch.models.mpm import MpmSim
    from fluidsim_tpu_torch.ops import apic
    from fluidsim_tpu_torch.ops import bucket_sort as bs
    from fluidsim_tpu_torch.ops import mpm_kernels as mk
    from fluidsim_tpu_torch.ops import pressure as pr
    from fluidsim_tpu_torch.ops import rows as rw
    from fluidsim_tpu_torch.ops import shift
    from fluidsim_tpu_torch.ops import stencil_kernels as sk
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm
    from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm
    from fluidsim_tpu_torch.core.splines import cround
    from fluidsim_tpu_torch.ops.svd3 import mv3
    from fluidsim_tpu_torch.utils import synthetic

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    native.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {native.library_path().name}")
    for line in native.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())

    # ---- 3. each FLIP kernel against its plain version --------------------
    sim = FlipSim("water_cube_drop", bound=BOUND, density=DENSITY,
                  seed=SEED, device=dev)
    B, wall, n = sim.params.bound, sim.params.wall, 2 * sim.params.bound + 1
    P = flip_particles = sim.num_particles
    print(f"scene water_cube_drop bound {B} grid {n}^3 particles {P}")
    rng = np.random.default_rng(SEED)
    vel0 = torch.as_tensor(rng.normal(scale=3.0, size=(P, 3))
                           .astype(np.float32), device=dev)
    pos_s, vel_s, flat = tk.sort_by_cell(sim.state.pos, vel0, B)
    w27t = tk.masked_weights_cm(pos_s, B)
    cs = tk.cell_starts(flat, n)
    results = {}
    # every K1 mode is timed with its chunk plan given, as a frame's launches
    # share one; the plan's build (once per frame) is timed apart
    plan = tk.chunk_plan(cs, P)
    results["p2g_scatter"] = _compare(
        "K1 p2g_scatter", lambda: tk.p2g_scatter(w27t, vel_s, cs, n, plan),
        lambda: tk.p2g_scatter_plain(w27t, vel_s, cs, n), 1e-5,
        (w27t, vel_s, cs), 27 * 7 * P, torch)
    results["p2g_scatter"].update(_k1_order_checks(
        "K1, the FLIP state",
        lambda c, pl: tk.p2g_scatter(w27t, vel_s, c, n, pl),
        lambda pl: tk.p2g_scatter_chunked(w27t, vel_s, pl, n), cs, n, P,
        torch))
    nch = plan.chunk_first.shape[0] - 1
    results["chunk_fill"] = _compare(
        "K1 plan chunk_fill",
        lambda: tuple(t[:nch + 1] for t in tk.chunk_fill(cs, plan.chunk_start,
                                                         P)),
        lambda: tuple(t[:nch + 1] for t in tk.chunk_fill_plain(
            cs, plan.chunk_start, P)), 0.0, (cs, plan.chunk_start), 0, torch)
    acc = tk.p2g_scatter(w27t, vel_s, cs, n, plan)
    vc = cell_center_velocity_cm(normalize_velocity_cm(acc[0], acc[1:4]))
    fm = tk.gather_fields(vc, B, wall)
    results["g2p_gather"] = _compare(
        "K2 g2p_gather", lambda: tk.g2p_gather(fm, w27t, flat),
        lambda: tk.g2p_gather_plain(fm, w27t, flat), 1e-5,
        (w27t, flat), 27 * 8 * P, torch,
        extra_bytes=_field_bytes(flat, n, n, 4))
    results["g2p_gather"]["staged_tiles"] = _k2_staged(
        "the FLIP state", fm, w27t, flat, None, torch)
    _k2_edge_cases(torch)

    # K3/K4 on the adiag and pressure of a real frame (the 2nd of the sim)
    kes = [float(sim.step()["kinetic_energy"])]
    m = sim.step()
    kes.append(float(m["kinetic_energy"]))
    fluid = (m["occupancy"] > 0) & ~sim.solid
    dt = m["dt_used"]
    adiag = pr.laplacian_diag(fluid, sim.solid, dt, 1.0, 1.0)
    scale = float(dt / 1.0)
    z = torch.where(fluid, sim.state.pressure, 0.0)
    r = sk.apply_laplacian_plain(z, adiag, scale)
    d = 0.5 * z
    print(f"frame fields: {int(fluid.sum())} fluid cells, dt {float(dt):.6g}, "
          f"max|p| {float(z.abs().max()):.4g}")
    # phase 31 cuts its solve slabs out of these fields
    solve_fields = dict(z=z, adiag=adiag, r=r, d=d, scale=scale)
    results.update(_stencil_cases("the 129^3 frame", solve_fields, None,
                                  torch))
    # above S_MAX steps the preconditioner splits its launches: 7 steps in
    # 3 launches
    deg = 2 * sk.S_MAX + 2
    theta, coefs = sk.cheb_coefs(deg)
    sk.cheb_steps.launches = 0
    split = sk.chebyshev_precond_fused(adiag, scale, degree=deg)(r)
    if sk.cheb_steps.launches != math.ceil((deg - 1) / sk.S_MAX):
        raise AssertionError(f"preconditioner degree {deg}: "
                             f"{sk.cheb_steps.launches} launches")
    _require_bitwise(f"K4 preconditioner, degree {deg} in "
                     f"{sk.cheb_steps.launches} launches, against its plain "
                     "version", split,
                     sk.cheb_steps_plain(adiag, r, scale, coefs, theta),
                     torch)
    del acc, vc, fm, vel0, pos_s, vel_s, flat, w27t, cs, z, r, d, adiag, plan
    del split

    # ---- 4. the FLIP main path: the two frames above were its warm-up ----
    counted = (tk.p2g_scatter, tk.g2p_gather, tk.p2g_scatter_affine,
               tk.g2p_moments, tk.p2g_scatter_force, tk.g2p_gather_gw,
               tk.chunk_fill,
               sk.apply_laplacian, sk.cheb_steps, bs.bucket_move,
               tk.p2g_scatter_base, tk.shift_reduce, tk.shift_expand,
               tk.g2p_gather_table, tk.g2p_moments_table,
               tk.p2g_scatter_spans, tk.g2p_gather_spans,
               shift.to_channel_major, shift.from_channel_major,
               shift.p2g_shift_reduce, shift.g2p_table_expand,
               rw.gather_rows_cm, rw.scatter_rows_cm)
    ke, flip_launches, flip_ms, flip_cg, _ = _run_frames(sim, counted, torch)
    kes += ke
    flip_pos = sim.state.pos.clone()   # phase 35's particles
    del sim

    # ---- 5. FLIP determinism ----------------------------------------------
    _rerun("flip", kes, dev)

    # ---- 6. the APIC kernels against their plain versions -----------------
    sim = FlipSim("water_cube_drop", bound=BOUND, density=DENSITY,
                  seed=SEED, device=dev, mode="apic")
    vel0 = torch.as_tensor(rng.normal(scale=3.0, size=(P, 3))
                           .astype(np.float32), device=dev)
    aff0 = torch.as_tensor(rng.normal(scale=0.5, size=(P, 9))
                           .astype(np.float32), device=dev)
    pos_s, vel_s, flat, aff_s = tk.sort_by_cell(sim.state.pos, vel0, B,
                                                extra=aff0)
    veff = vel_s + mv3(aff_s.reshape(-1, 3, 3), cround(pos_s) - pos_s)
    w27t = tk.masked_weights_cm(pos_s, B)
    cs = tk.cell_starts(flat, n)
    plan = tk.chunk_plan(cs, P)
    results["p2g_scatter_affine"] = _compare(
        "K1 aff p2g_scatter_affine",
        lambda: tk.p2g_scatter_affine(w27t, veff, aff_s, cs, n, plan),
        lambda: tk.p2g_scatter_affine_plain(w27t, veff, aff_s, cs, n), 1e-5,
        (w27t, veff, aff_s, cs), 27 * 25 * P, torch)
    results["p2g_scatter_affine"].update(_k1_order_checks(
        "K1 aff, the APIC state",
        lambda c, pl: tk.p2g_scatter_affine(w27t, veff, aff_s, c, n, pl),
        lambda pl: tk.p2g_scatter_affine_chunked(w27t, veff, aff_s, pl, n),
        cs, n, P, torch))
    acc = tk.p2g_scatter_affine(w27t, veff, aff_s, cs, n, plan)
    vc = cell_center_velocity_cm(normalize_velocity_cm(acc[0], acc[1:4]))
    fm = tk.gather_fields(vc, B, wall)
    results["g2p_moments"] = _compare(
        "K2 moments g2p_moments", lambda: tk.g2p_moments(fm, w27t, flat),
        lambda: tk.g2p_moments_plain(fm, w27t, flat), 0.0,
        (w27t, flat), 27 * 44 * P, torch,
        extra_bytes=_field_bytes(flat, n, n, 4))
    results["g2p_moments"]["staged_tiles"] = _k2_staged(
        "the APIC state", fm, w27t, flat, None, torch, moments=True)
    vel_a, c_a = apic.g2p_apic(w27t, flat, pos_s, vc, B, wall)
    if not (bool(torch.isfinite(vel_a).all()) and bool(torch.isfinite(c_a).all())):
        raise AssertionError("g2p_apic: non-finite velocity or C")
    # phase 14 times K6a's APIC instance on this state, phase 20 K9a's
    apic_k6a = (pos_s, veff, flat, aff_s)
    del acc, vc, fm, vel0, aff0, pos_s, vel_s, flat, aff_s, veff, w27t, cs
    del vel_a, c_a, plan

    # ---- 7. the APIC main path --------------------------------------------
    kes = [float(sim.step()["kinetic_energy"]) for _ in range(2)]
    ke, apic_launches, *_ = _run_frames(sim, counted, torch)
    kes += ke
    print(f"apic: kinetic energy of frames 1-{len(kes)} from seed {SEED}: "
          f"{kes}")
    results["g2p_moments"]["bucket_order_staged_tiles"] = (
        _moments_bucket_order(sim, torch))
    del sim

    # ---- 8. APIC determinism ----------------------------------------------
    _rerun("apic", kes, dev)

    # ---- 9. a small scene: card against the plain versions on the CPU -----
    for mode in ("flip", "apic", "pic"):
        _small_scene(mode, dev)

    # ---- 10. the MPM kernels against their plain versions -----------------
    sim = MpmSim("mpm_cone", bound=MPM_BOUND, seed=SEED, device=dev)
    prm = sim.params
    B, n, P = prm.bound, 2 * prm.bound + 1, sim.num_particles
    mpm_particles = P
    print(f"scene mpm_cone bound {B} grid {n}^3 particles {P} "
          f"operator {prm.hessian}")
    kes = [float(sim.step()["kinetic_energy"]) for _ in range(2)]
    vel_s, flat, w27t, gradw, cs, mass, velg, m9 = _cone_inputs(
        sim, "mpm frame 2 state", torch)
    plan = tk.chunk_plan(cs, P)
    cone = _compare(
        "K1 p2g_scatter (cone state)",
        lambda: tk.p2g_scatter(w27t, vel_s, cs, n, plan),
        lambda: tk.p2g_scatter_plain(w27t, vel_s, cs, n), 1e-5,
        (w27t, vel_s, cs), 27 * 7 * P, torch)
    cone.update(_k1_order_checks(
        "K1, the cone state",
        lambda c, pl: tk.p2g_scatter(w27t, vel_s, c, n, pl),
        lambda pl: tk.p2g_scatter_chunked(w27t, vel_s, pl, n), cs, n, P,
        torch))
    results["p2g_scatter"]["mpm_cone"] = cone
    results["p2g_scatter_force"] = _compare(
        "K1 fg p2g_scatter_force",
        lambda: tk.p2g_scatter_force(gradw, m9, cs, n, plan),
        lambda: tk.p2g_scatter_force_plain(gradw, m9, cs, n), 1e-5,
        (gradw, m9, cs), 27 * 18 * P, torch)
    results["p2g_scatter_force"].update(_k1_order_checks(
        "K1 fg, the cone state",
        lambda c, pl: tk.p2g_scatter_force(gradw, m9, c, n, pl),
        lambda pl: tk.p2g_scatter_force_chunked(gradw, m9, pl, n), cs, n, P,
        torch))
    # skewed states past the cone's: 20,000 particles in one cell, cells of
    # exactly one chunk and one more, occupied faces, empty neighbourhoods
    gs, ms, css, _ = synthetic.skewed_force_state(
        SEED, n, 20_000, band=0.15, device=dev)
    ws, vs, afs, csw, _ = synthetic.skewed_wv_state(
        SEED, n, 20_000, band=0.15, device=dev)
    ps = ms.shape[0]
    modes = (
        ("K1 p2g_scatter", csw, (ws, vs), 27 * 7,
         tk.p2g_scatter, tk.p2g_scatter_plain, tk.p2g_scatter_chunked),
        ("K1 aff p2g_scatter_affine", csw, (ws, vs, afs), 27 * 25,
         tk.p2g_scatter_affine, tk.p2g_scatter_affine_plain,
         tk.p2g_scatter_affine_chunked),
        ("K1 fg p2g_scatter_force", css, (gs, ms), 27 * 18,
         tk.p2g_scatter_force, tk.p2g_scatter_force_plain,
         tk.p2g_scatter_force_chunked))
    for name, c0, args, ops, fn, plain, chunked in modes:
        pl0 = tk.chunk_plan(c0, ps)
        _compare(f"{name} (skewed state)", lambda: fn(*args, c0, n, pl0),
                 lambda: plain(*args, c0, n), 1e-5, args + (c0,), ops * ps,
                 torch)
        _k1_order_checks(
            f"{name.split(' p2g')[0]}, the skewed state",
            lambda c, pl: fn(*args, c, n, pl),
            lambda pl: chunked(*args, pl, n), c0, n, ps, torch)
    del gs, ms, css, ws, vs, afs, csw, pl0, modes
    fm = torch.where(~sim.solid[None], velg, 0.0)
    results["g2p_gather_gw"] = _compare(
        "K2 gw g2p_gather_gw", lambda: tk.g2p_gather_gw(fm, gradw, flat),
        lambda: tk.g2p_gather_gw_plain(fm, gradw, flat), 1e-5,
        (gradw, flat), 27 * 18 * P, torch,
        extra_bytes=_field_bytes(flat, n, n, 3))
    # K2 as the frame's density gather launches it (mpm_kernels.density)
    fm_d = mk.density_fields(mass, sim.solid)
    cone_k2 = _compare(
        "K2 g2p_gather (cone density)",
        lambda: tk.g2p_gather(fm_d, w27t, flat),
        lambda: tk.g2p_gather_plain(fm_d, w27t, flat), 1e-5,
        (w27t, flat), 27 * 8 * P, torch,
        extra_bytes=_field_bytes(flat, n, n, 4))
    cone_k2["staged_tiles"] = _k2_staged("the cone state", fm_d, w27t, flat,
                                         None, torch)
    results["g2p_gather"]["mpm_cone"] = cone_k2
    del vel_s, flat, w27t, gradw, cs, plan, cone, mass, velg, m9, fm, fm_d

    # ---- 11. the MPM main path: the two frames above were its warm-up -----
    ke, mpm_launches, mpm_cg, mpm_ms, mpm_spd = _run_mpm_frames(
        sim, counted, torch)
    kes += ke
    del sim

    # ---- 12. MPM determinism ----------------------------------------------
    rerun = MpmSim("mpm_cone", bound=MPM_BOUND, seed=SEED, device=dev)
    ke2 = [float(rerun.step()["kinetic_energy"]) for _ in range(3)]
    if ke2 != kes[:3]:
        raise AssertionError(f"mpm: rerun energies {ke2} != {kes[:3]}")
    print(f"mpm determinism: 3 frames rerun from seed {SEED}: bit-identical "
          f"kinetic energy {ke2}")
    del rerun

    # ---- 13. a small MPM scene: card against the plain versions on the CPU -
    for hessian in ("full", "hybrid"):
        _mpm_small_scene(hessian, dev)

    # ---- 14. the bucket path's kernels against their plain versions -------
    sim = _flip_sim(dev, sort_method="bucket")
    kes = [float(sim.step()["kinetic_energy"]) for _ in range(2)]
    st = sim.state
    B, n, P = sim.params.bound, 2 * sim.params.bound + 1, sim.num_particles
    bc = torch.clamp(cround(st.pos).to(torch.int32) + B, 0, n - 1)
    flat = (bc[:, 0] * n + bc[:, 1]) * n + bc[:, 2]
    key_s, pay_s, tbl, stats = bs.bucket_plan(
        flat, torch.cat([st.pos.T, st.vel.T]), w=tk.WINDOW,
        emax=tk.BUCKET_EMAX)
    stats = stats.tolist()
    to = 1024
    print(f"bucket plan of the frame-2 state: {tbl.shape[0]} output blocks "
          f"of {to} rows; at most {stats[0]} runs in a 512-row chunk (cap 8) "
          f"and {stats[1]} runs meeting an output block (cap "
          f"{tk.BUCKET_EMAX}; the JAX package's 8 would "
          f"{'hold' if bs.caps_hold(stats) else 'fall back'})")
    if not bs.caps_hold(stats, emax=tk.BUCKET_EMAX):
        raise AssertionError("bucket: the state after 2 frames trips the caps")
    perm = bs.move_permutation(tbl, P, to)
    rows = torch.cat([key_s.view(torch.float32)[None], pay_s])
    results["bucket_move"] = _compare(
        "K5 bucket_move", lambda: bs.bucket_move(key_s, pay_s, tbl, P, to),
        lambda: bs.bucket_move_plain(key_s, pay_s, tbl, P, to), 0.0,
        (key_s, pay_s, tbl), 0, torch,
        library=lambda: rows.index_select(1, perm))
    # synthetic tables: a run across three output blocks, a block met by
    # exactly emax runs, runs of one row, dead entries, P not a multiple of to
    for seed, p_y, nc_y, to_y, emax_y in ((0, 2_000_000, 6, 1024, 64),
                                          (1, 1_000_003, 15, 1024, 64),
                                          (2, 99_999, 1, 512, 32)):
        key_y, pay_y, tbl_y, _ = synthetic.bucket_tables(
            seed, p_y, nc_y, to_y, emax_y, device=dev)
        name = f"K5 bucket_move (synthetic {p_y} x {nc_y}, to {to_y})"
        move = lambda: bs.bucket_move(key_y, pay_y, tbl_y, p_y, to_y)
        plain = lambda: bs.bucket_move_plain(key_y, pay_y, tbl_y, p_y, to_y)
        _compare(name, move, plain, 0.0, (key_y, pay_y, tbl_y), 0, torch)
        _require_bitwise(name, move(), plain(), torch)
        del key_y, pay_y, tbl_y
    flat_o, cols_o = bs.bucket_move(key_s, pay_s, tbl, P, to)
    pos_s, vel_s = cols_o[0:3].T.contiguous(), cols_o[3:6].T.contiguous()
    w27t = tk.masked_weights_cm(pos_s, B)
    results["p2g_scatter_base"] = _k6a_case(
        "K6a p2g_scatter_base", w27t, vel_s, flat_o, n, None, torch)
    results["p2g_scatter_base"].update(_k6a_more_states(
        w27t, vel_s, flat_o, apic_k6a, B, n, dev, torch))
    # the bucket frame's G2P launches K2 on this window-grouped order
    fm_b = torch.rand((4, n, n, n), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    _k2_staged("the bucket state, window-grouped", fm_b, w27t, flat_o, None,
               torch)
    del fm_b
    d = tk.p2g_scatter_base(w27t, vel_s, flat_o,
                            tk.window_starts(flat_o, n), n)
    _, onehot = _shift_onehots(dev, torch)
    torch.backends.cudnn.allow_tf32 = False
    conv = lambda: torch.nn.functional.conv3d(d.view(1, 108, n, n, n),
                                              onehot, padding=1)
    results["shift_reduce"] = _compare(
        "K6b shift_reduce", lambda: tk.shift_reduce(d),
        lambda: tk.shift_reduce_plain(d), 0.0, (d,), 27 * 4 * n ** 3, torch,
        library=conv)
    print(f"K6b library conv3d: max |conv3d - kernel| "
          f"{_max_err(conv()[0], tk.shift_reduce(d)):.3e}")
    del st, bc, flat, key_s, pay_s, tbl, perm, rows, flat_o, cols_o
    del pos_s, vel_s, w27t, d, onehot

    # ---- 15. the bucket path: the two frames above were its warm-up ------
    ke, bucket_launches, bucket_ms, *_ = _run_frames(sim, counted, torch)
    kes += ke
    print(f"flip-bucket: ms/frame {bucket_ms:.3f} against the full sort's "
          f"{flip_ms:.3f} in phase 4 of this process")
    del sim

    # ---- 16. bucket determinism -------------------------------------------
    _rerun("flip", kes, dev, "bucket")

    # ---- 17. a small bucket scene: card against the CPU -------------------
    for mode in ("flip", "apic", "pic"):
        _small_scene(mode, dev, "bucket", **BUCKET_SMALL)

    # ---- 18-20. the materialised G2P and the K9, K10 entry points -------
    more, table_launches, entry_launches, state = _materialised_phases(
        dev, counted, torch, apic_k6a)
    results.update(more)
    del apic_k6a

    # ---- 21. the row-layout transfer kernels on that state --------------
    results.update(_row_phases(dev, torch, state))
    del state

    # ---- 22. the row-layout transfers at 129^3 --------------------------
    row_launches = _row_transfers(dev, counted, torch)

    # ---- 23-26. config-driven runs: multigrid, the clean projection, MPM
    # Jacobi, and small scenes card against CPU ---------------------------
    config_launches = _config_phases(dev, counted, torch, flip_particles,
                                     flip_ms, flip_cg, mpm_particles,
                                     mpm_launches, mpm_cg)

    # ---- 27-30. the run-time layer: the command line, steps(k), the
    # particle surface and a trace (last: a profile slows what follows),
    # and before phase 30 phases 31-34, the slab-sharded sims -------------
    sharded = {}

    def sharded_phases():
        sharded["results"], sharded["launches"] = _sharded_phases(
            dev, counted, torch, np, flip_ms, mpm_ms, solve_fields)
        # ---- 35. the tools suite on phase 4's final state --------------
        _tools_phase(dev, torch, np, flip_pos)
        # ---- 36. the transfer-spline choice ----------------------------
        sharded["spline"], spline_launches = _spline_phase(
            dev, counted, torch, mpm_particles, mpm_ms, mpm_cg, mpm_spd)
        sharded["launches"].update(spline_launches)
        # ---- 37. the validation runs -----------------------------------
        shapes, valid_launches = _validation_phase(dev, counted, torch)
        sharded["results"].update(shapes)
        sharded["launches"].update(valid_launches)
        # ---- 38. the MPM 3x3 chain's kernels ---------------------------
        sharded["mat3"] = _mat3_phase(dev, torch)

    runtime_launches = _runtime_phases(dev, counted, torch, flip_particles,
                                       flip_ms, mpm_particles, sharded_phases)
    results.update(sharded["results"])
    for name, fields in sharded["spline"].items():
        results[name]["mpm_flip_spline"] = fields

    csrc = "fluidsim_tpu_torch/csrc/"
    sources = {
        "p2g_scatter": ("transfer.cu", "pallas_transfer.py:1064", flip_launches),
        "g2p_gather": ("transfer.cu", "pallas_transfer.py:1339", flip_launches),
        "apply_laplacian": ("stencil.cu", "pallas_stencil.py:89", flip_launches),
        "cheb_steps": ("stencil.cu", "pallas_stencil.py:382, :532",
                       flip_launches),
        "p2g_scatter_affine": ("transfer.cu", "pallas_transfer.py:1064",
                               apic_launches),
        "g2p_moments": ("transfer.cu", "pallas_transfer.py:1339",
                        apic_launches),
        "p2g_scatter_force": ("transfer.cu", "pallas_transfer.py:1064",
                              mpm_launches),
        # K1's chunk plan (one per FLIP, PIC, APIC and MPM frame)
        "chunk_fill": ("transfer.cu", "pallas_transfer.py:1064",
                       flip_launches),
        "g2p_gather_gw": ("transfer.cu", "pallas_transfer.py:1339",
                          mpm_launches),
        "bucket_move": ("bucket.cu", "bucket_sort.py:168", bucket_launches),
        "p2g_scatter_base": ("transfer.cu", "pallas_transfer.py:728",
                             bucket_launches),
        "shift_reduce": ("stencil.cu", "pallas_shift.py:252", bucket_launches),
        "shift_expand": ("stencil.cu", "pallas_shift.py:316", table_launches),
        "g2p_gather_table": ("transfer.cu", "pallas_transfer.py:845",
                             table_launches),
        "g2p_moments_table": ("transfer.cu", "pallas_transfer.py:845",
                              table_launches),
        "p2g_scatter_spans": ("transfer.cu", "pallas_transfer.py:1500",
                              entry_launches),
        "g2p_gather_spans": ("transfer.cu", "pallas_transfer.py:1603",
                             entry_launches),
        "p2g_shift_reduce": ("stencil.cu", "pallas_shift.py:150",
                             entry_launches),
        "g2p_table_expand": ("stencil.cu", "pallas_shift.py:179",
                             entry_launches),
        "to_channel_major": ("layout.cu", "pallas_shift.py:212",
                             entry_launches),
        "from_channel_major": ("layout.cu", "pallas_shift.py:230",
                               entry_launches),
        "gather_rows_cm": ("rows.cu", "pallas_transfer.py:225", row_launches),
        "scatter_rows_cm": ("rows.cu", "pallas_transfer.py:332", row_launches)}
    # the slab shapes of phase 31 and the shapes of phase 37, each with the
    # launches of the path that runs it (the slab stencils': the sharded
    # FLIP's)
    for key in sorted(k for k in results if _shape_suffix(k)):
        src, rep, _ = sources[_base_kernel(key)]
        path = results[key].get("path", "sharded_flip")
        sources[key] = (src, rep, sharded["launches"][path])
    paths = {"flip": flip_launches, "apic": apic_launches, "mpm": mpm_launches,
             "flip_bucket": bucket_launches,
             "g2p_materialised": table_launches,
             "shift_entry_points": entry_launches,
             "row_transfers": row_launches, **config_launches,
             **runtime_launches, **sharded["launches"]}
    base = _base_kernel
    kernels = [{"name": name, "route": "cuda", "source": csrc + src,
                "replaces": "fluidsim_tpu/ops/" + rep,
                "launches": launches[base(name)], **results[name],
                "launches_by_path": {k: v[base(name)]
                                     for k, v in paths.items()}}
               for name, (src, rep, launches) in sources.items()]
    # phase 38's kernels replace no TPU kernel; launches a frame by path
    mat3, mat3_launches = sharded["mat3"]
    kernels += [{"name": name, "route": "cuda", "source": csrc + "mat3.cu",
                 "replaces": None, **entry, "launches_by_path": {
                     path: counts[name]
                     for path, counts in mat3_launches.items()}}
                for name, entry in mat3.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
