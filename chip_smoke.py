#!/usr/bin/env python3
"""Drive the PyTorch port's FLIP, APIC, MPM and bucket-sort paths, the
materialised G2P, the span and unhaloed shift entry points and the
row-layout transfers on one NVIDIA GPU and check them.

    python3 chip_smoke.py   # water_cube_drop at 129^3 (~1.99M particles),
                            # mpm_cone at 127^3 (473,798 particles)

Phases, each of which raises on failure (nonzero exit):

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from ``fluidsim_tpu_torch/csrc`` and time the build;
3. compare each FLIP kernel (K1 P2G, K2 G2P, K3 Laplacian, K4 Chebyshev
   step) with its plain PyTorch version on the card at the main path's
   shapes, and time both with CUDA events (median of the runs); K1 with
   its chunk plan given, the plan timed apart (its device work, and the
   card's idle time after its host read), K1 bit for bit against its
   summation order in PyTorch (``p2g_scatter_chunked``) and a rerun, a
   plan of another ``cell_start`` refused, and the plan's chunk lists
   (``chunk_fill``) against their plain version;
4. run ``FlipSim`` (FLIP) for warm-up and timed frames: finite energy,
   particles in the box, the projection's outer tolerance met, every
   kernel launched by the timed frames the number of times the frame's CG
   iterations call for, and one K1 chunk plan built per frame; print
   ms/frame;
5. determinism: the first frames rerun from the same seed give bit-identical
   kinetic energies;
6. the APIC kernels (K1 aff, K2 moments) against their plain versions at the
   APIC configuration's shapes, timed as in phase 3, K1 aff with the
   checks of K1 in phase 3 (``p2g_scatter_affine_chunked``);
7. ``FlipSim(mode="apic")`` at the same size: warm-up and timed frames with
   the checks of phase 4 and the launch counts of all six kernels;
8. determinism of the APIC frames, as phase 5;
9. reference: a small scene stepped on the card in FLIP, APIC and PIC mode
   matches the same scene stepped on the CPU, where every kernel wrapper
   runs its plain version (APIC: the affine matrices too);
10. the MPM kernels (K1, K1 fg, K2 gw) against their plain versions on
   the sorted state, stress and grid velocity of ``MpmSim("mpm_cone")``
   after its 2 warm-up frames, timed as in phase 3, K1 and K1 fg with the
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
20. the span entry points (K9a, K9b) against K6a and K7a and their plain
   versions, the unhaloed shift entry points (K10a, K10b) against K6b and
   K7b, their plain versions and ``conv3d``, the transposes (K10c, K10d) of
   a (129^3, 108) matrix against ``.T.contiguous()``, and the launch
   counts of one call of each entry point;
21. the row-layout transfer kernels (K8a row gather, K8b row scatter-add)
   against their plain versions and one PyTorch call (``index_select``,
   ``index_add_``) on that state, timed as in phase 3; the row P2G (K8b,
   then K6b) against K6a and K6b and the row G2P (K7b, K8a, the
   contraction) against K7a and K2, bit for bit; both kernels again on
   sweep_transfer's 127-lane rows and table of ones;
22. ``utils/transfer_parts`` at 129^3 on the 3-frame state: one pass of the
   row P2G and G2P with the launch counts of every kernel, the row P2G
   against K1 and the row G2P against K2, then each part's time.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# ~10 ms of spinning at the H100's clocks: longer than the host takes to
# enqueue any timed call below
_SPIN_CYCLES = 20_000_000
_REPS = 20          # timed runs per kernel and per plain version

# the least time of a kernel: H100 SXM HBM3 bandwidth and f32 rate outside
# the tensor cores (NVIDIA's data sheet)
_HBM_BYTES_PER_S = 3.35e12
_F32_OPS_PER_S = 67e12

# the main paths' configuration: the JAX package's bench scene, uncut
BOUND = 64          # scene half-width: a (2*64+1)^3 = 129^3 grid
DENSITY = 25.0      # particles per seeded voxel: ~1.99M particles
FRAMES = 10         # timed frames per mode, after 2 warm-up frames
SEED = 0
# the MPM path's configuration: the JAX package's scaled MPM bench row,
# uncut, with the scene's density of 400 particles per seeded voxel
MPM_BOUND = 63      # a 127^3 grid, 473,798 particles; "hybrid" operator
MPM_SMALL = dict(bound=15, density=40.0)   # phase 13's reference scene
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
    bytes_ms, ops_ms = 1e3 * nbytes / _HBM_BYTES_PER_S, 1e3 * ops / _F32_OPS_PER_S
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


def _run_frames(sim, counted, torch):
    """Step ``FRAMES`` frames with every launch count set to 0 just before;
    check them and their launch counts; return (energies, launches,
    ms/frame)."""
    from fluidsim_tpu_torch.ops import bucket_sort as bs
    from fluidsim_tpu_torch.ops import stencil_kernels as sk
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    bucket = sim.params.sort_method == "bucket"
    mode = sim.params.mode + ("-bucket" if bucket else "")
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
    # preconditioner (degree - 1 fused steps) as often
    solves = sum(cg) + sum(outer)
    gather = "g2p_moments" if sim.params.mode == "apic" else "g2p_gather"
    if bucket:
        scatters = {"p2g_scatter_base": FRAMES, "shift_reduce": FRAMES,
                    "bucket_move": FRAMES - fallbacks}
    elif sim.params.mode == "apic":
        scatters = {"p2g_scatter_affine": FRAMES, "chunk_fill": FRAMES}
    else:
        scatters = {"p2g_scatter": FRAMES, "chunk_fill": FRAMES}
    want = {name: 0 for name in launches}
    want.update({gather: FRAMES, **scatters, "apply_laplacian": solves,
                 "cheb_step": (sk.CHEB_DEGREE - 1) * solves})
    if launches != want:
        raise AssertionError(f"{mode}: kernel launches {launches}, expected {want}")
    # one chunk plan per frame, shared by the frame's K1 launch
    if tk.chunk_plan.builds != (0 if bucket else FRAMES):
        raise AssertionError(f"{mode}: {tk.chunk_plan.builds} K1 chunk plans "
                             f"built in {FRAMES} frames")
    ms = 1e3 * wall_s / FRAMES
    print(f"{mode}: ms/frame {ms:.3f}  steps/s {FRAMES / wall_s:.3f}  "
          f"({FRAMES} frames, host clock, synchronised)")
    return ke, launches, ms


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
    gpu_sim = _flip_sim(dev, mode, sort_method, bound, density)
    cpu_sim = _flip_sim("cpu", mode, sort_method, bound, density)
    mode = f"{mode} {sort_method}"
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


def _mpm_solves(m, params):
    """The number of CG solves of an MPM frame, and whether the solve its
    velocity came from converged before its cap."""
    if params.hessian == "hybrid" and m["spd_fallback"] == 0:
        return 1, m["cg_iters"] < params.cg_hybrid_cap
    spd_iters = m["cg_iters"] - (params.cg_hybrid_cap
                                 if params.hessian == "hybrid" else 0)
    return 1 + m["spd_fallback"], spd_iters < params.cg_maxiter


def _run_mpm_frames(sim, counted, torch):
    """Step ``FRAMES`` MPM frames with every launch count set to 0 just
    before; check them and their launch counts; return (energies,
    launches)."""
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
    print("mpm: launches in the timed frames:", json.dumps(launches),
          f"K1 chunk plans built: {tk.chunk_plan.builds}")

    ke = [float(f["kinetic_energy"]) for f in frames]
    cg = [f["cg_iters"] for f in frames]
    spd = [f["spd_fallback"] for f in frames]
    print(f"mpm frames: ke {ke[0]:.6g} .. {ke[-1]:.6g}, cg_iters {cg}, "
          f"spd_fallback {spd}, min_det_fp(last) "
          f"{float(frames[-1]['min_det_fp']):.6g}")
    st = sim.state
    if not all(math.isfinite(k) for k in ke):
        raise AssertionError("mpm: non-finite kinetic energy")
    if (not bool(torch.isfinite(st.pos).all())
            or float(st.pos.abs().max()) >= MPM_BOUND):
        raise AssertionError("mpm: particles left the box or went non-finite")
    if not all(bool(torch.isfinite(f).all()) for f in (st.FE, st.FP)):
        raise AssertionError("mpm: non-finite deformation gradients")
    if not all(float(f["min_det_fp"]) > 0 for f in frames):
        raise AssertionError("mpm: det(FP) <= 0")
    applies = 0
    for f, m in enumerate(frames):
        solves, converged = _mpm_solves(m, sim.params)
        if not converged:
            raise AssertionError(f"mpm frame {f}: the solve stopped at its cap")
        # one apply for each solve's initial residual plus one per iteration
        applies += m["cg_iters"] + solves
    want = {name: 0 for name in launches}
    want.update({"p2g_scatter": FRAMES, "g2p_gather": 2 * FRAMES,
                 "p2g_scatter_force": FRAMES + applies,
                 "g2p_gather_gw": applies + FRAMES, "chunk_fill": FRAMES})
    if launches != want:
        raise AssertionError(f"mpm: kernel launches {launches}, expected {want}")
    # K1 and every K1 fg launch of a frame share the frame's one plan
    if tk.chunk_plan.builds != FRAMES:
        raise AssertionError(f"mpm: {tk.chunk_plan.builds} K1 chunk plans "
                             f"built in {FRAMES} frames")
    print(f"mpm: ms/frame {1e3 * wall_s / FRAMES:.3f}  steps/s "
          f"{FRAMES / wall_s:.3f}  CG iterations/frame {sum(cg) / FRAMES:.1f} "
          f"({FRAMES} frames, host clock, synchronised)")
    return ke, launches


def _mpm_small_scene(hessian, dev):
    """``mpm_cone`` at bound 15, 3 frames on the card against 3 on the CPU."""
    from fluidsim_tpu_torch.models.mpm import MpmParams, MpmSim

    params = MpmParams(hessian=hessian,
                       cg_hybrid_cap=1 if hessian == "hybrid" else 150)
    gpu_sim = MpmSim("mpm_cone", params=params, seed=SEED, device=dev,
                     **MPM_SMALL)
    cpu_sim = MpmSim("mpm_cone", params=params, seed=SEED, device="cpu",
                     **MPM_SMALL)
    fallbacks = 0
    for f in range(3):
        mg, mc = gpu_sim.step(), cpu_sim.step()
        kg, kc = float(mg["kinetic_energy"]), float(mc["kinetic_energy"])
        print(f"reference mpm {hessian} frame {f}: card ke {kg:.7g} cg "
              f"{mg['cg_iters']} spd {mg['spd_fallback']} | cpu ke {kc:.7g} "
              f"cg {mc['cg_iters']} spd {mc['spd_fallback']}")
        solves, _ = _mpm_solves(mc, params)
        if (abs(kg - kc) > 1e-4 * abs(kc)
                or int(mg["num_active_cells"]) != int(mc["num_active_cells"])
                or mg["spd_fallback"] != mc["spd_fallback"]
                or abs(mg["cg_iters"] - mc["cg_iters"]) > solves):
            raise AssertionError(f"mpm {hessian} frame {f}: card and cpu differ")
        fallbacks += mc["spd_fallback"]
    if hessian == "hybrid" and fallbacks == 0:
        raise AssertionError("mpm hybrid cap 1: no frame took the SPD fallback")
    pos_err = _max_err(gpu_sim.state.pos.cpu(), cpu_sim.state.pos)
    fe_err = _max_err(gpu_sim.state.FE.cpu(), cpu_sim.state.FE)
    if pos_err > 1e-4 or fe_err > 1e-5:
        raise AssertionError(f"mpm {hessian}: positions differ by {pos_err}, "
                             f"FE by {fe_err}")
    print(f"reference mpm {hessian}: bound 15, 3 frames, max pos diff card vs "
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


def _materialised_phases(dev, counted, torch):
    """Phases 18-20 on the sorted state of ``FlipSim`` after its 2 warm-up
    frames: the materialised G2P's kernels (K7b, K7a), the materialised G2P
    against the fused one, and the span and unhaloed shift entry points
    (K9, K10).  Returns (results, launches of the materialised G2P,
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
    ws = tk.window_starts(flat, n)
    u108 = tk._wv_values(w27t, vel_s).reshape(P, 108)
    flat64 = flat.to(torch.int64)
    results["p2g_scatter_spans"] = _compare(
        "K9a p2g_scatter_spans",
        lambda: tk.p2g_scatter_spans(w27t, vel_s, flat, n),
        lambda: tk.p2g_scatter_base_plain(w27t, vel_s, flat, n), 1e-5,
        (w27t, vel_s, flat), 27 * 7 * P, torch,
        library=lambda: torch.zeros((n3, 108), device=dev).index_add_(
            0, flat64, u108))
    del u108, flat64
    d = tk.p2g_scatter_base(w27t, vel_s, flat, ws, n)
    table = tk.shift_expand(fm)
    results["g2p_gather_spans"] = _compare(
        "K9b g2p_gather_spans", lambda: tk.g2p_gather_spans(table, w27t, flat),
        lambda: tk.g2p_gather_table_plain(table, w27t, flat), 1e-5,
        (w27t, flat), 27 * 8 * P, torch, extra_bytes=per_cell)
    checks = (("K9a", tk.p2g_scatter_spans(w27t, vel_s, flat, n), d),
              ("K9b", tk.g2p_gather_spans(table, w27t, flat),
               tk.g2p_gather_table(table, w27t, flat)),
              ("K9b moments", tk.g2p_gather_spans(table, w27t, flat, True),
               tk.g2p_moments_table(table, w27t, flat)))
    for name, a, b in checks:
        if not torch.equal(a, b):
            raise AssertionError(f"{name} differs from K6a/K7a")
    print("K9a, K9b: equal to K6a and K7a on the fully sorted state")
    del checks

    d_rows = d.view(108, n3).T.contiguous()                     # (n^3, 108)
    conv_in = d_rows.view(1, n, n, n, 108).permute(0, 4, 1, 2, 3)
    results["p2g_shift_reduce"] = _compare(
        "K10a p2g_shift_reduce", lambda: shift.p2g_shift_reduce(d_rows, n),
        lambda: shift.p2g_shift_reduce_plain(d_rows, n), 0.0, (d_rows,),
        27 * 4 * n3, torch,
        library=lambda: F.conv3d(conv_in, onehot_r, padding=1))
    red = shift.p2g_shift_reduce(d_rows, n)
    if not torch.equal(red, tk.shift_reduce(d).permute(1, 2, 3, 0)):
        raise AssertionError("K10a differs from K6b")
    fm_rows = fm.permute(1, 2, 3, 0).contiguous()               # (n, n, n, 4)
    fm_in = fm_rows.view(1, n, n, n, 4).permute(0, 4, 1, 2, 3)
    results["g2p_table_expand"] = _compare(
        "K10b g2p_table_expand", lambda: shift.g2p_table_expand(fm_rows, n),
        lambda: shift.g2p_table_expand_plain(fm_rows, n), 0.0, (fm_rows,), 0,
        torch, library=lambda: F.conv3d(fm_in, onehot, padding=1))
    if not torch.equal(shift.g2p_table_expand(fm_rows, n),
                       table.view(108, n3).T):
        raise AssertionError("K10b differs from K7b")
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
    want.update({"p2g_scatter_spans": 1, "p2g_scatter_base": 1,
                 "g2p_gather_spans": 1, "g2p_gather_table": 1,
                 "p2g_shift_reduce": 1, "shift_reduce": 1,
                 "g2p_table_expand": 1, "shift_expand": 1,
                 "to_channel_major": 3, "from_channel_major": 3})
    if entry_launches != want:
        raise AssertionError(f"shift_entry_points: launches {entry_launches}, "
                             f"expected {want}")
    state = dict(pos_s=pos_s, vel_s=vel_s, flat=flat, w27t=w27t, fm=fm,
                 bound=B, wall=wall, cells=cells)
    return results, table_launches, entry_launches, state


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
    del d, acc, base
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
    from fluidsim_tpu_torch.ops.svd3 import (det3, hardening, mm3, mv3,
                                             piola_linearized)
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
    for line in native.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())

    # ---- 3. each FLIP kernel against its plain version --------------------
    sim = FlipSim("water_cube_drop", bound=BOUND, density=DENSITY,
                  seed=SEED, device=dev)
    B, wall, n = sim.params.bound, sim.params.wall, 2 * sim.params.bound + 1
    P = sim.num_particles
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
        (fm, w27t, flat), 27 * 8 * P, torch)

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
    theta, delta = 0.5 * (2.0 + 2.0 / 30.0), 0.5 * (2.0 - 2.0 / 30.0)
    rho = delta / theta
    rho_new = 1.0 / (2.0 * theta / delta - rho)
    c1, c2 = rho_new * rho, 2.0 * rho_new / delta
    print(f"frame fields: {int(fluid.sum())} fluid cells, dt {float(dt):.6g}, "
          f"max|p| {float(z.abs().max()):.4g}")
    results["apply_laplacian"] = _compare(
        "K3 apply_laplacian", lambda: sk.apply_laplacian(z, adiag, scale),
        lambda: sk.apply_laplacian_plain(z, adiag, scale), 1e-6,
        (z, adiag), 9 * n ** 3, torch)
    results["cheb_step"] = _compare(
        "K4 cheb_step", lambda: sk.cheb_step(z, adiag, r, d, scale, c1, c2),
        lambda: sk.cheb_step_plain(z, adiag, r, d, scale, c1, c2), 1e-6,
        (z, adiag, r, d), 15 * n ** 3, torch)
    del acc, vc, fm, vel0, pos_s, vel_s, flat, w27t, cs, z, r, d, adiag, plan

    # ---- 4. the FLIP main path: the two frames above were its warm-up ----
    counted = (tk.p2g_scatter, tk.g2p_gather, tk.p2g_scatter_affine,
               tk.g2p_moments, tk.p2g_scatter_force, tk.g2p_gather_gw,
               tk.chunk_fill,
               sk.apply_laplacian, sk.cheb_step, bs.bucket_move,
               tk.p2g_scatter_base, tk.shift_reduce, tk.shift_expand,
               tk.g2p_gather_table, tk.g2p_moments_table,
               tk.p2g_scatter_spans, tk.g2p_gather_spans,
               shift.to_channel_major, shift.from_channel_major,
               shift.p2g_shift_reduce, shift.g2p_table_expand,
               rw.gather_rows_cm, rw.scatter_rows_cm)
    ke, flip_launches, flip_ms = _run_frames(sim, counted, torch)
    kes += ke
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
        lambda: tk.g2p_moments_plain(fm, w27t, flat), 1e-5,
        (fm, w27t, flat), 27 * 44 * P, torch)
    vel_a, c_a = apic.g2p_apic(w27t, flat, pos_s, vc, B, wall)
    if not (bool(torch.isfinite(vel_a).all()) and bool(torch.isfinite(c_a).all())):
        raise AssertionError("g2p_apic: non-finite velocity or C")
    del acc, vc, fm, vel0, aff0, pos_s, vel_s, flat, aff_s, veff, w27t, cs
    del vel_a, c_a, plan

    # ---- 7. the APIC main path --------------------------------------------
    kes = [float(sim.step()["kinetic_energy"]) for _ in range(2)]
    ke, apic_launches, _ = _run_frames(sim, counted, torch)
    kes += ke
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
    print(f"scene mpm_cone bound {B} grid {n}^3 particles {P} "
          f"operator {prm.hessian}")
    kes = [float(sim.step()["kinetic_energy"]) for _ in range(2)]
    st = sim.state
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
    print(f"mpm frame 2 state: {int(heavy.sum())} cells above the mass "
          f"threshold, max|M| {float(m9.abs().max()):.4g}, "
          f"max|velg| {float(velg.abs().max()):.4g}")
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
        (fm, gradw, flat), 27 * 18 * P, torch)
    del pos_s, vel_s, fe, fp, vol, flat, w27t, gradw, cs, plan, cone
    del mass, mom, heavy, velg, mu, lam, p0, valid, m9, fm

    # ---- 11. the MPM main path: the two frames above were its warm-up -----
    ke, mpm_launches = _run_mpm_frames(sim, counted, torch)
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
    ws = tk.window_starts(flat_o, n)
    u108 = torch.cat([w27t.T[..., None], w27t.T[..., None] * vel_s[:, None]],
                     dim=-1).reshape(P, 108)
    flat64 = flat_o.to(torch.int64)
    results["p2g_scatter_base"] = _compare(
        "K6a p2g_scatter_base",
        lambda: tk.p2g_scatter_base(w27t, vel_s, flat_o, ws, n),
        lambda: tk.p2g_scatter_base_plain(w27t, vel_s, flat_o, n), 1e-5,
        (w27t, vel_s, flat_o, ws), 27 * 7 * P, torch,
        library=lambda: torch.zeros((n ** 3, 108), device=dev).index_add_(
            0, flat64, u108))
    d = tk.p2g_scatter_base(w27t, vel_s, flat_o, ws, n)
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
    del pos_s, vel_s, w27t, ws, u108, flat64, d, onehot

    # ---- 15. the bucket path: the two frames above were its warm-up ------
    ke, bucket_launches, bucket_ms = _run_frames(sim, counted, torch)
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
        dev, counted, torch)
    results.update(more)

    # ---- 21. the row-layout transfer kernels on that state --------------
    results.update(_row_phases(dev, torch, state))
    del state

    # ---- 22. the row-layout transfers at 129^3 --------------------------
    row_launches = _row_transfers(dev, counted, torch)

    csrc = "fluidsim_tpu_torch/csrc/"
    sources = {
        "p2g_scatter": ("transfer.cu", "pallas_transfer.py:1064", flip_launches),
        "g2p_gather": ("transfer.cu", "pallas_transfer.py:1339", flip_launches),
        "apply_laplacian": ("stencil.cu", "pallas_stencil.py:89", flip_launches),
        "cheb_step": ("stencil.cu", "pallas_stencil.py:382", flip_launches),
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
    paths = {"flip": flip_launches, "apic": apic_launches, "mpm": mpm_launches,
             "flip_bucket": bucket_launches,
             "g2p_materialised": table_launches,
             "shift_entry_points": entry_launches,
             "row_transfers": row_launches}
    kernels = [{"name": name, "route": "cuda", "source": csrc + src,
                "replaces": "fluidsim_tpu/ops/" + rep,
                "launches": launches[name], **results[name],
                "launches_by_path": {k: v[name] for k, v in paths.items()}}
               for name, (src, rep, launches) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
