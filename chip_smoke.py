#!/usr/bin/env python3
"""Drive the PyTorch port's FLIP main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # water_cube_drop at 129^3, ~1.99M particles

Phases, each of which raises on failure (nonzero exit):

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from ``fluidsim_tpu_torch/csrc`` and time the build;
3. compare each kernel (K1 P2G, K2 G2P, K3 Laplacian, K4 Chebyshev step)
   with its plain PyTorch version on the card at the main path's shapes,
   and time both with CUDA events (median of the runs);
4. run ``FlipSim`` for warm-up and timed frames: finite energy, particles
   in the box, the projection's outer tolerance met, and every kernel
   launched by the timed frames the number of times the frame's CG
   iterations call for; print ms/frame;
5. determinism: the first frames rerun from the same seed give bit-identical
   kinetic energies;
6. reference: a small scene stepped on the card matches the same scene
   stepped on the CPU, where every kernel wrapper runs its plain version.

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

# the main path's configuration: the JAX package's bench scene, uncut
BOUND = 64          # scene half-width: a (2*64+1)^3 = 129^3 grid
DENSITY = 25.0      # particles per seeded voxel: ~1.99M particles
FRAMES = 10         # timed frames, after 2 warm-up frames
SEED = 0


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


def _compare(name, kernel, plain, rel_tol, torch):
    """Run a kernel and its plain version on the same inputs; require
    ``max|kernel - plain| <= rel_tol * max|plain|``.  Returns the error and
    both times."""
    out_k, out_p = kernel(), plain()
    torch.cuda.synchronize()
    if not isinstance(out_k, tuple):
        out_k, out_p = (out_k,), (out_p,)
    err = max(_max_err(k, p) for k, p in zip(out_k, out_p))
    scale = max(float(p.abs().max()) for p in out_p)
    bound = rel_tol * scale
    ok = err <= bound and all(bool(torch.isfinite(k).all()) for k in out_k)
    print(f"compare {name}: max_abs_err {err:.3e} (bound {bound:.3e} = "
          f"{rel_tol:g} x max|plain| {scale:.4g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    ms = _cuda_ms(kernel, torch)
    plain_ms = _cuda_ms(plain, torch)
    print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of {_REPS})")
    return err, ms, plain_ms


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
    from fluidsim_tpu_torch.ops import pressure as pr
    from fluidsim_tpu_torch.ops import stencil_kernels as sk
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm
    from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm

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
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    # ---- 3. each kernel against its plain version at the main path's shapes
    sim = FlipSim("water_cube_drop", bound=BOUND, density=DENSITY,
                  seed=SEED, device=dev)
    B, wall, n = sim.params.bound, sim.params.wall, 2 * sim.params.bound + 1
    print(f"scene water_cube_drop bound {B} grid {n}^3 particles "
          f"{sim.num_particles}")
    rng = np.random.default_rng(SEED)
    vel0 = torch.as_tensor(rng.normal(scale=3.0, size=(sim.num_particles, 3))
                           .astype(np.float32), device=dev)
    pos_s, vel_s, flat = tk.sort_by_cell(sim.state.pos, vel0, B)
    w27t = tk.masked_weights_cm(pos_s, B)
    cs = tk.cell_starts(flat, n)
    results = {}
    results["p2g_scatter"] = _compare(
        "K1 p2g_scatter", lambda: tk.p2g_scatter(w27t, vel_s, cs, n),
        lambda: tk.p2g_scatter_plain(w27t, vel_s, cs, n), 1e-5,
        torch)
    acc = tk.p2g_scatter(w27t, vel_s, cs, n)
    vc = cell_center_velocity_cm(normalize_velocity_cm(acc[0], acc[1:4]))
    fm = tk.gather_fields(vc, B, wall)
    results["g2p_gather"] = _compare(
        "K2 g2p_gather", lambda: tk.g2p_gather(fm, w27t, flat),
        lambda: tk.g2p_gather_plain(fm, w27t, flat), 1e-5, torch)

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
        torch)
    results["cheb_step"] = _compare(
        "K4 cheb_step", lambda: sk.cheb_step(z, adiag, r, d, scale, c1, c2),
        lambda: sk.cheb_step_plain(z, adiag, r, d, scale, c1, c2), 1e-6,
        torch)
    del acc, vc, fm, vel0, pos_s, vel_s, flat, w27t, cs, z, r, d, adiag

    # ---- 4. the main path: the two frames above were its warm-up --------
    counted = (tk.p2g_scatter, tk.g2p_gather, sk.apply_laplacian, sk.cheb_step)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = [sim.step() for _ in range(FRAMES)]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    print("launches in the timed frames:", json.dumps(launches))

    ke = [float(f["kinetic_energy"]) for f in frames]
    kes += ke
    cg = [f["cg_iters"] for f in frames]
    outer = [f["outer_iters"] for f in frames]
    print(f"frames: ke {ke[0]:.6g} .. {ke[-1]:.6g}, cg_iters {cg}, "
          f"outer_iters {outer}, error(last) {float(frames[-1]['error']):.4g}")
    pos = sim.state.pos
    if not all(math.isfinite(k) for k in ke):
        raise AssertionError("non-finite kinetic energy")
    if not bool(torch.isfinite(pos).all()) or float(pos.abs().max()) >= B:
        raise AssertionError("particles left the box or went non-finite")
    last = frames[-1]
    if not (float(last["error"]) <= sim.params.outer_tol
            or last["outer_iters"] < sim.params.max_outer):
        raise AssertionError("projection did not meet its outer tolerance")
    # PCG: one apply for the initial residual plus one per iteration, and the
    # preconditioner (degree - 1 fused steps) as often
    solves = sum(cg) + sum(outer)
    want = {"p2g_scatter": FRAMES, "g2p_gather": FRAMES,
            "apply_laplacian": solves,
            "cheb_step": (sk.CHEB_DEGREE - 1) * solves}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    ms_frame = 1e3 * wall_s / FRAMES
    print(f"ms/frame {ms_frame:.3f}  steps/s {FRAMES / wall_s:.3f}  "
          f"({FRAMES} frames, host clock, synchronised)")

    # ---- 5. determinism ---------------------------------------------------
    k = min(3, len(kes))
    rerun = FlipSim("water_cube_drop", bound=BOUND, density=DENSITY,
                    seed=SEED, device=dev)
    ke2 = [float(rerun.step()["kinetic_energy"]) for _ in range(k)]
    if ke2 != kes[:k]:
        raise AssertionError(f"rerun energies {ke2} != {kes[:k]}")
    print(f"determinism: {k} frames rerun from seed {SEED}: "
          f"bit-identical kinetic energy {ke2}")
    del rerun

    # ---- 6. a small scene: card against the plain versions on the CPU -----
    small = dict(bound=8, density=3.0, seed=SEED)
    gpu_sim = FlipSim("water_cube_drop", device=dev, **small)
    cpu_sim = FlipSim("water_cube_drop", device="cpu", **small)
    # f32 sums in another order may move CG's stopping test by one iteration
    # in a pass; the outer passes, the energy and the positions must agree
    for f in range(3):
        mg, mc = gpu_sim.step(), cpu_sim.step()
        kg, kc = float(mg["kinetic_energy"]), float(mc["kinetic_energy"])
        print(f"reference frame {f}: card ke {kg:.7g} outer {mg['outer_iters']}"
              f" cg {mg['cg_iters']} | cpu ke {kc:.7g} outer "
              f"{mc['outer_iters']} cg {mc['cg_iters']}")
        if (abs(kg - kc) > 1e-4 * abs(kc)
                or mg["outer_iters"] != mc["outer_iters"]
                or abs(mg["cg_iters"] - mc["cg_iters"]) > mc["outer_iters"]):
            raise AssertionError(f"small scene frame {f}: card and cpu differ")
    pos_err = _max_err(gpu_sim.state.pos.cpu(), cpu_sim.state.pos)
    if pos_err > 1e-3:
        raise AssertionError(f"small scene positions differ by {pos_err}")
    print(f"reference: bound 8, 3 frames, max pos diff card vs cpu "
          f"{pos_err:.3e}")

    sources = {"p2g_scatter": ("fluidsim_tpu_torch/csrc/transfer.cu",
                               "fluidsim_tpu/ops/pallas_transfer.py:1064"),
               "g2p_gather": ("fluidsim_tpu_torch/csrc/transfer.cu",
                              "fluidsim_tpu/ops/pallas_transfer.py:1339"),
               "apply_laplacian": ("fluidsim_tpu_torch/csrc/stencil.cu",
                                   "fluidsim_tpu/ops/pallas_stencil.py:89"),
               "cheb_step": ("fluidsim_tpu_torch/csrc/stencil.cu",
                             "fluidsim_tpu/ops/pallas_stencil.py:382")}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": results[name][0],
                "ms": results[name][1], "plain_ms": results[name][2]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
