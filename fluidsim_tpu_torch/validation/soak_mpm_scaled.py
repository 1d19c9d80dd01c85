"""The scaled MPM cone soak — the port's counterpart of
``scripts/soak_mpm_scaled.py``: the full 500-frame workload at a scaled
grid (default 255^3 / 3,939,805 particles; ``--bound 63`` is 127^3), with
the trajectory-shaped oracle and a per-phase ledger (fall, impact,
settle).

    python -m fluidsim_tpu_torch.validation.soak_mpm_scaled [--bound 127]
        [--frames 500]
    python -m fluidsim_tpu_torch.validation.soak_mpm_scaled --device cpu \\
        --bound 10 --frames 6

The oracle is the script's (``traces.trajectory_oracle``): the kinetic
energy rises through free fall, peaks at impact and decays; every
particle finite and inside the box, det FP > 0 (``sound``: what a run of
any length can show). A run that ends before the settle phase
(``traces.SETTLE_FRAME``) cannot test the trajectory: its ``pass`` is
null, its trajectory is reported and the command exits 1 with a message.
At 255^3 the figures stand beside the JAX run's ledger
``docs/mpm_soak_255.json`` (read only): its shape is reported, never its
times. Frames are stepped one at a time (the script's default above
192^3; the port's ``steps(k)`` is the same frames). ``--out`` takes the
place of the script's ``--json``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from fluidsim_tpu_torch.models.mpm import MpmSim, frame_solves
from fluidsim_tpu_torch.seeding import seed_particles
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.validation import traces

FRAMES, BOUND = 500, 127
PHASES = (("fall", 0, 100), ("impact", 100, 250), ("settle", 250, None))
KEYS = ("kinetic_energy", "cg_iters", "spd_fallback", "min_det_fp")


def run(frames: int = FRAMES, bound: int = BOUND, device="cuda",
        seed: int = 0, log=None):
    """Step the cone ``frames`` frames, reading each frame's figures as it
    ends (every 100 frames ``log(sim, rows, seed_secs, cum)`` is called
    with the run so far).  Returns (the sim, per-frame rows of ``KEYS``,
    the seeding's seconds, the host clock's seconds at the end of each
    frame)."""
    scene = get_scene("mpm_cone", bound=bound)
    t0 = time.perf_counter()
    pos, vel = seed_particles(scene, seed=seed, dtype="float32")
    seed_secs = time.perf_counter() - t0
    sim = MpmSim(scene, seeder=traces.fixed_seeder(pos, vel), seed=seed,
                 device=device)
    rows, cum = [], []
    traces.sync(device)
    t0 = time.perf_counter()
    for f in range(frames):
        m = sim.step()
        rows.append({k: float(m[k]) for k in KEYS})
        cum.append(time.perf_counter() - t0)
        if log is not None and (f + 1) % 100 == 0:
            log(sim, rows, seed_secs, cum)
    return sim, rows, seed_secs, cum


def figures(sim, rows, seed_secs, cum, device) -> dict:
    """The run's figures, the per-phase ledger and the oracle (``pass``)."""
    col = lambda k: np.asarray([r[k] for r in rows])
    ke, cg, spd = col("kinetic_energy"), col("cg_iters"), col("spd_fallback")
    grid = 2 * sim.params.bound + 1
    frames = len(rows)
    phases = []
    for name, a, b in PHASES:
        b = frames if b is None else min(b, frames)
        if b <= a:
            continue
        secs = cum[b - 1] - (cum[a - 1] if a > 0 else 0.0)
        phases.append({"phase": name, "frames": [a, b],
                       "ms_per_frame": 1e3 * secs / (b - a),
                       "cg_iters_mean": float(cg[a:b].mean()),
                       "cg_iters_max": int(cg[a:b].max()),
                       "spd_fallback_frames": int(spd[a:b].sum())})
    out = {"run": "soak_mpm_scaled", "device": str(sim.device), "grid": grid,
           "particles": sim.num_particles, "hessian": sim.params.hessian,
           "frames": frames, "seed_secs": seed_secs,
           "first_frame_secs": cum[0], "frames_secs": cum[-1],
           "oracle": traces.trajectory_oracle(ke, grid),
           "min_det_fp": float(col("min_det_fp").min()),
           "cg_iters_total": int(cg.sum()),
           "spd_fallback_frames_total": int(spd.sum()),
           # frames whose velocity came from a solve stopped at its cap
           "capped_frames": [f for f, (c, s) in enumerate(zip(cg, spd))
                             if not frame_solves(sim.params, int(c),
                                                 int(s))[1]],
           "phases": phases,
           **traces.confined(sim.state.pos.cpu().numpy(), sim.params.bound),
           "max_memory_bytes": traces.peak_memory(device),
           "ke_trace_every10": ke[::10].tolist(),
           "cg": cg.astype(int).tolist(), "spd": spd.astype(int).tolist(),
           "recorded": None}
    if grid == 255:
        rec = traces.load(traces.MPM_SOAK_255)
        out["recorded"] = {k: rec[k] for k in (
            "grid", "particles", "hessian", "frames", "ke_peak",
            "ke_peak_frame", "ke_tail_mean50", "min_det_fp",
            "cg_iters_total", "spd_fallback_frames_total")}
    out["sound"] = bool(out["oracle"]["finite_ke"] and out["confined"]
                        and out["min_det_fp"] > 0)
    trajectory = out["oracle"]["pass"]
    out["pass"] = (None if out["sound"] and trajectory is None
                   else bool(out["sound"] and trajectory))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bound", type=int, default=BOUND)
    ap.add_argument("--frames", type=int, default=FRAMES)
    a = traces.common_args(ap).parse_args(argv)

    def log(sim, rows, seed_secs, cum):
        # the figures so far, so that a run cut short leaves its frames
        figs = figures(sim, rows, seed_secs, cum, a.device)
        print(f"# frame {len(rows)}: {cum[-1]:.1f} s, ke "
              f"{rows[-1]['kinetic_energy']:.4g}, SPD fallbacks "
              f"{figs['spd_fallback_frames_total']}", file=sys.stderr,
              flush=True)
        if a.out:
            traces.report(figs, a.out, echo=False)

    sim, rows, seed_secs, cum = run(a.frames, a.bound, a.device, log=log)
    figs = figures(sim, rows, seed_secs, cum, a.device)
    code = traces.report(figs, a.out)
    if figs["pass"] is None:
        print(f"soak_mpm_scaled: {len(rows)} frames, fewer than the "
              f"{traces.SETTLE_FRAME} the trajectory test needs: the rise "
              "and the decay were not tested", file=sys.stderr)
    return code


if __name__ == "__main__":
    sys.exit(main())
