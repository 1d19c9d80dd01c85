"""The 500-frame MPM cone soak at the reference's workload (dt 1e-3, E
48000, nu 0.47, snow plasticity) — the port's counterpart of
``scripts/soak_mpm.py``: the bit-compat-seeded ``mpm_cone`` at 31^3, its
kinetic-energy trace held to the recorded run
(``docs/mpm_trace_500frames.json``, read only).

    python -m fluidsim_tpu_torch.validation.soak_mpm [--frames 500]
    python -m fluidsim_tpu_torch.validation.soak_mpm --device cpu \\
        --density 40 --frames 6

The oracle is the script's: every energy finite, every particle finite and
inside the box; at the recorded size (bound 15, density 400) frames 0-19
within 1e-2 of the record and the last 100 frames' mean within 0.1-10x
its.  Besides, det FP > 0 in every frame; the least and largest det FP of
each frame are reported beside the record's.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from fluidsim_tpu_torch.compat.scatter import seed_particles_compat
from fluidsim_tpu_torch.models.mpm import MpmSim
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.validation import traces

FRAMES, BOUND, DENSITY = 500, 15, 400.0   # the recorded run's
KEYS = ("kinetic_energy", "dt", "min_det_fp", "max_det_fp", "cg_iters",
        "spd_fallback")


def run(frames: int = FRAMES, bound: int = BOUND, density: float = DENSITY,
        device="cuda", seed: int = 0):
    """Seed the cone with the reference's stream and step ``frames``
    frames; returns (the sim, per-frame rows of ``KEYS``, seconds)."""
    scene = get_scene("mpm_cone", bound=bound, density=density)
    t0 = time.perf_counter()
    pos, vel = seed_particles_compat(scene, seed=seed, dtype="float32")
    seed_secs = time.perf_counter() - t0
    sim = MpmSim(scene, seeder=traces.fixed_seeder(pos, vel), seed=seed,
                 device=device)
    rows, secs = traces.record_frames(sim, frames, KEYS, device)
    return sim, rows, {"seed_secs": seed_secs, **secs}


def figures(sim, rows, secs, device, recorded: bool) -> dict:
    """The run's figures and the oracle on them (``pass``); ``recorded``:
    the run is the recorded one's size, whose trace it is held to."""
    col = lambda k: np.asarray([r[k] for r in rows])
    ke, mn, mx = col("kinetic_energy"), col("min_det_fp"), col("max_det_fp")
    frames = len(rows)
    out = {"run": "soak_mpm", "device": str(sim.device),
           "grid": 2 * sim.params.bound + 1, "particles": sim.num_particles,
           "hessian": sim.params.hessian, "frames": frames, **secs,
           "ms_per_frame": (1e3 * (secs["frames_secs"]
                                   - secs["first_frame_secs"])
                            / max(frames - 1, 1)),
           "cg_total": int(col("cg_iters").sum()),
           "cg_max": int(col("cg_iters").max()),
           "spd_fallback_frames": int(col("spd_fallback").sum()),
           "min_det_fp": float(mn.min()), "max_det_fp": float(mx.max()),
           "finite_ke": bool(np.isfinite(ke).all()),
           **traces.confined(sim.state.pos.cpu().numpy(), sim.params.bound),
           "max_memory_bytes": traces.peak_memory(device),
           "ke": ke.tolist(), "min_det_fp_per_frame": mn.tolist(),
           "max_det_fp_per_frame": mx.tolist(), "trace": None}
    ok = out["finite_ke"] and out["confined"] and bool((mn > 0).all())
    if recorded:
        ref = traces.load(traces.MPM_SOAK)[:frames]
        out["trace"] = traces.soak_oracle(ke, [r["ke"] for r in ref],
                                          early=(0, 20))
        out["recorded_min_det_fp"] = min(r["min_det_fp"] for r in ref)
        out["recorded_max_det_fp"] = max(r["max_det_fp"] for r in ref)
        ok = ok and out["trace"]["pass"]
    out["pass"] = bool(ok)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--bound", type=int, default=BOUND)
    ap.add_argument("--density", type=float, default=DENSITY)
    a = traces.common_args(ap).parse_args(argv)
    sim, rows, secs = run(a.frames, a.bound, a.density, a.device)
    recorded = (a.bound, a.density) == (BOUND, DENSITY)
    return traces.report(figures(sim, rows, secs, a.device, recorded), a.out)


if __name__ == "__main__":
    sys.exit(main())
