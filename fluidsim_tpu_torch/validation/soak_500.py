"""The 500-frame FLIP soak at the reference's full scale — the port's
counterpart of ``scripts/soak_500.py``: the bit-compat-seeded
``water_cube_drop`` at 121^3 (689,210 particles) end to end, its
kinetic-energy trace held to the recorded run
(``docs/ke_trace_500frames.json``, read only).

    python -m fluidsim_tpu_torch.validation.soak_500 [--frames 500]
    python -m fluidsim_tpu_torch.validation.soak_500 --device cpu \\
        --bound 10 --density 4 --frames 6

The oracle is the script's: every energy finite, every particle finite and
inside the box, the projection's error at most 0.101 after frame 0; at the
recorded size (bound 60, density 10) frames 1-14 within 1e-2 of the
record and the last 100 frames' mean within 0.1-10x its (later frames are
chaotic).  Outer projection passes per frame are reported beside the
record's.  No ``--update``: the record is never written.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from fluidsim_tpu_torch.compat.scatter import seed_particles_compat
from fluidsim_tpu_torch.models.flip import FlipSim
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.validation import traces

FRAMES, BOUND, DENSITY = 500, 60, 10.0   # the recorded run's
KEYS = ("kinetic_energy", "dt", "error", "outer_iters", "cg_iters")


def run(frames: int = FRAMES, bound: int = BOUND, density: float = DENSITY,
        device="cuda", seed: int = 0):
    """Seed the scene with the reference's stream and step ``frames``
    frames.  Returns (the sim, per-frame rows of ``KEYS``, the seconds of
    the seeding, of the first frame and of all frames)."""
    scene = get_scene("water_cube_drop", bound=bound, density=density)
    t0 = time.perf_counter()
    pos, vel = seed_particles_compat(scene, seed=seed, dtype="float32")
    seed_secs = time.perf_counter() - t0
    sim = FlipSim(scene, seeder=traces.fixed_seeder(pos, vel), seed=seed,
                  device=device)
    rows, secs = traces.record_frames(sim, frames, KEYS, device)
    return sim, rows, {"seed_secs": seed_secs, **secs}


def figures(sim, rows, secs, device, recorded: bool) -> dict:
    """The run's figures and the script's oracle on them (``pass``);
    ``recorded``: the run is the recorded one's size, whose trace it is
    held to."""
    prm = sim.params
    ke = np.asarray([r["kinetic_energy"] for r in rows])
    err = np.asarray([r["error"] for r in rows])
    outer = np.asarray([r["outer_iters"] for r in rows])
    frames = len(rows)
    out = {"run": "soak_500", "device": str(sim.device),
           "grid": 2 * prm.bound + 1, "particles": sim.num_particles,
           "frames": frames, **secs,
           "ms_per_frame": (1e3 * (secs["frames_secs"]
                                   - secs["first_frame_secs"])
                            / max(frames - 1, 1)),
           "outer_mean": float(outer.mean()), "outer_max": int(outer.max()),
           "cg_total": int(sum(r["cg_iters"] for r in rows)),
           "err_max": float(err[1:].max()) if frames > 1 else None,
           "finite_ke": bool(np.isfinite(ke).all()),
           **traces.confined(sim.state.pos.cpu().numpy(), prm.bound),
           "max_memory_bytes": traces.peak_memory(device),
           "ke": ke.tolist(), "outer": outer.tolist(),
           "cg": [r["cg_iters"] for r in rows], "trace": None}
    ok = (out["finite_ke"] and out["confined"]
          and (frames < 2 or out["err_max"] <= 0.101))
    if recorded:
        ref = traces.load(traces.FLIP_SOAK)[:frames]
        out["trace"] = traces.soak_oracle(ke, [r["ke"] for r in ref],
                                          early=(1, 15))
        rec_outer = np.asarray([r["outer"] for r in ref])
        out["recorded_outer_mean"] = float(rec_outer.mean())
        out["recorded_outer_max"] = int(rec_outer.max())
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
