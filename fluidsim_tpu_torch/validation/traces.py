"""The recorded traces of the validation runs (read only) and their oracles,
each with the bounds of the JAX script or test it copies.

The traces are the JAX package's runs on a TPU and the C++ reference
ports' (``native/ref_cpu``, ``native/ref_mpm``): their kinetic energies
are results of the physics, which the port is held to; their times are
not the port's and no oracle reads them.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
DOCS = ROOT / "docs"

# the recorded runs, by the entry point that reads each
FLIP_SOAK = "ke_trace_500frames.json"      # soak_500: 121^3, 500 frames
MPM_SOAK = "mpm_trace_500frames.json"      # soak_mpm: the 31^3 cone
MPM_SOAK_255 = "mpm_soak_255.json"         # soak_mpm_scaled: shape only
FLIP_PARITY = "parity_full_121cube.json"   # ke_parity flip: cpp, tpu
MPM_PARITY = "mpm_parity_cone.json"        # ke_parity mpm: ref_ke, jax_ke


def load(name: str):
    """A recorded file under ``docs/``, parsed."""
    with open(DOCS / name) as f:
        return json.load(f)


def rel_err(ke, ref, floor: float = 0.0) -> np.ndarray:
    """``|ke - ref| / max(|ref|, floor)`` per frame, in f64."""
    ke, ref = np.asarray(ke, np.float64), np.asarray(ref, np.float64)
    return np.abs(ke - ref) / np.maximum(np.abs(ref), floor)


def soak_oracle(ke, ref_ke, early: tuple[int, int]) -> dict:
    """A soak's trajectory against its recorded run
    (``scripts/soak_500.py:54-71`` with ``early=(1, 15)``,
    ``scripts/soak_mpm.py`` with ``(0, 20)``): the early frames' kinetic
    energy within 1e-2 relative of the record; the mean of the last 100
    frames within 0.1-10x the record's over the same frames."""
    ke = np.asarray(ke, np.float64)
    ref = np.asarray(ref_ke, np.float64)[:len(ke)]
    n = min(len(ref), len(ke))
    lo, hi = early
    rel = rel_err(ke[lo:min(hi, n)], ref[lo:min(hi, n)])
    tail = slice(max(0, n - 100), n)
    ratio = float(ke[tail].mean() / ref[tail].mean())
    out = {"frames_compared": n, "early_frames": [lo, min(hi, n)],
           "early_rel_max": float(rel.max()),
           "early_rel_median": float(np.median(rel)),
           "tail_mean": float(ke[tail].mean()),
           "recorded_tail_mean": float(ref[tail].mean()),
           "tail_ratio": ratio}
    out["pass"] = bool(out["early_rel_max"] < 1e-2 and 0.1 < ratio < 10.0)
    return out


def flip_parity_oracle(ke, cpp) -> dict:
    """FLIP against the C++ port (``tests/test_ke_parity.py:62-74``): the
    free-fall frames 0-7 within 5% (relative to ``max(cpp, 1)``), the
    median over all frames under 25%, correlation above 0.99."""
    ke = np.asarray(ke, np.float64)
    cpp = np.asarray(cpp, np.float64)[:len(ke)]
    rel = rel_err(ke, cpp, floor=1.0)
    out = {"frames": len(ke), "fall_rel_max": float(rel[:8].max()),
           "rel_median": float(np.median(rel)), "rel_max": float(rel.max()),
           "correlation": float(np.corrcoef(ke, cpp)[0, 1])}
    out["pass"] = bool(out["fall_rel_max"] < 0.05
                       and out["rel_median"] < 0.25
                       and out["correlation"] > 0.99)
    return out


def mpm_parity_oracle(ke, dt, ref_ke, ref_dt) -> dict:
    """MPM against the C++ port (``tests/test_ke_parity.py:109-111``): the
    kinetic energy's median relative error (to ``max(ref, 1)``) under
    5e-4, its largest under 5e-3, and dt within rtol 1e-4."""
    ke = np.asarray(ke, np.float64)
    ref = np.asarray(ref_ke, np.float64)[:len(ke)]
    dt = np.asarray(dt, np.float64)
    rdt = np.asarray(ref_dt, np.float64)[:len(dt)]
    rel = rel_err(ke, ref, floor=1.0)
    out = {"frames": len(ke), "rel_median": float(np.median(rel)),
           "rel_max": float(rel.max()),
           "rel_p90": float(np.percentile(rel, 90)),
           "correlation": float(np.corrcoef(ke, ref)[0, 1]),
           "dt_rel_max": float(rel_err(dt, rdt).max())}
    out["pass"] = bool(out["rel_median"] < 5e-4 and out["rel_max"] < 5e-3
                       and out["dt_rel_max"] <= 1e-4)
    return out


# a scaled soak's run must reach the settle phase for the decay test: the
# 127^3 cone peaks near frame 175, the 255^3 one at 147
# (scripts/soak_mpm_scaled.py's phases: fall 0-100, impact 100-250)
SETTLE_FRAME = 250


def trajectory_oracle(ke, grid: int) -> dict:
    """``scripts/soak_mpm_scaled.py``'s kinetic-energy oracle: the peak
    after frame 10; the mean of the last 50 frames under 0.5x the peak up
    to 127^3 (0.75x above, and under the mean of the 50 frames after the
    peak).  The rise and the decay are tested only on a run that reaches
    ``SETTLE_FRAME``: on a shorter one they and ``pass`` are None (not
    tested), unless a kinetic energy is not finite (``pass`` False)."""
    ke = np.asarray(ke, np.float64)
    peak = int(ke.argmax())
    tail = float(ke[max(0, len(ke) - 50):].mean())
    post_peak = float(ke[peak:peak + 50].mean())
    frac = 0.5 if grid <= 127 else 0.75
    out = {"finite_ke": bool(np.isfinite(ke).all()),
           "ke_peak": float(ke.max()), "ke_peak_frame": peak,
           "ke_tail_mean50": tail, "ke_post_peak_mean50": post_peak,
           "decay_frac_required": frac, "rise": None, "decay": None}
    if len(ke) >= SETTLE_FRAME:
        out["rise"] = peak > 10
        out["decay"] = bool(tail < frac * ke.max()
                            and (grid <= 127 or tail < post_peak))
    if not out["finite_ke"]:
        out["pass"] = False
    elif out["rise"] is None:
        out["pass"] = None
    else:
        out["pass"] = bool(out["rise"] and out["decay"])
    return out


def confined(pos, bound: int) -> dict:
    """Every particle finite and inside ``|x| <= bound`` (the soak scripts'
    last check)."""
    pos = np.asarray(pos)
    finite = bool(np.isfinite(pos).all())
    top = float(np.abs(pos).max()) if finite else math.inf
    return {"finite_pos": finite, "pos_abs_max": top,
            "confined": bool(finite and top <= bound)}


def common_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The arguments every validation entry point adds to its script's."""
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON figures to this path")
    return ap


def report(figures: dict, out: str | None = None, echo: bool = True) -> int:
    """Print the figures as one JSON line (unless not ``echo``) and write
    them to ``out``; returns the exit code: 0 when ``figures["pass"]``
    holds."""
    line = json.dumps(figures)
    if echo:
        print(line, flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")
    return 0 if figures.get("pass") else 1


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def record_frames(sim, frames: int, keys, device) -> tuple[list, dict]:
    """Step ``sim`` ``frames`` times, keeping the metrics ``keys`` of each
    frame (the grid-sized ones are dropped as each frame ends; the
    device's values are read once, after the last frame).  Returns (one
    dict of Python numbers per frame, the host clock's seconds: the first
    frame, all of them)."""
    import torch

    kept = []
    sync(device)
    t0 = time.perf_counter()
    first = None
    for f in range(frames):
        m = sim.step()
        kept.append({k: m[k] for k in keys})
        if f == 0:
            sync(device)
            first = time.perf_counter() - t0
    sync(device)
    wall = time.perf_counter() - t0
    rows = []
    for m in kept:
        rows.append({k: (v.item() if isinstance(v, torch.Tensor) else v)
                     for k, v in m.items()})
    return rows, {"first_frame_secs": first, "frames_secs": wall}


def peak_memory(device) -> int | None:
    """``torch.cuda.max_memory_allocated()`` on a CUDA device, else None."""
    import torch

    dev = torch.device(device)
    return (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else None)


def fixed_seeder(pos: np.ndarray, vel: np.ndarray):
    """A ``seeder=`` that returns these particles (seeded once, shared by
    the sims of a run and the C++ oracle's particle file)."""
    def seeder(scene, seed: int = 0, dtype="float32"):
        return pos.copy(), vel.copy()
    return seeder
