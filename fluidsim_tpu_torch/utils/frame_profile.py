"""Where the time of a frame goes: profile a few frames of ``FlipSim`` or
``MpmSim`` and print each phase's wall time, the device time of the
kernels it ran, the busiest kernels and the device's busy share.

    python -m fluidsim_tpu_torch.utils.frame_profile --mode apic
    python -m fluidsim_tpu_torch.utils.frame_profile --mode flip-bucket
    python -m fluidsim_tpu_torch.utils.frame_profile --mode mpm

The FLIP, PIC and APIC scene is ``water_cube_drop`` at 129^3 (bound 64,
density 25, ~1.99M particles); ``flip-bucket`` is FLIP with
``sort_method="bucket"`` (the bucket sort and the unfused P2G); the MPM
scene ``mpm_cone`` at 127^3 (bound 63, 473,798 particles, the "hybrid"
operator); seed 0, on "cuda".  After 5
warm-up frames (past FLIP's splash of frames 1-4, whose projection runs up
to 7 outer passes) the same 3 frames run four times from the same state:
twice unprofiled, once under ``torch.profiler``, and once more
unprofiled.  The frames are deterministic, so every run does the same
work; their iteration counts are checked equal.

Method.  Each phase (the functions ``flip_step`` or ``mpm_step`` calls,
``PHASES``) is wrapped for the profiled run in a ``record_function`` range
with a device synchronise at both ends, so every kernel a phase launches
runs inside the phase's host range; a kernel counts for the phase whose
range holds its midpoint.  The synchronises and the profiler's own
per-operation cost make the profiled run slower than the unprofiled ones.  The frame time is the mean of the
two unprofiled runs before the profile, and the busy share is the profiled
run's kernel time over it; the run after the profile shows what the
profiler leaves behind in the process.  The last line is a JSON object
with every number.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from fluidsim_tpu_torch.models import flip, mpm
from fluidsim_tpu_torch.ops import apic
from fluidsim_tpu_torch.ops import mpm_kernels as mk
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.utils.card_inputs import (
    FLIP_BOUND as BOUND, FLIP_DENSITY as DENSITY, MPM_BOUND, SEED)

WARMUP = 5          # frames stepped before the profiled window
FRAMES = 3          # frames in the window, run three times
TOP_KERNELS = 30    # kernels listed, the busiest first

# (phase, module, function): the calls of each frame, one phase each
PHASES = {
    "flip": (
        ("sort", tk, "sort_by_cell"),
        ("stencil weights", tk, "masked_weights_cm"),
        ("P2G", tk, "p2g"),             # with its cell or window ranges and
                                        # (K1) the frame's chunk plan
        ("P2G", apic, "p2g_apic"),
        ("projection", flip, "project"),
        ("G2P", tk, "g2p"),
        ("G2P", apic, "g2p_apic"),
        ("advection", flip, "advect_bounce"),
    ),
    "mpm": (
        ("sort", mk, "sort_mpm"),
        ("stencil", mk, "mpm_stencil"),
        ("cell ranges", tk, "cell_starts"),
        ("chunk plan", tk, "chunk_plan"),   # K1's, once per frame
        ("P2G", mk, "p2g_mpm"),
        ("density", mk, "density"),
        ("stress (polar)", mk, "make_force_fns"),
        ("implicit solve", mpm, "pcg"),
        ("gradV", mk, "gradv_gather"),
        ("F update (SVD)", mpm, "clamp_singular"),
        ("FLIP delta", mk, "flip_delta"),
        ("advection", mpm, "advect_bounce"),
    ),
}
# per frame: the counts that must agree between the runs
_COUNTS = {"flip": ("outer_iters", "cg_iters"),
           "mpm": ("spd_fallback", "cg_iters")}
_TAG = "phase:"


def _kind(sim) -> str:
    return "mpm" if isinstance(sim, mpm.MpmSim) else "flip"


@contextlib.contextmanager
def _phase_ranges(kind, sync):
    """Wrap the phase functions in synchronised ``record_function`` ranges
    for the duration of the block."""
    saved = []
    for phase, mod, name in PHASES[kind]:
        fn = getattr(mod, name)

        # wraps() carries the function's attributes (``chunk_plan.builds``,
        # which the function updates through its module's name) over
        @functools.wraps(fn)
        def wrapped(*args, _fn=fn, _phase=phase, **kwargs):
            sync()
            with record_function(_TAG + _phase):
                out = _fn(*args, **kwargs)
                sync()
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _run(sim, start, frames: int, sync):
    """Step ``frames`` frames from ``start``; return (ms/frame, the host
    time of each frame up to its ``step`` returning, the ``_COUNTS`` of
    each frame)."""
    keys = _COUNTS[_kind(sim)]
    sim.state = start
    sync()
    t0 = time.perf_counter()
    marks, counts = [t0], []
    for _ in range(frames):
        m = sim.step()
        marks.append(time.perf_counter())
        counts.append(tuple(m[k] for k in keys))
    sync()
    ms = 1e3 * (time.perf_counter() - t0) / frames
    return ms, [1e3 * (b - a) for a, b in zip(marks, marks[1:])], counts


def profile_frames(sim, frames: int = FRAMES) -> dict:
    """Run ``frames`` frames from the sim's state four times (unprofiled
    twice, profiled, unprofiled) and leave the sim after them; return
    ms/frame of each run, the frames' iteration counts, each phase's wall
    and kernel ms/frame, the kernels by device time, and the busy share of
    the device."""
    kind = _kind(sim)
    cuda = sim.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    start = sim.state

    ms_a, frame_ms, counts = _run(sim, start, frames, sync)
    ms_b, _, counts_b = _run(sim, start, frames, sync)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with _phase_ranges(kind, sync), profile(activities=acts) as prof:
        profiled_ms, _, counts_p = _run(sim, start, frames, sync)
    ms_after, _, counts_after = _run(sim, start, frames, sync)
    if not counts == counts_b == counts_p == counts_after:
        raise RuntimeError(f"the runs of the same frames differ: {counts}, "
                           f"{counts_b}, {counts_p}, {counts_after}")
    frame_ms_mean = 0.5 * (ms_a + ms_b)

    events = prof.events()
    ranges = [(e.name[len(_TAG):], e.time_range.start, e.time_range.end)
              for e in events
              if e.name.startswith(_TAG) and e.device_type == DeviceType.CPU]
    wall = defaultdict(float)
    for phase, t0, t1 in ranges:
        wall[phase] += (t1 - t0) / 1e3 / frames
    inside = defaultdict(float)
    by_kernel = defaultdict(lambda: [0, 0.0])
    kernel_ms = 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith(_TAG):
            continue
        dur = (e.time_range.end - e.time_range.start) / 1e3 / frames
        kernel_ms += dur
        by_kernel[e.name][0] += 1
        by_kernel[e.name][1] += dur
        mid = 0.5 * (e.time_range.start + e.time_range.end)
        for phase, t0, t1 in ranges:
            if t0 <= mid <= t1:
                inside[phase] += dur
                break
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    mode = "mpm"
    if kind == "flip":
        bucket = sim.params.sort_method == "bucket"
        mode = sim.params.mode + ("-bucket" if bucket else "")
    return {
        "mode": mode,
        "particles": sim.num_particles,
        "grid": 2 * sim.params.bound + 1, "frames": frames,
        "first_frame": int(start.frame) + 1,
        **{k: [c[i] for c in counts] for i, k in enumerate(_COUNTS[kind])},
        "ms_per_frame": frame_ms_mean,
        "ms_per_frame_runs": [ms_a, ms_b],
        "frame_ms": frame_ms,
        "profiled_ms_per_frame": profiled_ms,
        "after_profile_ms_per_frame": ms_after,
        "phases": {p: {"wall_ms": wall[p], "kernel_ms": inside[p]}
                   for p in sorted(wall, key=lambda p: -wall[p])},
        "kernel_ms_per_frame": kernel_ms,
        "busy_share": kernel_ms / frame_ms_mean,
        "kernels": [{"name": name[:80], "launches_per_frame": n / frames,
                     "ms_per_frame": ms} for name, (n, ms) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="flip",
                    choices=("flip", "pic", "apic", "flip-bucket", "mpm"))
    args = ap.parse_args(argv)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    if args.mode == "mpm":
        sim = mpm.MpmSim("mpm_cone", bound=MPM_BOUND, seed=SEED)
    elif args.mode == "flip-bucket":
        scene = get_scene("water_cube_drop", bound=BOUND, density=DENSITY)
        sim = flip.FlipSim(scene, seed=SEED, params=flip.FlipParams(
            bound=BOUND, wall=scene.spec.wall, dx=scene.spec.dx,
            gravity=tuple(scene.gravity), sort_method="bucket"))
    else:
        sim = flip.FlipSim("water_cube_drop", bound=BOUND, density=DENSITY,
                           seed=SEED, mode=args.mode)
    torch.cuda.reset_peak_memory_stats(sim.device)
    for _ in range(WARMUP):
        sim.step()
    out = profile_frames(sim)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(sim.device) / 1e9
    print(f"{out['mode']} {out['grid']}^3 {out['particles']} particles, "
          f"frames {out['first_frame']}-{out['first_frame'] + FRAMES - 1}: "
          + " ".join(f"{k} {out[k]}" for k in _COUNTS[_kind(sim)]))
    print(f"unprofiled {out['ms_per_frame_runs'][0]:.3f} and "
          f"{out['ms_per_frame_runs'][1]:.3f} ms/frame (first run by frame: "
          + ", ".join(f"{t:.3f}" for t in out["frame_ms"])
          + f"), profiled {out['profiled_ms_per_frame']:.3f}, unprofiled "
          f"after the profile {out['after_profile_ms_per_frame']:.3f}")
    print(f"{'phase':<16} {'wall ms/frame':>14} {'kernels ms/frame':>17}")
    for phase, v in out["phases"].items():
        print(f"{phase:<16} {v['wall_ms']:>14.3f} {v['kernel_ms']:>17.3f}")
    print(f"all kernels {out['kernel_ms_per_frame']:.3f} ms/frame, busy share "
          f"{out['busy_share']:.3f} of the unprofiled frame")
    for k in out["kernels"]:
        print(f"  {k['ms_per_frame']:9.3f} ms  {k['launches_per_frame']:7.1f}x"
              f"  {k['name']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
