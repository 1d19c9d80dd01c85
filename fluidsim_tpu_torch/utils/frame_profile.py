"""Where the time of a frame goes: profile a few frames of ``FlipSim`` or
``MpmSim`` with the program's spans on and print each span's device time,
the busiest kernels, the device's idle share and the frame's host waits.

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
twice unprofiled, once under ``torch.profiler`` with the program's spans
traced (``profiling.tracing``), and once more unprofiled.  The frames are
deterministic, so every run does the same work; their iteration counts are
checked equal.

Method.  The spans are the frame's own (``profiling.span``), and the
profiled run adds no synchronise: ``profiling.attribute`` gives each
kernel's device time to the innermost span around its launch (a span's
self time), and the idle share is that of the profiled run, 1 - the union
of its device operations over its span (the first frame's start to the
end of the last range or device operation), the wait idle the part of it
in gaps that start inside a host wait.  The host waits a frame are
``profiling.host_wait.counts`` over the profiled run.  The profiler's own
per-operation cost makes the profiled run slower than the unprofiled ones;
the frame time is the mean of the two unprofiled runs before the profile,
and the run after the profile shows what the profiler leaves behind in the
process.  The last line is a JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import Counter, defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fluidsim_tpu_torch.models import flip, mpm
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.utils import profiling
from fluidsim_tpu_torch.utils.card_inputs import (
    FLIP_BOUND as BOUND, FLIP_DENSITY as DENSITY, MPM_BOUND, SEED)

WARMUP = 5          # frames stepped before the profiled window
FRAMES = 3          # frames in the window, run three times
TOP_KERNELS = 30    # kernels listed, the busiest first

# per frame: the counts that must agree between the runs
_COUNTS = {"flip": ("outer_iters", "cg_iters"),
           "mpm": ("spd_fallback", "cg_iters")}


def _kind(sim) -> str:
    return "mpm" if isinstance(sim, mpm.MpmSim) else "flip"


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
    twice, profiled with the spans traced, unprofiled) and leave the sim
    after them; return ms/frame of each run, the frames' iteration counts,
    each span's calls and self device ms a frame, the kernels by device
    time, the idle share and wait idle of the profiled run and its host
    waits a frame by site."""
    kind = _kind(sim)
    cuda = sim.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    start = sim.state

    ms_a, frame_ms, counts = _run(sim, start, frames, sync)
    ms_b, _, counts_b = _run(sim, start, frames, sync)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    waits = Counter(profiling.host_wait.counts)
    with profile(activities=acts) as prof, profiling.tracing():
        profiled_ms, _, counts_p = _run(sim, start, frames, sync)
    waits = profiling.host_wait.counts - waits
    ms_after, _, counts_after = _run(sim, start, frames, sync)
    if not counts == counts_b == counts_p == counts_after:
        raise RuntimeError(f"the runs of the same frames differ: {counts}, "
                           f"{counts_b}, {counts_p}, {counts_after}")
    frame_ms_mean = 0.5 * (ms_a + ms_b)

    events = prof.events()
    att = profiling.attribute(events)
    calls = att["calls"]
    by_kernel = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        by_kernel[e.name][0] += 1
        by_kernel[e.name][1] += (e.time_range.end
                                 - e.time_range.start) / 1e3 / frames
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    span_ms = {name: 1e3 * att["spans"].get(name, 0.0) / frames
               for name in calls}
    mode = "mpm"
    if kind == "flip":
        bucket = sim.params.sort_method == "bucket"
        mode = sim.params.mode + ("-bucket" if bucket else "")
    window = att["window_s"]
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
        "spans": {name: {"calls_per_frame": calls[name] / frames,
                         "device_ms": span_ms[name]}
                  for name in sorted(calls, key=lambda n: -span_ms[n])},
        "device_ms_per_frame": 1e3 * att["device_s"] / frames,
        "unattributed_ms_per_frame": 1e3 * att["unattributed_s"] / frames,
        "idle_share": 1.0 - att["busy_s"] / window if window else None,
        "wait_idle_ms_per_frame": 1e3 * att["wait_idle_s"] / frames,
        "wait_idle_ms_by_site": {site: 1e3 * t / frames for site, t in
                                 sorted(att["wait_idle"].items())},
        "host_waits_per_frame": {site: n / frames
                                 for site, n in sorted(waits.items())},
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
    print(f"{'span':<24} {'calls/frame':>12} {'device ms/frame':>16}")
    for name, v in out["spans"].items():
        print(f"{name:<24} {v['calls_per_frame']:>12.1f} "
              f"{v['device_ms']:>16.3f}")
    print(f"device {out['device_ms_per_frame']:.3f} ms/frame "
          f"({out['unattributed_ms_per_frame']:.3f} outside every span), "
          f"idle share {out['idle_share']:.3f} of the profiled run, wait "
          f"idle {out['wait_idle_ms_per_frame']:.3f} ms/frame; host waits "
          f"a frame {out['host_waits_per_frame']}")
    for k in out["kernels"]:
        print(f"  {k['ms_per_frame']:9.3f} ms  {k['launches_per_frame']:7.1f}x"
              f"  {k['name']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
