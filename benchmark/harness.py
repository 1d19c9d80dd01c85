"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, and the result line.

Set-up seeds the cell's start state on the device, builds the program's sim
on it and runs one pass of the span (which builds the kernels on the first
run in a checkout).  The window replays the span from a copy of the start
state, pass after pass, until ``seconds`` have gone by, and ends with a
synchronise after the last completed frame.  A traced run profiles one pass
with labelled phase ranges and no added synchronise (idle share, device
time, host waits, roofline), then times one more pass with synchronised
phase ranges (phase walls).  Neither the window nor the traced passes copy
anything of the program's state, and the peak memory is read when they end.

The comparison.  Then the same sim runs one more pass of the span through
the same ``step()``, from the same start state, at the same sizes, with its
state copied before and after a few frames: frame 0 (the benchmark's own
start state), the span's heaviest frame by CG iterations in the warm-up
pass, and more drawn from the seed, ``CHECKED`` in all; and once more at the
pass's end.  Every pass of the span is the same work (the replay is bit for
bit), so this pass computes what every pass of the window computed.  With
the program freed, the reference runs each of those frames from the
program's state before it.  The reference follows the program frame by
frame and not over the whole span, because two correct float32 runs part
once the liquid meets the floor: a bounce or a fluid cell that rounding
decides differently grows into a different splash.
"""

from __future__ import annotations

import importlib
import json
import random
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import ranks, tracing

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "fluidsim_tpu"}
CHECKED = 3     # frames of the span that a run compares with the reference


def load(root: Path, cell: str) -> dict:
    """The cell's entries: the workload, its configuration (the file that
    ``BENCHMARK.json`` names), traffic mix and limits, and the metrics that
    the cell reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise SystemExit(f"unknown workload {cell!r}; BENCHMARK.json has "
                         f"{sorted(work)}")
    w = work[cell]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = HERE / "limits" / f"{cell}.json"
    limits = (json.loads(limits_file.read_text())["limits"]
              if limits_file.exists() else {})

    def reported(section):
        return [m for m in bench[section]
                if cell in m.get("workloads", (cell,))]

    return {"workload": w, "cfg": cfg, "mix": mix, "limits": limits,
            "end_to_end": reported("end_to_end"),
            "per_layer": reported("per_layer")}


def frames_to_check(counts: list, seed: int) -> list:
    """Frame 0, the heaviest frame by CG iterations, and frames drawn from
    the seed among the rest up to ``CHECKED`` (so that a span whose frames
    all take as many iterations still has ``CHECKED`` frames checked)."""
    k = len(counts)
    heavy = max(range(k), key=lambda f: (counts[f]["cg_iters"], -f))
    chosen = {0, heavy}
    rest = [f for f in range(k) if f not in chosen]
    chosen.update(random.Random(seed).sample(
        rest, max(0, min(len(rest), CHECKED - len(chosen)))))
    return sorted(chosen)


class Record:
    """What the metric readers read of one run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def phase_ms(self, layer: str):
        """ms a frame of the phases of ``layer`` in the timed pass, None
        when the system has no such phase."""
        names = [p for p, lay, _m, _f in self.system.phases if lay == layer]
        if not names or self.walls is None:
            return None
        return 1e3 * sum(self.walls[p] for p in names) / self.traced_frames


def warm_up(system) -> list:
    """One pass of the span; returns the frames' CG iterations."""
    system.restore()
    return [{"cg_iters": int(system.step()["cg_iters"])}
            for _ in range(system.frames)]


def _window(system, seconds: float, sync, dev):
    """Replay the span until ``seconds`` have gone by.  Returns (window
    seconds, each frame's ms from one ``step()`` return to the next, the
    frames' counts).  On one rank the window ends after the frame in which
    the time ran out.  Several ranks have to stop after the same frame, and
    deciding that needs a collective and a device read, which the program's
    frame does not make: they decide it together once a pass, at its end,
    so that the window may run on for the rest of a pass."""
    several = ranks.world()[1] > 1
    frame_ms, counts = [], []
    sync()
    t0 = last = time.perf_counter()
    while True:
        system.restore()
        for _ in range(system.frames):
            counts.append(system.step())
            now = time.perf_counter()
            frame_ms.append(1e3 * (now - last))
            last = now
            if not several and now - t0 >= seconds:
                break
        if ranks.any_rank(now - t0 >= seconds, dev):
            sync()
            return time.perf_counter() - t0, frame_ms, counts


def _traced(system, sync, dev):
    """One profiled pass with labelled phases, then one pass with timed
    phases."""
    counts = []
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        with tracing.wrapped(system.phases), record_function(tracing.WINDOW):
            system.restore()
            for _ in range(system.frames):
                with record_function(tracing.FRAME):
                    counts.append(system.step())
            sync()
    summary = tracing.summarize(prof.events())
    for key in ("busy_s", "window_s"):     # over the ranks' cards
        summary[key] = ranks.mean(summary[key], dev)
    walls = defaultdict(float)
    with tracing.wrapped(system.phases, sync=sync, walls=walls):
        system.restore()
        for _ in range(system.frames):
            system.step()
    sync()
    return summary, walls, counts


def checked_pass(system, check: list):
    """One more pass of the span through the program's ``step()``, its state
    copied before and after each frame of ``check`` and at the pass's end.
    Returns ({frame: (before, after)}, the state at the end, each frame's
    counts), the copies gathered on rank 0 where the system spans ranks
    (None on the others)."""
    system.restore()
    pairs, counts = {}, []
    for f in range(system.frames):
        before = system.snapshot() if f in check else None
        counts.append(system.step())
        if before is not None:
            pairs[f] = (before, system.snapshot())
    final = system.snapshot()
    if hasattr(system, "gather"):       # the ranks' particles on rank 0
        pairs = {f: (system.gather(a), system.gather(b))
                 for f, (a, b) in pairs.items()}
        final = system.gather(final)
    return pairs, final, counts


def keep_worst(into: dict, got: dict):
    """Keep in ``into`` the largest reading of each number of ``got``; a
    reading that is not a number is the largest."""
    for name, v in got.items():
        old = into.get(name)
        if old is None or (old == old and not v <= old):
            into[name] = v


def _compare(system, pairs: dict, final, counts: list, limits: dict):
    """The worst of each compared number over the checked frames and the
    whole pass (where the system checks the pass: ``pass_gaps``), and
    whether each lies within its limit (a number that is not a number
    fails)."""
    worst = {}
    for f in sorted(pairs):
        before, after = pairs[f]
        keep_worst(worst, system.gaps(after, system.reference(before)))
    if hasattr(system, "pass_gaps"):
        keep_worst(worst, system.pass_gaps(final, counts))
    checks = {name: {"value": v, "limit": limits.get(name)}
              for name, v in worst.items()}
    ok = bool(pairs) and all(c["limit"] is not None and c["value"] <= c["limit"]
                             for c in checks.values())
    return ok, checks


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"not read ({out.stderr.strip()})"


def run(root: Path, cell: str, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda", system=None):
    """One run of ``cell`` from the wall-clock time ``t_start`` on; returns
    the result line as a dict on rank 0 and None on the other ranks.
    ``system`` (a built system, for tests) replaces the one the
    configuration names."""
    spec = load(root, cell)
    rank, size = ranks.world()
    cfg, mix = spec["cfg"], spec["mix"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    if system is None:
        mod = importlib.import_module(f"benchmark.systems.{cfg['system']}")
        system = mod.System(cfg, mix, seed, dev)
    warm = warm_up(system)
    sync()
    setup_s = time.time() - t_start
    check = frames_to_check(warm, seed)

    if trace:
        summary, walls, counts = _traced(system, sync, dev)
        window_s, frame_ms = summary["window_s"], []
        attempted = 2 * system.frames
    else:
        window_s, frame_ms, counts = _window(system, seconds, sync, dev)
        summary = walls = None
        attempted = len(frame_ms)
    peak = ranks.largest(torch.cuda.max_memory_allocated(dev) if cuda else 0,
                         dev)
    traced_counts = counts if trace else []
    frame_bytes = [system.frame_bytes(c) for c in traced_counts]
    pairs, final, pass_counts = checked_pass(system, check)
    system.release()
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    t_ref = time.perf_counter()
    ok, checks = _compare(system, pairs, final, pass_counts, spec["limits"])
    reference_s = time.perf_counter() - t_ref

    rec = Record(system=system, cfg=cfg, setup_s=setup_s, window_s=window_s,
                 frames=len(frame_ms), frame_ms=frame_ms, peak_bytes=peak,
                 counts=traced_counts, traced_frames=len(traced_counts),
                 frame_bytes=frame_bytes, trace=summary, walls=walls)
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        # a metric split over cells that report different end-to-end
        # metrics (``name.part``) is read by the reader of its ``name``
        reader = importlib.import_module(
            f"benchmark.metrics.{m['name'].split('.')[0]}")
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    card = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": size, "memory_peak_bytes": int(peak)}
    if trace:
        card.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    out = {"correct": ok, "attempted": attempted,
           "failed": 0 if ok else attempted, "metrics": metrics,
           "device": card}
    if trace:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["about"] = {"name_and_power_limit": power_limit() if cuda else "cpu",
                   "particles": system.particles, "grid": system.n,
                   "span_frames": system.frames, "checked_frames": check,
                   "reference_s": reference_s,
                   "warmup_cg_iters": [c["cg_iters"] for c in warm]}
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    """The JAX modules and the JAX package among the loaded modules,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def emit(out: dict) -> int:
    """Print the compared numbers as the last lines of standard error and
    the result as the last line of standard output; refuse to print it if
    JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
