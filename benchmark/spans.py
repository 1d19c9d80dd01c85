"""The program's own spans and counters over a cell's profiled pass, beside
the numbers the traced run reads, with the program's tracing off and on in
turns: what tracing costs when on, and what the spans and counters hold.

    python3 benchmark/spans.py --workload flip257.fall --seed 7
    python3 benchmark/spans.py --workload mpm255.fall --seed 7 --turns off,on

A tool beside the benchmark, not a cell's metric: no run of ``run.py``
imports it.  It builds the cell's system as ``run.py`` does (one process a
card, rank 0 prints), runs one warm-up pass, then the profiled pass of the
traced run (``harness._traced``'s first half: the labelled phases, the
window and frame ranges, no added synchronise) once a turn, the program's
spans traced (``profiling.tracing()``) in the turns ``on``.  Each turn
prints one JSON line:

* what the traced run reads, by the benchmark's own readers, from
  ``tracing.summarize`` of the pass with the device-side copies of the
  program's ranges left out (``device_idle_share``,
  ``host_syncs_per_frame``, ``kernels_roofline``, ``comm_ms_per_frame``,
  ``cg_iters_per_frame``), the idle share with those copies counted
  (``idle_share_with_range_copies``), and the pass's frame time
  (``frame_ms``: the window range over its frames);
* what the program's counters hold, in every turn (they are always on):
  the host waits a frame by site and in all, and the MB a frame handed to
  the collectives (rank 0);
* in the turns ``on``, what its spans hold (``profiling.attribute`` over
  the window): the device ms a frame of each span's self time (rank 0),
  the share of the device time launched inside a span, the wait idle (a
  mean over the ranks, as ``busy_s``, in all and by site), the CG's own
  vector time (``pcg``'s self time) and the 3x3 chain's (``hardening``,
  ``stress``, ``apply.stress``, ``F update``).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STRESS = ("hardening", "stress", "apply.stress", "F update")


def _counted(prof, halo) -> Counter:
    out = Counter({"wait:" + k: v for k, v in prof.host_wait.counts.items()})
    for fn in (halo.shift_pair, halo.all_reduce):
        out[f"{fn.__name__}.bytes"] = fn.bytes
    return out


def profiled_pass(system, dev, on: bool) -> dict:
    """One profiled pass of ``system`` with the program's spans traced when
    ``on``; returns its numbers (see the module docstring)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import harness, ranks, tracing
    from benchmark.metrics import (cg_iters_per_frame, comm_ms_per_frame,
                                   device_idle_share, host_syncs_per_frame,
                                   kernels_roofline)

    from fluidsim_tpu_torch.parallel import halo
    from fluidsim_tpu_torch.utils import profiling as prof_mod

    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    spans = prof_mod.tracing() if on else contextlib.nullcontext()
    before = _counted(prof_mod, halo)
    counts = []
    sync()
    with profile(activities=acts) as prof:
        with tracing.wrapped(system.phases), \
                record_function(tracing.WINDOW), spans:
            system.restore()
            for _ in range(system.frames):
                with record_function(tracing.FRAME):
                    counts.append(system.step())
            sync()
    made = _counted(prof_mod, halo) - before
    events = prof.events()
    copy = lambda e: (e.device_type == DeviceType.CUDA
                      and e.name.startswith("fs:"))
    summary = tracing.summarize([e for e in events if not copy(e)])
    raw = tracing.summarize(events)
    frames = len(counts)
    out = {"spans_on": on, "frame_ms": 1e3 * summary["window_s"] / frames,
           "idle_share_with_range_copies":
               100.0 * (1.0 - raw["busy_s"] / raw["window_s"])}
    att = None
    if on:
        window = [(e.time_range.start, e.time_range.end) for e in events
                  if e.name == tracing.WINDOW
                  and e.device_type == DeviceType.CPU][0]
        att = prof_mod.attribute(events, window)
        att["wait_idle_s"] = ranks.mean(att["wait_idle_s"], dev)
        # every rank makes the same waits, so each site is on every rank
        att["wait_idle"] = {k: ranks.mean(v, dev) for k, v in
                            sorted(att["wait_idle"].items())}
    for key in ("busy_s", "window_s"):
        summary[key] = ranks.mean(summary[key], dev)
    rec = harness.Record(system=system, trace=summary, traced_frames=frames,
                         counts=counts, walls=None,
                         frame_bytes=[system.frame_bytes(c) for c in counts])
    for reader in (device_idle_share, host_syncs_per_frame,
                   kernels_roofline, comm_ms_per_frame, cg_iters_per_frame):
        out[reader.__name__.split(".")[-1]] = reader.read(rec)
    out["idle_ms_per_frame"] = (1e3 * (summary["window_s"]
                                       - summary["busy_s"]) / frames)
    waits = {k[len("wait:"):]: v / frames for k, v in sorted(made.items())
             if k.startswith("wait:")}
    out.update({
        "host_waits_per_frame": sum(waits.values()),
        "host_waits_by_site": waits,
        "comm_mb_per_frame": (made["shift_pair.bytes"]
                              + made["all_reduce.bytes"]) / 1e6 / frames,
    })
    if att is not None:
        per = lambda s: 1e3 * s / frames
        out.update({
            "wait_idle_ms_per_frame": per(att["wait_idle_s"]),
            "wait_idle_ms_by_site": {k: per(v) for k, v in sorted(
                att["wait_idle"].items())},
            "cg_vector_ms_per_frame": per(att["spans"].get("pcg", 0.0)),
            "stress_ms_per_frame": per(sum(att["spans"].get(k, 0.0)
                                           for k in STRESS)),
            "attributed_share": (1.0 - att["unattributed_s"]
                                 / att["device_s"]) if att["device_s"] else
            None,
            "span_ms_per_frame": {k: per(v) for k, v in sorted(
                att["spans"].items(), key=lambda kv: -kv[1])},
        })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--turns", default="off,on,on,off",
                    help="the profiled passes, in order: off or on each")
    args = ap.parse_args(argv)
    turns = args.turns.split(",")
    if set(turns) - {"off", "on"}:
        raise SystemExit(f"--turns: off or on, not {args.turns!r}")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness, ranks

    spec = harness.load(ROOT, args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    if chips > 1 and not ranks.launched():
        return ranks.launch([__file__, *(sys.argv[1:] if argv is None
                                         else argv)], chips)
    dev = ranks.init("cuda") if chips > 1 else torch.device("cuda")
    rank = ranks.world()[0]
    try:
        t0 = time.time()
        cfg = spec["cfg"]
        mod = importlib.import_module(f"benchmark.systems.{cfg['system']}")
        system = mod.System(cfg, spec["mix"], args.seed, dev)
        harness.warm_up(system)
        torch.cuda.synchronize(dev)
        setup_s = time.time() - t0
        rows = [profiled_pass(system, dev, turn == "on") for turn in turns]
    finally:
        if chips > 1:
            torch.distributed.destroy_process_group()
    if rank == 0:
        card = harness.power_limit()
        for turn, row in enumerate(rows):
            print(json.dumps({"workload": args.workload, "seed": args.seed,
                              "turn": turn, "card": card,
                              "setup_s": setup_s, **row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
