"""The readings that a cell's limits are set from, at the cell's own size.

    python3 benchmark/control.py --workload flip257.fall --seeds 11,12,13 \\
        --control 3 --out readings/control_flip257.fall.jsonl

For each seed, as a run does: the start state from the seed, one warm-up
pass of the span through the program's ``step()``, the frames to check, the
checked pass (``harness.checked_pass``); then, with the program freed, the
reference's frame from each copy.  It prints, a JSON line a seed, the
compared numbers of the program against the float32 reference (the lower
readings) and, for the first ``--control`` seeds, those of the control: the
same reference computed in bfloat16, the precision below the float32 that
the configuration states, in the program's place (the upper readings).
The benchmark's own runs do not run this; it needs the cell's CUDA cards
(a cell of several runs one rank a card, as ``run.py`` does, and compares
on rank 0).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(spec: dict, seed: int, control: bool, device) -> dict:
    import importlib

    import torch

    from benchmark import harness, ranks

    cfg, mix = spec["cfg"], spec["mix"]
    mod = importlib.import_module(f"benchmark.systems.{cfg['system']}")
    system = mod.System(cfg, mix, seed, device)
    warm = harness.warm_up(system)
    check = harness.frames_to_check(warm, seed)
    pairs, final, counts = harness.checked_pass(system, check)
    system.release()
    torch.cuda.empty_cache()
    if ranks.world()[0] != 0:
        return None
    out = {"seed": seed, "checked_frames": check,
           "cg_iters": [c["cg_iters"] for c in warm],
           "program": {}, "control": {}, "counts": {}}
    for f, (before, after) in pairs.items():
        want = system.reference(before)
        # the program's counts of the frame beside the reference's
        out["counts"][f] = [{k: int(v) for k, v in counts[f].items()},
                            {k: v[0] for k, v in want.items()
                             if isinstance(v, list)}]
        harness.keep_worst(out["program"], system.gaps(after, want))
        if control:
            low = system.reference(before, torch.bfloat16)
            harness.keep_worst(out["control"], system.gaps(low, want))
    if hasattr(system, "pass_gaps"):
        harness.keep_worst(out["program"], system.pass_gaps(final, counts))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness, ranks
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.load(ROOT, args.workload)
    chips = spec["workload"]["chips"]
    if chips > 1 and not ranks.launched():
        return ranks.launch([__file__, *(sys.argv[1:] if argv is None
                                         else argv)], chips)
    device = ranks.init("cuda") if chips > 1 else torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        r = readings(spec, seed, i < args.control, device)
        if r is None:
            continue
        r.update(workload=args.workload, seconds=time.perf_counter() - t0,
                 card=harness.power_limit())
        line = json.dumps(r)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
        print(line, flush=True)
    if chips > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
