"""Run one cell of the benchmark of ``fluidsim_tpu_torch`` on this machine's
card and print its result as the last line of standard output.

    python3 benchmark/run.py --workload flip257.fall --seed 7 --seconds 30 --trace 0

``--trace 0`` measures the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from one traced run.  The run needs as many CUDA cards as
the cell asks for, and fails without them; it never falls back to the CPU.
A cell on several cards runs as one process a card, started here, joined
over NCCL through a TCP store on a free local port; rank 0 prints.
Run it from the root of a checkout: the program's kernels build into the
checkout (``fluidsim_tpu_torch/_build/``) on a cell's first run there.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--t0", type=float, default=None,
                    help=argparse.SUPPRESS)   # the launcher's start, to a rank
    args = ap.parse_args(argv)

    # every compile cache of the run stays inside the checkout, at a fixed
    # path, so that only a cell's first run there builds
    cache = ROOT / "benchmark" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark import harness, ranks
    if chips > 1 and not ranks.launched():
        return ranks.launch([__file__, *(sys.argv[1:] if argv is None
                                         else argv), "--t0", repr(T_START)],
                            chips)
    device = ranks.init("cuda") if chips > 1 else torch.device("cuda")
    try:
        out = harness.run(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), args.t0 or T_START, device=device)
    finally:
        if chips > 1:
            torch.distributed.destroy_process_group()
    return 0 if out is None else harness.emit(out)


if __name__ == "__main__":
    raise SystemExit(main())
