"""The sharded FLIP at world size 1 beside ``FlipSim`` in one process on the
card, so that two checkouts of the port can be compared in one call.

    python3 -m fluidsim_tpu_torch.utils.sharded_timing [--root DIR] [--label L]

``--root`` names the checkout whose ``fluidsim_tpu_torch`` is imported and
built (default: the one holding this file); run it from two checkouts in
alternation (A, B, B, A) in one call.  Both sims step ``water_cube_drop``
at 129^3 (1,987,675 particles) from seed 0: 2 warm-up frames each, then
``ROUNDS`` rounds of ``FRAMES`` frames, ``FlipSim``'s then the sharded
sim's, each round's ms/frame on the host clock with the card
synchronised.  The sharded sim runs in a process group of this process
alone (NCCL, a ``file://`` store in a temporary directory).  The last line
is a JSON object with the rounds' times, the CG iterations, the card's
name and power limit, and the label.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

FRAMES = 10
ROUNDS = 2
SEED = 0


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here,
                    help="checkout whose fluidsim_tpu_torch is timed")
    ap.add_argument("--label", default="")
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("fluidsim_tpu_torch")]:
        del sys.modules[name]

    import torch
    import torch.distributed as dist

    from fluidsim_tpu_torch import FlipSim, get_scene, native
    from fluidsim_tpu_torch.parallel.flip_sharded import ShardedFlipSim

    if not torch.cuda.is_available():
        print("sharded_timing: no CUDA device", file=sys.stderr)
        return 1
    if not native.__file__.startswith(root):
        raise RuntimeError(f"imported {native.__file__}, not from {root}")
    dev = torch.device("cuda")
    native.library()
    out = {"label": a.label, "root": os.path.relpath(root, here)}
    scene = get_scene("water_cube_drop", bound=64, density=25.0)
    with tempfile.TemporaryDirectory(prefix="sharded_timing_") as tmp:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(tmp, "store"),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            sims = {"flip_sim": FlipSim(scene, seed=SEED, device=dev),
                    "sharded": ShardedFlipSim(scene, seed=SEED, device=dev)}
            for sim in sims.values():
                sim.step()
                sim.step()
            for key, sim in sims.items():
                out[f"{key}_ms"], out[f"{key}_cg"] = [], []
            for _ in range(ROUNDS):
                for key, sim in sims.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ms = [sim.step() for _ in range(FRAMES)]
                    torch.cuda.synchronize()
                    out[f"{key}_ms"].append(
                        1e3 * (time.perf_counter() - t0) / FRAMES)
                    out[f"{key}_cg"].append(
                        sum(int(m["cg_iters"]) for m in ms) / FRAMES)
        finally:
            dist.destroy_process_group()
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0:1]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
