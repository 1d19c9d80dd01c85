"""K2 and K2 gw at the main paths' cube shapes, timed on the card, so that
two checkouts of the port can be compared in one call.

    python3 -m fluidsim_tpu_torch.utils.gather_timing [--root DIR] [--label L]

``--root`` names the checkout whose ``fluidsim_tpu_torch`` is imported and
built (default: the one holding this file); run the script from two
checkouts in alternation (A, B, B, A) in one call, since the card's clocks
and power limit differ between calls.  The inputs are those of
``chip_smoke.py`` phases 3 and 10 at the same sizes, made from seed 0:

- K2 (``g2p_gather``, no ``count``): ``water_cube_drop`` at 129^3, its
  1,987,675 seeded particles sorted by cell, ``masked_weights_cm``, and
  random (4, n, n, n) fields;
- K2 gw (``g2p_gather_gw``, no ``count``): ``mpm_cone`` at 127^3, its
  473,798 seeded particles sorted by cell, ``mpm_stencil``'s gradients and
  random (3, n, n, n) fields.

Each kernel is timed ``ROUNDS`` times, each the median of ``REPS`` runs with
CUDA events, each run queued behind a spin kernel so that the events time
the device and not the host.  The last line is a JSON object with the
rounds' times, the card's name and power limit, and the label.  It needs
the card and uses only calls that every slice of the port has had.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPS = 20
ROUNDS = 5
SPIN_CYCLES = 20_000_000   # ~10 ms at the H100's clocks
SEED = 0


def _ms(fn, torch) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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

    from fluidsim_tpu_torch import native
    from fluidsim_tpu_torch.ops import mpm_kernels as mk
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.scenes import get_scene
    from fluidsim_tpu_torch.seeding import seed_particles

    if not torch.cuda.is_available():
        print("gather_timing: no CUDA device", file=sys.stderr)
        return 1
    if not native.__file__.startswith(root):
        raise RuntimeError(f"imported {native.__file__}, not from {root}")
    dev = torch.device("cuda")
    native.library()
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {"label": a.label, "root": os.path.relpath(root, here)}

    def sorted_state(scene, bound):
        pos, vel = seed_particles(scene, seed=SEED, dtype="float32")
        pos = torch.as_tensor(pos, device=dev)
        vel = torch.as_tensor(vel, device=dev)
        pos_s, _, flat = tk.sort_by_cell(pos, vel, bound)
        return pos_s, flat

    pos_s, flat = sorted_state(get_scene("water_cube_drop", bound=64,
                                         density=25.0), 64)
    w27t = tk.masked_weights_cm(pos_s, 64)
    fm = torch.rand((4, 129, 129, 129), generator=g, device=dev)
    k2 = lambda: tk.g2p_gather(fm, w27t, flat)
    out["k2_particles"] = int(flat.shape[0])
    out["k2_ms"] = [_ms(k2, torch) for _ in range(ROUNDS)]
    del pos_s, flat, w27t, fm

    pos_s, flat = sorted_state(get_scene("mpm_cone", bound=63), 63)
    _, gradw = mk.mpm_stencil(pos_s, 63)
    fm3 = torch.rand((3, 127, 127, 127), generator=g, device=dev)
    gw = lambda: tk.g2p_gather_gw(fm3, gradw, flat)
    out["gw_particles"] = int(flat.shape[0])
    out["gw_ms"] = [_ms(gw, torch) for _ in range(ROUNDS)]

    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0:1]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
