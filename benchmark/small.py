"""Cells of ``BENCHMARK.json`` cut to a size that a CPU test holds, and the
faults that the tests plant in the timed path.  Only the tests use it.

    python -m benchmark.small <cell> <fault>

runs a cell of several ranks at the small size on the CPU (gloo), its ranks
started as ``run.py`` starts them, with ``fault`` ("sound" for none)
planted in every rank, and prints rank 0's result line."""

from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import sys
import time

import torch

from benchmark import harness, ranks

SIZES = {"flip": {"bound": 12, "density": 4.0},
         "mpm": {"bound": 15, "density": 400.0},
         "mpm_slab": {"bound": 15, "density": 40.0}}
SEED = 2 ** 31 + 23
FAULTS = ("sound", "unchanged", "half", "altered", "no_exchange")


def system(cell: str, seed: int, frames: int = 4, device="cpu"):
    """The cell's system at the small size, on ``device``."""
    spec = harness.load(harness.HERE.parent, cell)
    cfg = copy.deepcopy(spec["cfg"])
    cfg.update(SIZES[cfg["system"]])
    mix = copy.deepcopy(spec["mix"])
    kind = "flip" if cfg["system"] == "flip" else "mpm"
    mix["frames"] = {kind: frames}
    mod = importlib.import_module(f"benchmark.systems.{cfg['system']}")
    return mod.System(cfg, mix, seed, torch.device(device))


def plant(cell: str, fault: str, setattr_=setattr):
    """Break the program's timed path: a step that returns its state
    unchanged, the frame of half the particles, a particle's answer altered
    in G2P, or the slabs' halo sums not exchanged."""
    from fluidsim_tpu_torch.models import flip, mpm
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.parallel import flip_sharded, mpm_sharded

    sharded = harness.load(harness.HERE.parent, cell)["workload"]["chips"] > 1
    if sharded:
        mod, name = mpm_sharded, "sharded_mpm_step"
    elif cell.startswith("mpm"):
        mod, name = mpm, "mpm_step"
    else:
        mod, name = flip, "flip_step"
    real = getattr(mod, name)
    if fault == "unchanged":
        def step(*args):
            return args[-1], real(*args)[1]
        setattr_(mod, name, step)
    elif fault == "half":
        def step(*args):
            state = args[-1]
            p = state.pos.shape[0]
            half = {f.name: getattr(state, f.name)[:p // 2]
                    for f in dataclasses.fields(state)
                    if torch.is_tensor(getattr(state, f.name))
                    and getattr(state, f.name).dim() >= 1
                    and getattr(state, f.name).shape[0] == p}
            return real(*args[:-1], dataclasses.replace(state, **half))
        if sharded:     # a rank keeps the live half of its slots
            def step(*args, _real=real):
                state = args[-1]
                live = torch.cumsum(state.alive.long(), 0)
                keep = live <= (int(state.alive.sum()) + 1) // 2
                return _real(*args[:-1], dataclasses.replace(
                    state, alive=state.alive & keep))
        setattr_(mod, name, step)
    elif fault == "altered":
        g2p = tk.g2p_gather if sharded else tk.g2p

        def altered(*args, **kwargs):
            out = g2p(*args, **kwargs).clone()
            if out.shape[0] == 4:       # K2's (4, P) rows: a particle's
                out[0, ::100] += 1.0    # numerator
            else:
                out[::100] += 1.0
            return out
        setattr_(tk, "g2p_gather" if sharded else "g2p", altered)
    elif fault == "no_exchange":
        def fold(ext, width, group=None, dim=0):
            rows = ext.shape[dim]
            return ext.narrow(dim, width, rows - 2 * width).contiguous()
        setattr_(flip_sharded, "halo_reduce", fold)


def main(argv=None) -> int:
    cell, fault = sys.argv[1:] if argv is None else argv
    chips = harness.load(harness.HERE.parent, cell)["workload"]["chips"]
    if not ranks.launched():
        return ranks.launch(["-m", "benchmark.small", cell, fault], chips)
    ranks.init("cpu")
    torch.set_num_threads(1)
    try:
        sys_ = system(cell, SEED, frames=3)
        plant(cell, fault)
        out = harness.run(harness.HERE.parent, cell, SEED, 0.2, False,
                          time.time(), device="cpu", system=sys_)
    finally:
        torch.distributed.destroy_process_group()
    if out is not None:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
