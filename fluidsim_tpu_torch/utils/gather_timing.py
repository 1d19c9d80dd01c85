"""K2 at every shape its paths launch, with K2 moments, K7a, K9b and K2 gw
beside it, timed on the card, so that two checkouts of the port can be
compared in one call.

    python3 -m fluidsim_tpu_torch.utils.gather_timing [--root DIR] [--label L]

``--root`` names the checkout whose kernels are built and timed (default:
the one holding this file).  The inputs are always made by this file's
checkout, before the timed one is imported, so both checkouts get the
same tensors.  Run it for two checkouts in alternation (A, B, B, A) in one
call, since the card's clocks and power limit differ between calls.  The
inputs are those of ``chip_smoke.py`` at ``utils/card_inputs``'s sizes,
made from seed 0:

- ``cube``: ``water_cube_drop`` at 129^3, its 1,987,675 seeded particles
  sorted by cell, ``masked_weights_cm`` and random (4, n, n, n) fields: K2
  (FLIP, PIC), K2 moments (APIC), and on ``shift_expand``'s table K7a, K7a
  moments and K9b (the kernels alone, ``g2p_gather_spans_launch``);
- ``cone``: ``mpm_cone`` at 127^3, its 473,798 seeded particles sorted by
  cell, ``mpm_stencil``'s weights and the MPM density gather's fields
  (``mpm_kernels.density_fields`` of K1's mass): K2; K2 gw on random
  (3, n, n, n) fields with ``mpm_stencil``'s gradients;
- ``slab133``, ``slab37``: the sharded FLIP's transfer slabs of
  ``water_cube_drop`` at world size 1 and on rank 1 of 4
  (``card_inputs.rank_arrays``: the rank's sorted slots, dead ones last,
  and the live count), random fields: K2 with the count, as
  ``parallel/flip_sharded.py`` launches it;
- ``slab131``, ``slab36``: the sharded MPM's slabs of ``mpm_cone`` at
  world size 1 and on rank 1 of 4, likewise (``parallel/mpm_sharded.py``).

Each kernel is timed ``ROUNDS`` times, each the median of ``REPS`` runs with
CUDA events, each run queued behind a spin kernel so that the events time
the device and not the host.  Each K2 shape carries K2's bound: the bytes
it must move (the live rows' weights and ids, the count, the 4 output rows
and the 16 B of every cell in the live rows' neighbourhoods,
``card_inputs.read_cells``) over the HBM rate; and, where the timed K2
takes ``paths``, the kernel's own count of its tiles that staged their
fields.  K2 moments on the cube carries its bound likewise (the weights
and ids, its 22 output rows and 16 B a cell read), its share of it and,
where the timed ``g2p_moments`` takes ``paths``, its staged tiles.

Then ``FlipSim(mode="apic")`` steps ``APIC_FRAMES`` frames of the cube from
seed 0, as ``chip_smoke.py``'s phases 6-7 do (2 warm-up and 10 timed),
and their kinetic energies are printed: two checkouts whose K2 moments
agree give the same energies to the bit.

The last line is a JSON object with the rounds' times, the card's name and
power limit, and the label.  It needs the card; the timed checkout needs
only calls that every slice of the port since the slab sims has had.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

REPS = 20
ROUNDS = 5
APIC_FRAMES = 12
SPIN_CYCLES = 20_000_000   # ~10 ms at the H100's clocks


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


def _inputs(dev):
    """Every timed kernel's inputs, by this file's checkout: ``shapes``
    (name -> K2's fm, w27t, flat, count, live count and bound), and the
    cube's and cone's tensors of the kernels beside K2."""
    import numpy as np
    import torch

    from fluidsim_tpu_torch.ops import mpm_kernels as mk
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.scenes import get_scene
    from fluidsim_tpu_torch.seeding import seed_particles
    from fluidsim_tpu_torch.utils import card_inputs as ci

    g = torch.Generator(device=dev).manual_seed(ci.SEED)
    rng = np.random.default_rng(ci.SEED)
    shapes = {}

    def k2(name, fm, w27t, flat, count=None, live=None):
        p = flat.shape[0]
        live = p if live is None else live
        cells = ci.read_cells(flat, fm.shape[1], fm.shape[-1], live)
        nbytes = (27 * 4 + 4) * live + 16 * p + 16 * cells + (
            0 if count is None else 4)
        shapes[name] = dict(fm=fm, w27t=w27t, flat=flat, count=count, info={
            "slots": p, "live": live, "rows": int(fm.shape[1]),
            "read_cells": cells, "bound_mb": nbytes / 1e6,
            "bound_ms": 1e3 * max(nbytes / ci.HBM_BYTES_PER_S,
                                  27 * 8 * live / ci.F32_OPS_PER_S)})

    def sorted_state(scene, bound):
        pos, vel = seed_particles(scene, seed=ci.SEED, dtype="float32")
        pos_s, vel_s, flat = tk.sort_by_cell(torch.as_tensor(pos, device=dev),
                                             torch.as_tensor(vel, device=dev),
                                             bound)
        return pos_s, vel_s, flat

    n = 2 * ci.FLIP_BOUND + 1
    flip_scene = get_scene("water_cube_drop", bound=ci.FLIP_BOUND,
                           density=ci.FLIP_DENSITY)
    pos_s, _, flat = sorted_state(flip_scene, ci.FLIP_BOUND)
    w27t = tk.masked_weights_cm(pos_s, ci.FLIP_BOUND)
    fm = torch.rand((4, n, n, n), generator=g, device=dev)
    k2("cube", fm, w27t, flat)
    cube = dict(fm=fm, w27t=w27t, flat=flat, table=tk.shift_expand(fm))

    m = 2 * ci.MPM_BOUND + 1
    cone_scene = get_scene("mpm_cone", bound=ci.MPM_BOUND)
    pos_s, vel_s, flat = sorted_state(cone_scene, ci.MPM_BOUND)
    w27t, gradw = mk.mpm_stencil(pos_s, ci.MPM_BOUND)
    solid = torch.as_tensor(np.asarray(cone_scene.solid), device=dev)
    mass, _ = mk.p2g_mpm(w27t, vel_s, tk.cell_starts(flat, m), solid,
                         ci.MPM_BOUND)
    k2("cone", mk.density_fields(mass, solid), w27t, flat)
    cone = dict(gradw=gradw, flat=flat,
                fm3=torch.rand((3, m, m, m), generator=g, device=dev))

    for scene, bound, weights in (
            (flip_scene, ci.FLIP_BOUND, lambda p: tk.masked_weights_cm(
                p, ci.FLIP_BOUND)),
            (cone_scene, ci.MPM_BOUND,
             lambda p: mk.mpm_stencil(p, ci.MPM_BOUND)[0])):
        nb = 2 * bound + 1
        for size, rank in ((1, 0), (ci.SLAB_WORLD, ci.SLAB_RANK)):
            slab, pos_s, _, flat, live = ci.rank_arrays(scene, bound, rank,
                                                        size, rng, dev)
            count = tk.cell_starts(flat, nb, slab.rows)[-1:]
            fm = torch.rand((4, slab.rows, nb, nb), generator=g, device=dev)
            k2(f"slab{slab.rows}", fm, weights(pos_s), flat, count, live)
    torch.cuda.synchronize()
    return shapes, cube, cone


def _moments(tk, fm, w27t, flat, label, torch):
    """K2 moments on the cube: its rounds, its bound (the weights and ids,
    the 22 output rows, 16 B at each cell the rows read) and share, and
    where the timed wrapper takes ``paths`` its kernel's tile count."""
    from fluidsim_tpu_torch.utils import card_inputs as ci

    p, n = flat.shape[0], fm.shape[-1]
    cells = ci.read_cells(flat, n, n)
    nbytes = (27 * 4 + 4) * p + 4 * tk.MOMENT_ROWS * p + 16 * cells
    res = {"read_cells": cells, "bound_mb": nbytes / 1e6,
           "bound_ms": 1e3 * max(nbytes / ci.HBM_BYTES_PER_S,
                                 27 * 44 * p / ci.F32_OPS_PER_S)}
    if "paths" in inspect.signature(tk.g2p_moments).parameters:
        paths = torch.zeros(2, dtype=torch.int32, device=fm.device)
        tk.g2p_moments(fm, w27t, flat, paths=paths)
        res["staged_tiles"] = paths.tolist()
    res["ms"] = [_ms(lambda: tk.g2p_moments(fm, w27t, flat), torch)
                 for _ in range(ROUNDS)]
    res["share"] = res["bound_ms"] / min(res["ms"])
    print(f"{label} k2_moments: {res}", file=sys.stderr)
    return res


def _apic_energies(dev):
    """The kinetic energies of ``APIC_FRAMES`` APIC frames of the cube
    from seed 0, through the timed checkout's ``FlipSim``."""
    from fluidsim_tpu_torch.models.flip import FlipSim
    from fluidsim_tpu_torch.utils import card_inputs as ci

    sim = FlipSim("water_cube_drop", bound=ci.FLIP_BOUND,
                  density=ci.FLIP_DENSITY, seed=ci.SEED, device=dev,
                  mode="apic")
    return [float(sim.step()["kinetic_energy"]) for _ in range(APIC_FRAMES)]


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here,
                    help="checkout whose kernels are timed")
    ap.add_argument("--label", default="")
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)

    import torch

    if not torch.cuda.is_available():
        print("gather_timing: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    shapes, cube, cone = _inputs(dev)

    if root != here:       # the timed checkout's package in place of this one
        sys.path.insert(0, root)
        for name in [m for m in sys.modules
                     if m.startswith("fluidsim_tpu_torch")]:
            del sys.modules[name]
    from fluidsim_tpu_torch import native
    from fluidsim_tpu_torch.ops import transfer_kernels as tk

    if not native.__file__.startswith(root):
        raise RuntimeError(f"imported {native.__file__}, not from {root}")
    native.library()
    counts_paths = "paths" in inspect.signature(tk.g2p_gather).parameters
    out = {"label": a.label, "root": os.path.relpath(root, here),
           "shapes": {}}

    for name, s in shapes.items():
        res = dict(s["info"])
        fm, w27t, flat, count = s["fm"], s["w27t"], s["flat"], s["count"]
        if counts_paths:
            paths = torch.zeros(2, dtype=torch.int32, device=dev)
            tk.g2p_gather(fm, w27t, flat, count, paths=paths)
            res["staged_tiles"] = paths.tolist()
        res["k2_ms"] = [_ms(lambda: tk.g2p_gather(fm, w27t, flat, count),
                            torch) for _ in range(ROUNDS)]
        res["share"] = res["bound_ms"] / min(res["k2_ms"])
        out["shapes"][name] = res
        print(f"{a.label} {name}: {res}", file=sys.stderr)

    fm, w27t, flat, table = (cube[k] for k in ("fm", "w27t", "flat", "table"))
    out["k2_moments"] = _moments(tk, fm, w27t, flat, a.label, torch)
    for key, fn in (
            ("k7a_ms", lambda: tk.g2p_gather_table(table, w27t, flat)),
            ("k7a_moments_ms",
             lambda: tk.g2p_moments_table(table, w27t, flat)),
            ("k9b_ms", lambda: tk.g2p_gather_spans_launch(table, w27t, flat)),
            ("k9b_moments_ms",
             lambda: tk.g2p_gather_spans_launch(table, w27t, flat, True))):
        out[key] = [_ms(fn, torch) for _ in range(ROUNDS)]
        print(f"{a.label} {key}: {out[key]}", file=sys.stderr)
    fm3, gradw, flat = cone["fm3"], cone["gradw"], cone["flat"]
    out["gw_particles"] = int(flat.shape[0])
    out["gw_ms"] = [_ms(lambda: tk.g2p_gather_gw(fm3, gradw, flat), torch)
                    for _ in range(ROUNDS)]
    del shapes, cube, cone, fm, w27t, flat, table, fm3, gradw
    out["apic_kinetic_energy"] = _apic_energies(dev)
    print(f"{a.label} APIC kinetic energies: {out['apic_kinetic_energy']}",
          file=sys.stderr)

    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0:1]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
