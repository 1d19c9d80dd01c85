"""K3 and the Chebyshev preconditioner (K4) at the pressure solve's shapes,
timed on the card, so that two checkouts of the port can be compared in one
call.

    python3 -m fluidsim_tpu_torch.utils.stencil_timing [--root DIR] [--label L]

``--root`` names the checkout whose ``fluidsim_tpu_torch`` is imported and
built (default: the one holding this file); run the script from two
checkouts in alternation (A, B, B, A) in one call, since the card's clocks
and power limit differ between calls.  It takes either API: the one where
the sharded solve built each K3/K4 operand with its ghost rows (a pad at
world size 1, a ``cat`` of the neighbours' rows on a rank of several), and
the one where K3 and K4 read the neighbours' edge rows in place
(``ghost=`` / ``edges=``) and the preconditioner is one ``cheb_steps``
launch.  Each case times the work the solve does for one call on that
tree: the operand build, the kernels and the cut where there are any.

The fields are ``chip_smoke.py`` phase 3's: ``water_cube_drop`` at 129^3
(1,987,675 particles, seed 0) after two ``FlipSim`` frames, its fluid cells
(4.2% of the box), ``adiag``, the masked pressure as ``p`` and its K3 image
as ``r``; and a dense variant, every cell that is not solid fluid, with
random ``p``.  Shapes: the cube (``FlipSim``), the 129-row slab of world
size 1 (``ShardedFlipSim`` on one rank) and rank 1's 33-row slab of a 4-way
cut with its neighbours' rows.  At 129^3 each timed run takes the next of
three copies of the inputs (3 x 26 MB for K3, more than the 50 MB L2); the
33-row slabs' inputs (2.2 MB a field) stay in L2, as a rank's CG vectors
do.  The exchanges' communication is not timed: the neighbours' rows are
fixed tensors.

Each case is timed ``ROUNDS`` times, each the median of ``REPS`` runs with
CUDA events, each run queued behind a spin kernel so that the events time
the device and not the host.  Two floors of that timing come first: one
minimal launch (``torch.cuda._sleep(1)``), and ``torch.add`` of two fields
into a third at both shapes, a stream of 12 B a cell.  The last line is a
JSON object with the rounds' times, the card's name and power limit, and
the label.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

from fluidsim_tpu_torch.utils.card_inputs import (
    FLIP_BOUND as BOUND, FLIP_DENSITY as DENSITY, SEED, SLAB_RANK, SLAB_WORLD)

REPS = 20
ROUNDS = 3
SPIN_CYCLES = 20_000_000   # ~10 ms at the H100's clocks
COPIES = 3                 # input sets cycled at 129^3


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


def _cycle(make, copies):
    """A callable running ``make(i)``'s function for i = 0, 1, .. in turn:
    each run on the next copy of its inputs."""
    fns = [make(i) for i in range(copies)]
    state = [0]

    def run():
        fn = fns[state[0] % len(fns)]
        state[0] += 1
        return fn()

    return run


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

    import math

    import torch
    import torch.nn.functional as F

    from fluidsim_tpu_torch import FlipSim, native
    from fluidsim_tpu_torch.ops import pressure as pr
    from fluidsim_tpu_torch.ops import stencil_kernels as sk

    if not torch.cuda.is_available():
        print("stencil_timing: no CUDA device", file=sys.stderr)
        return 1
    if not native.__file__.startswith(root):
        raise RuntimeError(f"imported {native.__file__}, not from {root}")
    dev = torch.device("cuda")
    native.library()
    in_place = hasattr(sk, "cheb_steps")
    out = {"label": a.label, "root": os.path.relpath(root, here),
           "api": "edge rows in place" if in_place else "ghost operands"}
    sim = FlipSim("water_cube_drop", bound=BOUND, density=DENSITY, seed=SEED,
                  device=dev)
    sim.step()
    m = sim.step()
    scale = float(m["dt_used"])
    g = torch.Generator(device=dev).manual_seed(SEED)
    pad1 = lambda t: F.pad(t, (0, 0, 0, 0, 1, 1))
    no_edges = lambda ts, width: [(None, None)] * len(ts)

    # the floors of this timing: one minimal launch, and a streaming add of
    # two fields into a third (12 B a cell, K3's bound's traffic)
    n = sim.solid.shape[0]
    nl = math.ceil(n / SLAB_WORLD)
    out["launch_floor_ms"] = [_ms(lambda: torch.cuda._sleep(1), torch)
                              for _ in range(ROUNDS)]
    for key, rows in (("cube", n), ("slab33", nl)):
        ab = [torch.rand((2, rows, n, n), generator=g, device=dev)
              for _ in range(COPIES)]
        res = torch.empty((rows, n, n), device=dev)
        add = _cycle(lambda i: lambda: torch.add(ab[i][0], ab[i][1], out=res),
                     COPIES if rows == n else 1)
        out[f"add_{key}_ms"] = [_ms(add, torch) for _ in range(ROUNDS)]
    del ab, res

    for data in ("frame", "dense"):
        fluid = ((m["occupancy"] > 0) & ~sim.solid if data == "frame"
                 else ~sim.solid)
        adiag = pr.laplacian_diag(fluid, sim.solid, m["dt_used"], 1.0, 1.0)
        p = torch.where(fluid, sim.state.pressure if data == "frame" else
                        torch.randn(fluid.shape, generator=g, device=dev),
                        0.0)
        r = sk.apply_laplacian_plain(p, adiag, scale)
        out[f"{data}_fluid_share"] = float(fluid.float().mean())
        sets = [tuple(t.clone() for t in (p, adiag, r)) for _ in range(COPIES)]
        cases = {}

        # ---- the cube (FlipSim) ----
        cases["k3_cube"] = _cycle(
            lambda i: lambda: sk.apply_laplacian(sets[i][0], sets[i][1],
                                                 scale), COPIES)
        for deg in (3, 4):
            pcs = [sk.chebyshev_precond_fused(s[1], scale, degree=deg)
                   for s in sets]
            cases[f"precond_cube_deg{deg}"] = _cycle(
                lambda i, pcs=pcs: lambda: pcs[i](sets[i][2]), COPIES)

        # ---- world size 1 (ShardedFlipSim on one rank) ----
        if in_place:
            cases["k3_world1"] = _cycle(
                lambda i: lambda: sk.apply_laplacian(
                    sets[i][0], sets[i][1], scale, ghost=(None,) * 4), COPIES)
            for deg in (3, 4):
                pcs = [sk.chebyshev_precond_fused(
                    s[1], scale, degree=deg, edges=no_edges) for s in sets]
                cases[f"precond_world1_deg{deg}"] = _cycle(
                    lambda i, pcs=pcs: lambda: pcs[i](sets[i][2]), COPIES)
        else:
            exts = [pad1(s[1]) for s in sets]
            cases["k3_world1"] = _cycle(
                lambda i: lambda: sk.apply_laplacian(
                    pad1(sets[i][0]), exts[i], scale)[1:n + 1], COPIES)
            for deg in (3, 4):
                pcs = [sk.chebyshev_precond_fused(e, scale, degree=deg,
                                                  ghost=pad1) for e in exts]
                cases[f"precond_world1_deg{deg}"] = _cycle(
                    lambda i, pcs=pcs: lambda: pcs[i](sets[i][2]), COPIES)

        # ---- rank 1 of a 4-way cut: 33 rows and the neighbours' rows ----
        x0 = SLAB_RANK * nl
        rows = lambda t, lo, hi: t[lo:hi].contiguous()
        p_s, a_s, r_s = (rows(t, x0, x0 + nl) for t in (p, adiag, r))
        depth = 3
        blocks = {name: (rows(t, x0 - depth, x0),
                         rows(t, x0 + nl, x0 + nl + depth))
                  for name, t in (("p", p), ("adiag", adiag), ("r", r))}
        near = lambda name, w: (blocks[name][0][depth - w:],
                                blocks[name][1][:w])
        out[f"{data}_slab_rows"] = nl
        if in_place:
            ghost3 = (blocks["p"][0][-1], blocks["p"][1][0],
                      blocks["adiag"][0][-1], blocks["adiag"][1][0])
            cases["k3_slab33"] = lambda: sk.apply_laplacian(
                p_s, a_s, scale, ghost=ghost3)
            # the neighbours' z and d before a second launch: p's rows
            edges = lambda ts, w: [near("r" if t is r_s else "adiag" if t
                                        is a_s else "p", w) for t in ts]
            for deg in (3, 4):
                pc = sk.chebyshev_precond_fused(
                    a_s, scale, degree=deg, edges=edges)
                cases[f"precond_slab33_deg{deg}"] = (
                    lambda pc=pc: pc(r_s))
        else:
            cat1 = lambda t, name: torch.cat([near(name, 1)[0], t,
                                              near(name, 1)[1]])
            a_ext = cat1(a_s, "adiag")
            cases["k3_slab33"] = lambda: sk.apply_laplacian(
                cat1(p_s, "p"), a_ext, scale)[1:nl + 1]
            for deg in (3, 4):
                pc = sk.chebyshev_precond_fused(
                    a_ext, scale, degree=deg,
                    ghost=lambda q: cat1(q, "p"))
                cases[f"precond_slab33_deg{deg}"] = (
                    lambda pc=pc: pc(r_s))

        # ---- one K4 launch of 1 to S_MAX steps (this tree's kernel) ----
        if in_place:
            for steps in range(1, sk.S_MAX + 1):
                theta, coefs = sk.cheb_coefs(steps + 1)
                cases[f"k4_cube_{steps}steps"] = _cycle(
                    lambda i, coefs=coefs, theta=theta: lambda: sk.cheb_steps(
                        sets[i][1], sets[i][2], scale, coefs, theta),
                    COPIES)

        for key, fn in cases.items():
            out[f"{data}_{key}_ms"] = [_ms(fn, torch) for _ in range(ROUNDS)]
        del sets, cases

    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0:1]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
