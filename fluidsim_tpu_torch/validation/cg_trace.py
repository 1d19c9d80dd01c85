"""Where an MPM frame's implicit solve stops at its cap: step ``mpm_cone``
and, for every frame whose velocity came from a CG solve that reached its
iteration cap, step that frame again from a copy of its input state with
its solves recorded, and report each solve's residuals against the
tolerance (``||r||^2 / tol2``: above 1 until the solve converges).  The
recording is outside the solver: for the traced frame the frame's ``pcg``
is one whose preconditioner first records ``||r||^2`` of each residual it
is given, by the loop's own sum (``recording_pcg``).

    python -m fluidsim_tpu_torch.validation.cg_trace [--bound 63] \\
        [--frames 250]
    python -m fluidsim_tpu_torch.validation.cg_trace --device cpu \\
        --bound 15 --frames 3 --all

``--all`` traces every frame, capped or not; ``--hessian`` picks the
implicit operator (default: the scene's, "hybrid" past bound 15).  The
rerun is checked to be the same frame (the same iteration counts, the
same kinetic energy to the bit).  One JSON line: the frames run, each
frame's CG iterations, SPD fallbacks and kinetic energy, and per traced
frame, per solve its iterations, cap, the residual ratio at the start,
its least value and the iteration of it, and the least, median and
largest ratio over the last 100 iterations (or all of them, if fewer).
At bound 63 with ``--hessian full`` or ``spd`` the frames stand beside
the JAX package's 127^3 runs of that operator
(``docs/mpm_anatomy_127_none.json``, ``docs/mpm_anatomy_127_spd.json``,
read only): their CG iterations per frame, the largest and its frame.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from fluidsim_tpu_torch.models import mpm
from fluidsim_tpu_torch.models.mpm import (MpmParams, MpmSim, MpmState,
                                           frame_solves)
from fluidsim_tpu_torch.ops import pcg as pcg_ops
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.validation import traces

# the JAX package's 127^3 cone runs by operator (precond "none")
RECORDS = {"full": "mpm_anatomy_127_none.json",
           "spd": "mpm_anatomy_127_spd.json"}


def _copy(state: MpmState) -> MpmState:
    return MpmState(**{f.name: getattr(state, f.name).clone()
                       for f in dataclasses.fields(MpmState)})


def solve_summary(solve: dict) -> dict:
    """One traced solve's residuals relative to its stopping threshold."""
    ratio = np.asarray(solve["rr"], np.float64) / solve["tol2"]
    last = ratio[-100:]
    return {"iters": len(ratio) - 1, "maxiter": solve["maxiter"],
            "start": float(ratio[0]), "least": float(ratio.min()),
            "least_at": int(ratio.argmin()), "end": float(ratio[-1]),
            "last100_least": float(last.min()),
            "last100_median": float(np.median(last)),
            "last100_largest": float(last.max())}


def recording_pcg(solves: list):
    """``ops.pcg.pcg`` with the caller's preconditioner (none: the identity)
    wrapped by one that records ``||r||^2`` of every residual it is given:
    the initial one and one per iteration, the values the loop's stopping
    test reads, by the loop's own sum.  Each solve appends its threshold
    ``tol2``, its ``maxiter`` and ``rr`` to ``solves``; the solve is the
    same as without the recording."""
    def traced(apply_a, b, x0=None, precond=None, rtol=1e-5, maxiter=200):
        inner = precond or (lambda r: r)
        rr = []

        def record(r):
            rr.append(float(pcg_ops._dot(r, r)))
            return inner(r)
        res = pcg_ops.pcg(apply_a, b, x0=x0, precond=record, rtol=rtol,
                          maxiter=maxiter)
        solves.append({"tol2": float(rtol * rtol * pcg_ops._dot(b, b)),
                       "maxiter": maxiter, "rr": rr})
        return res
    return traced


def traced_frame(sim: MpmSim, state: MpmState) -> tuple[dict, list[dict]]:
    """Step ``sim`` once from ``state`` with its solves recorded; returns
    (the frame's metrics, its solves' traces)."""
    sim.state = state
    solves = []
    saved, mpm.pcg = mpm.pcg, recording_pcg(solves)
    try:
        m = sim.step()
    finally:
        mpm.pcg = saved
    return m, solves


def run(bound: int = 63, frames: int = 250, device="cuda",
        every: bool = False, hessian: str = "auto") -> dict:
    scene = get_scene("mpm_cone", bound=bound)
    sim = MpmSim(scene, device=device, params=MpmParams(
        bound=bound, wall=scene.spec.wall, dx=scene.spec.dx,
        gravity=tuple(scene.gravity), hessian=hessian))
    out = {"grid": 2 * bound + 1, "particles": sim.num_particles,
           "hessian": sim.params.hessian, "frames": frames,
           "cg_rtol": sim.params.cg_rtol, "traced": []}
    cg, spd, ke = [], [], []
    for f in range(frames):
        before = _copy(sim.state)
        m = sim.step()
        cg.append(m["cg_iters"])
        spd.append(m["spd_fallback"])
        ke.append(float(m["kinetic_energy"]))
        if not every and frame_solves(sim.params, m["cg_iters"],
                                      m["spd_fallback"])[1]:
            continue
        after = sim.state
        again, solves = traced_frame(sim, before)
        same = (again["cg_iters"] == m["cg_iters"]
                and torch.equal(again["kinetic_energy"],
                                m["kinetic_energy"]))
        out["traced"].append({"frame": f, "cg_iters": m["cg_iters"],
                              "spd_fallback": m["spd_fallback"],
                              "rerun_same": bool(same),
                              "solves": [solve_summary(s) for s in solves]})
        sim.state = after
    out["cg"], out["spd"], out["ke"] = cg, spd, ke
    if bound == 63 and sim.params.hessian in RECORDS:
        rows = traces.load(RECORDS[sim.params.hessian])["rows"][:frames]
        rec = [r["cg_iters"] for r in rows]
        out["record"] = {
            "file": "docs/" + RECORDS[sim.params.hessian], "cg": rec,
            "cg_max": max(rec), "cg_max_frame": int(np.argmax(rec)),
            "cg_total": sum(rec), "port_cg_max": max(cg),
            "port_cg_max_frame": int(np.argmax(cg)),
            "port_cg_total": sum(cg),
            "ke_rel_max_0_99": float(traces.rel_err(
                ke[:100], [r["ke"] for r in rows[:100]]).max())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bound", type=int, default=63)
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--all", action="store_true",
                    help="trace every frame, not only the capped ones")
    ap.add_argument("--hessian", default="auto",
                    choices=("auto", "full", "spd", "hybrid"))
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    res = run(a.bound, a.frames, a.device, a.all, a.hessian)
    line = json.dumps(res)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0 if all(t["rerun_same"] for t in res["traced"]) else 1


if __name__ == "__main__":
    sys.exit(main())
