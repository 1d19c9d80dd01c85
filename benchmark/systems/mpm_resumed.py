"""The snow MPM picked up mid-run: ``systems/mpm.py``'s system started from
the program's own state after the mix's lead-in.

Set-up seeds the scene as ``mpm`` does (frame 0), steps the program through
``MpmSim.step`` for the mix's ``lead_in`` frames and takes the state they
end in, ``t`` and ``frame`` included, as the span's start; the window, the
checked pass and the reference (``reference/mpm.py``, whose hybrid solve
falls back to the SPD operator as the program's does) run from it as from
``mpm``'s.  The traced run also times the hybrid solve's SPD re-solve
(``spd_resolve``), and each frame's counts carry ``spd_iters``.
"""

from __future__ import annotations

import importlib

from benchmark.systems import mpm

PROGRAM = "fluidsim_tpu_torch.models.mpm"
# ``mpm``'s phases and the SPD re-solve, which runs inside the solve's
# ``pcg`` phase and adds to the solve layer through it
PHASES = mpm.PHASES + (("SPD solve", "spd", PROGRAM, "spd_resolve"),)


class System(mpm.System):
    """An MPM cell whose span starts after ``lead_in`` of the program's
    frames."""

    phases = PHASES

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        if not hasattr(importlib.import_module(PROGRAM), "spd_resolve"):
            raise RuntimeError("this program has no spd_resolve: the "
                               "landing's traced phases and counts read it")
        super().__init__(cfg, mix, seed, device)
        for _ in range(int(mix["lead_in"][self.kind])):
            self.sim.step()
        s = self.sim.state
        self.start = {k: getattr(s, k).clone()
                      for k in mpm.STATE_KEYS + ("t",)}

    def step(self) -> dict:
        """One frame; ``mpm``'s counts and the SPD solve's iterations."""
        m = self.sim.step()
        return {"cg_iters": m["cg_iters"], "spd_iters": m["spd_iters"],
                "spd_fallback": m["spd_fallback"],
                "active_cells": m["num_active_cells"]}
