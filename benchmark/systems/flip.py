"""The FLIP configurations: ``fluidsim_tpu_torch``'s ``FlipSim`` on one card.

The program receives the benchmark's start state through
``FlipSim.from_state`` and runs its frames through ``FlipSim.step``; the
plain reference is ``reference/flip.py``, and the particles compare binned
by cell (``compare.py``).
"""

from __future__ import annotations

import torch

from benchmark import compare, traffic, work_bytes
from benchmark.reference import flip as ref
from benchmark.systems import check_covered

# what the reference computes: any other setting is refused
COVERED = {"mode": "flip", "kernel": "flip", "sort_method": "full",
           "preconditioner": "chebyshev", "compat_projection": True}
# (phase, layer, module, function): the calls of a FLIP frame that the traced
# run times, each in the layer whose per-frame metric it adds to
PHASES = (
    ("sort", "transfer", "fluidsim_tpu_torch.ops.transfer_kernels",
     "sort_by_cell"),
    ("weights", "transfer", "fluidsim_tpu_torch.ops.transfer_kernels",
     "masked_weights_cm"),
    ("P2G", "transfer", "fluidsim_tpu_torch.ops.transfer_kernels", "p2g"),
    ("projection", "projection", "fluidsim_tpu_torch.models.flip", "project"),
    ("G2P", "transfer", "fluidsim_tpu_torch.ops.transfer_kernels", "g2p"),
    ("advection", "transfer", "fluidsim_tpu_torch.models.flip",
     "advect_bounce"),
)
STATE_KEYS = ("pos", "vel", "dt", "pressure")


class System:
    """One FLIP cell: the sim, its start state and the span's length."""

    kind = "flip"
    phases = PHASES

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from fluidsim_tpu_torch.models import flip
        from fluidsim_tpu_torch.scenes import get_scene

        check_covered(cfg, COVERED)
        self.cfg = cfg
        self.frames = traffic.frames(mix, self.kind)
        n = 2 * cfg["bound"] + 1
        pos, vel, dt = traffic.start_particles(cfg, mix, seed, device)
        f32 = dict(dtype=torch.float32, device=device)
        self.start = {"pos": pos, "vel": vel,
                      "dt": torch.tensor(dt, **f32),
                      "pressure": torch.zeros((n, n, n), **f32)}
        scene = get_scene(cfg["scene"], bound=cfg["bound"],
                          density=cfg["density"])
        params = flip.FlipParams(
            bound=cfg["bound"], wall=scene.spec.wall, dx=cfg["dx"],
            gravity=tuple(cfg["gravity"]), **cfg["params"])
        self._state = flip.FlipState
        self.sim = flip.FlipSim.from_state(scene, self._fresh(), params,
                                           device=device)
        if not self.sim.params.walls_only_solid:
            raise ValueError("the FLIP cells' scenes are walled boxes")
        self.particles = pos.shape[0]
        self.n = n

    def _fresh(self):
        s = self.start
        return self._state(
            pos=s["pos"].clone(), vel=s["vel"].clone(), dt=s["dt"].clone(),
            t=torch.zeros_like(s["dt"]),
            frame=torch.zeros((), dtype=torch.int32, device=s["pos"].device),
            pressure=s["pressure"].clone())

    def restore(self):
        """Put the start state back: a device copy."""
        self.sim.state = self._fresh()

    def step(self) -> dict:
        """One frame; returns its counts (``fluid_cells`` stays a device
        tensor until the window has closed)."""
        m = self.sim.step()
        return {"cg_iters": m["cg_iters"], "outer_iters": m["outer_iters"],
                "fluid_cells": m["num_fluid_cells"]}

    def snapshot(self) -> dict:
        """A copy of the program's state, as the reference reads it."""
        return {k: getattr(self.sim.state, k).clone() for k in STATE_KEYS}

    def release(self):
        """Free the program and its state."""
        self.sim = None

    def frame_bytes(self, counts: dict) -> int:
        return work_bytes.flip_frame(self.particles, self.n,
                                     int(counts["fluid_cells"]),
                                     counts["outer_iters"],
                                     counts["cg_iters"])

    # ---- the comparison ------------------------------------------------

    def reference(self, state: dict, dtype=torch.float32) -> dict:
        """The reference's frame from ``state``, computed in ``dtype``."""
        return ref.run(self._ref_cfg(), state, 1, dtype)

    def _ref_cfg(self) -> dict:
        c = self.cfg
        p = c["params"]
        return {"bound": c["bound"], "gravity": tuple(c["gravity"]),
                "dx": c["dx"], "rho": p["rho"], "pcg_rtol": p["pcg_rtol"],
                "pcg_maxiter": p["pcg_maxiter"],
                "cheb_degree": p["cheb_degree"],
                "cheb_ratio": p["cheb_ratio"], "max_outer": p["max_outer"],
                "outer_tol": p["outer_tol"], "max_dt": p["max_dt"]}

    def gaps(self, prog: dict, want: dict) -> dict:
        """The compared numbers of one frame: the particles binned by cell
        (``compare.binned_gaps``: the share binned elsewhere, the cells'
        mean positions and velocities) and the pressure's gap in L2 over
        the reference's norm."""
        out = compare.binned_gaps(prog, want, self.cfg["bound"],
                                  [("vel_gap", "vel", "rel")])
        out["pressure_gap"] = compare.grid_gap(prog["pressure"],
                                               want["pressure"])
        return out
