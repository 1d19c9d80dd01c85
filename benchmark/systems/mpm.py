"""The snow MPM configurations: ``fluidsim_tpu_torch``'s ``MpmSim`` on one
card.

The program receives the benchmark's particles through ``MpmSim``'s
``seeder`` argument and runs its frames through ``MpmSim.step``; the plain
reference is ``reference/mpm.py``, and the particles compare binned by cell
(``compare.py``).
"""

from __future__ import annotations

import torch

from benchmark import compare, traffic, work_bytes
from benchmark.reference import mpm as ref
from benchmark.systems import check_covered

# what the reference computes: any other setting is refused
COVERED = {"kernel": "mpm", "hessian": "hybrid", "precond": "none"}
# (phase, layer, module, function): the calls of an MPM frame that the
# traced run times, each in the layer whose per-frame metric it adds to
# (the force applies run inside the solve's ``pcg``)
PHASES = (
    ("sort", "transfer", "fluidsim_tpu_torch.ops.mpm_kernels", "sort_mpm"),
    ("stencil", "transfer", "fluidsim_tpu_torch.ops.mpm_kernels",
     "mpm_stencil"),
    ("cell ranges", "transfer", "fluidsim_tpu_torch.ops.transfer_kernels",
     "cell_starts"),
    ("chunk plan", "transfer", "fluidsim_tpu_torch.ops.transfer_kernels",
     "chunk_plan"),
    ("P2G", "transfer", "fluidsim_tpu_torch.ops.mpm_kernels", "p2g_mpm"),
    ("density", "transfer", "fluidsim_tpu_torch.ops.mpm_kernels", "density"),
    ("hardening", "constitutive", "fluidsim_tpu_torch.models.mpm",
     "hardening"),
    ("stress", "constitutive", "fluidsim_tpu_torch.ops.mpm_kernels",
     "make_force_fns"),
    ("solve", "solve", "fluidsim_tpu_torch.models.mpm", "pcg"),
    ("gradV", "transfer", "fluidsim_tpu_torch.ops.mpm_kernels",
     "gradv_gather"),
    ("F update", "constitutive", "fluidsim_tpu_torch.models.mpm",
     "clamp_singular"),
    ("FLIP delta", "transfer", "fluidsim_tpu_torch.ops.mpm_kernels",
     "flip_delta"),
    ("advection", "transfer", "fluidsim_tpu_torch.models.mpm",
     "advect_bounce"),
)
STATE_KEYS = ("pos", "vel", "FE", "FP", "volume", "dt", "frame")
# the particles' fields that the comparison bins by cell, beside positions
FIELDS = (("vel_gap", "vel", "rel"), ("fe_gap", "FE", "entry"),
          ("fp_gap", "FP", "entry"), ("volume_gap", "volume", "rel"))
REF_KEYS = ("bound", "gravity", "dx", "E", "nu", "beta", "hardening_eps",
            "theta_c", "theta_s", "max_dt", "mass_threshold",
            "hardening_max", "max_gradv_dt", "cg_rtol", "cg_maxiter",
            "cg_hybrid_cap")


class System:
    """One MPM cell: the sim, its start state and the span's length."""

    kind = "mpm"
    phases = PHASES

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from fluidsim_tpu_torch.models import mpm
        from fluidsim_tpu_torch.scenes import get_scene

        check_covered(cfg, COVERED)
        self.cfg = cfg
        self.frames = traffic.frames(mix, self.kind)
        pos, vel, _dt = traffic.start_particles(cfg, mix, seed, device)
        scene = get_scene(cfg["scene"], bound=cfg["bound"],
                          density=cfg["density"])
        params = mpm.MpmParams(
            bound=cfg["bound"], wall=scene.spec.wall, dx=cfg["dx"],
            gravity=tuple(cfg["gravity"]), **cfg["params"])
        self._state = mpm.MpmState
        self.sim = mpm.MpmSim(scene, params,
                              seeder=lambda *_a, **_k: (pos, vel),
                              device=device)
        if not self.sim.params.walls_only_solid:
            raise ValueError("the MPM cells' scenes are walled boxes")
        s = self.sim.state
        self.start = {k: getattr(s, k).clone() for k in STATE_KEYS + ("t",)}
        self.particles = pos.shape[0]
        self.n = 2 * cfg["bound"] + 1

    def restore(self):
        """Put the start state back: a device copy."""
        self.sim.state = self._state(**{k: v.clone()
                                        for k, v in self.start.items()})

    def step(self) -> dict:
        """One frame; returns its counts (``active_cells`` stays a device
        tensor until the window has closed)."""
        m = self.sim.step()
        return {"cg_iters": m["cg_iters"], "spd_fallback": m["spd_fallback"],
                "active_cells": m["num_active_cells"]}

    def snapshot(self) -> dict:
        """A copy of the program's state, as the reference reads it."""
        return {k: getattr(self.sim.state, k).clone() for k in STATE_KEYS}

    def release(self):
        """Free the program and its state."""
        self.sim = None

    def frame_bytes(self, counts: dict) -> int:
        # each solve's first residual and every CG iteration apply once
        applies = counts["cg_iters"] + 1 + counts["spd_fallback"]
        return work_bytes.mpm_frame(self.particles, self.n,
                                    int(counts["active_cells"]), applies)

    # ---- the comparison ------------------------------------------------

    def reference(self, state: dict, dtype=torch.float32) -> dict:
        """The reference's frame from ``state``, computed in ``dtype``."""
        c = {**self.cfg, **self.cfg["params"]}
        return ref.run({k: c[k] for k in REF_KEYS}, state, 1, dtype)

    def gaps(self, prog: dict, want: dict) -> dict:
        """The compared numbers of one frame, the particles binned by cell
        (``compare.binned_gaps``): the share binned elsewhere, the gaps of
        the cells' mean velocity and volume in L2 over the reference's norm,
        the RMS gaps of their mean position (cells) and of their mean FE
        and FP entries."""
        return compare.binned_gaps(prog, want, self.cfg["bound"], FIELDS)
