"""The snow MPM configurations over x-slab ranks: ``fluidsim_tpu_torch``'s
``ShardedMpmSim``, one rank a card.

Every rank seeds the same particles from ``--seed`` and hands them to the
sim, which keeps the ones of its slab.  The comparison gathers the ranks'
live particles on rank 0 in rank order, runs the plain MPM frame
(``reference/mpm.py``) from the gathered state before a checked frame, and
compares the state after it binned by cell, as one card's
(``compare.py``), which is blind to the order in which ranks hold and
migrate their particles.  It also holds the ranks' live particles at the
end of the checked pass, and the frames' own counts of dropped ones,
against the seeded count.
"""

from __future__ import annotations

import torch

from benchmark import ranks, traffic
from benchmark.systems import check_covered
from benchmark.systems import mpm as single

SLAB = "fluidsim_tpu_torch.parallel.mpm_sharded"
TK = "fluidsim_tpu_torch.ops.transfer_kernels"
# (phase, layer, module, function), as ``systems/mpm.py``; the migration is
# the slab decomposition's own
PHASES = (
    ("sort", "transfer", SLAB, "sort_slab"),
    ("stencil", "transfer", "fluidsim_tpu_torch.ops.mpm_kernels",
     "mpm_stencil"),
    ("cell ranges", "transfer", TK, "cell_starts"),
    ("chunk plan", "transfer", TK, "chunk_plan"),
    ("P2G", "transfer", TK, "p2g_scatter"),
    ("gathers", "transfer", TK, "g2p_gather"),
    ("hardening", "constitutive", SLAB, "hardening"),
    ("stress", "constitutive", SLAB, "piola_linearized"),
    ("solve", "solve", SLAB, "pcg"),
    ("F update", "constitutive", SLAB, "clamp_singular"),
    ("advection", "transfer", SLAB, "advect_bounce"),
    ("migration", "slab", SLAB, "migrate"),
)
LOCAL_KEYS = ("pos", "vel", "FE", "FP", "volume", "alive", "dt", "frame")
PARTICLE_KEYS = ("pos", "vel", "FE", "FP", "volume")


class System(single.System):
    """One rank's part of a sharded MPM cell."""

    phases = PHASES

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from fluidsim_tpu_torch.models.mpm import MpmParams
        from fluidsim_tpu_torch.parallel import mpm_sharded
        from fluidsim_tpu_torch.scenes import get_scene

        check_covered(cfg, single.COVERED)
        self.cfg = cfg
        self.frames = traffic.frames(mix, self.kind)
        pos, vel, _dt = traffic.start_particles(cfg, mix, seed, device)
        scene = get_scene(cfg["scene"], bound=cfg["bound"],
                          density=cfg["density"])
        params = MpmParams(bound=cfg["bound"], wall=scene.spec.wall,
                           dx=cfg["dx"], gravity=tuple(cfg["gravity"]),
                           **cfg["params"])
        host = (pos.cpu().numpy(), vel.cpu().numpy())
        self._state = mpm_sharded.ShardedMpmState
        self.sim = mpm_sharded.ShardedMpmSim(
            scene, params, seeder=lambda *_a, **_k: host, device=device,
            **cfg.get("slabs", {}))
        s = self.sim.state
        self.start = {k: getattr(s, k).clone() for k in LOCAL_KEYS + ("t",)}
        self.particles = pos.shape[0]
        self.n = 2 * cfg["bound"] + 1

    def snapshot(self) -> dict:
        return {k: getattr(self.sim.state, k).clone() for k in LOCAL_KEYS}

    def gather(self, local: dict):
        """The ranks' live particles of a snapshot on rank 0, in rank order
        (None on the others)."""
        alive = local["alive"]
        out = {k: ranks.gather_rows(local[k][alive]) for k in PARTICLE_KEYS}
        if out["pos"] is None:
            return None
        return {**out, "dt": local["dt"], "frame": local["frame"]}

    def frame_bytes(self, counts: dict) -> int:
        """A rank's share of the frame's bytes: the whole frame's over the
        ranks."""
        return single.System.frame_bytes(self, counts) // ranks.world()[1]

    def step(self) -> dict:
        """One frame; returns its counts, with the particles that the
        frame's migration dropped over all ranks (a device tensor)."""
        m = self.sim.step()
        return {"cg_iters": m["cg_iters"], "spd_fallback": m["spd_fallback"],
                "active_cells": m["num_active_cells"], "lost": m["lost"]}

    def gaps(self, prog: dict, want: dict) -> dict:
        """The compared numbers of one frame, as one card's (binned by
        cell), and ``lost_share``: the seeded particles that the ranks no
        longer hold."""
        out = single.System.gaps(self, prog, want)
        out["lost_share"] = 1.0 - prog["pos"].shape[0] / self.particles
        return out

    def pass_gaps(self, final: dict, counts: list) -> dict:
        """The particles lost over the whole checked pass, in the frames
        that are not compared too: ``lost_share`` of the state at its end,
        and ``lost_counted``, the sum of the frames' own counts of the
        particles that migration dropped."""
        return {"lost_share": 1.0 - final["pos"].shape[0] / self.particles,
                "lost_counted": float(sum(int(c["lost"]) for c in counts))}
