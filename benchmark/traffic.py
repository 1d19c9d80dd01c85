"""The start states of the traffic mixes, made from ``--seed``.

The particles are drawn from the seed (``scenes.seed_particles``), or, where
the mix names a ``positions_seed``, drawn from that seed and put in an
order drawn from the run's: the same particles for every seed.  The splash
of ``impact`` is chaotic: particles drawn anew change its work from seed to
seed, and so does an order that changes the order of a cell's particles,
since the frame's sums then round otherwise.  So the run's seed shuffles
whole cells and keeps each cell's particles in their drawn order
(``cell_order``): the frame's first stable sort by cell gives the same
sequence for every seed, and every seed the same work.

A mix is a frame span: a start state and K frames, which the window replays
pass after pass.  Its file (``traffic/<mix>.json``) names the start rule and
K for each kind of system:

  ``seeded``       the scene as seeded, at rest or at the scene's initial
                   velocity, frame 0;
  ``pre_impact``   the seeded body moved down until its lowest particle is
                   ``gap_cells`` above the floor's wall plane, every particle
                   at the speed that a drop from its seeded height reaches
                   under the scene's gravity, pressure zero and dt from the
                   CFL rule: the state that free fall gives just before the
                   body meets the floor, made without running the program.
"""

from __future__ import annotations

import math

import torch

from benchmark import scenes
from benchmark.reference.grid import cround


def frames(mix: dict, system: str) -> int:
    """K, the frames of one pass of the span for this kind of system."""
    try:
        return int(mix["frames"][system])
    except KeyError:
        raise ValueError(f"traffic {mix['name']!r} has no span for "
                         f"{system!r} systems") from None


def cell_order(pos: torch.Tensor, bound: int, seed: int) -> torch.Tensor:
    """An order of the particles drawn from ``seed`` that shuffles whole
    cells (the cell of the rounded position, clipped to the box, as the
    frame's sort bins them) and keeps each cell's particles in their order
    in ``pos``."""
    n = 2 * bound + 1
    cell = torch.clamp(cround(pos).long() + bound, 0, n - 1)
    flat = (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]
    place = torch.randperm(n ** 3, generator=scenes.generator(
        seed, pos.device), device=pos.device)
    return torch.sort(place[flat], stable=True).indices


def start_particles(cfg: dict, mix: dict, seed: int, device):
    """(pos, vel, dt) of the mix's start state: (P, 3) float32 tensors and a
    Python float."""
    pos, vel, dt = _start(cfg, mix, scenes.seed_particles(
        cfg["scene"], cfg["bound"], cfg["density"],
        mix.get("positions_seed", seed), device))
    if "positions_seed" in mix:
        # the same particles for every seed, whole cells in the seed's order
        order = cell_order(pos, cfg["bound"], seed)
        pos, vel = pos[order], vel[order]
    return pos, vel, dt


def _start(cfg: dict, mix: dict, pos: torch.Tensor):
    """The start rule of the mix applied to the seeded positions."""
    device = pos.device
    g = abs(cfg["gravity"][1])
    rule = mix["start"]
    if rule == "seeded":
        vel = torch.tensor(cfg.get("initial_velocity", (0.0, 0.0, 0.0)),
                           dtype=torch.float32, device=device).expand_as(pos)
        return pos, vel.contiguous(), float(cfg["params"]["max_dt"])
    if rule == "pre_impact":
        # the floor's wall plane lies between the solid cell -(bound - 1)
        # and the first open one, -(bound - 2)
        plane = -(cfg["bound"] - 2) - 0.5
        drop = float(pos[:, 1].min()) - (plane + float(mix["gap_cells"]))
        if drop <= 0:
            raise ValueError("pre_impact: the seeded body already lies "
                             "within gap_cells of the floor")
        pos = pos.clone()
        pos[:, 1] -= drop
        speed = math.sqrt(2.0 * g * drop)
        vel = torch.zeros_like(pos)
        vel[:, 1] = -speed
        dt = min(float(cfg["params"]["max_dt"]), float(cfg["dx"]) / speed)
        return pos, vel, dt
    raise ValueError(f"traffic {mix['name']!r}: unknown start rule {rule!r}")
