"""The scenes' geometry and particles, made by the benchmark from ``--seed``.

The seed masks are the reference's scenes: ``fluid.cc``'s water cube (half
width ``bound // 3`` at the centre) and ``mpm.cc``'s cone (radius ``(j -
lo) / 2`` on layer ``j`` from ``lo = -(bound - 2)``, ``max(4, round(4 bound
/ 15))`` layers).  The particles follow the project's seeding rule:
``int(density)`` a voxel of the mask, each in a voxel drawn uniformly from
the mask, jittered uniformly inside it (``coord - 0.5 + u``), then those
with ``|p| >= bound - 2`` on some axis left out.  They are drawn on the
device by one ``torch.Generator`` seeded with ``--seed``, so a seed gives
the same particles on the same device.
"""

from __future__ import annotations

import torch


def seed_mask(scene: str, bound: int, device) -> torch.Tensor:
    """(N,N,N) bool: the voxels that the scene seeds."""
    c = torch.arange(-bound, bound + 1, device=device)
    n = c.shape[0]
    if scene == "water_cube_drop":
        ok = c.abs() <= bound // 3
        return ok[:, None, None] & ok[None, :, None] & ok[None, None, :]
    if scene == "mpm_cone":
        mask = torch.zeros((n, n, n), dtype=torch.bool, device=device)
        lo = -(bound - 2)
        r2 = c[:, None] ** 2 + c[None, :] ** 2
        for j in range(lo, lo + max(4, round(4 * bound / 15))):
            r = (j - lo) / 2.0
            mask[:, j + bound, :] |= r2 <= r * r
        return mask
    raise ValueError(f"scene {scene!r}: the benchmark knows water_cube_drop "
                     "and mpm_cone")


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number;
    taken modulo 2**63)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def seed_particles(scene: str, bound: int, density: float, seed: int,
                   device) -> torch.Tensor:
    """(P, 3) float32 positions in index space."""
    g = generator(seed, device)
    active = torch.nonzero(seed_mask(scene, bound, device)) - bound
    target = int(density) * active.shape[0]
    which = torch.randint(0, active.shape[0], (target,), generator=g,
                          device=device)
    jitter = torch.rand((target, 3), generator=g, dtype=torch.float64,
                        device=device)
    pos = active[which].to(torch.float64) - 0.5 + jitter
    keep = torch.all(pos.abs() < bound - 2, dim=1)
    return pos[keep].to(torch.float32)
