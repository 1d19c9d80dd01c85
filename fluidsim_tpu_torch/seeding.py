"""Deterministic particle seeding (host-side numpy) — the counterpart of
``fluidsim_tpu/seeding.py``.

``int(density * voxel_volume) * active_voxel_count`` particles land in
uniformly random active voxels of the scene's seed mask, jittered uniformly
inside the voxel (``coord - 0.5 + u``, ``u ~ U[0,1)^3``), then filtered to
``|p| < bound - 2`` per component.  The random stream is numpy's
``default_rng(seed)`` drawn in the same order as the JAX package, so the
same seed gives bit-identical particles in both packages.
"""

from __future__ import annotations

import numpy as np

from fluidsim_tpu_torch.scenes import Scene


def seed_particles(scene: Scene, seed: int = 0, dtype=np.float32):
    """Scatter particles into the scene's seed mask.

    Returns:
      pos: (P, 3) numpy positions in index space, all inside ``|p| < bound - 2``.
      vel: (P, 3) numpy initial velocities (``scene.initial_velocity``).
    """
    spec = scene.spec
    active = np.argwhere(scene.seed_mask)
    if active.size == 0:
        raise ValueError(f"scene {scene.name} has an empty seed mask")
    coords = active - spec.bound
    vol = spec.dx ** 3
    target = int(int(scene.density * vol) * len(active))

    rng = np.random.default_rng(seed)
    which = rng.integers(0, len(active), size=target)
    jitter = rng.random((target, 3))
    pos = coords[which].astype(np.float64) - 0.5 + jitter

    keep = np.all(np.abs(pos) < spec.bound - 2, axis=1)
    pos = pos[keep].astype(dtype)
    vel = np.broadcast_to(np.asarray(scene.initial_velocity, dtype=dtype),
                          pos.shape).copy()
    return pos, vel
