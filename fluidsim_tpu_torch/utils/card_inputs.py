"""The sizes and inputs at which ``chip_smoke.py`` and
``utils/gather_timing.py`` drive the port's kernels on the card: the JAX
package's bench scene and its scaled MPM bench row, uncut, and one rank of
a 4-way slab cut; ``rank_arrays`` builds a rank's particles as a sharded
frame holds them, and ``read_cells`` counts the grid cells a gather's
live rows must read, which a bound on its bytes counts at the card's
rates below."""

from __future__ import annotations

import numpy as np
import torch

FLIP_BOUND = 64       # water_cube_drop: a (2*64+1)^3 = 129^3 grid
FLIP_DENSITY = 25.0   # particles per seeded voxel: 1,987,675 particles
MPM_BOUND = 63        # mpm_cone: a 127^3 grid, 473,798 particles
SEED = 0
SLAB_WORLD, SLAB_RANK = 4, 1   # the 4-way cut's rank whose slab is taken

# the least time of a kernel: H100 SXM HBM3 bandwidth and f32 rate outside
# the tensor cores (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def rank_arrays(scene, bound: int, rank: int, size: int, rng, dev):
    """Rank ``rank``'s sorted slots in a ``size``-way cut of the scene's
    seeded particles (seed ``SEED``) with random velocities from the numpy
    generator ``rng``: its own particles alive, every other slot dead, as
    the rank holds them in a frame.  Returns (slab, pos, vel, flat, live
    count)."""
    from fluidsim_tpu_torch.parallel import flip_sharded as fs
    from fluidsim_tpu_torch.seeding import seed_particles

    slab = fs.Slab.build(np.asarray(scene.solid), bound, None, dev,
                         rank=rank, size=size)
    pos, _ = seed_particles(scene, seed=SEED, dtype="float32")
    vel = torch.as_tensor(rng.normal(scale=3.0, size=pos.shape)
                          .astype(np.float32), device=dev)
    pos = torch.as_tensor(pos, device=dev)
    alive = fs.owners(slab, pos) == rank
    pos = torch.where(alive[:, None], pos, fs.SENTINEL)
    vel = torch.where(alive[:, None], vel, 0.0)
    pos_s, vel_s, _, flat = fs.sort_slab(slab, pos, vel, alive)
    return slab, pos_s, vel_s, flat, int(alive.sum())


def read_cells(flat: torch.Tensor, nx: int, n: int,
               live: int | None = None) -> int:
    """How many distinct cells of the (nx, n, n) grid lie in the 27-cell
    neighbourhoods of the base cells ``flat[:live]`` (all of ``flat``
    without ``live``): the cells a gather of those rows must read."""
    ids = flat if live is None else flat[:live]
    occupied = torch.zeros(nx * n * n, dtype=torch.float32,
                           device=flat.device)
    occupied[ids.long()] = 1.0
    near = torch.nn.functional.max_pool3d(occupied.view(1, 1, nx, n, n), 3,
                                          stride=1, padding=1)
    return int(near.sum())
