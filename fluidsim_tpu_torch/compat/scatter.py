"""Bit-exact reproduction of the reference's particle seeding — the
counterpart of ``fluidsim_tpu/compat/scatter.py``, on the port's ``Scene``.

``UniformPointScatter`` (``openvdb/tools/PointScatter.h:139-186``) draws
``target = int(density * voxel_volume) * activeVoxelCount`` random *virtual
voxel indices* (through a copy of the seeded std::mt19937), sorts them, walks
the grid's active-value iterator to the containing voxel or tile, and jitters
a point inside it (``addPoint``, ``:416-439``) using a second, independent
copy of the same engine.  ``PointList::add`` then filters to
``|p| < bound - 2`` (``fluid.cc:841``).

Reproducing this bit-for-bit requires modelling:

* the std::mt19937 streams and libstdc++ distributions (``compat.mt19937``),
* the tree topology that ``Grid::fill(bbox, v, active)`` produces — active
  *tiles* for fully covered node-aligned regions and dense leaves at the box
  boundary (``openvdb/tree/Tree.h:502`` sparseFill semantics) — or pure
  per-voxel topology for grids built via ``setValue`` (the MPM scenes),
* the ValueOnCIter traversal order: root children in lexicographic Coord
  order (``openvdb/math/Coord.h`` operator<, std::map), then node offsets in
  x-major/z-fastest order, depth first.

Tree4<T,5,4,3> geometry: leaf 8^3, internal 16^3 (span 128), internal 32^3
(span 4096).
"""

from __future__ import annotations

import numpy as np

from fluidsim_tpu_torch.compat.mt19937 import Mt19937
from fluidsim_tpu_torch.scenes import Scene

LEAF = 8
SPAN1 = 128
SPAN2 = 4096


def _fill_items(lo, hi):
    """Active items for ``fill([lo, hi], active=True)``.

    Returns a list of (key, origin, size) where ``size`` is the tile edge
    length (1 for an individual voxel) and ``key`` orders items in traversal
    order.
    """
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    items = []

    def covered(o, span):
        return np.all(o >= lo) and np.all(o + span - 1 <= hi)

    def overlaps(o, span):
        return np.all(o + span - 1 >= lo) and np.all(o <= hi)

    r2lo = (lo // SPAN2) * SPAN2
    r2hi = (hi // SPAN2) * SPAN2
    roots = [(x, y, z)
             for x in range(int(r2lo[0]), int(r2hi[0]) + 1, SPAN2)
             for y in range(int(r2lo[1]), int(r2hi[1]) + 1, SPAN2)
             for z in range(int(r2lo[2]), int(r2hi[2]) + 1, SPAN2)]
    roots.sort()  # lexicographic Coord order == std::map order

    for ri, r in enumerate(roots):
        r = np.asarray(r)
        # L2 node: 32^3 children of span 128, offsets x-major
        for o2 in range(32 ** 3):
            c2 = np.asarray([(o2 >> 10) & 31, (o2 >> 5) & 31, o2 & 31])
            org1 = r + c2 * SPAN1
            if not overlaps(org1, SPAN1):
                continue
            if covered(org1, SPAN1):
                items.append(((ri, o2, -1, -1), org1, SPAN1))
                continue
            # L1 node: 16^3 children of span 8
            for o1 in range(16 ** 3):
                c1 = np.asarray([(o1 >> 8) & 15, (o1 >> 4) & 15, o1 & 15])
                org0 = org1 + c1 * LEAF
                if not overlaps(org0, LEAF):
                    continue
                if covered(org0, LEAF):
                    items.append(((ri, o2, o1, -1), org0, LEAF))
                    continue
                # partial leaf: active voxels in offset order
                for o0 in range(LEAF ** 3):
                    c0 = np.asarray([(o0 >> 6) & 7, (o0 >> 3) & 7, o0 & 7])
                    v = org0 + c0
                    if np.all(v >= lo) and np.all(v <= hi):
                        items.append(((ri, o2, o1, o0), v, 1))
    return items


def _voxel_items(mask: np.ndarray, bound: int):
    """Active items for a grid built by per-voxel setValue calls: every
    active voxel, ordered by its tree path."""
    coords = np.argwhere(mask) - bound              # (V, 3) grid coords
    r = (coords // SPAN2) * SPAN2
    l2 = ((coords - r) // SPAN1)
    l1 = ((coords - r - l2 * SPAN1) // LEAF)
    l0 = coords - r - l2 * SPAN1 - l1 * LEAF
    o2 = (l2[:, 0] << 10) + (l2[:, 1] << 5) + l2[:, 2]
    o1 = (l1[:, 0] << 8) + (l1[:, 1] << 4) + l1[:, 2]
    o0 = (l0[:, 0] << 6) + (l0[:, 1] << 3) + l0[:, 2]
    order = np.lexsort((o0, o1, o2, r[:, 2], r[:, 1], r[:, 0]))
    return [((int(r[i, 0]), int(r[i, 1]), int(r[i, 2]),
              int(o2[i]), int(o1[i]), int(o0[i])), coords[i], 1)
            for i in order]


def scatter_reference(items, density: float, seed: int, bound: int,
                      dtype=np.float32):
    """Replay UniformPointScatter + PointList::add.

    Args:
      items: ordered active items [(key, origin, size), ...].
      density: points per volume (10 for FLIP, 400 for MPM).
      seed: std::mt19937 seed (0 in both apps, ``fluid.cc:1348``).
    Returns:
      (P, 3) positions, bit-matching the reference's particle order.
    """
    sizes = np.asarray([s for (_, _, s) in items], np.int64)
    voxel_counts = sizes ** 3
    total_voxels = int(voxel_counts.sum())
    target = int(density) * total_voxels  # Index64(density*1.0)*count

    ids_rng = Mt19937(seed)               # RandInt copies the fresh engine
    jit_rng = Mt19937(seed)               # mRand01 holds its own fresh copy
    ids = np.sort(ids_rng.uniform_int(target, total_voxels - 1))

    cum = np.concatenate([[0], np.cumsum(voxel_counts)])
    item_idx = np.searchsorted(cum, ids, side="right") - 1
    within = ids - cum[item_idx]

    jitter = jit_rng.uniform_real(3 * target).reshape(target, 3)

    origins = np.asarray([o for (_, o, _) in items], np.float64)
    orgs = origins[item_idx]
    szs = sizes[item_idx].astype(np.float64)
    # voxel: pos = (coord - 0.5) + u ; tile: pos = (min - 0.5) + size * u
    pos = (orgs - 0.5) + szs[:, None] * jitter

    keep = np.all(np.abs(pos) < bound - 2, axis=1)  # PointList::add filter
    return pos[keep].astype(dtype)


def seed_particles_compat(scene: Scene, seed: int = 0, dtype=np.float32):
    """Drop-in replacement for ``seeding.seed_particles`` with bit-exact
    reference parity.  Scenes whose seed region came from a single
    ``fill(box)`` use the tile topology; setValue-built scenes use per-voxel
    topology."""
    spec = scene.spec
    box = _detect_fill_box(scene.seed_mask, spec.bound)
    if box is not None:
        items = _fill_items(box[0], box[1])
    else:
        items = _voxel_items(scene.seed_mask, spec.bound)
    pos = scatter_reference(items, scene.density, seed, spec.bound, dtype)
    vel = np.broadcast_to(np.asarray(scene.initial_velocity, dtype),
                          pos.shape).copy()
    return pos, vel


def _detect_fill_box(mask: np.ndarray, bound: int):
    """If the mask is exactly one axis-aligned box, return (lo, hi) coords."""
    idx = np.argwhere(mask)
    if len(idx) == 0:
        return None
    lo = idx.min(axis=0)
    hi = idx.max(axis=0)
    if int(np.prod(hi - lo + 1)) == len(idx):
        return lo - bound, hi - bound
    return None
