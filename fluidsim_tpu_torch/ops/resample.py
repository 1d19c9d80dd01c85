"""Grid resampling between transforms and multi-resolution sampling — the
counterpart of ``fluidsim_tpu/ops/resample.py``
(``openvdb/tools/GridTransformer.h`` and ``openvdb/tools/MultiResGrid.h``):
resampling is one gather — the target lattice pushed through the inverse
affine map into source index space and sampled; a mip pyramid is
repeated 2× mean pooling, sampled at a fractional level as a lerp of two
levels.
"""

from __future__ import annotations

import math

import torch

from fluidsim_tpu_torch.ops.advect_volume import _lattice, sample_trilinear

__all__ = ["affine_resample", "resample_to_match", "mean_pool2",
           "build_pyramid", "sample_pyramid"]


def affine_resample(src, matrix, translate, bound: int, order: int = 1):
    """Resample ``src`` under the affine map ``x_world = A·x_index + t``:
    the output at target index ``i`` is ``src`` sampled at ``A⁻¹(i − t)``
    (``GridTransformer::transformGrid`` with an inverse-map gather).

    Args:
      src: (N,N,N) source values on the centered index lattice.
      matrix: (3,3) forward map A (need not be orthogonal).
      translate: (3,) forward translation t, in index units.
      order: 0 = nearest (PointSampler), 1 = trilinear (BoxSampler).
    Out-of-range samples read the background (0), like the reference.
    """
    a = torch.as_tensor(matrix, dtype=src.dtype, device=src.device)
    t = torch.as_tensor(translate, dtype=src.dtype, device=src.device)
    n = src.shape[0]
    inv = torch.linalg.inv(a)
    # the product in f32 elementwise (no TF32 matmul): x · A⁻¹ᵀ
    src_pos = torch.sum((_lattice(bound, src.dtype, src.device) - t)[:, None, :]
                        * inv[None], dim=-1)
    if order == 0:
        cells = torch.round(src_pos).to(torch.int64) + bound
        ok = torch.all((cells >= 0) & (cells <= n - 1), dim=-1)
        cells = torch.clamp(cells, 0, n - 1)
        vals = src[cells[:, 0], cells[:, 1], cells[:, 2]]
        vals = torch.where(ok, vals, 0.0)
    else:
        vals = sample_trilinear(src, src_pos, bound)
    return vals.reshape(n, n, n)


def resample_to_match(src, src_dx: float, dst_dx: float, bound: int,
                      order: int = 1):
    """``tools::resampleToMatch``: re-voxelize a grid whose voxel size is
    ``src_dx`` onto a target lattice with voxel size ``dst_dx`` (same
    world origin)."""
    s = dst_dx / src_dx
    return affine_resample(src, torch.eye(3) / s, torch.zeros(3), bound,
                           order=order)


def mean_pool2(a):
    """One 2× mean-pooling step (odd trailing slices are dropped), the
    pyramid constructor MultiResGrid uses."""
    n = [d - d % 2 for d in a.shape[:3]]
    a = a[: n[0], : n[1], : n[2]]
    return a.reshape(n[0] // 2, 2, n[1] // 2, 2, n[2] // 2, 2).mean(
        dim=(1, 3, 5))


def build_pyramid(a, levels: int):
    """Mip pyramid [level0 .. level(levels-1)], level 0 = input."""
    out = [a]
    for _ in range(levels - 1):
        out.append(mean_pool2(out[-1]))
    return out


def sample_pyramid(pyramid, pos, bound: int, level: float):
    """``MultiResGrid::sampleValue`` at a fractional ``level`` (read on the
    host): trilinear sample of the two bracketing levels in their own
    index spaces, lerped.  ``pos`` is (P,3) in level-0 centered index
    coordinates."""
    level = float(level)
    lo = max(0, min(int(math.floor(level)), len(pyramid) - 1))
    hi = min(lo + 1, len(pyramid) - 1)
    frac = min(max(level - lo, 0.0), 1.0)

    def sample_level(lv):
        # level-lv cell i covers level-0 raw indices [i·s, (i+1)·s), so its
        # center sits at raw0 = (i + 0.5)·s − 0.5; invert for the sample
        # coordinate (exact identity at lv = 0)
        p = (torch.as_tensor(pos) + bound + 0.5) / 2.0 ** lv - 0.5
        return _sample_raw(pyramid[lv], p)

    va = sample_level(lo)
    if hi == lo:
        return va
    return va * (1.0 - frac) + sample_level(hi) * frac


def _sample_raw(grid, p):
    """Trilinear sample in raw (corner-origin) index coordinates for
    even-sized pyramid levels; out-of-range taps read 0."""
    n0, n1, n2 = grid.shape
    i = torch.floor(p).to(torch.int64)
    f = p - i
    val = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                ix, iy, iz = i[:, 0] + dx, i[:, 1] + dy, i[:, 2] + dz
                ok = ((ix >= 0) & (ix < n0) & (iy >= 0) & (iy < n1)
                      & (iz >= 0) & (iz < n2))
                v = grid[torch.clamp(ix, 0, n0 - 1), torch.clamp(iy, 0, n1 - 1),
                         torch.clamp(iz, 0, n2 - 1)]
                val = val + torch.where(ok, w * v, 0.0)
    return val
