"""Named FLIP and MPM scene registry — the counterpart of ``fluidsim_tpu/scenes.py``.

A scene bundles static geometry only (host-side numpy); particle seeding is
``fluidsim_tpu_torch.seeding``.  The geometry is the JAX package's, array for
array, so both packages seed and step the same scene.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from fluidsim_tpu_torch.core.gridspec import GridSpec


@dataclasses.dataclass(frozen=True)
class Scene:
    """Static scene geometry.

    Attributes:
      name: registry key.
      kind: "flip" or "mpm".
      spec: grid geometry.
      solid: (N,N,N) bool — walls plus obstacles.
      normals: (N,N,N,3) f32 wall normals (unused by the dynamics).
      seed_mask: (N,N,N) bool — voxels that particles are scattered into.
      density: particles per voxel for seeding.
      gravity: body force.
      initial_velocity: per-particle initial velocity.
    """

    name: str
    kind: str
    spec: GridSpec
    solid: np.ndarray
    normals: np.ndarray
    seed_mask: np.ndarray
    density: float
    gravity: tuple
    initial_velocity: tuple = (0.0, 0.0, 0.0)


REGISTRY: Dict[str, Callable[..., Scene]] = {}


def register(name):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


def get_scene(name: str, **kwargs) -> Scene:
    return REGISTRY[name](**kwargs)


def _box_mask(spec: GridSpec, lo, hi) -> np.ndarray:
    """Bool mask of the coordinate box [lo, hi] (inclusive), per axis."""
    c = spec.coords()
    m = np.ones(spec.shape, dtype=bool)
    for d in range(3):
        ax = (c >= lo[d]) & (c <= hi[d])
        shape = [1, 1, 1]
        shape[d] = spec.n
        m &= ax.reshape(shape)
    return m


def _flip_base(spec: GridSpec, seed_mask: np.ndarray, extra_solid=None,
               name="", density=10.0) -> Scene:
    solid = spec.wall_mask()
    if extra_solid is not None:
        solid = solid | extra_solid
    return Scene(name=name, kind="flip", spec=spec, solid=solid,
                 normals=spec.wall_normals(), seed_mask=seed_mask,
                 density=density, gravity=(0.0, -10.0, 0.0))


@register("water_cube_drop")
def water_cube_drop(bound: int = 60, density: float = 10.0) -> Scene:
    """Headline FLIP scene: a fluid cube of half-width ``bound // 3`` at the
    centre, walls at ``|c| > bound - 2``."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    cube = bound // 3
    seed = _box_mask(spec, (-cube,) * 3, (cube,) * 3)
    return _flip_base(spec, seed, name=f"water_cube_drop(b={bound})",
                      density=density)


@register("pea_fluid")
def pea_fluid(bound: int = 60) -> Scene:
    """A 3^3 pea plus a 3x4x3 column above it."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    seed = _box_mask(spec, (-1, -1, -1), (1, 1, 1))
    seed |= _box_mask(spec, (-1, 6, -1), (1, 9, 1))
    return _flip_base(spec, seed, name="pea_fluid")


@register("side_fluid")
def side_fluid(bound: int = 60) -> Scene:
    """A corner block -57..57 x -57..-40 x -57..-40."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    w = spec.wall - 1
    seed = _box_mask(spec, (-w, -w, -w), (w, -40, -40))
    return _flip_base(spec, seed, name="side_fluid")


@register("stable_fluid")
def stable_fluid(bound: int = 60) -> Scene:
    """A thin resting pool at the floor."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    w = spec.wall - 1
    seed = _box_mask(spec, (-w, -w, -w), (w, -w + 2, w))
    return _flip_base(spec, seed, name="stable_fluid")


def _pillars(spec: GridSpec, xranges) -> np.ndarray:
    m = np.zeros(spec.shape, dtype=bool)
    for (x0, x1) in xranges:
        m |= _box_mask(spec, (x0, -58, -3), (x1, -8, 3))
    return m


@register("two_blocks")
def two_blocks(bound: int = 60) -> Scene:
    """A water cube over two solid pillars."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    seed = _box_mask(spec, (-20,) * 3, (20,) * 3)
    return _flip_base(spec, seed,
                      extra_solid=_pillars(spec, [(-11, -6), (6, 11)]),
                      name="two_blocks")


@register("three_blocks")
def three_blocks(bound: int = 60) -> Scene:
    """A water cube over three solid pillars."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    seed = _box_mask(spec, (-20,) * 3, (20,) * 3)
    return _flip_base(spec, seed,
                      extra_solid=_pillars(spec, [(-11, -7), (-2, 2), (7, 11)]),
                      name="three_blocks")


@register("big_wall")
def big_wall(bound: int = 60) -> Scene:
    """A water cube with a low wall across the floor."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    seed = _box_mask(spec, (-20,) * 3, (20,) * 3)
    wall = _box_mask(spec, (-58, -58, -30), (58, -50, -25))
    return _flip_base(spec, seed, extra_solid=wall, name="big_wall")


# ----------------------------- MPM scenes --------------------------------

def _mpm_base(spec: GridSpec, seed_mask: np.ndarray, name: str,
              density: float = 400.0) -> Scene:
    return Scene(name=name, kind="mpm", spec=spec, solid=spec.wall_mask(),
                 normals=spec.wall_normals(), seed_mask=seed_mask,
                 density=density, gravity=(0.0, -10.0, 0.0),
                 initial_velocity=(0.0, -50.0, 0.0))


@register("mpm_cone")
def mpm_cone(bound: int = 15, density: float = 400.0) -> Scene:
    """Headline MPM scene: a cone standing on the floor whose radius grows
    with height, ``(j - lo) / 2`` on layer ``j`` from ``lo = -(bound - 2)``.
    Bound 15 has 4 layers; larger bounds scale the height to
    ``round(4 * bound / 15)`` layers with the same radius slope."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    c = spec.coords()
    seed = np.zeros(spec.shape, dtype=bool)
    lo = -(bound - 2)
    layers = max(4, round(4 * bound / 15))
    for j in range(lo, lo + layers):
        r = (j - lo) / 2.0
        disk = (c[:, None] ** 2 + c[None, :] ** 2) <= r * r
        seed[:, j + bound, :] |= disk
    return _mpm_base(spec, seed, name="mpm_cone", density=density)


@register("mpm_pea")
def mpm_pea(bound: int = 15, density: float = 400.0) -> Scene:
    """A small block near the floor."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    seed = _box_mask(spec, (-1, -13, -1), (2, -10, 2))
    return _mpm_base(spec, seed, name="mpm_pea", density=density)


@register("mpm_block_drop")
def mpm_block_drop(bound: int = 15, density: float = 400.0) -> Scene:
    """A block filling -13..-10 on every axis."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    seed = _box_mask(spec, (-13, -13, -13), (-10, -10, -10))
    return _mpm_base(spec, seed, name="mpm_block_drop", density=density)


@register("mpm_double_balls")
def mpm_double_balls(bound: int = 15, density: float = 400.0) -> Scene:
    """Two radius-2 balls centred at y = -11 and y = -7."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    c = spec.coords()
    seed = np.zeros(spec.shape, dtype=bool)
    r2 = c[:, None, None] ** 2 + c[None, None, :] ** 2
    for yc in (-11, -7):
        seed |= (r2 + (c[None, :, None] - yc) ** 2) <= 4
    return _mpm_base(spec, seed, name="mpm_double_balls", density=density)


@register("mpm_sphere")
def mpm_sphere(bound: int = 15, density: float = 400.0) -> Scene:
    """A radius-3 ball centred at y = -10."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    c = spec.coords()
    seed = (c[:, None, None] ** 2 + (c[None, :, None] + 10) ** 2
            + c[None, None, :] ** 2) <= 9
    return _mpm_base(spec, seed, name="mpm_sphere", density=density)


@register("mpm_o")
def mpm_o(bound: int = 15, density: float = 400.0) -> Scene:
    """A flat "O" (the annulus 4 <= r <= 5 around y = -8) in the z = 0
    plane."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    c = spec.coords()
    r2 = c[:, None] ** 2 + (c[None, :] + 8) ** 2
    ring = (r2 <= 25) & (r2 >= 16)
    seed = np.zeros(spec.shape, dtype=bool)
    seed[:, :, bound] = ring
    return _mpm_base(spec, seed, name="mpm_o", density=density)
