"""Named FLIP scene registry — the counterpart of ``fluidsim_tpu/scenes.py``.

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
      kind: "flip" (MPM scenes are not ported yet).
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
