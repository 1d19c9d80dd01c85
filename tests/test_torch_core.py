"""The PyTorch port's core numerics, scenes and seeding against the JAX
package, on the same numpy inputs.

Rounding, masks, shifts and seeding select or copy values, so they must
agree bit for bit.  The splines run the same f32 operations in the same
order, so they must agree to at most 1 ulp (XLA may contract a multiply-add
into one rounding where PyTorch rounds twice).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fluidsim_tpu import scenes as jscenes
from fluidsim_tpu import seeding as jseeding
from fluidsim_tpu.core import gridspec as jgs
from fluidsim_tpu.core import splines as jsp
from fluidsim_tpu_torch import scenes as tscenes
from fluidsim_tpu_torch import seeding as tseeding
from fluidsim_tpu_torch.core import gridspec as tgs
from fluidsim_tpu_torch.core import splines as tsp


def _jax(fn, x):
    return np.asarray(fn(jnp.asarray(x)))


def _torch(fn, x):
    return fn(torch.as_tensor(x)).numpy()


def _halves_and_noise():
    k = np.arange(-6, 7, dtype=np.float32)
    rng = np.random.default_rng(0)
    noise = rng.uniform(-9.0, 9.0, size=2000).astype(np.float32)
    near = (k[:, None] + np.float32(0.5)
            + np.array([-1e-6, 0.0, 1e-6], np.float32)).ravel()
    return np.concatenate([k + np.float32(0.5), k - np.float32(0.5), k, near,
                           noise, np.float32([0.0, -0.0])])


@pytest.mark.parametrize("name", ["cround", "cround_out"])
def test_rounding_bitwise(name):
    x = _halves_and_noise()
    out_t = _torch(getattr(tsp, name), x)
    np.testing.assert_array_equal(out_t, _jax(getattr(jsp, name), x))
    if name == "cround":
        # half away from zero, not half to even
        np.testing.assert_array_equal(
            _torch(tsp.cround, np.float32([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5])),
            np.float32([-3, -2, -1, 1, 2, 3]))


@pytest.mark.parametrize("name", ["bspline_base", "spline_flip", "spline_mpm"])
def test_splines_within_one_ulp(name):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.6, 1.6, size=4000).astype(np.float32)
    if name == "bspline_base":
        x = np.abs(x)
    x = np.concatenate([x, np.float32([0.0, 0.5, 1.0, -0.5, -1.0, 1.5])])
    np.testing.assert_array_max_ulp(_torch(getattr(tsp, name), x),
                                    _jax(getattr(jsp, name), x), maxulp=1)


def test_shifts_and_cell_centring_bitwise():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 9, 9, 9)).astype(np.float32)
    for d in range(3):
        np.testing.assert_array_equal(
            tgs.shift_to_plus(torch.as_tensor(a[d]), d).numpy(),
            np.asarray(jgs.shift_to_plus(jnp.asarray(a[d]), d)))
        np.testing.assert_array_equal(
            tgs.shift_to_minus(torch.as_tensor(a[d]), d).numpy(),
            np.asarray(jgs.shift_to_minus(jnp.asarray(a[d]), d)))
    np.testing.assert_array_equal(
        tgs.cell_center_velocity_cm(torch.as_tensor(a)).numpy(),
        np.asarray(jgs.cell_center_velocity_cm(jnp.asarray(a))))
    cells = rng.integers(0, 9, size=(50, 3))
    np.testing.assert_array_equal(tgs.flat_index(torch.as_tensor(cells), 9).numpy(),
                                  np.asarray(jgs.flat_index(jnp.asarray(cells), 9)))


def test_gridspec_masks_bitwise():
    t, j = tgs.GridSpec(bound=7, wall=5), jgs.GridSpec(bound=7, wall=5)
    np.testing.assert_array_equal(t.wall_mask(), j.wall_mask())
    np.testing.assert_array_equal(t.within_mask(3), j.within_mask(3))
    np.testing.assert_array_equal(t.wall_normals(), j.wall_normals())


_FLIP_SCENES = ["water_cube_drop", "pea_fluid", "side_fluid", "stable_fluid",
                "two_blocks", "three_blocks", "big_wall"]


@pytest.mark.parametrize("name", _FLIP_SCENES)
def test_scene_geometry_bitwise(name):
    t, j = tscenes.get_scene(name), jscenes.get_scene(name)
    assert (t.name, t.kind, t.density, t.gravity, t.initial_velocity) == \
        (j.name, j.kind, j.density, j.gravity, j.initial_velocity)
    assert (t.spec.bound, t.spec.wall, t.spec.dx) == \
        (j.spec.bound, j.spec.wall, j.spec.dx)
    for field in ("solid", "normals", "seed_mask"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))


@pytest.mark.parametrize("bound,density,seed",
                         [(8, 3.0, 0), (12, 4.0, 7), (64, 1.0, 0)])
def test_seed_particles_bitwise(bound, density, seed):
    kw = dict(bound=bound, density=density)
    pt, vt = tseeding.seed_particles(
        tscenes.get_scene("water_cube_drop", **kw), seed=seed)
    pj, vj = jseeding.seed_particles(
        jscenes.get_scene("water_cube_drop", **kw), seed=seed)
    assert pt.dtype == pj.dtype == np.float32
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(vt, vj)
