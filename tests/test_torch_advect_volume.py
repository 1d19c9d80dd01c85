"""The port's level-set basics and semi-Lagrangian samplers
(``fluidsim_tpu_torch/ops/levelset.py``, ``ops/advect_volume.py``) against
the JAX package's on the same seeded inputs: one case for each case of
``tests/test_levelset_advect.py``.  The nearest sampler agrees bit for
bit; the SDFs (a square root in f32), the CSG, the trilinear and
quadratic samplers and the advection within 1e-5 (f32 sums in the same
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.ops import advect_volume as jav
from fluidsim_tpu.ops import levelset as jls
from fluidsim_tpu_torch.ops import advect_volume as av
from fluidsim_tpu_torch.ops import levelset as ls

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_sphere_sdf_values():
    s = ls.sphere_sdf(None, 16, (0.0, 0.0, 0.0), 5.0, device="cpu")
    _close(s, jls.sphere_sdf(None, 16, (0.0, 0.0, 0.0), 5.0))
    assert float(s[16, 16, 16]) == -5.0 and float(s[21, 16, 16]) == 0.0


def test_box_sdf_and_csg():
    b = ls.box_sdf(None, 16, (-3, -3, -3), (3, 3, 3), device="cpu")
    jb = jls.box_sdf(None, 16, (-3, -3, -3), (3, 3, 3))
    s = ls.sphere_sdf(None, 16, (0.0, 0.0, 0.0), 2.0, device="cpu")
    js = jls.sphere_sdf(None, 16, (0.0, 0.0, 0.0), 2.0)
    _close(b, jb)
    _equal(ls.csg_union(b, s), np.minimum(np.asarray(b), np.asarray(s)))
    _close(ls.csg_union(b, s), jls.csg_union(jb, js))
    _close(ls.csg_intersection(b, s), jls.csg_intersection(jb, js))
    _close(ls.csg_difference(b, s), jls.csg_difference(jb, js))
    _close(ls.offset(s, 1.0), jls.offset(js, 1.0))


def test_particles_to_levelset_sphere_cloud():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(3000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = (4.0 * d).astype(np.float32)
    sdf = ls.particles_to_levelset(_t(pos), bound=12, radius=1.0)
    ref = jls.particles_to_levelset(jnp.asarray(pos), bound=12, radius=1.0)
    _close(sdf, ref, 1e-6)
    _close(ls.sdf_to_fog(sdf), jls.sdf_to_fog(ref), 1e-6)
    assert float(sdf[12, 12, 12]) > 0 and float(sdf[16, 12, 12]) < 0.4


def test_levelset_volume_sphere():
    s = ls.sphere_sdf(None, 20, (0.0, 0.0, 0.0), 8.0, device="cpu")
    v = float(ls.levelset_volume(s))
    np.testing.assert_allclose(
        v, float(jls.levelset_volume(jls.sphere_sdf(None, 20, (0, 0, 0), 8.0))),
        rtol=1e-6)
    assert abs(v - 4 / 3 * np.pi * 8 ** 3) / (4 / 3 * np.pi * 8 ** 3) < 0.05


def _field(bound, channels, seed):
    n = 2 * bound + 1
    shape = (n, n, n) if channels is None else (n, n, n, channels)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("channels", [None, 3])
def test_sample_trilinear_linear_field_exact(channels):
    # a random field (and the linear one of the JAX case) at random
    # positions, inside the box and past its edge (clamped reads)
    bound = 8
    rng = np.random.default_rng(1)
    pos = rng.uniform(-10, 10, size=(200, 3)).astype(np.float32)
    f = _field(bound, channels, 2)
    _close(av.sample_trilinear(_t(f), _t(pos), bound),
           jav.sample_trilinear(jnp.asarray(f), jnp.asarray(pos), bound))
    c = np.arange(-bound, bound + 1, dtype=np.float32)
    lin = 2 * c[:, None, None] + 3 * c[None, :, None] - c[None, None, :]
    inner = pos[np.all(np.abs(pos) < 6, axis=1)]
    got = av.sample_trilinear(_t(lin), _t(inner), bound)
    _close(got, jav.sample_trilinear(jnp.asarray(lin), jnp.asarray(inner),
                                     bound))
    _close(got, 2 * inner[:, 0] + 3 * inner[:, 1] - inner[:, 2], 1e-4)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_advect_points_uniform_flow(order):
    bound = 8
    vc = _field(bound, 3, 3)
    rng = np.random.default_rng(4)
    pos = rng.uniform(-7, 7, size=(64, 3)).astype(np.float32)
    _close(av.advect_points(_t(pos), _t(vc), 0.7, bound, order=order),
           jav.advect_points(jnp.asarray(pos), jnp.asarray(vc), 0.7, bound,
                             order=order))
    n = 2 * bound + 1
    uni = np.broadcast_to(np.float32([1.0, 0.0, -0.5]), (n, n, n, 3)).copy()
    out = av.advect_points(_t(pos[:2] * 0), _t(uni), 2.0, bound, order=order)
    _close(out, np.float32([[2.0, 0.0, -1.0]] * 2))


@pytest.mark.parametrize("order", [1, 2])
def test_advect_volume_translates_blob(order):
    bound = 10
    f = _field(bound, None, 5)
    vc = 0.8 * _field(bound, 3, 6)
    _close(av.advect_volume(_t(f), _t(vc), 1.5, bound, order=order),
           jav.advect_volume(jnp.asarray(f), jnp.asarray(vc), 1.5, bound,
                             order=order))
    n = 2 * bound + 1
    blob = np.zeros((n, n, n), np.float32)
    blob[10, 10, 10] = 1.0
    uni = np.broadcast_to(np.float32([1.0, 0.0, 0.0]), (n, n, n, 3)).copy()
    out = av.advect_volume(_t(blob), _t(uni), 2.0, bound, order=order)
    assert float(out[12, 10, 10]) > 0.9 and float(out[10, 10, 10]) < 0.1


@pytest.mark.parametrize("channels", [None, 2])
def test_sample_quadratic_reproduces_quadratic_field(channels):
    bound = 8
    rng = np.random.default_rng(3)
    pos = rng.uniform(-10, 10, size=(128, 3)).astype(np.float32)
    f = _field(bound, channels, 7)
    _close(av.sample_quadratic(_t(f), _t(pos), bound),
           jav.sample_quadratic(jnp.asarray(f), jnp.asarray(pos), bound))


def test_sample_nearest_rounds():
    bound = 4
    f = _field(bound, None, 8)
    rng = np.random.default_rng(9)
    pos = rng.uniform(-6, 6, size=(300, 3)).astype(np.float32)
    # .5 ties, both signs: half away from zero (torch.round would differ)
    pos[:100] = np.round(pos[:100]) + np.float32(0.5)
    pos[100:150] = np.round(pos[100:150]) - np.float32(0.5)
    got = av.sample_nearest(_t(f), _t(pos), bound)
    _equal(got, jav.sample_nearest(jnp.asarray(f), jnp.asarray(pos), bound))
    c = np.arange(-bound, bound + 1, dtype=np.float32)
    g = c[:, None, None] * 100 + c[None, :, None] * 10 + c[None, None, :]
    ties = np.float32([[0.5, -1.5, 2.5], [-0.5, 0.49, -0.51]])
    assert av.sample_nearest(_t(g), _t(ties), bound).tolist() == [
        1 * 100 + (-2) * 10 + 3, (-1) * 100 + 0 * 10 + (-1)]


@pytest.mark.parametrize("order", [0, 1, 2])
def test_sample_staggered_offsets_each_component(order):
    bound = 8
    f = _field(bound, 3, 10)
    rng = np.random.default_rng(5)
    pos = rng.uniform(-7, 7, size=(64, 3)).astype(np.float32)
    pos[:8] = np.round(pos[:8])       # +0.5 shifts land on nearest's ties
    got = av.sample_staggered(_t(f), _t(pos), bound, order=order)
    want = jav.sample_staggered(jnp.asarray(f), jnp.asarray(pos), bound,
                                order=order)
    if order == 0:
        _equal(got, want)
    else:
        _close(got, want)
