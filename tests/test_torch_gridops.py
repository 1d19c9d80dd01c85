"""The port's grid operators (``fluidsim_tpu_torch/ops/gridops.py``) against
the JAX package's on the same seeded fields: one case for each case of
``tests/test_gridops.py``, each on the analytic field of that case and on
a random one, within 1e-5 relative to the field's scale (f32 shifted
differences in the same order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.ops import gridops as jg
from fluidsim_tpu.ops import levelset as jls
from fluidsim_tpu_torch.ops import gridops as g

B = 10
N = 2 * B + 1


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _coords():
    c = np.arange(-B, B + 1, dtype=np.float64)
    return np.meshgrid(c, c, c, indexing="ij")


def _same(fn, jfn, *fields, tol=1e-5, **kw):
    """``fn`` and ``jfn`` on the same f32 fields agree within ``tol`` times
    the output's largest magnitude; returns the port's output."""
    fields = [np.array(f, np.float32) for f in fields]
    got = fn(*[torch.as_tensor(f) for f in fields], **kw).numpy()
    want = np.asarray(jfn(*[jnp.asarray(f) for f in fields], **kw))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    return got


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=(N, N, N) + shape)


def _interior(a, m=2):
    return a[m:-m, m:-m, m:-m]


def test_gradient_quadratic():
    x, y, z = _coords()
    out = _same(g.gradient, jg.gradient, x * x + 2 * y * y + 3 * z * z)
    assert np.allclose(_interior(out[..., 2]), _interior(6 * z), atol=1e-3)
    _same(g.gradient, jg.gradient, _rand())


@pytest.mark.parametrize("dx", [0.5, 2.0])
def test_gradient_dx_scaling(dx):
    x, _, _ = _coords()
    out = _same(g.gradient, jg.gradient, x, dx=dx)
    assert np.allclose(_interior(out[..., 0]), 1.0 / dx, atol=1e-4)
    _same(g.gradient, jg.gradient, _rand(seed=1), dx=dx)


def test_divergence_linear_field():
    x, y, z = _coords()
    out = _same(g.divergence, jg.divergence, np.stack([x, y, z], axis=-1))
    assert np.allclose(_interior(out), 3.0, atol=1e-3)
    _same(g.divergence, jg.divergence, _rand(3, seed=2), dx=0.7)


def test_divergence_solenoidal():
    x, y, _ = _coords()
    out = _same(g.divergence, jg.divergence,
                np.stack([-y, x, np.zeros_like(x)], -1))
    assert np.allclose(_interior(out), 0.0, atol=1e-3)


def test_curl_rotation_field():
    x, y, _ = _coords()
    out = _same(g.curl, jg.curl, np.stack([-y, x, np.zeros_like(x)], -1))
    assert np.allclose(_interior(out[..., 2]), 2.0, atol=1e-3)
    _same(g.curl, jg.curl, _rand(3, seed=3), dx=1.5)


def test_curl_of_gradient_vanishes():
    x, y, z = _coords()
    f = torch.as_tensor((x * x * y + z * y * y).astype(np.float32))
    c = g.curl(g.gradient(f)).numpy()
    want = np.asarray(jg.curl(jg.gradient(jnp.asarray(f.numpy()))))
    np.testing.assert_allclose(c, want, rtol=0, atol=1e-5 * 2000)
    assert np.allclose(_interior(c), 0.0, atol=1e-2)


@pytest.mark.parametrize("dx", [1.0, 2.0])
def test_laplacian_quadratic(dx):
    x, y, z = _coords()
    out = _same(g.laplacian, jg.laplacian, x * x + y * y + z * z, dx=dx)
    assert np.allclose(_interior(out), 6.0 / dx ** 2, atol=1e-3)
    _same(g.laplacian, jg.laplacian, _rand(seed=4), dx=dx)


def test_magnitude_and_normalize():
    v = _rand(3, seed=5)
    v[:3] = 0.0                                   # zero vectors stay zero
    _same(g.magnitude, jg.magnitude, v)
    out = _same(g.normalize, jg.normalize, v)
    assert np.allclose(out[:3], 0.0)
    assert np.allclose(np.linalg.norm(out[3:], axis=-1), 1.0, atol=1e-5)


def test_mean_curvature_sphere():
    s = np.asarray(jls.sphere_sdf(None, B, (0.0, 0.0, 0.0), 6.0))
    k = _same(g.mean_curvature, jg.mean_curvature, s)
    x, y, z = _coords()
    r = np.sqrt(x * x + y * y + z * z)
    shell = (r > 4.5) & (r < 7.5)
    assert np.allclose(k[shell], 1.0 / r[shell], rtol=0.15)
    _same(g.mean_curvature, jg.mean_curvature, s + 0.1 * _rand(seed=6))


def test_closest_point_transform_sphere():
    s = np.asarray(jls.sphere_sdf(None, B, (0.5, 0.0, -0.5), 5.0))
    _same(lambda f: g.closest_point_transform(f, B, dx=0.5),
          lambda f: jg.closest_point_transform(f, B, dx=0.5), s)
    cpt = _same(lambda f: g.closest_point_transform(f, B),
                lambda f: jg.closest_point_transform(f, B), s)
    x, y, z = _coords()
    r = np.sqrt((x - 0.5) ** 2 + y * y + (z + 0.5) ** 2)
    shell = (r > 2.5) & (r < 8.0)
    d = np.linalg.norm(cpt - np.float32([0.5, 0.0, -0.5]), axis=-1)
    assert np.allclose(d[shell], 5.0, atol=0.15)
