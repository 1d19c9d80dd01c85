"""The port's level-set evolution tools (``fluidsim_tpu_torch/ops/
levelset_tools.py``) against the JAX package's on the same seeded fields:
one case for each case of ``tests/test_levelset_tools.py``.
``filter_median`` (a selection) and the frozen far field agree bit for
bit; ``redistance``, the other filters, the morph, tracking and the
measures within 1e-5 times the field's scale (f32 arithmetic in the same
order, iterated: 1e-4 where a loop runs more than 20 steps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.ops import levelset as jls
from fluidsim_tpu.ops import levelset_tools as jlt
from fluidsim_tpu_torch.ops import gridops as g
from fluidsim_tpu_torch.ops import levelset as ls
from fluidsim_tpu_torch.ops import levelset_tools as lt

B = 12
N = 2 * B + 1


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sphere(r, center=(0.0, 0.0, 0.0), bound=B):
    return np.array(jls.sphere_sdf(None, bound, center, r))


def _box(lo, hi):
    return np.array(jls.box_sdf(None, B, lo, hi))


def _both(fn, jfn, *arrays, tol=1e-5, **kw):
    """The port's ``fn`` against ``jfn`` on the same f32 fields, within
    ``tol`` times the output's largest magnitude; the port's output."""
    arrays = [np.array(a, np.float32) for a in arrays]
    got = fn(*[torch.as_tensor(a) for a in arrays], **kw).numpy()
    want = np.asarray(jfn(*[jnp.asarray(a) for a in arrays], **kw))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    return got


def _grad_norm_err(phi, shell):
    gn = g.magnitude(g.gradient(torch.as_tensor(phi))).numpy()
    return np.abs(gn[shell] - 1.0).mean()


def _crossing(line):
    c = np.where(np.diff(np.sign(line)) != 0)[0]
    assert len(c) >= 1
    return int(c[0])


def test_redistance_restores_unit_gradient():
    s = _sphere(6.0)
    out = _both(lt.redistance, jlt.redistance, 3.0 * s, iterations=40,
                tol=1e-4)
    assert _grad_norm_err(out, np.abs(s) < 4.0) < 0.15
    noisy = s + np.random.default_rng(0).normal(0, 0.3, s.shape)
    _both(lt.redistance, jlt.redistance, noisy, iterations=12, dx=0.5)


def test_redistance_banded_freezes_far_field():
    distorted = 2.0 * _sphere(5.0, (0.3, 0.0, -0.2))
    out = _both(lt.redistance, jlt.redistance, distorted, iterations=10,
                band=4.0)
    far = np.abs(distorted) > 4.0
    np.testing.assert_array_equal(out[far], distorted.astype(np.float32)[far])


@pytest.mark.parametrize("fog", [True, False])
def test_rebuild_from_fog(fog):
    s = _sphere(6.0)
    field = (s < 0).astype(np.float32) if fog else 0.7 * s
    iso = 0.5 if fog else 0.0
    out = _both(lt.rebuild_levelset, jlt.rebuild_levelset, field, iso=iso,
                half_width=3.0, iterations=60, fog=fog, tol=1e-4)
    assert out.max() <= 3.0 + 1e-5 and out.min() >= -3.0 - 1e-5
    assert out[B, B, B] < 0 and out[0, 0, 0] > 0
    assert abs(_crossing(out[B:, B, B]) - 6) <= 1


@pytest.mark.parametrize("kind", ["mean", "mean5", "gaussian"])
def test_filters_denoise_and_preserve_radius(kind):
    rng = np.random.default_rng(0)
    s = _sphere(6.0)
    noisy = s + rng.normal(0, 0.12, s.shape)
    fn, jfn, kw = {
        "mean": (lt.filter_mean, jlt.filter_mean, dict(width=3)),
        "mean5": (lt.filter_mean, jlt.filter_mean, dict(width=5)),
        "gaussian": (lt.filter_gaussian, jlt.filter_gaussian,
                     dict(width=3, iterations=2))}[kind]
    out = _both(fn, jfn, noisy, **kw)
    base = _both(fn, jfn, s, **kw)
    shell = np.abs(s) < 4.0
    assert (np.abs(out - base)[shell].mean()
            < 0.35 * np.abs(noisy - s)[shell].mean())
    assert abs(_crossing(out[B:, B, B]) - 6) <= 1
    with pytest.raises(ValueError):
        lt.filter_mean(torch.as_tensor(s), 4)


def test_filter_median_rejects_outliers():
    rng = np.random.default_rng(1)
    s = _sphere(6.0).astype(np.float32)
    spiky = s.copy().reshape(-1)
    idx = rng.choice(s.size, size=60, replace=False)
    spiky[idx] += rng.choice([-8.0, 8.0], size=60).astype(np.float32)
    spiky = spiky.reshape(s.shape)
    for field, band in ((spiky, None), (s, None), (spiky, 2.0)):
        got = lt.filter_median(torch.as_tensor(field), band=band).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jlt.filter_median(jnp.asarray(field), band=band)))
    out = lt.filter_median(torch.as_tensor(spiky)).numpy()
    base = lt.filter_median(torch.as_tensor(s)).numpy()
    assert np.abs(out - base).max() < 1.0
    assert abs(_crossing(out[B:, B, B]) - 6) <= 1


def test_filter_offset_plain_and_masked():
    s = _sphere(6.0)
    mask = np.zeros_like(s)
    mask[B, B, B] = 0.5
    mask[0, 0, 0] = 1.0
    _both(lambda x: lt.filter_offset(x, 2.5),
          lambda x: jlt.filter_offset(x, 2.5), s)
    out = _both(lambda x, m: lt.filter_offset(x, 4.0, mask=m),
                lambda x, m: jlt.filter_offset(x, 4.0, mask=m), s, mask)
    sn = s.astype(np.float32)
    assert out[1, 1, 1] == sn[1, 1, 1]
    assert np.isclose(out[B, B, B], sn[B, B, B] + 2.0, atol=1e-6)


@pytest.mark.parametrize("kind", ["mean", "gaussian"])
def test_filter_band_freezes_far_field(kind):
    s = _sphere(6.0)
    fn, jfn = ((lt.filter_mean, jlt.filter_mean) if kind == "mean"
               else (lt.filter_gaussian, jlt.filter_gaussian))
    out = _both(fn, jfn, s, width=3, band=2.0, dx=0.5)
    far = np.abs(s) > 1.0
    np.testing.assert_array_equal(out[far], s.astype(np.float32)[far])


def test_morph_sphere_to_box():
    src, tgt = _sphere(4.0), _box((-6, -6, -6), (6, 6, 6))
    out = _both(lt.morph_levelset, jlt.morph_levelset, src, tgt,
                iterations=40, tol=1e-4)
    shell = np.abs(tgt) < 3.0
    before = np.abs(src - tgt)[shell].mean()
    assert np.abs(out - tgt)[shell].mean() < 0.35 * before
    _both(lt.morph_levelset, jlt.morph_levelset, src, tgt, iterations=7,
          renorm_every=3, speed_clamp=2.0, dx=0.8)


def test_track_levelset_translation():
    s = _sphere(5.0, (-3.0, 0.0, 0.0))
    vc = np.zeros((N, N, N, 3), np.float32)
    vc[..., 0] = 1.0
    phi, jphi = torch.as_tensor(s.astype(np.float32)), jnp.asarray(s,
                                                                   jnp.float32)
    for _ in range(6):
        phi = lt.track_levelset(phi, torch.as_tensor(vc), 1.0, B,
                                redist_iterations=3)
        jphi = jlt.track_levelset(jphi, jnp.asarray(vc), 1.0, B,
                                  redist_iterations=3)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=0,
                               atol=1e-4 * float(np.abs(jphi).max()))
    expect = _sphere(5.0, (3.0, 0.0, 0.0))
    shell = np.abs(expect) < 2.5
    assert np.abs(phi.numpy() - expect)[shell].mean() < 0.5
    _both(lambda p, v: lt.track_levelset(p, v, 0.7, B, order=1,
                                         half_width=2.0, spatial="first"),
          lambda p, v: jlt.track_levelset(p, v, 0.7, B, order=1,
                                          half_width=2.0, spatial="first"),
          s, vc)


def test_levelset_area_and_volume_sphere():
    r = 7.0
    s = ls.sphere_sdf(None, B, (0.0, 0.0, 0.0), r, device="cpu")
    js = jls.sphere_sdf(None, B, (0.0, 0.0, 0.0), r)
    a = float(lt.levelset_area(s))
    assert a == pytest.approx(float(jlt.levelset_area(js)), rel=1e-5)
    assert np.isclose(a, 4 * np.pi * r * r, rtol=0.05)
    assert float(lt.levelset_area(s, dx=0.5, eps_voxels=2.0)) == pytest.approx(
        float(jlt.levelset_area(js, dx=0.5, eps_voxels=2.0)), rel=1e-5)
    assert float(ls.levelset_volume(s)) == pytest.approx(
        float(jls.levelset_volume(js)), rel=1e-6)


@pytest.mark.parametrize("r", [6.0, 9.0])
def test_levelset_avg_curvature_sphere(r):
    s = ls.sphere_sdf(None, B, (0.0, 0.0, 0.0), r, device="cpu")
    js = jls.sphere_sdf(None, B, (0.0, 0.0, 0.0), r)
    k = float(lt.levelset_avg_curvature(s))
    assert k == pytest.approx(float(jlt.levelset_avg_curvature(js)), rel=1e-5)
    assert abs(k - 1.0 / r) < 0.15 / r
