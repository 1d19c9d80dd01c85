"""The port's small tools (``fluidsim_tpu_torch/ops/composite.py``,
``resample.py``, ``diagnostics.py``, ``platonic.py``,
``volume_to_spheres.py`` and ``levelset.fracture``) against the JAX
package's on the same seeded inputs: one case for each case of
``tests/test_tools_suite.py``.

Bit for bit: ``interior_mask``, ``points_to_mask``, the clips, the comp
family on exact operands, ``signed_flood_fill``'s signs and far field,
the diagnostics' counts and masks, the platonic meshes, the nearest
resample on a lattice map.  Within 1e-5 times the output's scale: the
trilinear resample and the pyramid, ``topology_to_levelset`` (1e-4: 30
relaxation steps), ``platonic_sdf`` (``mesh_to_sdf``, with its sign
rule), ``fill_with_spheres`` and ``closest_surface_points``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.ops import composite as jcp
from fluidsim_tpu.ops import diagnostics as jdg
from fluidsim_tpu.ops import levelset as jls
from fluidsim_tpu.ops import platonic as jpl
from fluidsim_tpu.ops import resample as jrs
from fluidsim_tpu.ops import volume_to_spheres as jvs
from fluidsim_tpu_torch.ops import composite as cp
from fluidsim_tpu_torch.ops import diagnostics as dg
from fluidsim_tpu_torch.ops import levelset as ls
from fluidsim_tpu_torch.ops import mesh
from fluidsim_tpu_torch.ops import platonic as pl
from fluidsim_tpu_torch.ops import resample as rs
from fluidsim_tpu_torch.ops import volume_to_spheres as vs
from fluidsim_tpu_torch.ops.volume_to_mesh import mesh_area

B = 10
N = 2 * B + 1


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sphere(r, center=(0.0, 0.0, 0.0)):
    return np.array(jls.sphere_sdf(None, B, center, r))


def _box(lo, hi):
    return np.array(jls.box_sdf(None, B, lo, hi))


def _t(x):
    return torch.as_tensor(np.array(x))


def _both(fn, jfn, *arrays, tol=None):
    """``fn`` against ``jfn`` on the same inputs: bit for bit (``tol``
    None) or within ``tol`` times the output's scale; the port's output."""
    got = fn(*map(_t, arrays))
    want = jfn(*map(jnp.asarray, arrays))
    got, want = np.asarray(got), np.asarray(want)
    if tol is None:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    return got


# ---------------- composite ----------------

@pytest.mark.parametrize("op", ["max", "min", "sum", "mul", "div"])
def test_comp_family_topology_union(op):
    rng = np.random.default_rng(0)
    a, b = rng.integers(-4, 5, size=(2, 5, 5, 5)).astype(np.float32)
    am, bm = rng.random((2, 5, 5, 5)) < 0.5
    fn, jfn = getattr(cp, f"comp_{op}"), getattr(jcp, f"comp_{op}")
    _both(lambda x, y, p, q: fn(x, y, p, q, background=-1.0),
          lambda x, y, p, q: jfn(x, y, p, q, background=-1.0), a, b, am, bm,
          tol=None if op != "div" else 1e-6)
    _both(fn, jfn, a, b, tol=None if op != "div" else 1e-6)
    _both(lambda x, y, p: fn(x, y, p), lambda x, y, p: jfn(x, y, p),
          a, b, am, tol=None if op != "div" else 1e-6)
    out = _both(cp.comp_replace, jcp.comp_replace, a, b, bm)
    assert (out[bm] == b[bm]).all() and (out[~bm] == a[~bm]).all()
    assert (cp.comp_div(_t(a), torch.zeros(5, 5, 5)).numpy() == 0).all()


def test_interior_mask_and_clip():
    s = _sphere(5.0, (0.4, 0.0, -0.3))
    for levelset in (True, False):
        _both(lambda x: cp.interior_mask(x, 0.5, levelset),
              lambda x: jcp.interior_mask(x, 0.5, levelset), s)
    m = cp.interior_mask(_t(s)).numpy()
    assert np.isclose(m.sum(), 4 / 3 * np.pi * 125, rtol=0.1)
    clipped = _both(lambda x: cp.clip_to_box(x, (0, -B, -2), (B, 3, B), B,
                                             background=99.0),
                    lambda x: jcp.clip_to_box(x, (0, -B, -2), (B, 3, B), B,
                                              background=99.0), s)
    assert (clipped[:B] == 99.0).all() and (clipped[B:] != 99.0).any()
    vec = np.random.default_rng(1).normal(size=(N, N, N, 3)).astype(np.float32)
    _both(lambda x: cp.clip_to_box(x, (-3, -B, 0), (5, 3, 4), B),
          lambda x: jcp.clip_to_box(x, (-3, -B, 0), (5, 3, 4), B), vec)
    for grid in (s, vec):
        _both(lambda x, k: cp.clip_to_mask(x, k, background=7.0),
              lambda x, k: jcp.clip_to_mask(x, k, background=7.0), grid, m)


def test_points_to_mask():
    rng = np.random.default_rng(2)
    pos = rng.uniform(-B - 2, B + 2, size=(300, 3)).astype(np.float32)
    pos[:30] = np.round(pos[:30]) + np.float32(0.5)    # half-even ties
    _both(lambda p: cp.points_to_mask(p, B),
          lambda p: jcp.points_to_mask(p, B), pos)
    m = cp.points_to_mask(_t(np.float32([[0.2, 0.1, -0.3], [3, 3, 3],
                                         [3.4, 2.9, 3.1]])), B).numpy()
    assert m[B, B, B] and m[B + 3, B + 3, B + 3] and m.sum() == 2


@pytest.mark.parametrize("iterations,outside", [(None, None), (4, 5.0)])
def test_signed_flood_fill(iterations, outside):
    s = _sphere(6.0, (0.5, -0.5, 0.0))
    band = 2.0
    trunc = np.where(np.abs(s) < band, s, band).astype(np.float32)
    out = _both(lambda p: cp.signed_flood_fill(p, band, iterations, outside),
                lambda p: jcp.signed_flood_fill(p, band, iterations, outside),
                trunc)
    if iterations is None:
        assert out[B, B, B] == -band and out[0, 0, 0] == band
        nz = s != 0
        assert (np.sign(out)[nz] == np.sign(s)[nz]).all()


def test_topology_to_levelset():
    mask = _sphere(5.0) < 0
    phi = _both(lambda m: cp.topology_to_levelset(m, half_width=3.0),
                lambda m: jcp.topology_to_levelset(m, half_width=3.0),
                mask, tol=1e-4)
    assert phi[B, B, B] == -3.0 and phi[0, 0, 0] == 3.0
    line = phi[B:, B, B]
    c = np.where(np.diff(np.sign(line)) != 0)[0]
    assert len(c) >= 1 and abs(int(c[0]) - 5) <= 1
    _both(lambda m: cp.topology_to_levelset(m, 2.0, dilation=1,
                                            smooth_iterations=1,
                                            iterations=8),
          lambda m: jcp.topology_to_levelset(m, 2.0, dilation=1,
                                             smooth_iterations=1,
                                             iterations=8),
          mask, tol=1e-4)


def test_change_background():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(4, 4, 4)).astype(np.float32)
    act = rng.random((4, 4, 4)) < 0.5
    for levelset in (False, True):
        out = _both(lambda x, a: cp.change_background(x, a, -9.0, levelset),
                    lambda x, a: jcp.change_background(x, a, -9.0, levelset),
                    g, act)
        assert (np.abs(out[~act]) == 9.0).all()
        assert (out[act] == g[act]).all()


# ---------------- resample ----------------

def test_affine_resample_translation_and_scale():
    s = _sphere(5.0, (0.3, -0.2, 0.4))
    for m, t in ((np.eye(3), (3.0, 0.0, 0.0)), (2.0 * np.eye(3), (0, 0, 0)),
                 (np.diag([1.0, 0.5, 1.5]), (0.25, -1.0, 2.0))):
        for order in (0, 1):
            _both(lambda x: rs.affine_resample(x, m, t, B, order=order),
                  lambda x: jrs.affine_resample(x, m, t, B, order=order),
                  s, tol=None if order == 0 else 1e-5)
    out = rs.affine_resample(_t(_sphere(5.0)), np.eye(3), (3.0, 0.0, 0.0),
                             B).numpy()
    expect = _sphere(5.0, (3.0, 0.0, 0.0))
    assert np.abs(out - expect)[np.abs(expect) < 3].mean() < 0.05


def test_affine_resample_rotation():
    s = _box((-6, -2, -2), (6, 2, 2))
    th = 0.7
    rot = np.float32([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    _both(lambda x: rs.affine_resample(x, rot, (0.5, 0.0, -0.5), B),
          lambda x: jrs.affine_resample(x, rot, (0.5, 0.0, -0.5), B), s,
          tol=1e-5)
    q = np.float32([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
    out = rs.affine_resample(_t(s), q, (0.0, 0.0, 0.0), B).numpy()
    expect = _box((-2, -6, -2), (2, 6, 2))
    assert np.abs(out - expect)[np.abs(expect) < 2].mean() < 0.1


@pytest.mark.parametrize("order", [0, 1])
def test_resample_to_match_nearest(order):
    s = _sphere(5.0)
    out = _both(lambda x: rs.resample_to_match(x, 1.0, 2.0, B, order=order),
                lambda x: jrs.resample_to_match(x, 1.0, 2.0, B, order=order),
                s, tol=None if order == 0 else 1e-5)
    c = np.where(np.diff(np.sign(out[B:, B, B])) != 0)[0]
    assert len(c) and abs(int(c[0]) - 2) <= 1


def test_pyramid_sampling():
    s = _sphere(6.0, (0.5, 0.0, 0.0))
    pyr = rs.build_pyramid(_t(s), 3)
    jpyr = jrs.build_pyramid(jnp.asarray(s), 3)
    for a, b in zip(pyr, jpyr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5 * 20)
    assert pyr[1].shape == (N // 2,) * 3
    rng = np.random.default_rng(4)
    pos = rng.uniform(-B - 1, B + 1, size=(64, 3)).astype(np.float32)
    for level in (0.0, 0.5, 1.0, 1.75, 2.0, 5.0):
        v = rs.sample_pyramid(pyr, _t(pos), B, level).numpy()
        np.testing.assert_allclose(
            v, np.asarray(jrs.sample_pyramid(jpyr, jnp.asarray(pos), B,
                                             level)), rtol=0, atol=1e-4)
    pyr = rs.build_pyramid(_t(_sphere(6.0)), 3)
    p3 = _t(np.float32([[0, 0, 0], [6, 0, 0], [0, -8, 0]]))
    v0 = rs.sample_pyramid(pyr, p3, B, 0.0).numpy()
    assert np.allclose(v0, [-6.0, 0.0, 2.0], atol=1e-5)
    v1 = rs.sample_pyramid(pyr, p3, B, 1.0).numpy()
    vh = rs.sample_pyramid(pyr, p3, B, 0.5).numpy()
    assert np.allclose(vh, 0.5 * (v0 + v1), atol=1e-5)


# ---------------- diagnostics ----------------

def _same_reports(got, want):
    assert len(got) == len(want)
    for r, j in zip(got, want):
        assert (r.name, r.failed, r.ok, str(r)) == (j.name, j.failed, j.ok,
                                                    str(j))
        if j.mask is not None:
            np.testing.assert_array_equal(r.mask.numpy(), np.asarray(j.mask))


def test_diagnostics():
    s = _sphere(5.0)
    w = 3.0
    good = np.clip(s, -w, w).astype(np.float32)
    bad = good.copy()
    bad[2, 2, 2] = np.nan
    bad[5, 5, 5] = 2 * w
    warped = np.clip(3.0 * s, -w, w).astype(np.float32)
    for field in (good, bad, warped):
        for mask in (False, True):
            got = dg.check_levelset(_t(field), half_width=w, mask=mask)
            want = jdg.check_levelset(jnp.asarray(field), half_width=w,
                                      mask=mask)
            _same_reports(got, want)
            assert dg.diagnose(got) == jdg.diagnose(want)
    assert dg.diagnose(dg.check_levelset(_t(good), half_width=w)) == ""
    assert "unit-gradient" in dg.diagnose(dg.check_levelset(_t(warped),
                                                            half_width=w))
    fog = np.zeros((5, 5, 5, 3), np.float32)
    fog[2, 2, 2] = 1.5
    fog[1, 1, 1, 0] = np.inf
    _same_reports(dg.check_fog_volume(_t(fog[..., 0]), mask=True),
                  jdg.check_fog_volume(jnp.asarray(fog[..., 0]), mask=True))
    _same_reports([dg.check_finite_grid(_t(fog), mask=True)],
                  [jdg.check_finite_grid(jnp.asarray(fog), mask=True)])
    assert dg.check_range(torch.zeros(3, 3, 3), -1, 1).ok


# ---------------- platonic ----------------

@pytest.mark.parametrize("faces", pl.PLATONIC_FACES)
def test_platonic_meshes_closed(faces):
    verts, tris = pl.platonic_mesh(faces, scale=1.5, center=(0.5, 0, -1))
    jverts, jtris = jpl.platonic_mesh(faces, scale=1.5, center=(0.5, 0, -1))
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(tris, jtris)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    assert len(verts) - len(np.unique(np.sort(e, axis=1), axis=0)) \
        + len(tris) == 2
    assert mesh_area(verts, tris) > 0


def _same_platonic(faces, bound, scale, **kw):
    got = pl.platonic_sdf(faces, bound, scale, device="cpu", **kw).numpy()
    want = np.asarray(jpl.platonic_sdf(faces, bound, scale, **kw))
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=0, atol=1e-5)
    flip = np.sign(got) != np.sign(want)
    if flip.any():                     # the sign rule of mesh_to_sdf
        v, t = pl.platonic_mesh(faces, scale, kw.get("center", (0, 0, 0)))
        c = np.arange(-bound, bound + 1, dtype=np.float32)
        pts = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)[flip]
        vt = torch.as_tensor(v, dtype=torch.float32)
        tt = torch.as_tensor(t, dtype=torch.int64)
        wn = mesh.winding_number(torch.as_tensor(pts), vt[tt[:, 0]],
                                 vt[tt[:, 1]], vt[tt[:, 2]]).numpy()
        assert ((np.abs(wn - 0.5) < 1e-4) | (np.abs(got[flip]) < 1e-4)).all()
    return got


def test_platonic_sdf_cube_matches_box():
    r = 7.0
    h = r / np.sqrt(3)
    sdf = _same_platonic(6, B, r)
    expect = _box((-h, -h, -h), (h, h, h))
    assert np.abs(sdf - expect)[np.abs(expect) < 2.0].mean() < 0.1
    clipped = _same_platonic(6, B, r, half_width=2.0, center=(0.5, 0, 0))
    assert np.abs(clipped).max() <= 2.0


@pytest.mark.parametrize("faces", [4, 8, 12, 20])
def test_platonic_sdf_icosahedron_near_sphere(faces):
    sdf = _same_platonic(faces, 8, 6.0, center=(0.25, -0.5, 0.0))
    assert sdf[8, 8, 8] < -1.0 and sdf[0, 0, 0] > 0


# ---------------- volume to spheres ----------------

@pytest.mark.parametrize("overlap", [False, True])
def test_fill_with_spheres(overlap):
    h = 7.0
    s = _box((-h, -h, -h), (h, h, h))
    s += np.random.default_rng(5).normal(0, 0.01, s.shape)   # no ties
    s = s.astype(np.float32)
    centers, radii = vs.fill_with_spheres(_t(s), 9, B, min_radius=0.5,
                                          overlap=overlap)
    jc, jr = jvs.fill_with_spheres(jnp.asarray(s), 9, B, min_radius=0.5,
                                   overlap=overlap)
    centers, radii = centers.numpy(), radii.numpy()
    np.testing.assert_array_equal(np.isnan(centers), np.isnan(np.asarray(jc)))
    np.testing.assert_allclose(centers, np.asarray(jc), rtol=0, atol=1e-5,
                               equal_nan=True)
    np.testing.assert_allclose(radii, np.asarray(jr), rtol=0, atol=1e-5)
    placed = radii > 0
    assert placed.sum() >= 5
    assert np.allclose(centers[0], 0.0, atol=1.0) and abs(radii[0] - h) < 0.1
    # a level set with room for fewer spheres than asked: NaN centres
    few_c, few_r = vs.fill_with_spheres(_t(_sphere(4.0)), 4, B,
                                        min_radius=2.0)
    jfc, jfr = jvs.fill_with_spheres(jnp.asarray(_sphere(4.0)), 4, B,
                                     min_radius=2.0)
    np.testing.assert_array_equal(few_r.numpy(), np.asarray(jfr))
    np.testing.assert_array_equal(few_c.numpy(), np.asarray(jfc))
    assert np.isnan(few_c.numpy()[1:]).all()


def test_closest_surface_points():
    s = _sphere(6.0, (0.3, 0.0, 0.0))
    rng = np.random.default_rng(6)
    pos = rng.uniform(-B, B, size=(64, 3)).astype(np.float32)
    for dx in (1.0, 0.5):
        got = vs.closest_surface_points(_t(s), _t(pos), B, dx=dx)
        want = jvs.closest_surface_points(jnp.asarray(s), jnp.asarray(pos),
                                          B, dx=dx)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-4)
    closest, dist = vs.closest_surface_points(
        _t(_sphere(6.0)), _t(np.float32([[2, 0, 0], [0, -8, 0], [3, 3, 0]])),
        B)
    assert np.abs(np.linalg.norm(closest.numpy(), axis=1) - 6.0).max() < 0.15


# ---------------- fracture ----------------

def test_fracture():
    s = ls.sphere_sdf(None, B, (0.0, 0.0, 0.0), 6.0, device="cpu")
    cut = ls.box_sdf(None, B, (0, -B, -B), (B, B, B), device="cpu")
    frag, rest = ls.fracture(s, cut)
    jfrag, jrest = jls.fracture(jnp.asarray(s.numpy()),
                                jnp.asarray(cut.numpy()))
    np.testing.assert_array_equal(frag.numpy(), np.asarray(jfrag))
    np.testing.assert_array_equal(rest.numpy(), np.asarray(jrest))
    frag, rest = frag.numpy(), rest.numpy()
    assert frag[B + 3, B, B] < 0 and frag[B - 3, B, B] > 0
    assert rest[B - 3, B, B] < 0 and rest[B + 3, B, B] > 0
    sel = (s.numpy() < 0) & (cut.numpy() != 0)
    assert ((frag < 0) ^ (rest < 0))[sel].all()
    assert ((frag < 0) & (rest < 0)).sum() == 0
