"""The port's mesh tools (``fluidsim_tpu_torch/ops/mesh.py``,
``ops/volume_to_mesh.py``) against the JAX package's on the same seeded
inputs: one case for each mesh case of ``tests/test_mesh_raytrace.py``
and each case of ``tests/test_volume_to_mesh.py``.

``volume_to_mesh``'s active cells and quads agree bit for bit, its
vertices within 1e-6; distances and winding numbers within 1e-5.
``mesh_to_sdf``'s sign may differ only where the winding number is
within 1e-4 of 0.5 (f32 noise of a sum of solid angles) or ``|d|`` is
below 1e-4; its magnitude agrees within 1e-5 everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.ops import levelset as jls
from fluidsim_tpu.ops import mesh as jmesh
from fluidsim_tpu.ops import volume_to_mesh as jvm
from fluidsim_tpu_torch.ops import levelset as ls
from fluidsim_tpu_torch.ops import mesh
from fluidsim_tpu_torch.ops import volume_to_mesh as vm

B = 12
R = 7.0
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def _same_sdf(got, want, verts, tris, bound):
    """``mesh_to_sdf`` of the port against the JAX one, under the sign
    rule of the module docstring."""
    got, want = got.numpy(), np.asarray(want)
    _close(np.abs(got), np.abs(want))
    flip = np.sign(got) != np.sign(want)
    if flip.any():
        c = np.arange(-bound, bound + 1, dtype=np.float32)
        pts = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)[flip]
        v = torch.as_tensor(verts, dtype=torch.float32)
        tri = torch.as_tensor(tris, dtype=torch.int64)
        w = mesh.winding_number(torch.as_tensor(pts), v[tri[:, 0]],
                                v[tri[:, 1]], v[tri[:, 2]]).numpy()
        assert ((np.abs(w - 0.5) < 1e-4) | (np.abs(got[flip]) < 1e-4)).all()


def test_point_triangle_distance_regions():
    rng = np.random.default_rng(0)
    p = rng.uniform(-3, 3, size=(500, 3)).astype(np.float32)
    tri = rng.uniform(-2, 2, size=(500, 3, 3)).astype(np.float32)
    tri[:5, 2] = tri[:5, 1]                       # degenerate triangles
    args = [p] + [tri[:, i] for i in range(3)]
    got = mesh.point_triangle_distance(*map(_t, args))
    _close(got, jmesh.point_triangle_distance(*map(jnp.asarray, args)))
    a, b, c = (np.float32(x) for x in ([0, 0, 0], [1, 0, 0], [0, 1, 0]))
    q = np.float32([[0.25, 0.25, 2.0], [-3, -4, 0], [0.5, -2, 0], [1, 1, 0]])
    d = mesh.point_triangle_distance(_t(q), _t(a), _t(b), _t(c)).numpy()
    np.testing.assert_allclose(d, [2.0, 5.0, 2.0, np.sqrt(2) / 2], rtol=1e-5)


def test_winding_number_sphere():
    v, t = mesh.icosphere((0.0, 0.0, 0.0), 4.0, subdivisions=2)
    verts = v.astype(np.float32)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-8, 8, size=(300, 3)).astype(np.float32)
    abc = [verts[t[:, i]] for i in range(3)]
    w = mesh.winding_number(_t(pts), *map(_t, abc)).numpy()
    _close(w, jmesh.winding_number(jnp.asarray(pts), *map(jnp.asarray, abc)))
    r = np.linalg.norm(pts, axis=1)
    assert (w[r < 3.5] > 0.9).all() and (np.abs(w[r > 4.5]) < 0.1).all()


@pytest.mark.parametrize("chunk", [4096, 1000])
def test_mesh_to_sdf_matches_analytic_sphere(chunk):
    v, t = mesh.icosphere((0.3, -0.2, 0.1), 6.0, subdivisions=3)
    got = mesh.mesh_to_sdf(v, t, B, chunk=chunk, device="cpu")
    _same_sdf(got, jmesh.mesh_to_sdf(v, t, B, chunk=4096), v, t, B)
    ana = ls.sphere_sdf(None, B, (0.3, -0.2, 0.1), 6.0, device="cpu").numpy()
    err = (got.numpy() - ana)[np.abs(ana) < 3.0]
    assert err.max() < 0.12 and err.min() > -1e-4


def test_mesh_to_sdf_matches_analytic_box():
    lo, hi = (-5.0, -4.0, -3.0), (2.0, 5.0, 6.0)
    v, t = mesh.box_mesh(lo, hi)
    got = mesh.mesh_to_sdf(v, t, B, chunk=4096, device="cpu")
    _same_sdf(got, jmesh.mesh_to_sdf(v, t, B, chunk=4096), v, t, B)
    _close(got, ls.box_sdf(None, B, lo, hi, device="cpu"), 1e-4)


def _mesh_both(phi, iso=0.0, bound=B):
    """The port's and the JAX ``volume_to_mesh`` on one field: the dense
    pass's masks and quads bit for bit, vertices within 1e-6."""
    arrs = vm.volume_to_mesh_arrays(_t(phi), iso=iso)
    jarrs = jvm.volume_to_mesh_arrays(jnp.asarray(phi), iso=iso)
    np.testing.assert_array_equal(arrs["cell_active"].numpy(),
                                  np.asarray(jarrs["cell_active"]))
    for d in range(3):
        np.testing.assert_array_equal(arrs["quad_active"][d].numpy(),
                                      np.asarray(jarrs["quad_active"][d]))
        np.testing.assert_array_equal(arrs["quads"][d].numpy(),
                                      np.asarray(jarrs["quads"][d]))
    _close(arrs["vertex"], jarrs["vertex"], 1e-6)
    verts, quads = vm.volume_to_mesh(_t(phi), iso=iso, bound=bound)
    jverts, jquads = jvm.volume_to_mesh(jnp.asarray(phi), iso=iso,
                                        bound=bound)
    np.testing.assert_array_equal(quads, jquads)
    _close(verts, jverts, 1e-6)
    return verts, quads


def _signed_volume(verts, quads):
    tris = vm.quads_to_triangles(quads)
    a, b, c = (verts[tris[:, i]] for i in range(3))
    return np.einsum("ij,ij->", a, np.cross(b, c)) / 6.0


def _noisy(phi, seed):
    rng = np.random.default_rng(seed)
    return (np.asarray(phi) + rng.normal(0, 0.2, np.shape(phi))
            ).astype(np.float32)


def test_sphere_mesh_geometry():
    s = jls.sphere_sdf(None, B, (0.0, 0.0, 0.0), R)
    verts, quads = _mesh_both(s)
    assert len(verts) > 100 and quads.min() >= 0 and quads.max() < len(verts)
    r = np.linalg.norm(verts, axis=1)
    assert np.abs(r - R).max() < 0.75
    assert np.isclose(vm.mesh_area(verts, quads), 4 * np.pi * R * R, rtol=0.07)
    np.testing.assert_allclose(vm.mesh_area(verts, quads),
                               jvm.mesh_area(verts, quads), rtol=1e-12)
    _mesh_both(_noisy(s, 0))                      # many small components


def test_sphere_mesh_closed_and_oriented():
    s = jls.sphere_sdf(None, B, (0.5, 0.25, -0.5), R)
    verts, quads = _mesh_both(s)
    assert len(verts) - len(quads) == 2
    e = np.concatenate([quads[:, [i, (i + 1) % 4]] for i in range(4)])
    _, counts = np.unique(np.sort(e, axis=1), axis=0, return_counts=True)
    assert (counts == 2).all() and len(set(map(tuple, e))) == len(e)
    assert np.isclose(_signed_volume(verts, quads), 4 / 3 * np.pi * R ** 3,
                      rtol=0.05)
    np.testing.assert_array_equal(vm.quads_to_triangles(quads),
                                  jvm.quads_to_triangles(quads))


def test_box_mesh_faces_snap():
    s = jls.box_sdf(None, B, (-5, -5, -5), (5, 5, 5))
    verts, quads = _mesh_both(s)
    assert np.allclose(np.abs(verts).max(axis=1), 5.0, atol=0.51)
    assert np.isclose(_signed_volume(verts, quads), 10.0 ** 3, rtol=0.05)


@pytest.mark.parametrize("iso", [-2.0, 0.7])
def test_iso_offset(iso):
    s = jls.sphere_sdf(None, B, (0.0, 0.0, 0.0), R)
    verts, _ = _mesh_both(s, iso=iso)
    r = np.linalg.norm(verts, axis=1)
    assert np.abs(r - (R + iso)).mean() < 0.2
    _mesh_both(_noisy(s, 1), iso=iso, bound=None)


def test_roundtrip_with_mesh_to_volume():
    s = jls.sphere_sdf(None, 8, (0.0, 0.0, 0.0), 5.0)
    verts, quads = _mesh_both(s, bound=8)
    tris = vm.quads_to_triangles(quads)
    got = mesh.mesh_to_sdf(verts.astype(np.float32), tris, 8, device="cpu")
    _same_sdf(got, jmesh.mesh_to_sdf(jnp.asarray(verts, jnp.float32), tris, 8),
              verts, tris, 8)
    err = np.abs(got.numpy() - np.asarray(s))[np.abs(np.asarray(s)) < 3.0]
    assert err.mean() < 0.15 and err.max() < 0.8
