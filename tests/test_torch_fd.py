"""The port's finite-difference schemes (``fluidsim_tpu_torch/ops/fd.py``)
and ``track_levelset``'s HJ path against the JAX package's on the same
seeded fields: one case for each case of ``tests/test_fd.py``.
``shift_edge`` agrees bit for bit; the schemes, WENO, the Godunov norm,
TVD-RK and HJ advection within 1e-5 times the output's scale (f32
shifted differences in the same order; WENO's weights divide by
``(b + 1e-8)^2``, so 1e-4 there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.ops import fd as jfd
from fluidsim_tpu.ops import levelset_tools as jlt
from fluidsim_tpu_torch.ops import fd
from fluidsim_tpu_torch.ops import levelset_tools as lt

ORDERS = [
    ("cd_2nd", 2), ("cd_4th", 4), ("cd_6th", 5),
    ("fd_1st", 1), ("fd_2nd", 2), ("fd_3rd", 3),
    ("bd_1st", 1), ("bd_2nd", 2), ("bd_3rd", 3),
    ("fd_weno5", 3), ("bd_weno5", 3), ("fd_hjweno5", 3), ("bd_hjweno5", 3),
]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def _both(fn, jfn, *arrays, tol=1e-5, **kw):
    arrays = [np.array(a, np.float32) for a in arrays]
    got = fn(*[torch.as_tensor(a) for a in arrays], **kw).numpy()
    _close(got, jfn(*[jnp.asarray(a) for a in arrays], **kw), tol)
    return got


def _smooth_field(n):
    x = np.linspace(-1.0, 1.0, n, dtype=np.float64)
    grid = np.broadcast_to(np.sin(4.0 * x + 0.4)[:, None, None], (n, 4, 4))
    return grid.astype(np.float32), 4.0 * np.cos(4.0 * x + 0.4), x[1] - x[0]


@pytest.mark.parametrize("scheme,order", ORDERS)
def test_convergence_order(scheme, order):
    tol = 1e-4 if "weno" in scheme else 1e-5
    errs = []
    for n in (17, 33):
        grid, df, dx = _smooth_field(n)
        got = _both(lambda p: fd.d1(p, 0, dx, scheme),
                    lambda p: jfd.d1(p, 0, dx, scheme), grid, tol=tol)
        errs.append(np.abs(got[4:-4, 2, 2] - df[4:-4]).max())
    assert np.log2(errs[0] / errs[1]) > order - 0.5
    # every axis of a random field, edge clamps included
    rnd = np.random.default_rng(0).normal(size=(9, 10, 11))
    for axis in range(3):
        _both(lambda p: fd.d1(p, axis, 0.5, scheme),
              lambda p: jfd.d1(p, axis, 0.5, scheme), rnd, tol=tol)


def test_cd_2ndt_is_twice_cd_2nd():
    grid, _, dx = _smooth_field(17)
    a = _both(lambda p: fd.d1(p, 0, dx, "cd_2ndt"),
              lambda p: jfd.d1(p, 0, dx, "cd_2ndt"), grid)
    b = fd.d1(torch.as_tensor(grid), 0, dx, "cd_2nd").numpy()
    assert np.allclose(a, 2.0 * b, rtol=1e-6)
    with pytest.raises(ValueError):
        fd.d1(torch.as_tensor(grid), 0, dx, "cd_8th")
    for s in (-3, -1, 0, 2):
        for axis in range(3):
            np.testing.assert_array_equal(
                fd.shift_edge(torch.as_tensor(grid), axis, s).numpy(),
                np.asarray(jfd.shift_edge(jnp.asarray(grid), axis, s)))


def test_weno5_reconstructs_smooth_flux():
    x = np.linspace(0.0, 1.0, 5) * 0.1
    f = np.sin(2.0 * x + 0.3)
    got = _both(fd.weno5, jfd.weno5, *f, tol=1e-4)
    assert abs(float(got) - np.sin(2.0 * (x[2] + 0.05 * 0.25) + 0.3)) < 1e-3
    rng = np.random.default_rng(1)
    _both(fd.weno5, jfd.weno5, *rng.normal(size=(5, 64)), tol=1e-4)
    _both(lambda *v: fd.weno5(*v, scale2=4.0),
          lambda *v: jfd.weno5(*v, scale2=4.0), *rng.normal(size=(5, 64)),
          tol=1e-4)


def _kink(n):
    x = np.linspace(-1, 1, n)
    return np.broadcast_to(np.abs(x)[:, None, None], (n, 4, 4)), x[1] - x[0]


def test_weno_nonoscillatory_at_kink():
    grid, dx = _kink(65)
    for scheme in ("fd_hjweno5", "bd_hjweno5", "cd_6th"):
        g = _both(lambda p: fd.d1(p, 0, dx, scheme),
                  lambda p: jfd.d1(p, 0, dx, scheme), grid, tol=1e-4)
        if scheme != "cd_6th":
            assert np.abs(g[3:-3, 2, 2]).max() <= 1.0 + 1e-3
        else:
            assert abs(g[32, 2, 2]) < 0.2


@pytest.mark.parametrize("scheme", ["first", "second", "third", "weno5",
                                    "hjweno5"])
def test_biased_gradient_picks_upwind_side(scheme):
    grid, dx = _kink(33)
    rng = np.random.default_rng(2)
    direction = rng.normal(size=(33, 4, 4, 3))
    tol = 1e-4 if "weno" in scheme else 1e-5
    _both(lambda p, v: fd.biased_gradient(p, v, scheme, dx),
          lambda p, v: jfd.biased_gradient(p, v, scheme, dx),
          grid, direction, tol=tol)
    if scheme == "first":
        vpos = torch.ones((33, 4, 4, 3))
        gp = fd.biased_gradient(torch.as_tensor(np.array(grid, np.float32)),
                                vpos, "first", dx)[:, 2, 2, 0]
        gn = fd.biased_gradient(torch.as_tensor(np.array(grid, np.float32)),
                                -vpos, "first", dx)[:, 2, 2, 0]
        assert float(gp[16]) == pytest.approx(-1.0, abs=1e-6)
        assert float(gn[16]) == pytest.approx(+1.0, abs=1e-6)
    with pytest.raises(ValueError):
        fd.biased_gradient(torch.zeros(4, 4, 4), torch.zeros(4, 4, 4, 3),
                           "fourth")


def test_godunov_norm_matches_reference_selection():
    rng = np.random.default_rng(3)
    outside = rng.random((6, 6, 6)) > 0.5
    gm, gp = rng.normal(size=(2, 6, 6, 6, 3)).astype(np.float32)
    got = fd.godunov_norm_sqrd(torch.as_tensor(outside), torch.as_tensor(gm),
                               torch.as_tensor(gp)).numpy()
    _close(got, jfd.godunov_norm_sqrd(jnp.asarray(outside), jnp.asarray(gm),
                                      jnp.asarray(gp)))
    gm1 = torch.tensor([[[[0.5, -0.2, 0.0]]]])
    gp1 = torch.tensor([[[[-0.3, 0.4, 0.0]]]])
    out = float(fd.godunov_norm_sqrd(torch.tensor([[[True]]]), gm1, gp1))
    assert out == pytest.approx(0.5 ** 2, abs=1e-7)
    inn = float(fd.godunov_norm_sqrd(torch.tensor([[[False]]]), gm1, gp1))
    assert inn == pytest.approx(0.4 ** 2, abs=1e-7)


def _sphere(n, c, r):
    ax = np.arange(n, dtype=np.float64)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) - r


@pytest.mark.parametrize("spatial,temporal", [("hjweno5", 3), ("first", 1),
                                              ("second", 2), ("weno5", 3)])
def test_advect_hj_translates_sphere(spatial, temporal):
    n = 17
    phi = _sphere(n, (6.0, 8.0, 8.0), 4.0).astype(np.float32)
    v = np.zeros((n, n, n, 3), np.float32)
    v[..., 0] = 1.0
    v[..., 1] = np.random.default_rng(4).normal(0, 0.3, (n, n, n))
    p, jp = torch.as_tensor(phi), jnp.asarray(phi)
    for _ in range(4):
        p = fd.advect_hj(p, torch.as_tensor(v), 0.5, spatial=spatial,
                         temporal=temporal)
        jp = jfd.advect_hj(jp, jnp.asarray(v), 0.5, spatial=spatial,
                           temporal=temporal)
    _close(p.numpy(), jp, 1e-4 if "weno" in spatial else 1e-5)


def test_tvd_rk_orders_on_linear_ode():
    exact = np.exp(-0.1)
    errs = []
    for k in (1, 2, 3):
        got = float(fd.tvd_rk(torch.tensor(1.0), lambda p: p, 0.1, order=k))
        assert got == pytest.approx(
            float(jfd.tvd_rk(jnp.asarray(1.0), lambda p: p, 0.1, order=k)),
            abs=1e-7)
        errs.append(abs(got - exact))
    assert errs[0] > errs[1] > errs[2] and errs[2] < 1e-5
    with pytest.raises(ValueError):
        fd.tvd_rk(torch.tensor(1.0), lambda p: p, 0.1, order=4)


def test_track_levelset_hj_path():
    n = 17
    phi = _sphere(n, (7.0, 8.0, 8.0), 4.0).astype(np.float32)
    v = np.zeros((n, n, n, 3), np.float32)
    v[..., 0] = 1.0
    got = lt.track_levelset(torch.as_tensor(phi), torch.as_tensor(v), 1.0,
                            bound=n // 2, order=2, spatial="hjweno5",
                            redist_iterations=3).numpy()
    _close(got, jlt.track_levelset(jnp.asarray(phi), jnp.asarray(v), 1.0,
                                   bound=n // 2, order=2, spatial="hjweno5",
                                   redist_iterations=3), 1e-4)
    want = _sphere(n, (8.0, 8.0, 8.0), 4.0)
    assert np.abs(got - want)[np.abs(want) < 2.0].max() < 0.3


def test_track_levelset_schemes_agree_on_units_dx2():
    n = 33
    phi = _sphere(n, (12.0, 16.0, 16.0), 6.0).astype(np.float32)
    v = np.zeros((n, n, n, 3), np.float32)
    v[..., 0] = 1.0
    outs = {}
    for spatial in ("semi", "hjweno5"):
        kw = dict(bound=n // 2, order=2, spatial=spatial,
                  redist_iterations=2, dx=2.0)
        got = lt.track_levelset(torch.as_tensor(phi), torch.as_tensor(v),
                                2.0, **kw).numpy()
        _close(got, jlt.track_levelset(jnp.asarray(phi), jnp.asarray(v), 2.0,
                                       **kw), 1e-4)
        # the moved interface sits on lattice point 8, where |φ| is f32
        # noise of either sign: take the first sample below half a voxel
        outs[spatial] = int(np.argmax(got[:, 16, 16] < 0.5))
    assert outs["semi"] == outs["hjweno5"] == 8, outs
