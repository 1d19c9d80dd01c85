"""The port's multigrid V-cycle (``ops/multigrid.py``) against the JAX
package's, and the multigrid projection against the JAX Pallas branch
(``pallas_transfer=True`` in interpret mode).

Tolerances:
- The hierarchy's masks and diagonals, ``restrict`` and ``prolong`` are the
  same f32 operations in the same order: bit for bit.
- The V-cycles run the same smoothing, restriction and prolongation, and
  the packed cycle's fine level is K3; the jitted JAX cycles round apart
  from the eager ones (the dense cycle too, whose pieces are bitwise), so
  the cycles agree to atol 1e-5 x max|out| (measured up to 2.3e-7
  relative).
- The projection: ``tests/test_torch_project.py``'s tolerances (velocities
  and pressure atol 5e-4, rtol 1e-3) and equal outer and CG counts.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu.ops import multigrid as jmg
from fluidsim_tpu.ops import pallas_stencil as pst
from fluidsim_tpu.ops import pressure as jpr
from fluidsim_tpu_torch.core.gridspec import GridSpec
from fluidsim_tpu_torch.models import flip as tflip
from fluidsim_tpu_torch.ops import multigrid as tmg
from fluidsim_tpu_torch.ops import pressure as tpr
from fluidsim_tpu_torch.ops import stencil_kernels as sk
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.seeding import seed_particles

DT = 0.1
G = (0.0, -10.0, 0.0)


def _system(bound, seed=0):
    """A random fluid mask inside the walls of a ``bound`` box, with a
    solid block in it."""
    spec = GridSpec(bound=bound, wall=bound - 2)
    rng = np.random.default_rng(seed)
    solid = spec.wall_mask().copy()
    b = bound
    solid[b - 3:b + 1, b - 4:b - 1, b:b + 3] = True
    fluid = (rng.random(spec.shape) < 0.7) & spec.within_mask(b - 3) & ~solid
    return spec, fluid, solid


def _levels_equal(tl, jl):
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        np.testing.assert_array_equal(t.fluid.numpy(), np.asarray(j.fluid))
        np.testing.assert_array_equal(t.solid.numpy(), np.asarray(j.solid))
        np.testing.assert_array_equal(t.adiag.numpy(), np.asarray(j.adiag))
        assert t.dx == j.dx


@pytest.mark.parametrize("bound", [8, 16, 18])
def test_hierarchy_matches_jax(bound):
    """Bitwise masks and diagonals; bound 18 (n = 37) pads an odd level
    twice (37 -> 19 -> 10)."""
    _, fluid, solid = _system(bound)
    tl = tmg.build_hierarchy(torch.as_tensor(fluid), torch.as_tensor(solid),
                             torch.tensor(DT), 1.0, 1.0)
    jl = jmg.build_hierarchy(jnp.asarray(fluid), jnp.asarray(solid),
                             jnp.float32(DT), 1.0, 1.0)
    _levels_equal(tl, jl)
    assert [lv.fluid.shape[0] for lv in tl] == {
        8: [17, 9], 16: [33, 17, 9], 18: [37, 19, 10]}[bound]


def test_hierarchy_at_129_has_five_levels():
    """129 -> 65 -> 33 -> 17 -> 9; the odd levels pad fluid with False and
    solid with True."""
    spec = GridSpec(bound=64, wall=62)
    solid = torch.as_tensor(spec.wall_mask())
    fluid = torch.as_tensor(spec.within_mask(21))
    levels = tmg.build_hierarchy(fluid, solid, torch.tensor(DT), 1.0, 1.0)
    assert [lv.fluid.shape[0] for lv in levels] == [129, 65, 33, 17, 9]
    assert [lv.dx for lv in levels] == [1.0, 2.0, 4.0, 8.0, 16.0]
    # the padded plane is solid on every coarse level
    assert all(bool(lv.solid[-1].all()) for lv in levels[1:])
    assert not any(bool((lv.fluid & lv.solid).any()) for lv in levels)


@pytest.mark.parametrize("n", [16, 17, 37])
def test_restrict_prolong_match_jax(n):
    rng = np.random.default_rng(n)
    r = rng.normal(size=(n, n, n)).astype(np.float32)
    m = (n + 1) // 2
    e = rng.normal(size=(m, m, m)).astype(np.float32)
    np.testing.assert_array_equal(tmg.restrict(torch.as_tensor(r)).numpy(),
                                  np.asarray(jmg.restrict(jnp.asarray(r))))
    np.testing.assert_array_equal(
        tmg.prolong(torch.as_tensor(e), n).numpy(),
        np.asarray(jmg.prolong(jnp.asarray(e), n)))


def test_restrict_prolong_adjoint():
    """<R r, e> == (1/8) <r, P e> (the JAX package's adjointness test)."""
    rng = np.random.default_rng(0)
    r = torch.as_tensor(rng.normal(size=(16, 16, 16)).astype(np.float32))
    e = torch.as_tensor(rng.normal(size=(8, 8, 8)).astype(np.float32))
    lhs = float(torch.sum(tmg.restrict(r) * e))
    rhs = float(torch.sum(r * tmg.prolong(e, 16)) / 8.0)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


def test_dense_laplacian_matches_jax_bitwise():
    _, fluid, solid = _system(8)
    rng = np.random.default_rng(3)
    p = rng.normal(size=fluid.shape).astype(np.float32)
    for dx in (1.0, 2.0):
        jad = jpr.laplacian_diag(jnp.asarray(fluid), jnp.asarray(solid),
                                 jnp.float32(DT), 1.0, dx)
        tad = tpr.laplacian_diag(torch.as_tensor(fluid),
                                 torch.as_tensor(solid), torch.tensor(DT),
                                 1.0, dx)
        np.testing.assert_array_equal(tad.numpy(), np.asarray(jad))
        np.testing.assert_array_equal(
            tpr.apply_laplacian_dense(torch.as_tensor(p), tad,
                                      torch.as_tensor(fluid),
                                      torch.tensor(DT), 1.0, dx).numpy(),
            np.asarray(jpr.apply_laplacian(jnp.asarray(p), jad,
                                           jnp.asarray(fluid),
                                           jnp.float32(DT), 1.0, dx)))


def _close(t, j, rel=1e-5):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=rel * float(np.abs(j).max()))


@pytest.mark.parametrize("bound", [8, 16])
def test_v_cycle_matches_jax(bound):
    """The dense V-cycle and the plain preconditioner on a random vector."""
    _, fluid, solid = _system(bound, seed=1)
    rng = np.random.default_rng(4)
    b = np.where(fluid, rng.normal(size=fluid.shape), 0).astype(np.float32)
    tl = tmg.build_hierarchy(torch.as_tensor(fluid), torch.as_tensor(solid),
                             torch.tensor(DT), 1.0, 1.0)
    jl = jmg.build_hierarchy(jnp.asarray(fluid), jnp.asarray(solid),
                             jnp.float32(DT), 1.0, 1.0)
    _close(tmg.v_cycle(tl, torch.as_tensor(b)), jmg.v_cycle(jl, jnp.asarray(b)))
    tpre = tmg.mg_preconditioner(torch.as_tensor(fluid),
                                 torch.as_tensor(solid), torch.tensor(DT),
                                 1.0, 1.0)
    jpre = jmg.mg_preconditioner(jnp.asarray(fluid), jnp.asarray(solid),
                                 jnp.float32(DT), 1.0, 1.0)
    r = rng.normal(size=fluid.shape).astype(np.float32)
    _close(tpre(torch.as_tensor(r)), jpre(jnp.asarray(r)))


def _packed_pair(fluid, solid):
    """The port's frame preconditioner (fine level on K3) and the JAX
    packed one (fine level on the Pallas K3 in interpret mode)."""
    n = fluid.shape[0]
    tf, ts = torch.as_tensor(fluid), torch.as_tensor(solid)
    tad = tpr.laplacian_diag(tf, ts, torch.tensor(DT), 1.0, 1.0)
    scale = float(torch.tensor(DT) / 1.0)
    tpre = tmg.mg_preconditioner_packed(
        tf, ts, torch.tensor(DT), 1.0, 1.0,
        lambda q: sk.apply_laplacian(q, tad, scale), tad)
    jad = pst.pad_x(jpr.laplacian_diag(jnp.asarray(fluid), jnp.asarray(solid),
                                       jnp.float32(DT), 1.0, 1.0))
    jpre = jmg.mg_preconditioner_packed(
        jnp.asarray(fluid), jnp.asarray(solid), jnp.float32(DT), 1.0, 1.0,
        pst.pad_x, lambda q: pst.unpad_x(q, n),
        lambda q: pst.apply_laplacian_padded(q, jad, jnp.float32(DT), n), jad)
    return tpre, lambda r: pst.unpad_x(jpre(pst.pad_x(jnp.asarray(r))), n)


@pytest.mark.parametrize("bound", [4, 8, 16])
def test_packed_preconditioner_matches_jax(bound):
    """Bound 4 (n = 9) cannot coarsen: the fine smoother alone."""
    _, fluid, solid = _system(bound, seed=2)
    tpre, jpre = _packed_pair(fluid, solid)
    rng = np.random.default_rng(5)
    r = rng.normal(size=fluid.shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jpre(r)
    _close(tpre(torch.as_tensor(r)), ref)


@pytest.mark.parametrize("packed", [False, True])
def test_v_cycle_is_symmetric(packed):
    """<M z1, z2> == <M z2, z1> (the JAX package's symmetry tests), for the
    plain and the frame's preconditioner."""
    spec = GridSpec(bound=24, wall=22)
    solid = torch.as_tensor(spec.wall_mask())
    fluid = torch.as_tensor(spec.within_mask(15)) & ~solid
    dt = torch.tensor(DT)
    if packed:
        ad = tpr.laplacian_diag(fluid, solid, dt, 1.0, 1.0)
        mg = tmg.mg_preconditioner_packed(
            fluid, solid, dt, 1.0, 1.0,
            lambda q: sk.apply_laplacian(q, ad, float(dt)), ad)
    else:
        mg = tmg.mg_preconditioner(fluid, solid, dt, 1.0, 1.0)
    rng = np.random.default_rng(2)
    z1, z2 = (torch.where(fluid, torch.as_tensor(
        rng.normal(size=spec.shape).astype(np.float32)), 0.0)
        for _ in range(2))
    a1 = float(torch.sum(mg(z1) * z2))
    a2 = float(torch.sum(mg(z2) * z1))
    np.testing.assert_allclose(a1, a2, rtol=1e-4)


def _grid(bound):
    """Grid velocity and fluid mask of the seeded cube with a random
    particle velocity field (as ``tests/test_torch_project.py``)."""
    scene = get_scene("water_cube_drop", bound=bound, density=3.0)
    pos, _ = seed_particles(scene, seed=0)
    rng = np.random.default_rng(11)
    vel = (rng.normal(scale=2.0, size=pos.shape)
           + np.float32([0.0, -4.0, 0.0])).astype(np.float32)
    p, v, flat = tk.sort_by_cell(torch.as_tensor(pos), torch.as_tensor(vel),
                                 bound)
    solid = torch.as_tensor(scene.solid)
    w, mom, occ = tk.p2g(tk.masked_weights_cm(p, bound), v, flat, solid,
                         bound)
    velg = normalize_velocity_cm(w, mom).numpy()
    fluid = ((occ > 0) & ~solid).numpy()
    p0 = rng.normal(scale=0.5, size=fluid.shape).astype(np.float32)
    return scene, velg, fluid, np.asarray(scene.solid), p0


def assert_projection_matches(scene, velg, fluid, solid, p0, **params):
    """``project`` of both packages with ``params``, the JAX one on its
    Pallas branch in interpret mode, at the tolerances of the module
    docstring."""
    b = scene.spec.bound
    jparams = jflip.FlipParams(bound=b, wall=scene.spec.wall, gravity=G,
                               pallas_transfer=True, **params)
    tparams = tflip.FlipParams(bound=b, wall=scene.spec.wall, gravity=G,
                               **params)
    with pltpu.force_tpu_interpret_mode():
        ref = jflip.project(jparams, jnp.asarray(velg), jnp.asarray(fluid),
                            jnp.asarray(solid), jnp.float32(DT),
                            p0=jnp.asarray(p0), cm=True)
    out = tflip.project(tparams, torch.as_tensor(velg), torch.as_tensor(fluid),
                        torch.as_tensor(solid), torch.tensor(DT),
                        p0=torch.as_tensor(p0))
    jvel, jerr, jn, jcg, jdiv, jp = ref
    tvel, terr, tn, tcg, tdiv, tp_ = out
    assert tn == int(jn) and tn >= 1
    assert tcg == int(jcg) and tcg > 0
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), atol=5e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp), atol=5e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(float(terr), float(jerr), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(float(tdiv), float(jdiv), atol=1e-5, rtol=1e-3)
    return out


@pytest.mark.parametrize("bound", [8, 16])
def test_multigrid_projection_matches_pallas_branch(bound):
    """Two levels at bound 8, three at bound 16."""
    assert_projection_matches(*_grid(bound), preconditioner="multigrid")


def test_multigrid_launches_six_k3_per_iteration(monkeypatch):
    """The frame's V-cycle makes pre + 1 + post = 5 fine applies, so with
    the CG apply each iteration (and each solve's start) costs 6 K3 calls
    and no K4 call."""
    scene, velg, fluid, solid, p0 = _grid(8)
    calls = {"k3": 0, "k4": 0}
    k3, k4 = sk.apply_laplacian, sk.cheb_steps

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(sk, "apply_laplacian", count("k3", k3))
    monkeypatch.setattr(sk, "cheb_steps", count("k4", k4))
    params = tflip.FlipParams(bound=8, wall=scene.spec.wall, gravity=G,
                              preconditioner="multigrid")
    _, _, n_outer, cg, _, _ = tflip.project(
        params, torch.as_tensor(velg), torch.as_tensor(fluid),
        torch.as_tensor(solid), torch.tensor(DT), p0=torch.as_tensor(p0))
    assert calls == {"k3": 6 * (cg + n_outer), "k4": 0}


def test_make_sim_multigrid_frames_match_pallas_branch():
    """Two frames of a config with an obstacle (the grid probe of the
    bounce, not the analytic walls) and the multigrid preconditioner."""
    import copy
    from fluidsim_tpu import config as jconfig
    from fluidsim_tpu_torch import config as tconfig
    from test_torch_config import CFG, assert_frames_match

    cfg = dict(copy.deepcopy(CFG), params={"preconditioner": "multigrid"})
    tsim = tconfig.make_sim(cfg, device="cpu")
    cfg["params"]["pallas_transfer"] = True
    jsim = jconfig.make_sim(cfg)
    assert not tsim.params.walls_only_solid
    assert_frames_match(tsim, jsim)
