"""The port's APIC and PIC modes against the JAX package: the APIC transfers
(``ops/apic.py`` over the K1 aff and K2 moments plain versions) against the
Pallas APIC path (``transfer_pallas.p2g_pallas(aff=...)``,
``g2p_apic_pallas``, ``pallas_transfer.gather_wv_fused(nout=24)``) in
interpret mode and against the XLA direct fit (``ops/apic.py``), the 3x3
helpers, two physics checks, and whole frames against the JAX ``FlipSim``'s
Pallas branch.

Tolerances: the sort, the weights and the 3x3 helpers are the same f32
expressions in the same order (JAX run eagerly: under ``jit`` XLA's CPU
backend contracts ``a*b + c`` into one FMA), so they must agree bit for
bit.  P2G, the moments and G2P are f32 sums over up to 27 x (particles per
cell) terms in another order than the TPU kernels' one-hot matmuls and the
XLA scatter: atol 1e-5 (P2G and the moments also rtol 1e-5), and the fit
on the same moments atol 1e-5; the fit on the port's own moments moves C by
up to 5e-4 (``test_g2p_apic_matches`` says why).  Frames: kinetic energy
rtol 1e-4, positions atol 1e-3 (sums in another order, compounded over 3
frames), C as ``test_frames_match_pallas_branch`` states; the outer and CG
iteration counts must be equal.
"""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fluidsim_tpu.core.gridspec import cell_center_velocity_cm as j_centre
from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu.ops import apic as japic
from fluidsim_tpu.ops import pallas_shift as ps
from fluidsim_tpu.ops import pallas_transfer as pt
from fluidsim_tpu.ops import svd3 as jsvd3
from fluidsim_tpu.ops import transfer as jtr
from fluidsim_tpu.ops import transfer_fast as tf
from fluidsim_tpu.ops import transfer_pallas as tp
from fluidsim_tpu.scenes import get_scene
from fluidsim_tpu.seeding import seed_particles
from fluidsim_tpu_torch.core.gridspec import GridSpec, cell_center_velocity_cm
from fluidsim_tpu_torch.core.splines import cround
from fluidsim_tpu_torch.models import flip as tflip
from fluidsim_tpu_torch.ops import apic
from fluidsim_tpu_torch.ops import svd3 as tsvd3
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm
from fluidsim_tpu_torch.utils import synthetic

BOUND, DENSITY, FRAMES = 8, 3.0, 3
N = 2 * BOUND + 1


@pytest.fixture(scope="module")
def particles():
    """Seeded cube particles plus particles spread over the interior (some
    on exact .5 coordinates), with random velocities and affine matrices
    (scale 0.5)."""
    scene = get_scene("water_cube_drop", bound=BOUND, density=DENSITY)
    pos, _ = seed_particles(scene, seed=0)
    rng = np.random.default_rng(0)
    spread = rng.uniform(-(BOUND - 1.5), BOUND - 1.5, size=(300, 3))
    halves = rng.integers(-(BOUND - 3), BOUND - 3, size=(40, 3)) + 0.5
    pos = np.concatenate([pos, spread, halves]).astype(np.float32)
    vel = rng.normal(scale=3.0, size=pos.shape).astype(np.float32)
    aff = rng.normal(scale=0.5, size=(pos.shape[0], 3, 3)).astype(np.float32)
    return scene, pos, vel, aff


@pytest.fixture(scope="module")
def sorted_both(particles):
    scene, pos, vel, aff = particles
    lay = tp.HaloLayout(N)
    jsorted = tp.sort_by_cell_h(jnp.asarray(pos), jnp.asarray(vel), BOUND,
                                lay, extra=jnp.asarray(aff.reshape(-1, 9)))
    tsorted = tk.sort_by_cell(torch.as_tensor(pos), torch.as_tensor(vel),
                              BOUND, extra=torch.as_tensor(aff.reshape(-1, 9)))
    return scene, lay, jsorted, tsorted


def test_sort_carries_extra_in_the_same_order(sorted_both):
    _, _, (jp, jv, _, jx), (tpos, tvel, _, tx) = sorted_both
    for a, b in ((tpos, jp), (tvel, jv), (tx, jx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def p2g_all(particles, sorted_both):
    """P2G by the port, the Pallas path and the XLA direct path."""
    scene, pos, vel, aff = particles
    _, lay, (jp, jv, jflat, jx), (tpos, tvel, tflat, tx) = sorted_both
    jsolid = jnp.asarray(scene.solid)
    pallas = tp.p2g_pallas(jp, jv, jflat, jsolid, BOUND, lay, "flip",
                           aff=jx.reshape(-1, 3, 3), interpret=True,
                           channel_major=True)
    p2, v2, f2, x2 = tf.sort_by_cell(jnp.asarray(pos), jnp.asarray(vel),
                                     BOUND, extra=jnp.asarray(aff.reshape(-1, 9)))
    xw, xmom, xocc = japic.p2g_apic(p2, v2, x2.reshape(-1, 3, 3), f2, jsolid,
                                    BOUND, "flip")
    xla = (xw, jnp.moveaxis(xmom, -1, 0), xocc)
    w27t = tk.masked_weights_cm(tpos, BOUND)
    port = apic.p2g_apic(w27t, tpos, tvel, tx.reshape(-1, 3, 3), tflat,
                         torch.as_tensor(scene.solid), BOUND)
    return {"pallas": pallas[:3], "xla": xla}, port, pallas[3], w27t


@pytest.mark.parametrize("oracle", ["pallas", "xla"])
def test_p2g_apic_matches(p2g_all, oracle):
    oracles, port, *_ = p2g_all
    assert port[1].shape == (3, N, N, N)
    for name, a, b in zip(("weights", "momentum", "occupancy"), port,
                          oracles[oracle]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert float(port[0].sum()) > 0


@pytest.fixture(scope="module")
def cell_velocity(p2g_all):
    """The cell-centred grid velocity a frame gathers from, as JAX
    channel-major, JAX (N,N,N,3) and torch channel-major arrays."""
    oracles, *_ = p2g_all
    jw, jmom, _ = oracles["pallas"]
    jvc = j_centre(jtr.normalize_velocity_cm(jw, jmom))
    vc = cell_center_velocity_cm(normalize_velocity_cm(
        torch.as_tensor(np.array(jw)), torch.as_tensor(np.array(jmom))))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(jvc))
    return jvc, jnp.moveaxis(jvc, 0, -1), vc


@pytest.fixture(scope="module")
def pallas_moments(sorted_both, p2g_all, cell_velocity):
    """The 24 rows of ``gather_wv_fused(nout=24)`` on the within-wall
    masked cell velocity and its mask, as ``g2p_apic_pallas`` builds them;
    (24, P)."""
    scene, lay, (jp, _, jflat, _), _ = sorted_both
    _, _, wv, _ = p2g_all
    jvc, *_ = cell_velocity
    ok = np.abs(np.arange(-BOUND, BOUND + 1)) <= scene.spec.wall
    within = jnp.asarray(ok[:, None, None] & ok[None, :, None]
                         & ok[None, None, :])
    fm = jnp.stack([jnp.where(within, jvc[d], 0.0).reshape(N, N * N)
                    for d in range(3)]
                   + [within.astype(jnp.float32).reshape(N, N * N)])
    fm_hp = jnp.pad(fm, ((0, 0), (ps._XH, lay.xr - N - ps._XH),
                         (2 * lay.lh, lay.lwr - N * N)))
    mo = pt.gather_wv_fused(fm_hp, wv, jflat, N, w=lay.w, t=lay.t,
                            interpret=True, nout=24, cols=tp.cols_of(wv),
                            lh=lay.lh)
    return np.asarray(mo)[:, :jp.shape[0]]


def test_moments_match_the_24_row_gather(sorted_both, p2g_all, cell_velocity,
                                         pallas_moments):
    scene, *_, (_, _, tflat, _) = sorted_both
    _, _, _, w27t = p2g_all
    _, _, vc = cell_velocity
    out = tk.g2p_moments_plain(tk.gather_fields(vc, BOUND, scene.spec.wall),
                               w27t, tflat)
    assert out.shape == (tk.MOMENT_ROWS, tflat.shape[0])
    np.testing.assert_allclose(out.numpy(), pallas_moments[:22], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(pallas_moments[22:], 0.0)


@pytest.fixture(scope="module")
def g2p_oracles(particles, sorted_both, p2g_all, cell_velocity):
    """(velocity, C) of the Pallas path and of the XLA direct fit, and the
    Pallas path's 24 moments."""
    scene, pos, vel, aff = particles
    _, lay, (jp, _, jflat, _), _ = sorted_both
    _, _, wv, _ = p2g_all
    jvc, jvc_nnn3, _ = cell_velocity
    wall = scene.spec.wall
    pallas = tp.g2p_apic_pallas(jp, jflat, jvc, BOUND, wall, lay, "flip",
                                wv_rows=wv, interpret=True, channel_major=True)
    p2, _, f2 = tf.sort_by_cell(jnp.asarray(pos), jnp.asarray(vel), BOUND)
    xla = japic.g2p_apic(p2, f2, jvc_nnn3, BOUND, wall, "flip")
    return {"pallas": pallas, "xla": xla}


@pytest.mark.parametrize("oracle", ["pallas", "xla"])
def test_g2p_apic_matches(sorted_both, p2g_all, cell_velocity, g2p_oracles,
                          oracle):
    """C = B D^-1 multiplies the f32 summation-order differences of the
    moments (atol 1e-5 above) by D^-1, up to 1e3 with the 1e-3 ridge where
    a particle's stencil holds little weight: C is held to atol 5e-4, the
    bound ``tests/test_transfer_pallas.py`` holds the Pallas fit to against
    the XLA fit.  The fit's own arithmetic is held to 1e-5 by
    ``test_affine_fit_matches_pallas``."""
    scene, *_ = sorted_both
    *_, (tpos, _, tflat, _) = sorted_both
    _, _, _, w27t = p2g_all
    _, _, vc = cell_velocity
    rv, rc = g2p_oracles[oracle]
    v, c = apic.g2p_apic(w27t, tflat, tpos, vc, BOUND, scene.spec.wall)
    assert v.shape == (tpos.shape[0], 3) and c.shape == (tpos.shape[0], 3, 3)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=5e-4)
    assert float(c.abs().max()) > 0.1


def test_affine_fit_matches_pallas(sorted_both, pallas_moments, g2p_oracles):
    """The port's fit on the Pallas path's own 24 moments gives that
    path's (velocity, C) at atol 1e-5."""
    *_, (tpos, *_) = sorted_both
    v, c = apic.affine_fit(torch.as_tensor(pallas_moments[:22].copy()), tpos)
    rv, rc = g2p_oracles["pallas"]
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=1e-5)


def _apic_round_trip(pos, vel, bound, wall):
    """P2G then G2P of APIC particles with C = 0 through the port: (sorted
    positions, velocities, C)."""
    solid = torch.as_tensor(GridSpec(bound=bound, wall=wall).wall_mask())
    aff = torch.zeros((pos.shape[0], 9))
    pos_s, vel_s, flat, aff_s = tk.sort_by_cell(
        torch.as_tensor(pos), torch.as_tensor(vel), bound, extra=aff)
    w27t = tk.masked_weights_cm(pos_s, bound)
    w, mom, _ = apic.p2g_apic(w27t, pos_s, vel_s, aff_s.reshape(-1, 3, 3),
                              flat, solid, bound)
    vc = cell_center_velocity_cm(normalize_velocity_cm(w, mom))
    v, c = apic.g2p_apic(w27t, flat, pos_s, vc, bound, wall)
    return pos_s.numpy(), v.numpy(), c.numpy()


def test_apic_rigid_translation_preserved():
    # constant velocity field: APIC must return v and C == 0
    rng = np.random.default_rng(0)
    pos = rng.uniform(-5, 5, size=(8000, 3)).astype(np.float32)
    vel = np.broadcast_to(np.float32([1.0, -2.0, 0.5]), (8000, 3)).copy()
    pos_s, v, c = _apic_round_trip(pos, vel, 10, 8)
    interior = np.all(np.abs(pos_s) < 4, axis=1)
    np.testing.assert_allclose(v[interior], np.broadcast_to(
        [1.0, -2.0, 0.5], (interior.sum(), 3)), atol=0.05)
    assert np.abs(c[interior]).max() < 0.1


def test_apic_rotation_recovered():
    # v = omega x r: C must capture the angular velocity
    rng = np.random.default_rng(1)
    pos = rng.uniform(-5, 5, size=(4000, 3)).astype(np.float32)
    omega = np.asarray([0.0, 0.0, 1.0])
    vel = np.cross(np.broadcast_to(omega, pos.shape), pos).astype(np.float32)
    pos_s, _, c = _apic_round_trip(pos, vel, 12, 10)
    c = c[np.all(np.abs(pos_s) < 3.5, axis=1)]
    # grad v of omega x r = [[0,-1,0],[1,0,0],[0,0,0]]
    np.testing.assert_allclose(np.median(c[:, 0, 1]), -1.0, atol=0.25)
    np.testing.assert_allclose(np.median(c[:, 1, 0]), 1.0, atol=0.25)
    assert abs(np.median(c[:, 2, 2])) < 0.1


@pytest.mark.parametrize("name", ["mm3", "mv3", "det3", "cofactor3"])
def test_svd3_helpers_bitwise(name):
    rng = np.random.default_rng(2)
    a = (rng.normal(size=(3000, 3, 3)) * 3.7).astype(np.float32)
    b = rng.normal(size=(3000, 3, 3)).astype(np.float32)
    x = rng.normal(size=(3000, 3)).astype(np.float32)
    args = {"mm3": (a, b), "mv3": (a, x), "det3": (a,), "cofactor3": (a,)}[name]
    out = getattr(tsvd3, name)(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(getattr(jsvd3, name)(*map(jnp.asarray, args))))


def test_wrappers_take_the_plain_version_on_cpu_only(sorted_both):
    *_, (tpos, tvel, tflat, tx) = sorted_both
    w27t = tk.masked_weights_cm(tpos, BOUND)
    cs = tk.cell_starts(tflat, N)
    before = (tk.p2g_scatter_affine.launches, tk.g2p_moments.launches)
    np.testing.assert_array_equal(
        tk.p2g_scatter_affine(w27t, tvel, tx, cs, N).numpy(),
        tk.p2g_scatter_affine_plain(w27t, tvel, tx, cs, N).numpy())
    fm = torch.as_tensor(
        np.random.default_rng(0).random((4, N, N, N)).astype(np.float32))
    np.testing.assert_array_equal(tk.g2p_moments(fm, w27t, tflat).numpy(),
                                  tk.g2p_moments_plain(fm, w27t, tflat).numpy())
    # counts kernel launches only
    assert (tk.p2g_scatter_affine.launches, tk.g2p_moments.launches) == before
    # with C = 0 the affine scatter is the FLIP scatter
    np.testing.assert_array_equal(
        tk.p2g_scatter_affine(w27t, tvel, torch.zeros_like(tx), cs, N).numpy(),
        tk.p2g_scatter(w27t, tvel, cs, N).numpy())
    # a device with no kernel and no plain route raises instead of falling back
    meta = [t.to("meta") for t in (w27t, tvel, tx, cs)]
    with pytest.raises(ValueError):
        tk.p2g_scatter_affine(*meta, N)
    with pytest.raises(ValueError):
        tk.g2p_moments(fm.to("meta"), w27t.to("meta"), tflat.to("meta"))


def _jax_sim(mode):
    scene = get_scene("water_cube_drop", bound=BOUND, density=DENSITY)
    params = jflip.FlipParams(bound=BOUND, wall=scene.spec.wall,
                              dx=scene.spec.dx, gravity=tuple(scene.gravity),
                              pallas_transfer=True, mode=mode)
    return jflip.FlipSim(scene, params=params, seed=0)


@pytest.fixture(scope="module", params=["apic", "pic"])
def runs(request):
    mode = request.param
    jsim = _jax_sim(mode)
    tsim = tflip.FlipSim("water_cube_drop", bound=BOUND, density=DENSITY,
                         device="cpu", mode=mode)
    assert tsim.params.mode == mode and tsim.params.walls_only_solid
    # the weight and det(D + 1e-3 I) of each particle in the port's last fit
    last_fit = {}
    fit, det3 = apic.affine_fit, apic.det3

    def spy_fit(mo, pos_s):
        last_fit["den"] = mo[0].clone()
        return fit(mo, pos_s)

    def spy_det3(a):
        last_fit["det"] = det3(a)
        return last_fit["det"]

    jm, tm = [], []
    apic.affine_fit, apic.det3 = spy_fit, spy_det3
    try:
        with pltpu.force_tpu_interpret_mode():
            for _ in range(FRAMES):
                jm.append(jsim.step())
                tm.append(tsim.step())
    finally:
        apic.affine_fit, apic.det3 = fit, det3
    return mode, jsim, tsim, jm, tm, last_fit


def test_frames_match_pallas_branch(runs):
    mode, jsim, tsim, jm, tm, last_fit = runs
    for f, (j, t) in enumerate(zip(jm, tm)):
        np.testing.assert_allclose(float(t["kinetic_energy"]),
                                   float(j["kinetic_energy"]), rtol=1e-4,
                                   err_msg=f"{mode} frame {f}")
        assert t["outer_iters"] == int(j["outer_iters"]), (mode, f)
        assert t["cg_iters"] == int(j["cg_iters"]), (mode, f)
    assert tm[1]["cg_iters"] > 0
    np.testing.assert_allclose(tsim.state.pos.numpy(),
                               np.asarray(jsim.state.pos), atol=1e-3)
    if mode == "apic":
        # C passes through D^-1 every frame (see test_g2p_apic_matches),
        # which magnifies the moments' summation-order differences where a
        # stencil holds little weight: 99% of the entries agree within
        # 1e-4, all but one within 1e-3.  That one differs by 1.356e-3
        # (C_yy 0.09742 against 0.09878, at a particle with weight 0.817
        # and det(D + 1e-3 I) = 3.8e-8), which rtol 3.6e-3 covers
        aff, jaff = tsim.state.aff.numpy(), np.asarray(jsim.state.aff)
        assert aff.shape == (tsim.num_particles, 3, 3)
        diff = np.abs(aff - jaff)
        assert np.quantile(diff, 0.99) <= 1e-4
        np.testing.assert_allclose(aff, jaff, atol=1e-3, rtol=4e-3)
        # every entry beyond 1e-3 is at a particle with weight whose D is
        # near singular (D = 0 gives det(D + 1e-3 I) = 1e-9)
        over = np.unique(np.argwhere(diff > 1e-3)[:, 0])
        assert len(last_fit["det"]) == tsim.num_particles
        assert np.all(last_fit["den"].numpy()[over] > 0)
        assert np.all(last_fit["det"].numpy()[over] < 1e-6), over
        assert np.abs(aff).max() > 0.1
    else:
        assert tsim.state.aff is None and jsim.state.aff is None


def test_mode_is_checked():
    with pytest.raises(ValueError):
        tflip.FlipParams(mode="mpm")
    sim = tflip.FlipSim("water_cube_drop", bound=6, density=2.0, device="cpu")
    with pytest.raises(ValueError):
        tflip.FlipSim.from_state(sim.scene, sim.state, device="cpu",
                                 mode="apic")
    assert inspect.signature(tflip.FlipSim).parameters["mode"].default is None


@pytest.mark.parametrize("case", ["apic", "skewed"])
def test_p2g_scatter_affine_chunked_matches_plain(sorted_both, case):
    """``p2g_scatter_affine_chunked``, the order of K1 aff's CUDA kernels in
    PyTorch, against the plain K1 aff on the JAX-compared APIC state (veff
    as ``apic.p2g_apic`` forms it) and on
    ``utils/synthetic.skewed_wv_state`` (2,000 particles in one cell):
    within 1e-5 of ``max|plain|``, the bound of f32 sums of up to 27 x
    2,000 terms taken in another order."""
    if case == "apic":
        *_, (tpos, tvel, tflat, tx) = sorted_both
        w27t, aff, n = tk.masked_weights_cm(tpos, BOUND), tx, N
        veff = tvel + tsvd3.mv3(tx.reshape(-1, 3, 3), cround(tpos) - tpos)
        cs = tk.cell_starts(tflat, n)
    else:
        w27t, veff, aff, cs, _ = synthetic.skewed_wv_state(0, 24, 2000)
        n = 24
    plan = tk.chunk_plan(cs, veff.shape[0])
    ref = tk.p2g_scatter_affine_plain(w27t, veff, aff, cs, n)
    out = tk.p2g_scatter_affine_chunked(w27t, veff, aff, plan, n)
    scale = float(ref.abs().max())
    assert out.shape == (4, n, n, n) and scale > 1.0
    assert float((out - ref).abs().max()) <= 1e-5 * scale
    # C moves the sums: the affine term is live in this comparison
    assert not torch.equal(out, tk.p2g_scatter_chunked(w27t, veff, plan, n))
