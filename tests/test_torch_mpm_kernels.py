"""The port's MPM pieces against the JAX package on the same numpy inputs:
the MPM splines and scenes, the 3x3 linear algebra of ``ops/svd3.py``, the
sort and stencil of ``ops/mpm_kernels.py``, and the plain versions of the
force scatter (K1 fg) and gradW gather (K2 gw) against the Pallas pipeline
(``ops/mpm_pallas.py``) in interpret mode and the naive path's ``jax.jvp``.

Tolerances: the splines, scenes, seeding, the sort and the stencil select,
copy or run the same f32 operations in the same order (JAX run eagerly),
so they agree bit for bit.  The SVD family is compared where its outputs
are unique (``U diag(s) V^T``, R, S, the clamp's outputs, P0; U and V
only where the singular values are separated by more than 1e-3), at atol
1e-5 on O(1) entries.  The stress differentials: rtol 1e-5 of their max.
The forces and their linearisation are f32 sums over up to 27 x (particles
per cell) terms in another order than the TPU kernels: atol 2e-6 after
dividing by ``max|.|``, the JAX package's own bound
(``tests/test_mpm_pallas.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu import scenes as jscenes
from fluidsim_tpu import seeding as jseeding
from fluidsim_tpu.core import splines as jsp
from fluidsim_tpu.models import mpm as jmpm
from fluidsim_tpu.ops import mpm_fast as mf
from fluidsim_tpu.ops import mpm_pallas as mp
from fluidsim_tpu.ops import pallas_transfer as pt
from fluidsim_tpu.ops import smallmat as jsm
from fluidsim_tpu.ops import svd3 as jsvd3
from fluidsim_tpu.ops import transfer_pallas as tp
from fluidsim_tpu_torch import scenes as tscenes
from fluidsim_tpu_torch import seeding as tseeding
from fluidsim_tpu_torch.core import splines as tsp
from fluidsim_tpu_torch.ops import mpm_kernels as mk
from fluidsim_tpu_torch.ops import smallmat as tsm
from fluidsim_tpu_torch.ops import svd3 as tsvd3
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.utils import synthetic

B, DENSITY = 15, 40.0
N = 2 * B + 1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's CPU frames: they run thousands
    of small grid operations, and with the other test processes on the same
    cores, spreading each over every core costs far more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---- host pieces ------------------------------------------------------------

@pytest.mark.parametrize("name", ["spline2", "dspline2", "grad_w_mpm"])
def test_mpm_splines_bitwise(name):
    rng = np.random.default_rng(1)
    k = np.arange(-2, 3, dtype=np.float32)
    x = np.concatenate([rng.uniform(-1.6, 1.6, size=4000), k, k + 0.5,
                        [0.0, -0.0, 1.0, -1.0, 0.5, -0.5]]).astype(np.float32)
    if name == "grad_w_mpm":
        x = rng.uniform(-1.6, 1.6, size=(3000, 3)).astype(np.float32)
        tw, tg = tsp.grad_w_mpm(torch.as_tensor(x))
        jw, jg = jsp.grad_w_mpm(jnp.asarray(x))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        return
    out = getattr(tsp, name)(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(out, np.asarray(getattr(jsp, name)(jnp.asarray(x))))
    if name == "dspline2":
        assert np.all(out[x == 0] == 0.0)     # sign(0) == 0


_MPM_SCENES = ["mpm_cone", "mpm_pea", "mpm_block_drop", "mpm_double_balls",
               "mpm_sphere", "mpm_o"]


@pytest.mark.parametrize("name", _MPM_SCENES)
def test_mpm_scene_and_seeding_bitwise(name):
    t, j = tscenes.get_scene(name), jscenes.get_scene(name)
    assert (t.name, t.kind, t.density, t.gravity, t.initial_velocity) == \
        (j.name, j.kind, j.density, j.gravity, j.initial_velocity)
    assert t.kind == "mpm" and t.initial_velocity == (0.0, -50.0, 0.0)
    assert (t.spec.bound, t.spec.wall, t.spec.dx) == \
        (j.spec.bound, j.spec.wall, j.spec.dx)
    for field in ("solid", "normals", "seed_mask"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    pt, vt = tseeding.seed_particles(t, seed=3)
    pj, vj = jseeding.seed_particles(j, seed=3)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(vt, vj)


def test_scaled_cone_matches():
    t, j = tscenes.get_scene("mpm_cone", bound=40), jscenes.get_scene(
        "mpm_cone", bound=40)
    np.testing.assert_array_equal(t.seed_mask, j.seed_mask)


# ---- 3x3 linear algebra -----------------------------------------------------

def _matrices(kind, count=2000):
    rng = np.random.default_rng({"random": 0, "near_singular": 1,
                                 "rotation": 2, "inverted": 3}[kind])
    f = rng.normal(size=(count, 3, 3))
    if kind == "near_singular":
        u, s, vt = np.linalg.svd(f)
        s[:, 2] = rng.uniform(0, 1e-4, size=count)
        s[: count // 2, 1] = s[: count // 2, 0]          # repeated values too
        f = u @ (s[:, :, None] * vt)
    elif kind == "rotation":
        q, r = np.linalg.qr(f)
        f = q * np.sign(np.linalg.det(q))[:, None, None]
    elif kind == "inverted":
        f = np.eye(3) + 0.3 * f
        f[:, :, 0] *= -1.0
    return f.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "near_singular", "rotation",
                                  "inverted"])
def test_svd3_family(kind):
    """97% of U, s and V are bitwise equal to JAX's (the rest differ in
    the last bits: XLA sums the 3-vector norms in its own order).  F^T F
    squares the condition number, so both reconstruct a random F only to
    6.4e-5 of max|F| and a smallest singular value below sqrt(eps) max|F|
    only to ~3e-4 of max|F|; the port must do as well as JAX there, and
    the squared singular values (what the Jacobi sweeps compute) agree to
    2e-6 of max|F|^2 everywhere."""
    f = _matrices(kind)
    tu, ts, tvt = (x.numpy() for x in tsvd3.svd3(torch.as_tensor(f)))
    ju, js, jvt = (np.asarray(x) for x in jsvd3.svd3(jnp.asarray(f)))
    scale = np.abs(f).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(ts[:, :2] / scale[:, 0], js[:, :2] / scale[:, 0],
                               atol=1e-5)
    np.testing.assert_allclose(ts ** 2 / scale[:, 0] ** 2,
                               js ** 2 / scale[:, 0] ** 2, atol=2e-6)
    err_t = np.abs(tu @ (ts[..., None] * tvt) - f) / scale
    err_j = np.abs(ju @ (js[..., None] * jvt) - f) / scale
    assert err_t.max() <= 1.5 * err_j.max() + 1e-6 and err_t.max() < 5e-4
    np.testing.assert_allclose(np.linalg.det(tu @ tvt),
                               np.sign(np.linalg.det(f)), atol=1e-4)
    sep = np.min(np.abs(np.diff(js, axis=-1)), axis=-1) / scale[:, 0, 0] > 1e-3
    sep &= js[:, 2] / scale[:, 0, 0] > 1e-3
    np.testing.assert_allclose(tu[sep], ju[sep], atol=1e-4)
    np.testing.assert_allclose(tvt[sep], jvt[sep], atol=1e-4)
    tr, tss = (x.numpy() for x in tsvd3.polar_rs(torch.as_tensor(f)))
    jr, jss = (np.asarray(x) for x in jsvd3.polar_rs(jnp.asarray(f)))
    np.testing.assert_allclose(tr, jr, atol=1e-5)
    if kind != "near_singular":       # S = V diag(s) V^T carries s's error
        np.testing.assert_allclose(tss / scale, jss / scale, atol=1e-5)
    # clamp_singular on deformation gradients near the identity
    g = (np.eye(3) + 0.05 * (f / scale)).astype(np.float32)
    for a, b in zip(tsvd3.clamp_singular(torch.as_tensor(g), 0.975, 1.0075),
                    jsvd3.clamp_singular(jnp.asarray(g), 0.975, 1.0075)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.fixture(scope="module")
def stress_inputs():
    rng = np.random.default_rng(4)
    fe = (np.eye(3) + 0.05 * rng.normal(size=(3000, 3, 3))).astype(np.float32)
    jp = rng.uniform(0.95, 1.05, size=3000).astype(np.float32)
    df = (1e-3 * rng.normal(size=(3000, 3, 3))).astype(np.float32)
    return fe, jp, df


def test_hardening_matches(stress_inputs):
    _, jp, _ = stress_inputs
    jp = np.concatenate([jp, np.float32([-3.0, 5.0])])   # both caps bind
    p = jsvd3.hardening(1e4, 2e4, 10.0, jnp.asarray(jp), exponent_cap=10.0)
    t = tsvd3.hardening(1e4, 2e4, 10.0, torch.as_tensor(jp), exponent_cap=10.0)
    for a, b in zip(t, p):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("hessian", ["full", "spd"])
def test_piola_linearized_matches(stress_inputs, hessian):
    fe, jp, df = stress_inputs
    mu, lam = jsvd3.hardening(16326.5, 255782.0, 10.0, jnp.asarray(jp))
    jp0, jdp = jsvd3.piola_linearized(jnp.asarray(fe), mu, lam, hessian)
    tp0, tfull, tspd = tsvd3.piola_linearized(
        torch.as_tensor(fe), _t(mu), _t(lam))
    tdp = tfull if hessian == "full" else tspd
    for a, b in ((tp0, jp0), (tdp(torch.as_tensor(df)), jdp(jnp.asarray(df)))):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_dcofactor3_is_the_jvp_of_cofactor3(stress_inputs):
    """Bitwise equal to ``(da*b + a*db) - (dc*d + c*dd)`` in f32, the order
    of ``jax.jvp``'s jaxpr; XLA's CPU code contracts some of those products
    into FMAs, so against ``jax.jvp`` itself the entries (up to 0.2) agree
    to atol 1e-9."""
    fe, _, df = stress_inputs
    _, jd = jax.jvp(jsvd3.cofactor3, (jnp.asarray(fe),), (jnp.asarray(df),))
    td = tsvd3.dcofactor3(torch.as_tensor(fe), torch.as_tensor(df)).numpy()
    a, b, c, d = fe[:, 1, 1], fe[:, 2, 2], fe[:, 1, 2], fe[:, 2, 1]
    da, db, dc, dd = df[:, 1, 1], df[:, 2, 2], df[:, 1, 2], df[:, 2, 1]
    np.testing.assert_array_equal(td[:, 0, 0], (da * b + a * db) - (dc * d + c * dd))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=0, atol=1e-9)


def test_smallmat_matches():
    rng = np.random.default_rng(5)
    c = rng.normal(size=(500, 3, 3)).astype(np.float32)
    d = rng.normal(size=(500, 27, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tsm.apply_mat27(torch.as_tensor(c), torch.as_tensor(d)).numpy(),
        np.asarray(jsm.apply_mat27(jnp.asarray(c), jnp.asarray(d))))
    np.testing.assert_allclose(
        tsm.outer_sum27(torch.as_tensor(d), torch.as_tensor(d)).numpy(),
        np.asarray(jsm.outer_sum27(jnp.asarray(d), jnp.asarray(d))),
        rtol=1e-6, atol=1e-5)


# ---- the sorted state and the kernels ---------------------------------------

@pytest.fixture(scope="module")
def state():
    """The JAX fast path's state after 3 frames of ``mpm_cone`` (bound 15,
    density 40), sorted by both packages."""
    sim = jmpm.MpmSim("mpm_cone", density=DENSITY,
                      params=jmpm.MpmParams(fast_transfer=True))
    for _ in range(3):
        sim.step()
    st = sim.state
    lay = tp.HaloLayout(N)
    jsorted = mp.sort_mpm_h(st.pos, st.vel, st.FE, st.FP, st.volume, B, lay)
    tsorted = mk.sort_mpm(*(_t(getattr(st, k)) for k in
                            ("pos", "vel", "FE", "FP", "volume")), B)
    rows = mp.pack_mpm_rows(jsorted[5], jsorted[0], jsorted[1], B)
    return dict(lay=lay, j=jsorted, t=tsorted, rows=rows, solid=sim.solid)


def test_sort_mpm_matches_sort_mpm_h(state):
    for a, b in zip(state["t"][:5], state["j"][:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert state["t"][5].dtype == torch.int32


def test_mpm_stencil_matches_pack_rows(state):
    pos_s = state["t"][0]
    p = pos_s.shape[0]
    w27t, gradw = mk.mpm_stencil(pos_s, B)
    rows = np.asarray(state["rows"])
    assert w27t.shape == (27, p) and gradw.shape == (81, p)
    np.testing.assert_array_equal(w27t.numpy(), rows[0:27, :p])
    np.testing.assert_array_equal(gradw.numpy(), rows[40:121, :p])
    np.testing.assert_array_equal(
        w27t.numpy(), tk.masked_weights_cm(pos_s, B, "mpm").numpy())


@pytest.fixture(scope="module")
def frame(state):
    """The frame's grid masks and material, shared by the JAX and the port
    force functions: mass from the XLA fast P2G, hardening of FP."""
    jpos, jvel, jfe, jfp, jvol, _ = state["j"]
    tpos, tvel, tfe, tfp, tvol, tflat = state["t"]
    params = jmpm.MpmParams()
    _, _, _, _, _, flat_s = mf.sort_mpm(jpos, jvel, jfe, jfp, jvol, B)
    mass, _ = mf.p2g_mpm(jpos, jvel, flat_s, state["solid"], B)
    active = (mass > params.mass_threshold) & ~state["solid"]
    mu, lam = jsvd3.hardening(params.mu0, params.lam0, params.hardening_eps,
                              jsvd3.det3(jfp), exponent_cap=params.hardening_max)
    w27t, gradw = mk.mpm_stencil(tpos, B)
    cs = tk.cell_starts(tflat, N)
    rng = np.random.default_rng(6)
    u = np.where(np.asarray(active)[..., None],
                 rng.normal(size=(N, N, N, 3)), 0.0).astype(np.float32)
    velg = rng.normal(size=(N, N, N, 3)).astype(np.float32)
    return dict(active=active, mu=mu, lam=lam, gradw=gradw, cs=cs, u=u,
                velg=velg, flat_s=flat_s)


def _port_force_fns(state, frame, hessian="full"):
    tpos, _, tfe, _, tvol, tflat = state["t"]
    return mk.make_force_fns(tpos, tfe, tvol, _t(frame["mu"]), _t(frame["lam"]),
                             frame["gradw"], frame["cs"], tflat,
                             _t(frame["active"]), _t(state["solid"]), B,
                             hessian=hessian)


def _cm(a):
    """(N,N,N,3) numpy -> channel-major torch."""
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, -1, 0)))


def _assert_close_scaled(port_cm, ref_nnn3):
    ref = np.asarray(ref_nnn3).reshape(N, N, N, 3)
    scale = np.abs(ref).max() + 1e-30
    assert scale > 1e-3
    np.testing.assert_allclose(np.moveaxis(port_cm.numpy(), 0, -1) / scale,
                               ref / scale, atol=2e-6)


@pytest.fixture(scope="module")
def pallas_force_fns(state, frame):
    jpos, _, jfe, _, jvol, jflat = state["j"]
    return mp.make_force_fns(jpos, jflat, state["rows"], jfe, jvol, frame["mu"],
                             frame["lam"], frame["active"], state["solid"], B,
                             state["lay"], interpret=True)


def test_force_scatter_matches_pallas_f0(state, frame, pallas_force_fns):
    f0, _ = _port_force_fns(state, frame)
    _assert_close_scaled(f0(), pallas_force_fns[0]())


def test_gradv_gather_matches_pallas(state, frame):
    jpos, _, _, _, _, jflat = state["j"]
    ref = mp.gradv_gather(jnp.asarray(frame["velg"]), state["rows"], jflat,
                          state["solid"], B, state["lay"], interpret=True)
    out = mk.gradv_gather(_cm(frame["velg"]), frame["gradw"], state["t"][5],
                          _t(state["solid"]))
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert out.shape == ref.shape and scale > 1.0
    np.testing.assert_allclose(out.numpy() / scale, ref / scale, atol=2e-6)


@pytest.mark.parametrize("oracle", ["pallas", "jvp"])
def test_dforce_matches(state, frame, pallas_force_fns, oracle):
    _, dforce = _port_force_fns(state, frame)
    out = dforce(_cm(frame["u"]))
    if oracle == "pallas":
        ref = pallas_force_fns[1](jnp.asarray(frame["u"]))
    else:
        # the naive path: jax.jvp of the force function at u = 0
        jpos, _, jfe, _, jvol, _ = state["j"]
        ids, inb, not_solid, _, gradw = jmpm._particle_nodes(
            jpos, state["solid"], B)
        gather_mask = frame["active"].reshape(-1)[ids] & inb
        forces = jmpm.make_force_fn(ids, gather_mask, not_solid, gradw, jfe,
                                    jvol, frame["mu"], frame["lam"], N ** 3)
        _, ref = jax.jvp(forces, (jnp.zeros((N ** 3, 3), jnp.float32),),
                         (jnp.asarray(frame["u"]).reshape(N ** 3, 3),))
    _assert_close_scaled(out, ref)


def test_hybrid_force_fns_share_the_stress(state, frame):
    """"hybrid" gives the full and the SPD operator beside one f0."""
    f0h, dfull, dspd = _port_force_fns(state, frame, "hybrid")
    f0, dforce = _port_force_fns(state, frame, "full")
    _, dforce_spd = _port_force_fns(state, frame, "spd")
    u = _cm(frame["u"])
    np.testing.assert_array_equal(f0h().numpy(), f0().numpy())
    np.testing.assert_array_equal(dfull(u).numpy(), dforce(u).numpy())
    np.testing.assert_array_equal(dspd(u).numpy(), dforce_spd(u).numpy())
    assert not np.array_equal(dspd(u).numpy(), dfull(u).numpy())


def test_mpm_wrappers_take_the_plain_version_on_cpu_only(state, frame):
    tflat = state["t"][5]
    gradw, cs = frame["gradw"], frame["cs"]
    m9 = torch.as_tensor(np.random.default_rng(7).normal(
        size=(tflat.shape[0], 9)).astype(np.float32))
    fm = _cm(frame["velg"])
    before = (tk.p2g_scatter_force.launches, tk.g2p_gather_gw.launches)
    np.testing.assert_array_equal(
        tk.p2g_scatter_force(gradw, m9, cs, N).numpy(),
        tk.p2g_scatter_force_plain(gradw, m9, cs, N).numpy())
    np.testing.assert_array_equal(tk.g2p_gather_gw(fm, gradw, tflat).numpy(),
                                  tk.g2p_gather_gw_plain(fm, gradw, tflat).numpy())
    assert (tk.p2g_scatter_force.launches, tk.g2p_gather_gw.launches) == before
    with pytest.raises(ValueError):
        tk.p2g_scatter_force(gradw.to("meta"), m9.to("meta"), cs.to("meta"), N)
    with pytest.raises(ValueError):
        tk.g2p_gather_gw(fm.to("meta"), gradw.to("meta"), tflat.to("meta"))


# ---- the K1 chunk plan, K1 fg's order and a crowded cell --------------------

def _skewed():
    """``utils/synthetic.skewed_force_state`` at n = 24 with 2,000 particles
    in one cell."""
    return synthetic.skewed_force_state(0, 24, 2000)


def _flip_cell_start():
    """The cell ranges of ``water_cube_drop`` at bound 8, density 3 (the
    FLIP states of the transfer tests), seeded and sorted by the port."""
    scene = tscenes.get_scene("water_cube_drop", bound=8, density=3.0)
    pos, vel = tseeding.seed_particles(scene, seed=0)
    flat = tk.sort_by_cell(torch.as_tensor(pos), torch.as_tensor(vel), 8)[2]
    return tk.cell_starts(flat, 17)


@pytest.mark.parametrize("case", ["skewed", "cone", "empty", "flip"])
def test_chunk_plan_against_numpy(state, frame, case):
    """Every occupied cell's range is covered by consecutive chunks in
    order, each of at most ``CHUNK`` particles and all but a cell's last of
    exactly ``CHUNK``; no chunk crosses a cell, and ``chunk_cell`` names it;
    empty cells have none; the plan holds exactly the chunks, with P and
    n^3 in the last slot; one build is counted."""
    chunk = tk.CHUNK
    if case == "skewed":
        cs = _skewed()[2]
    elif case == "cone":
        cs = frame["cs"]
    elif case == "flip":
        cs = _flip_cell_start()
    else:
        cs = torch.zeros(N ** 3 + 1, dtype=torch.int32)
    cs_np = cs.numpy().astype(np.int64)
    p = int(cs_np[-1])
    builds = tk.chunk_plan.builds
    plan = tk.chunk_plan(cs, p)
    assert plan.cell_start is cs and tk.chunk_plan.builds == builds + 1
    start = plan.chunk_start.numpy().astype(np.int64)
    first = plan.chunk_first.numpy().astype(np.int64)
    counts = np.diff(cs_np)
    nch = int(start[-1])
    assert start[0] == 0 and nch == first.size - 1
    assert first[nch] == p
    np.testing.assert_array_equal(np.diff(start), -(-counts // chunk))
    if case == "empty":
        assert nch == 0
        return
    if case == "skewed":
        assert counts.max() > chunk
    else:                     # the cone's and FLIP's cells each fit a chunk
        assert counts.max() <= chunk and nch == int((counts > 0).sum())
    length = np.diff(first[:nch + 1])
    assert first[0] == 0 and (length >= 1).all() and (length <= chunk).all()
    cell_of = np.repeat(np.arange(counts.size), counts)
    owner = np.searchsorted(start, np.arange(nch), side="right") - 1
    np.testing.assert_array_equal(cell_of[first[:nch]], owner)
    chunk_cell = plan.chunk_cell.numpy()
    np.testing.assert_array_equal(chunk_cell[:nch], owner)
    assert chunk_cell[nch] == counts.size
    np.testing.assert_array_equal(cell_of[first[1:nch + 1] - 1], owner)
    last = np.zeros(nch, bool)
    last[start[1:][counts > 0] - 1] = True
    assert (length[~last] == chunk).all()
    occ = counts > 0
    np.testing.assert_array_equal(first[start[:-1][occ]], cs_np[:-1][occ])


@pytest.mark.parametrize("case", ["skewed", "cone"])
def test_force_chunked_order_matches_plain(state, frame, case):
    """``p2g_scatter_force_chunked``, the CUDA kernels' summation order in
    PyTorch, against the plain version: within 1e-5 of ``max|plain|`` (f32
    sums of up to 27 x 2,000 terms in another order)."""
    if case == "skewed":
        gradw, m9, cs, _ = _skewed()
        n = 24
    else:
        gradw, cs, n = frame["gradw"], frame["cs"], N
        m9 = torch.as_tensor(np.random.default_rng(8).normal(
            size=(gradw.shape[1], 9)).astype(np.float32))
    plan = tk.chunk_plan(cs, m9.shape[0])
    ref = tk.p2g_scatter_force_plain(gradw, m9, cs, n)
    out = tk.p2g_scatter_force_chunked(gradw, m9, plan, n)
    scale = float(ref.abs().max())
    assert out.shape == (3, n, n, n) and scale > 1.0
    assert float((out - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("mode", ["wv", "aff", "fg"])
def test_k1_wrapper_ignores_plan_on_cpu(mode):
    """On CPU tensors each K1 wrapper (FLIP, APIC, MPM force) runs its plain
    version whatever plan it is given: here the plan of an empty grid,
    whose one pull would drop every particle.  No launch is counted."""
    if mode == "fg":
        gradw, m9, cs, _ = _skewed()
        fn, plain, args = tk.p2g_scatter_force, tk.p2g_scatter_force_plain, \
            (gradw, m9)
    else:
        w27t, vel, aff, cs, _ = synthetic.skewed_wv_state(0, 24, 2000)
        if mode == "wv":
            fn, plain, args = tk.p2g_scatter, tk.p2g_scatter_plain, (w27t, vel)
        else:
            fn, plain, args = (tk.p2g_scatter_affine,
                               tk.p2g_scatter_affine_plain, (w27t, vel, aff))
    wrong = tk.chunk_plan(torch.zeros_like(cs), 0)
    before = fn.launches
    out = fn(*args, cs, 24, wrong)
    np.testing.assert_array_equal(out.numpy(), plain(*args, cs, 24).numpy())
    assert float(out.abs().max()) > 1.0
    assert fn.launches == before


CB = 6               # the crowded-cell state: a 13^3 grid
CN = 2 * CB + 1


@pytest.fixture(scope="module")
def crowded():
    """2,400 particles in the centre cell and 1,500 over the box, sorted by
    both packages; FE rides the sort and serves as M."""
    rng = np.random.default_rng(9)
    pos = np.concatenate([rng.uniform(-0.49, 0.49, (2400, 3)),
                          rng.uniform(-CB + 1.5, CB - 1.5, (1500, 3))])
    pos = pos[rng.permutation(pos.shape[0])].astype(np.float32)
    p = pos.shape[0]
    vel = rng.normal(size=(p, 3)).astype(np.float32)
    fe = rng.normal(size=(p, 3, 3)).astype(np.float32)
    fp = np.broadcast_to(np.eye(3, dtype=np.float32), (p, 3, 3)).copy()
    vol = np.ones(p, np.float32)
    t = mk.sort_mpm(*map(torch.as_tensor, (pos, vel, fe, fp, vol)), CB)
    w27t, gradw = mk.mpm_stencil(t[0], CB)
    cs = tk.cell_starts(t[5], CN)
    assert int((cs[1:] - cs[:-1]).max()) >= 2000
    return dict(pos=pos, vel=vel, fe=fe, fp=fp, vol=vol, gradw=gradw, cs=cs,
                m9=t[2].reshape(p, 9).contiguous(), flat=t[5])


def _force_float64(gradw, m9, flat, n):
    """The force of every (particle, offset) in float64, added to the cell
    ``base + off_o`` where that lies in the box.  (n, n, n, 3)."""
    g = gradw.numpy().astype(np.float64).T.reshape(-1, 27, 3)
    m = m9.numpy().astype(np.float64).reshape(-1, 3, 3)
    u = np.einsum("pck,pok->poc", m, g)
    f = flat.numpy().astype(np.int64)
    base = np.stack([f // (n * n), (f // n) % n, f % n], axis=-1)
    out = np.zeros((n, n, n, 3))
    for o in range(27):
        tgt = base + np.array([o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1])
        ok = ((tgt >= 0) & (tgt < n)).all(axis=-1)
        np.add.at(out, tuple(tgt[ok].T), u[ok, o])
    return out


@pytest.mark.parametrize("oracle", ["pallas", "float64"])
def test_force_scatter_plain_on_a_crowded_cell(crowded, oracle):
    """The plain K1 fg where one cell holds 2,400 particles, against the
    JAX package's MPM Pallas force scatter in interpret mode (its own sort
    and gradW rows, as ``mpm_pallas.make_force_fns`` scatters) and against
    a float64 sum: within 1e-5 of ``max|ref|``."""
    c = crowded
    out = tk.p2g_scatter_force_plain(c["gradw"], c["m9"], c["cs"], CN)
    out = np.moveaxis(out.numpy(), 0, -1)
    if oracle == "float64":
        ref = _force_float64(c["gradw"], c["m9"], c["flat"], CN)
    else:
        lay = tp.HaloLayout(CN)
        js = mp.sort_mpm_h(*map(jnp.asarray, (c["pos"], c["vel"], c["fe"],
                                              c["fp"], c["vol"])), CB, lay)
        p = c["pos"].shape[0]
        rows = mp.pack_mpm_rows(js[5], js[0], js[1], CB)
        rows = rows.at[pt._M0:pt._M0 + 9, :p].set(js[2].reshape(p, 9).T)
        d4 = pt.scatter_wv_fused(rows, js[5], lay.xr, lay.lwr, CN,
                                 interpret=True, expand="fg",
                                 cols=tp.cols_of(rows))
        ref = np.moveaxis(np.asarray(mp._slice_grid(d4, CN, lay)[:3]), 0, -1)
    scale = np.abs(ref).max()
    assert scale > 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * scale)
