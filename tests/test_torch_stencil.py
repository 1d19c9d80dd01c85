"""The port's pressure-solve stencils (``ops/stencil_kernels.py``) and CG
(``ops/pcg.py``) against the JAX Pallas stencil kernels run in interpret
mode and the JAX plain operators.

On CPU tensors the K3/K4 wrappers run their plain PyTorch versions; the CUDA
kernels themselves are compared with those on the card by ``chip_smoke.py``.

Tolerances: K3 against the packed Pallas kernel and the plain operator is an
f32 stencil whose six-term sum XLA may order or contract differently: atol
2e-4, rtol 1e-4 (``tests/test_pallas_stencil.py``'s bound).  K4 and the fused
Chebyshev preconditioner chain a few such steps: atol 1e-6, rtol 1e-5 on the
unit-scale fields used here.  CG stops on a squared-residual threshold, so
iteration counts must agree exactly and solutions to atol 1e-5.

Where the port is compared with itself it is bit for bit: K3 and K4 with
the neighbours' edge planes beside a slab against the operand that the
sharded solve built before (the slab with its ghost rows, the output cut
back), the S-step ``cheb_steps`` against as many composed steps, and the
preconditioner's launches split at any step count.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fluidsim_tpu.core.gridspec import GridSpec
from fluidsim_tpu.ops import pallas_stencil as pst
from fluidsim_tpu.ops import pcg as jpcg
from fluidsim_tpu.ops import pressure as jpr
from fluidsim_tpu_torch.ops import pcg as tpcg
from fluidsim_tpu_torch.ops import pressure as tpr
from fluidsim_tpu_torch.ops import stencil_kernels as sk

DT, RHO, DX = 0.1, 1.0, 1.0
SCALE = DT / (RHO * DX * DX)
BX = 8


@pytest.fixture(scope="module", params=[(8, 5), (8, 6)])
def system(request):
    """A fluid region with a ragged free surface (random air cells inside a
    box) and the walls of the scene; adiag from both packages."""
    bound, inner = request.param
    spec = GridSpec(bound=bound, wall=bound - 2)
    rng = np.random.default_rng(bound + inner)
    solid = spec.wall_mask()
    fluid = spec.within_mask(inner) & ~solid & (rng.random(spec.shape) > 0.1)
    jad = jpr.laplacian_diag(jnp.asarray(fluid), jnp.asarray(solid), DT, RHO, DX)
    tad = tpr.laplacian_diag(torch.as_tensor(fluid), torch.as_tensor(solid),
                             DT, RHO, DX)
    np.testing.assert_array_equal(tad.numpy(), np.asarray(jad))
    fields = rng.normal(size=(3,) + spec.shape).astype(np.float32)
    return spec, fluid, solid, np.asarray(jad), fields


def _t(a):
    return torch.as_tensor(np.array(a))


def test_apply_laplacian_matches_pallas_and_plain(system):
    spec, fluid, solid, ad, (p, _, _) = system
    n = spec.n
    out = sk.apply_laplacian(_t(p), _t(ad), SCALE).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref_k = pst.unpad_x(pst.apply_laplacian_padded(
            pst.pad_x(jnp.asarray(p), bx=BX), pst.pad_x(jnp.asarray(ad), bx=BX),
            SCALE, n, bx=BX), n, bx=BX)
    np.testing.assert_allclose(out, np.asarray(ref_k), atol=2e-4, rtol=1e-4)
    ref_x = jpr.apply_laplacian(jnp.asarray(p), jnp.asarray(ad),
                                jnp.asarray(fluid), DT, RHO, DX)
    np.testing.assert_allclose(out, np.asarray(ref_x), atol=2e-4, rtol=1e-4)
    # pressure.apply_laplacian (the reference's signature, masked by fluid)
    # is the same map
    np.testing.assert_allclose(
        tpr.apply_laplacian(_t(p), _t(ad), torch.as_tensor(fluid), DT, RHO,
                            DX).numpy(), out, atol=2e-6, rtol=1e-6)
    assert np.all(out[ad <= 0] == 0)


def test_cheb_step_matches_pallas(system):
    spec, _, _, ad, (z, r, d) = system
    n = spec.n
    c1, c2 = 0.7, 1.3
    z = np.where(ad > 0, z, 0).astype(np.float32)   # the solve keeps z masked
    dn, zn = sk.cheb_step(_t(z), _t(ad), _t(r), _t(d), SCALE, c1, c2)
    pad = lambda a: pst.pad_x(jnp.asarray(a), bx=BX)
    with pltpu.force_tpu_interpret_mode():
        jdn, jzn = pst.cheb_step_padded(pad(z), pad(ad), pad(r), pad(d), SCALE,
                                        c1, c2, n, bx=BX)
    np.testing.assert_allclose(dn.numpy(), np.asarray(pst.unpad_x(jdn, n, bx=BX)),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(zn.numpy(), np.asarray(pst.unpad_x(jzn, n, bx=BX)),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("degree", [2, 3, 4, 5])
def test_chebyshev_precond_fused_matches_pallas(system, degree):
    spec, _, _, ad, (r, _, _) = system
    n = spec.n
    r = np.where(ad > 0, r, 0).astype(np.float32)
    z = sk.chebyshev_precond_fused(_t(ad), SCALE, degree=degree)(_t(r)).numpy()
    with pltpu.force_tpu_interpret_mode():
        jz = pst.chebyshev_precond_fused(pst.pad_x(jnp.asarray(ad), bx=BX),
                                         SCALE, n, "row", BX, 0,
                                         degree=degree)(
            pst.pad_x(jnp.asarray(r), bx=BX))
    np.testing.assert_allclose(z, np.asarray(pst.unpad_x(jz, n, bx=BX)),
                               atol=1e-6, rtol=1e-5)
    # the fused steps compute the plain (composed) polynomial
    tad = _t(ad)
    composed = tpcg.chebyshev_preconditioner(
        lambda q: sk.apply_laplacian(q, tad, SCALE),
        tpcg.jacobi_preconditioner(tad, mask=tad > 0), degree=degree)
    np.testing.assert_allclose(z, composed(_t(r)).numpy(), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("precond", ["none", "jacobi", "chebyshev"])
def test_pcg_matches_jax(system, precond):
    spec, fluid, _, ad, (b, x0, _) = system
    b = np.where(fluid, b, 0).astype(np.float32)
    x0 = np.where(fluid, x0, 0).astype(np.float32) * 0.1
    jfl, jad = jnp.asarray(fluid), jnp.asarray(ad)
    japply = lambda q: jpr.apply_laplacian(q, jad, jfl, DT, RHO, DX)
    tfl, tad = torch.as_tensor(fluid), _t(ad)
    tapply = lambda q: sk.apply_laplacian(q, tad, SCALE)
    jpre = tpre = None
    if precond == "jacobi":
        jpre = jpcg.jacobi_preconditioner(jad, mask=jfl)
        tpre = tpcg.jacobi_preconditioner(tad, mask=tfl)
    elif precond == "chebyshev":
        jpre = jpcg.chebyshev_preconditioner(
            japply, jpcg.jacobi_preconditioner(jad, mask=jfl))
        tpre = sk.chebyshev_precond_fused(tad, SCALE)
    ref = jpcg.pcg(japply, jnp.asarray(b), x0=jnp.asarray(x0), precond=jpre,
                   rtol=1e-5, maxiter=400)
    out = tpcg.pcg(tapply, _t(b), x0=_t(x0), precond=tpre, rtol=1e-5,
                   maxiter=400)
    assert out.iters == int(ref.iters) > 0
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=1e-5,
                               rtol=1e-4)
    # maxiter caps the host loop exactly like the while_loop predicate
    capped = tpcg.pcg(tapply, _t(b), precond=tpre, rtol=1e-5, maxiter=2)
    assert capped.iters == 2


def test_wrappers_take_the_plain_version_on_cpu_only(system):
    _, _, _, ad, (z, r, d) = system
    before = (sk.apply_laplacian.launches, sk.cheb_steps.launches)
    np.testing.assert_array_equal(
        sk.apply_laplacian(_t(z), _t(ad), SCALE).numpy(),
        sk.apply_laplacian_plain(_t(z), _t(ad), SCALE).numpy())
    assert (sk.apply_laplacian.launches, sk.cheb_steps.launches) == before
    meta = [_t(a).to("meta") for a in (z, ad, r, d)]
    with pytest.raises(ValueError):
        sk.apply_laplacian(meta[0], meta[1], SCALE)
    with pytest.raises(ValueError):
        sk.cheb_step(*meta, SCALE, 0.5, 0.5)


# ---- edge planes and S steps, the port against itself, bit for bit ---------

N_G = 9      # the cube of the edge-plane cases
X0 = 2       # the slab's first row in it


def _field(rng, shape, mask=False):
    if mask:
        a = rng.uniform(0.5, 6.0, shape).astype(np.float32)
        a[rng.random(shape) < 0.3] = 0.0
        return torch.as_tensor(a)
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32))


def _equal(a, b):
    assert torch.equal(a, b) and torch.equal(torch.signbit(a),
                                             torch.signbit(b))


def _edges(cube, x0, nl, depth, real):
    """The ``depth`` rows of ``cube`` on either side of rows [x0, x0 + nl),
    or None (zeros) where ``real`` is False."""
    if not real:
        return None, None
    return (cube[x0 - depth:x0].contiguous(),
            cube[x0 + nl:x0 + nl + depth].contiguous())


def _operand(slab, lo, hi, depth=1):
    """The slab with its ``depth`` ghost rows on each side (zeros for
    None): the operand the sharded solve built per call before."""
    zero = slab.new_zeros((depth,) + tuple(slab.shape[1:]))
    return torch.cat([zero if lo is None else lo, slab,
                      zero if hi is None else hi])


@pytest.mark.parametrize("real", [False, True], ids=["zero", "neighbours"])
@pytest.mark.parametrize("nl", [2, 3, 4, 5])
def test_apply_laplacian_edge_planes_match_operand_path(nl, real):
    rng = np.random.default_rng(10 * nl + real)
    p = _field(rng, (N_G,) * 3)
    ad = _field(rng, (N_G,) * 3, mask=True)
    s = slice(X0, X0 + nl)
    p_lo, p_hi = _edges(p, X0, nl, 1, real)
    a_lo, a_hi = _edges(ad, X0, nl, 1, real)
    ghost = tuple(None if t is None else t[0]
                  for t in (p_lo, p_hi, a_lo, a_hi))
    out = sk.apply_laplacian(p[s].contiguous(), ad[s].contiguous(), SCALE,
                             ghost=ghost)
    ref = sk.apply_laplacian(_operand(p[s], p_lo, p_hi),
                             _operand(ad[s], a_lo, a_hi), SCALE)[1:-1]
    _equal(out, ref)
    if real:   # the slab of the cube, as the cube computes it
        _equal(out, sk.apply_laplacian(p, ad, SCALE)[s])
    else:      # null planes read 0: no ghost at all
        _equal(out, sk.apply_laplacian(p[s].contiguous(), ad[s].contiguous(),
                                       SCALE))


@pytest.mark.parametrize("real", [False, True], ids=["zero", "neighbours"])
@pytest.mark.parametrize("nl", [2, 3, 4, 5])
def test_cheb_step_edge_planes_match_operand_path(nl, real):
    """One step from a given (z, d), with one edge row of every field: the
    slab's rows of the step on the operand, d' included."""
    rng = np.random.default_rng(20 * nl + real)
    z, r, d = (_field(rng, (N_G,) * 3) for _ in range(3))
    ad = _field(rng, (N_G,) * 3, mask=True)
    s = slice(X0, X0 + nl)
    named = dict(z=z, d=d, r=r, adiag=ad)
    ghost = {k: _edges(v, X0, nl, 1, real) for k, v in named.items()}
    zn, dn = sk.cheb_steps(ad[s].contiguous(), r[s].contiguous(), SCALE,
                           [(0.7, 1.3)], z=z[s].contiguous(),
                           d=d[s].contiguous(), ghost=ghost, want_d=True)
    ops = {k: _operand(v[s], *ghost[k]) for k, v in named.items()}
    dref, zref = sk.cheb_step(ops["z"], ops["adiag"], ops["r"], ops["d"],
                              SCALE, 0.7, 1.3)
    _equal(zn, zref[1:-1])
    _equal(dn, dref[1:-1])


@pytest.mark.parametrize("jacobi", [True, False], ids=["jacobi", "given"])
@pytest.mark.parametrize("steps", [1, 2, 3])
def test_cheb_steps_match_composed_steps(steps, jacobi):
    """``cheb_steps`` is its steps composed, on the cube and on a slab of
    it with ``steps`` edge rows of every field (deeper blocks are cut to
    the rows next to the slab)."""
    rng = np.random.default_rng(steps + 7 * jacobi)
    z, r, d = (_field(rng, (N_G,) * 3) for _ in range(3))
    ad = _field(rng, (N_G,) * 3, mask=True)
    coefs = [(float(c1), float(c2))
             for c1, c2 in rng.uniform(0.3, 1.5, (steps, 2))]
    theta = 1.0333
    zc, dc = (sk._jacobi_start(ad, r, theta),) * 2 if jacobi else (z, d)
    for c1, c2 in coefs:
        dc, zc = sk.cheb_step(zc, ad, r, dc, SCALE, c1, c2)
    start = dict(theta=theta) if jacobi else dict(z=z, d=d)
    zs, ds = sk.cheb_steps(ad, r, SCALE, coefs, want_d=True, **start)
    _equal(zs, zc)
    _equal(ds, dc)
    x0, nl, depth = steps + 1, 2, steps + 1
    sl = slice(x0, x0 + nl)
    named = dict(z=z, d=d, r=r, adiag=ad)
    ghost = {k: _edges(v, x0, nl, depth, True) for k, v in named.items()}
    start = dict(theta=theta) if jacobi else dict(z=z[sl].contiguous(),
                                                  d=d[sl].contiguous())
    zs, ds = sk.cheb_steps(ad[sl].contiguous(), r[sl].contiguous(), SCALE,
                           coefs, ghost=ghost, want_d=True, **start)
    _equal(zs, zc[sl])
    _equal(ds, dc[sl])


def test_cheb_steps_refuse_more_than_s_max():
    """One launch takes 1 to ``S_MAX`` steps, on either route."""
    rng = np.random.default_rng(3)
    r = _field(rng, (N_G,) * 3)
    ad = _field(rng, (N_G,) * 3, mask=True)
    for count in (0, sk.S_MAX + 1):
        with pytest.raises(ValueError, match="steps"):
            sk.cheb_steps(ad, r, SCALE, [(0.5, 1.0)] * count, theta=1.0)


@pytest.mark.parametrize("degree", [2, 3, 4, 5, 8])
def test_chebyshev_precond_launch_splits_agree(system, degree, monkeypatch):
    """The polynomial's steps go out in ceil((degree - 1) / S_MAX)
    ``cheb_steps`` calls of near-equal sizes, one up to degree ``S_MAX +
    1``, and give the bits of the steps composed in one plain call."""
    _, _, _, ad, (r, _, _) = system
    tad, tr = _t(ad), _t(np.where(ad > 0, r, 0).astype(np.float32))
    calls = []
    steps = sk.cheb_steps
    monkeypatch.setattr(sk, "cheb_steps", lambda *a, **k: (
        calls.append(len(a[3])), steps(*a, **k))[1])
    theta, coefs = sk.cheb_coefs(degree)
    z = sk.chebyshev_precond_fused(tad, SCALE, degree=degree)(tr)
    _equal(z, sk.cheb_steps_plain(tad, tr, SCALE, coefs, theta))
    assert len(calls) == -(-(degree - 1) // sk.S_MAX)
    assert sum(calls) == degree - 1 and max(calls) - min(calls) <= 1
    if degree <= sk.S_MAX + 1:
        assert calls == [degree - 1]
