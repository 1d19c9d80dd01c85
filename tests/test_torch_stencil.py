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


@pytest.mark.parametrize("degree", [2, 3, 4])
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
    before = (sk.apply_laplacian.launches, sk.cheb_step.launches)
    np.testing.assert_array_equal(
        sk.apply_laplacian(_t(z), _t(ad), SCALE).numpy(),
        sk.apply_laplacian_plain(_t(z), _t(ad), SCALE).numpy())
    assert (sk.apply_laplacian.launches, sk.cheb_step.launches) == before
    meta = [_t(a).to("meta") for a in (z, ad, r, d)]
    with pytest.raises(ValueError):
        sk.apply_laplacian(meta[0], meta[1], SCALE)
    with pytest.raises(ValueError):
        sk.cheb_step(*meta, SCALE, 0.5, 0.5)
