"""The MPM frame's 3x3 chain as the port lays it out around its CUDA kernels
(``csrc/mat3.cu``), on the CPU, where every wrapper takes its plain
version: the fused apply ``StressDifferential.apply`` returns the bits of
the chain it replaces, ``scale * mm3(dP(mm3(g, FE)), FE^T)``; the plain
chain stays sound on the edge cases the kernels are held to on the card
(``chip_smoke.py`` phase 38); the factor rows' layout; the wrappers'
device rule; and ``native``'s list of entry points against the sources.

The kernels themselves run on the card only: ``chip_smoke.py`` holds each
to its plain version bit for bit there.
"""

import re

import numpy as np
import pytest
import torch

from fluidsim_tpu_torch import native
from fluidsim_tpu_torch.ops import svd3
from fluidsim_tpu_torch.utils import synthetic

ROWS = 1003
LO, HI = 0.975, 1.0075          # the F update's clamp: 1 - theta_c, 1 + theta_s
SINGULAR = ("near_singular", "zero", "rank1", "rank2")


def _inputs(kind, seed=0):
    """FE of ``kind`` as a view of a 19-column row (the sort's payload),
    with mu, lam, a (9, P) gather, the scale and the payload."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    payload = t(rng.normal(size=(ROWS, 19)))
    payload[:, 0:9] = t(synthetic.mat3_cases(kind, ROWS, seed)).reshape(
        ROWS, 9)
    fe = payload[:, 0:9].reshape(ROWS, 3, 3)
    mu, lam = svd3.hardening(16326.5, 255782.0, 10.0,
                             t(rng.uniform(0.9, 1.1, ROWS)))
    return fe, mu, lam, t(rng.normal(size=(9, ROWS))), t(
        -rng.uniform(0.0, 2.0, ROWS))


@pytest.mark.parametrize("kind", ["near_identity", "random", "zero_offdiag"])
@pytest.mark.parametrize("hessian", ["full", "spd"])
def test_apply_returns_the_bits_of_the_chain_it_fuses(kind, hessian):
    fe, mu, lam, g9, scale = _inputs(kind)
    assert not fe.is_contiguous()
    _, dfull, dspd = svd3.piola_linearized(fe, mu, lam)
    dp = dfull if hessian == "full" else dspd
    g = g9.reshape(3, 3, -1).permute(2, 0, 1)
    sigma = svd3.mm3(dp(svd3.mm3(g, fe)), fe.transpose(-1, -2))
    old = (scale[:, None] * sigma.reshape(ROWS, 9)).contiguous()
    new = dp.apply(g9, scale)
    assert new.shape == (ROWS, 9) and new.is_contiguous()
    np.testing.assert_array_equal(new.numpy().view(np.int32),
                                  old.numpy().view(np.int32))
    np.testing.assert_array_equal(dp.apply_plain(g9, scale).numpy(),
                                  new.numpy())


@pytest.mark.parametrize("kind", synthetic.MAT3_KINDS)
def test_plain_chain_on_the_kernels_cases(kind):
    """On every kind the card's checks use: svd3's factors are finite and
    orthonormal, s descending and non-negative, ``U diag(s) V^T`` gives F
    back; the polar stress, the clamp and both differentials are finite.
    Where a singular value is 0 or below sqrt(eps) max|F|, U's second
    column comes from Gram-Schmidt on a column of F V that is rounding
    noise, orthogonal to the first only to ~1e-5 (as in the JAX package,
    whose U the CPU tests compare only where the values are separated)."""
    f = torch.as_tensor(synthetic.mat3_cases(kind, ROWS))
    u, s, vt = svd3.svd3(f)
    for x in (u, s, vt):
        assert bool(torch.isfinite(x).all())
    eye = np.broadcast_to(np.eye(3), (ROWS, 3, 3))
    un, vn = u.double().numpy(), vt.double().numpy()
    np.testing.assert_allclose(un.transpose(0, 2, 1) @ un, eye,
                               atol=1e-4 if kind in SINGULAR else 1e-5)
    np.testing.assert_allclose(vn @ vn.transpose(0, 2, 1), eye, atol=1e-5)
    sn = s.double().numpy()
    assert (sn >= 0).all() and (np.diff(sn, axis=-1) <= 0).all()
    fn = f.double().numpy()
    scale = np.abs(fn).max(axis=(1, 2), keepdims=True) + 1e-30
    recon = un @ (sn[..., None] * vn)
    assert (np.abs(recon - fn) / scale).max() < 5e-4
    if kind not in SINGULAR:
        np.testing.assert_allclose(np.linalg.det(un @ vn),
                                   np.sign(np.linalg.det(fn)), atol=1e-4)
    fe, mu, lam, g9, sc = _inputs(kind)
    p0, dfull, dspd = svd3.piola_linearized(fe, mu, lam)
    outs = [p0, dfull.apply(g9, sc), dspd.apply(g9, sc),
            *svd3.clamp_singular(fe, LO, HI)]
    assert all(bool(torch.isfinite(x).all()) for x in outs)


def test_factor_rows_unpack_as_views():
    """``factor_rows`` lays the plain factors out as the (25, P) rows the
    polar-stress kernel writes: sliced by ``FACTOR_ROWS`` they unpack as
    views of the rows into R, the six entries of S that ``polar_delta``
    reads, cof and J."""
    fe, mu, lam, _, _ = _inputs("random")
    _, d, _ = svd3.piola_linearized_plain(fe, mu, lam)
    r, s, cof, j = d.factors
    fac = svd3.factor_rows(r, s, cof, j)
    assert fac.shape == (25, ROWS)
    assert sorted(i for rows in svd3.FACTOR_ROWS.values()
                  for i in rows) == list(range(25))
    got = {k: fac[rows.start:rows.stop]
           for k, rows in svd3.FACTOR_ROWS.items()}
    want = {"R": r.reshape(ROWS, 9).T, "cof": cof.reshape(ROWS, 9).T,
            "S": torch.stack([s[:, i, k] for i, k in svd3.S_ENTRIES]),
            "J": j[None]}
    for k, a in got.items():
        assert a.untyped_storage().data_ptr() == fac.untyped_storage(
        ).data_ptr()
        np.testing.assert_array_equal(a.numpy(), want[k].numpy())
    # polar_delta reads those six alone: S's lower entries (equal to the
    # upper ones only up to rounding) may be anything
    upper = torch.triu(torch.ones(3, 3, dtype=torch.bool))
    s_upper = torch.where(upper, s, torch.nan)
    df = torch.as_tensor(synthetic.mat3_cases("random", ROWS, 1))
    np.testing.assert_array_equal(svd3.polar_delta(r, s_upper, df).numpy(),
                                  svd3.polar_delta(r, s, df).numpy())


def test_wrappers_take_the_plain_version_on_cpu_only():
    fe, mu, lam, g9, scale = _inputs("near_identity")
    wrappers = (svd3.mm3, svd3.piola_linearized, svd3.clamp_singular)
    before = ([fn.launches for fn in wrappers],
              dict(svd3.StressDifferential.launches))
    np.testing.assert_array_equal(svd3.mm3(fe, fe.transpose(-1, -2)).numpy(),
                                  svd3.mm3_plain(fe, fe.transpose(-1, -2))
                                  .numpy())
    for a, b in zip(svd3.clamp_singular(fe, LO, HI),
                    svd3.clamp_singular_plain(fe, LO, HI)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    p0, dfull, _ = svd3.piola_linearized(fe, mu, lam)
    q0, qfull, _ = svd3.piola_linearized_plain(fe, mu, lam)
    np.testing.assert_array_equal(p0.numpy(), q0.numpy())
    assert not isinstance(dfull.factors, torch.Tensor)
    np.testing.assert_array_equal(dfull.apply(g9, scale).numpy(),
                                  qfull.apply_plain(g9, scale).numpy())
    assert ([fn.launches for fn in wrappers],
            svd3.StressDifferential.launches) == before
    meta = lambda *xs: [x.to("meta") for x in xs]
    with pytest.raises(ValueError):
        svd3.mm3(*meta(fe, fe))
    with pytest.raises(ValueError):
        svd3.piola_linearized(*meta(fe, mu, lam))
    with pytest.raises(ValueError):
        svd3.clamp_singular(*meta(fe), LO, HI)
    kernel_dp = svd3.StressDifferential(False, *meta(fe, mu, lam),
                                        torch.zeros(25, ROWS, device="meta"))
    with pytest.raises(ValueError):
        kernel_dp.apply(*meta(g9, scale))
    # the kernel's factor rows serve the fused apply only
    with pytest.raises(TypeError):
        kernel_dp(fe.to("meta"))
    # plain factors have no rows for the kernel to read
    with pytest.raises(ValueError):
        qfull.apply(*meta(g9, scale))
    # a (P, 3, 3) f32 operand in any layout, nothing else
    g = g9.reshape(3, 3, -1).permute(2, 0, 1)
    for ok in (fe, fe.transpose(-1, -2), fe.contiguous(), g):
        assert svd3._mat_strides("a", ok, ROWS, ok.device) == ok.stride()
    for bad, err in ((fe[:-1], ValueError), (fe.double(), TypeError),
                     (g9, ValueError)):
        with pytest.raises(err):
            svd3._mat_strides("a", bad, ROWS, bad.device)


@pytest.mark.parametrize("source", native.SOURCES)
def test_native_binds_every_entry_point_of_each_source(source):
    """Each ``extern "C"`` function of a source is in ``_SIGNATURES`` with
    as many arguments as it takes; the 3x3 chain's four are listed."""
    text = (native.CSRC / source).read_text()
    found = {name: len([a for a in args.split(",") if a.strip()])
             for name, args in re.findall(
                 r'extern "C" int (fs_\w+)\(([^)]*)\)', text)}
    assert found
    for name, nargs in found.items():
        assert len(native._SIGNATURES[name]) == nargs, name
    if source == "mat3.cu":
        assert set(found) == {"fs_polar_stress", "fs_stress_apply",
                              "fs_clamp_singular", "fs_mm3"}
