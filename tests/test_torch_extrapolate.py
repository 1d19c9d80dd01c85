"""The port's ``ops/extrapolate.py`` and ``cell_center_velocity`` against
the JAX package's.

Every function here is elementwise arithmetic, shifts, selections and a
sort, in the JAX functions' order, so each is held bit for bit.  The JAX
``extrapolate`` ignores its ``max_layers``; the port caps the sweeps with
it, so a small cap is held to a numpy loop over the same definition.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fluidsim_tpu.core import gridspec as jgs
from fluidsim_tpu.ops import extrapolate as jex
from fluidsim_tpu_torch.core import gridspec as tgs
from fluidsim_tpu_torch.ops import extrapolate as tex


def _field(n, seed, frac):
    rng = np.random.default_rng(seed)
    vel = rng.normal(size=(n, n, n, 3)).astype(np.float32)
    defined = rng.random((n, n, n)) < frac
    return vel, defined


def test_cell_center_velocity_matches_jax():
    vel, _ = _field(11, 0, 0.5)
    out = tgs.cell_center_velocity(torch.as_tensor(vel))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jgs.cell_center_velocity(jnp.asarray(vel))))
    # the (N,N,N,3) twin of the channel-major version
    cm = tgs.cell_center_velocity_cm(torch.as_tensor(vel).permute(3, 0, 1, 2))
    assert torch.equal(out, cm.permute(1, 2, 3, 0))


@pytest.mark.parametrize("n, seed, frac", [(9, 0, 0.02), (12, 1, 0.3),
                                           (15, 2, 0.002), (10, 3, 0.0)])
def test_extrapolate_matches_jax(n, seed, frac):
    """The default cap floods the box as the JAX loop does; (15, 2) seeds a
    single cell in a corner region, (10, 3) none at all."""
    vel, defined = _field(n, seed, frac)
    if seed == 2:
        defined[:] = False
        defined[1, 2, 1] = True
    tv, td = tex.extrapolate(torch.as_tensor(vel), torch.as_tensor(defined))
    jv, jd = jex.extrapolate(jnp.asarray(vel), jnp.asarray(defined))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert bool(td.all()) == bool(defined.any())


def _extrapolate_loop(vel, defined, layers):
    """``layers`` sweeps, cell by cell: an undefined cell with a defined
    27-neighbour takes the mean of those neighbours (f64)."""
    v, d = vel.astype(np.float64), defined.copy()
    n = v.shape[0]
    for _ in range(layers):
        v2, d2 = v.copy(), d.copy()
        for c in np.argwhere(~d):
            lo, hi = np.maximum(c - 1, 0), np.minimum(c + 2, n)
            dm = d[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
            if dm.any():
                nb = v[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]][dm]
                v2[tuple(c)] = nb.mean(axis=0)
                d2[tuple(c)] = True
        v, d = v2, d2
    return v, d


@pytest.mark.parametrize("layers", [0, 1, 2])
def test_extrapolate_cap_is_its_definition(layers):
    vel, defined = _field(9, 4, 0.01)
    tv, td = tex.extrapolate(torch.as_tensor(vel), torch.as_tensor(defined),
                             max_layers=layers)
    rv, rd = _extrapolate_loop(vel, defined, layers)
    np.testing.assert_array_equal(td.numpy(), rd)
    np.testing.assert_allclose(tv.numpy(), rv, rtol=1e-6, atol=1e-6)
    assert not bool(td.all())          # the cap stopped the flood
    np.testing.assert_array_equal(tv.numpy()[defined], vel[defined])


def test_mac_conversions_match_jax():
    vel, _ = _field(10, 5, 0.5)
    for name in ("to_collocated", "to_staggered"):
        out = getattr(tex, name)(torch.as_tensor(vel))
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(getattr(jex, name)(jnp.asarray(vel))),
            err_msg=name)
    np.testing.assert_array_equal(
        tex.to_collocated(torch.as_tensor(vel)).numpy(),
        tgs.cell_center_velocity(torch.as_tensor(vel)).numpy())


@pytest.mark.parametrize("cap", [1, 3])
def test_resample_mask_matches_jax(cap):
    rng = np.random.default_rng(6)
    pos = rng.uniform(-4.6, 4.6, size=(3000, 3)).astype(np.float32)
    pos[:5] = 0.5                       # C rounding: half away from zero
    keep = tex.resample_mask(torch.as_tensor(pos), 4, cap)
    np.testing.assert_array_equal(
        keep.numpy(), np.asarray(jex.resample_mask(jnp.asarray(pos), 4, cap)))
    assert 0 < int(keep.sum()) < pos.shape[0]
