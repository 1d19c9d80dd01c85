"""The port's level-set utilities (``fluidsim_tpu_torch/ops/levelset.py``)
against the JAX package's, within 1e-6: the particle surface (the CLI's
``--surface``), fog conversion, enclosed volume, the analytic SDFs and
the CSG operations, on the same inputs made from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.ops import levelset as jls
from fluidsim_tpu_torch.ops import levelset as ls

TOL = 1e-6


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("bound,npart,spread", [(8, 400, 6.0), (6, 50, 9.0)])
def test_particles_to_levelset_and_fog(bound, npart, spread):
    # particles inside the box and past its edge (out-of-box neighbours)
    rng = np.random.default_rng(bound)
    pos = rng.uniform(-spread, spread, size=(npart, 3)).astype(np.float32)
    pos[:5] = np.round(pos[:5]) + 0.5          # half-way rounding cases
    ref = jls.particles_to_levelset(jnp.asarray(pos), bound)
    out = ls.particles_to_levelset(torch.as_tensor(pos), bound)
    assert out.shape == (2 * bound + 1,) * 3 and out.dtype == torch.float32
    _close(out, ref)
    _close(ls.sdf_to_fog(out), jls.sdf_to_fog(ref))
    _close(ls.sdf_to_fog(out, 2.5), jls.sdf_to_fog(ref, 2.5))
    np.testing.assert_allclose(float(ls.levelset_volume(out, 0.5)),
                               float(jls.levelset_volume(ref, 0.5)),
                               rtol=TOL)


def test_sdfs_and_csg():
    bound = 7
    n = 2 * bound + 1
    s = ls.sphere_sdf((n,) * 3, bound, (1.0, -2.0, 0.5), 4.0, device="cpu")
    js = jls.sphere_sdf((n,) * 3, bound, (1.0, -2.0, 0.5), 4.0)
    b = ls.box_sdf((n,) * 3, bound, (-3, -2, -4), (2, 5, 1), device="cpu")
    jb = jls.box_sdf((n,) * 3, bound, (-3, -2, -4), (2, 5, 1))
    _close(s, js)
    _close(b, jb)
    _close(ls.csg_union(s, b), jls.csg_union(js, jb))
    _close(ls.csg_intersection(s, b), jls.csg_intersection(js, jb))
    _close(ls.csg_difference(s, b), jls.csg_difference(js, jb))
    _close(ls.offset(s, -1.5), jls.offset(js, -1.5))
    for a, c in zip(ls.fracture(s, b), jls.fracture(js, jb)):
        _close(a, c)
