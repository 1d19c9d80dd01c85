"""The port's pressure projection (``ops/pressure.py`` and
``models/flip.py:project``) against the JAX package's, the latter on its
Pallas branch (``pallas_transfer=True``, channel-major velocity) in interpret
mode.

Tolerances: the pressure pieces are the same f32 elementwise expressions,
held to atol/rtol 1e-6 (XLA may contract a multiply-add).  The projection
runs CG to rtol 1e-5 inside a loose outer do-while, so velocities are held
to atol 5e-4, rtol 1e-3 (``tests/test_pallas_stencil.py``'s bound for the
packed projection), and the outer and CG iteration counts must be equal:
both packages test the same predicates on sums that differ only in order.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu.ops import pressure as jpr
from fluidsim_tpu_torch.models import flip as tflip
from fluidsim_tpu_torch.ops import pressure as tpr
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.transfer import normalize_velocity_cm
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.seeding import seed_particles

BOUND = 8
DT = 0.1
G = (0.0, -10.0, 0.0)


@pytest.fixture(scope="module")
def grid():
    """Grid velocity and fluid mask of the seeded cube with a random
    particle velocity field (P2G through the port's plain K1)."""
    scene = get_scene("water_cube_drop", bound=BOUND, density=3.0)
    pos, _ = seed_particles(scene, seed=0)
    rng = np.random.default_rng(11)
    vel = (rng.normal(scale=2.0, size=pos.shape)
           + np.float32([0.0, -4.0, 0.0])).astype(np.float32)
    p, v, flat = tk.sort_by_cell(torch.as_tensor(pos), torch.as_tensor(vel),
                                 BOUND)
    solid = torch.as_tensor(scene.solid)
    w, mom, occ = tk.p2g(tk.masked_weights_cm(p, BOUND), v,
                         tk.cell_starts(flat, 2 * BOUND + 1), solid, BOUND)
    velg = normalize_velocity_cm(w, mom).numpy()
    fluid = ((occ > 0) & ~solid).numpy()
    p0 = rng.normal(scale=0.5, size=fluid.shape).astype(np.float32)
    return scene, velg, fluid, np.asarray(scene.solid), p0


def test_pressure_pieces_match(grid):
    _, velg, fluid, solid, p0 = grid
    jv, jf, js = jnp.asarray(velg), jnp.asarray(fluid), jnp.asarray(solid)
    tv, tf, ts = (torch.as_tensor(velg), torch.as_tensor(fluid),
                  torch.as_tensor(solid))
    jdt, tdt = jnp.float32(DT), torch.tensor(DT)
    close = lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)

    jrhs = jpr.set_rhs(jv, jf, js, jnp.asarray(G, jnp.float32), jdt, 1.0, cm=True)
    trhs = tpr.set_rhs(tv, tf, ts, G, tdt, 1.0)
    close(trhs, jrhs)
    close(tpr.divergence_rhs(tv, trhs, tf, ts, 1.0),
          jpr.divergence_rhs(jv, jrhs, jf, js, 1.0, cm=True))
    close(tpr.laplacian_diag(tf, ts, tdt, 1.0, 1.0),
          jpr.laplacian_diag(jf, js, jdt, 1.0, 1.0))
    close(tpr.vel_update(tv, torch.as_tensor(p0), tf, ts, G, tdt, 1.0, 1.0),
          jpr.vel_update(jv, jnp.asarray(p0), jf, js,
                         jnp.asarray(G, jnp.float32), jdt, 1.0, 1.0, cm=True))


@pytest.mark.parametrize("warm", [False, True])
def test_project_matches_pallas_branch(grid, warm):
    scene, velg, fluid, solid, p0 = grid
    jparams = jflip.FlipParams(bound=BOUND, wall=scene.spec.wall,
                               gravity=G, pallas_transfer=True)
    tparams = tflip.FlipParams(bound=BOUND, wall=scene.spec.wall, gravity=G)
    with pltpu.force_tpu_interpret_mode():
        ref = jflip.project(jparams, jnp.asarray(velg), jnp.asarray(fluid),
                            jnp.asarray(solid), jnp.float32(DT),
                            p0=jnp.asarray(p0) if warm else None, cm=True)
    out = tflip.project(tparams, torch.as_tensor(velg), torch.as_tensor(fluid),
                        torch.as_tensor(solid), torch.tensor(DT),
                        p0=torch.as_tensor(p0) if warm else None)
    jvel, jerr, jn, jcg, jdiv, jp = ref
    tvel, terr, tn, tcg, tdiv, tp_ = out
    assert tn == int(jn) and tn >= 1
    assert tcg == int(jcg) and tcg > 0
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), atol=5e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(float(terr), float(jerr), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(float(tdiv), float(jdiv), atol=1e-5, rtol=1e-3)
    assert float(terr) <= jparams.outer_tol or tn == jparams.max_outer


def test_project_runs_one_pass_at_least(grid):
    """The do-while runs its first pass whatever the tolerance."""
    scene, velg, fluid, solid, _ = grid
    params = tflip.FlipParams(bound=BOUND, wall=scene.spec.wall, gravity=G,
                              outer_tol=1e9)
    out = tflip.project(params, torch.as_tensor(velg), torch.as_tensor(fluid),
                        torch.as_tensor(solid), torch.tensor(DT))
    assert out[2] == 1 and out[3] > 0
    capped = tflip.project(dataclasses.replace(params, outer_tol=0.0,
                                               max_outer=2),
                           torch.as_tensor(velg), torch.as_tensor(fluid),
                           torch.as_tensor(solid), torch.tensor(DT))
    assert capped[2] == 2
