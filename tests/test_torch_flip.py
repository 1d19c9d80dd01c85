"""The port's FLIP frame (``models/flip.py``) against the JAX package's
production branch: ``FlipSim`` with ``pallas_transfer=True`` in Pallas
interpret mode, from the same seed.

Tolerances: kinetic energy per frame rtol 1e-4 and final positions atol
1e-3 (f32 transfer and CG sums in another order, compounded over frames);
the outer and CG iteration counts must be equal (same predicates).
Advection is elementwise and selects per particle, so it must agree
exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu.scenes import get_scene as jget_scene
from fluidsim_tpu_torch import interop
from fluidsim_tpu_torch import scenes as tscenes
from fluidsim_tpu_torch.models import flip as tflip

BOUND, DENSITY, FRAMES = 8, 3.0, 3
_STATE_KEYS = ("pos", "vel", "dt", "t", "frame", "pressure")


def _jax_sim():
    scene = jget_scene("water_cube_drop", bound=BOUND, density=DENSITY)
    params = jflip.FlipParams(bound=BOUND, wall=scene.spec.wall,
                              dx=scene.spec.dx, gravity=tuple(scene.gravity),
                              pallas_transfer=True)
    return jflip.FlipSim(scene, params=params, seed=0)


@pytest.fixture(scope="module")
def runs():
    jsim = _jax_sim()
    tsim = tflip.FlipSim("water_cube_drop", bound=BOUND, density=DENSITY,
                         device="cpu")
    assert tsim.params.walls_only_solid and jsim.params.walls_only_solid
    np.testing.assert_array_equal(tsim.state.pos.numpy(),
                                  np.asarray(jsim.state.pos))
    jm, tm = [], []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(FRAMES):
            jm.append(jsim.step())
            tm.append(tsim.step())
    return jsim, tsim, jm, tm


def test_frames_match_pallas_branch(runs):
    jsim, tsim, jm, tm = runs
    assert set(tm[0]) == set(jm[0])
    for f, (j, t) in enumerate(zip(jm, tm)):
        np.testing.assert_allclose(float(t["kinetic_energy"]),
                                   float(j["kinetic_energy"]), rtol=1e-4,
                                   err_msg=f"frame {f}")
        assert t["outer_iters"] == int(j["outer_iters"]), f
        assert t["cg_iters"] == int(j["cg_iters"]), f
        assert int(t["num_fluid_cells"]) == int(j["num_fluid_cells"]), f
        np.testing.assert_allclose(float(t["dt"]), float(j["dt"]), rtol=1e-5)
    assert tm[1]["cg_iters"] > 0
    np.testing.assert_allclose(tsim.state.pos.numpy(),
                               np.asarray(jsim.state.pos), atol=1e-3)
    assert int(tsim.state.frame) == FRAMES
    pos = tsim.state.pos.numpy()
    assert np.isfinite(pos).all() and np.abs(pos).max() < BOUND


def test_one_frame_from_a_carried_jax_state(runs):
    """Start both packages from the JAX state after the run above."""
    jsim, *_ = runs
    d = {k: np.asarray(getattr(jsim.state, k)) for k in _STATE_KEYS}
    state = interop.state_from_numpy(d, device="cpu")
    back = interop.state_to_numpy(state)
    for k in _STATE_KEYS:
        np.testing.assert_array_equal(back[k], d[k])
    tsim = tflip.FlipSim.from_state(jsim.scene, state, device="cpu")
    with pltpu.force_tpu_interpret_mode():
        jm = jsim.step()
    tm = tsim.step()
    np.testing.assert_allclose(float(tm["kinetic_energy"]),
                               float(jm["kinetic_energy"]), rtol=1e-4)
    assert tm["outer_iters"] == int(jm["outer_iters"])
    assert tm["cg_iters"] == int(jm["cg_iters"])
    np.testing.assert_allclose(tsim.state.pos.numpy(),
                               np.asarray(jsim.state.pos), atol=1e-3)


@pytest.mark.parametrize("name,bound,analytic", [
    ("water_cube_drop", BOUND, True),       # walls only: coordinate tests
    ("water_cube_drop", BOUND, False),      # the grid probe on the same walls
    ("two_blocks", 60, False)])             # the grid probe with obstacles
def test_advect_bounce_exact(name, bound, analytic):
    scene = jget_scene(name, bound=bound)
    rng = np.random.default_rng(3)
    pos = rng.uniform(-(bound - 1), bound - 1, size=(2000, 3)).astype(np.float32)
    vel = rng.normal(scale=15.0, size=pos.shape).astype(np.float32)
    wall = scene.spec.wall if analytic else None
    for e in (0.0, 0.5):
        jp, jv = jflip.advect_bounce(jnp.asarray(pos), jnp.asarray(vel),
                                     jnp.float32(0.1), jnp.asarray(scene.solid),
                                     bound, e, "round", analytic_wall=wall)
        tp_, tv = tflip.advect_bounce(torch.as_tensor(pos), torch.as_tensor(vel),
                                      torch.tensor(0.1),
                                      torch.as_tensor(scene.solid), bound, e,
                                      "round", analytic_wall=wall)
        np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_run_checks_finite_and_calls_back():
    sim = tflip.FlipSim("water_cube_drop", bound=6, density=2.0, device="cpu")
    seen = []
    out = sim.run(2, callback=lambda f, s, m: seen.append(f))
    assert seen == [0, 1] and np.isfinite(float(out["kinetic_energy"]))
    # the analytic probe only where the solid is exactly the walls
    assert sim.params.walls_only_solid
    assert not tflip._auto_params(tscenes.get_scene("two_blocks"),
                                  None).walls_only_solid
