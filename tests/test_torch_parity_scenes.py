"""Frame parity of the port against the JAX package on the scenes beside
the ones the model tests step: FLIP, APIC and PIC on ``pea_fluid`` against
the JAX Pallas branch in interpret mode (the harness of
``tests/test_torch_flip.py``), and MPM on ``mpm_double_balls``,
``mpm_block_drop`` and ``mpm_sphere`` against the JAX fast path (the
bounds of ``tests/test_torch_mpm.py``).

Tolerances: kinetic energy per frame rtol 1e-4 and equal outer and CG
counts in every FLIP mode; positions atol 1e-3 in APIC and PIC; FLIP's
position bound and the fluid cells that may differ are stated in the case.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu.models import mpm as jmpm
from fluidsim_tpu.scenes import get_scene as jget_scene
from fluidsim_tpu_torch.models import flip as tflip
from fluidsim_tpu_torch.models import mpm as tmpm

from test_torch_mpm import _assert_frame_matches

FLIP_SCENE, FLIP_BOUND, FLIP_FRAMES = "pea_fluid", 8, 3
MPM_DENSITY, MPM_FRAMES = 40.0, 5
# the fluid cells of the two packages may differ only where the occupancy
# is f32 noise in both (see test_flip_scene_matches_pallas_branch)
NOISE_OCCUPANCY = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's CPU frames, as in the other
    frame modules: the MPM frames run thousands of small grid operations."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["flip", "apic", "pic"])
def flip_runs(request):
    mode = request.param
    scene = jget_scene(FLIP_SCENE, bound=FLIP_BOUND)
    params = jflip.FlipParams(bound=FLIP_BOUND, wall=scene.spec.wall,
                              dx=scene.spec.dx, gravity=tuple(scene.gravity),
                              pallas_transfer=True, mode=mode)
    jsim = jflip.FlipSim(scene, params=params, seed=0)
    tsim = tflip.FlipSim(FLIP_SCENE, bound=FLIP_BOUND, device="cpu",
                         mode=mode)
    assert tsim.params.walls_only_solid and jsim.params.walls_only_solid
    np.testing.assert_array_equal(tsim.state.pos.numpy(),
                                  np.asarray(jsim.state.pos))
    jm, tm = [], []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(FLIP_FRAMES):
            jm.append(jsim.step())
            tm.append(tsim.step())
    return mode, jsim, tsim, jm, tm


def test_flip_scene_matches_pallas_branch(flip_runs):
    mode, jsim, tsim, jm, tm = flip_runs
    assert set(tm[0]) == set(jm[0])
    apart_cells = 0
    for f, (j, t) in enumerate(zip(jm, tm)):
        np.testing.assert_allclose(float(t["kinetic_energy"]),
                                   float(j["kinetic_energy"]), rtol=1e-4,
                                   err_msg=f"frame {f}")
        assert t["outer_iters"] == int(j["outer_iters"]), f
        assert t["cg_iters"] == int(j["cg_iters"]), f
        np.testing.assert_allclose(float(t["dt"]), float(j["dt"]), rtol=1e-5)
        jocc, tocc = np.asarray(j["occupancy"]), t["occupancy"].numpy()
        apart = (jocc > 0) != (tocc > 0)
        assert np.abs(jocc[apart]).max(initial=0) < NOISE_OCCUPANCY, f
        assert np.abs(tocc[apart]).max(initial=0) < NOISE_OCCUPANCY, f
        assert abs(int(t["num_fluid_cells"]) - int(j["num_fluid_cells"])) \
            <= int(apart.sum()), f
        apart_cells += int(apart.sum())
    assert tm[1]["cg_iters"] > 0
    tpos, jpos = tsim.state.pos.numpy(), np.asarray(jsim.state.pos)
    if mode == "flip":
        # Two cells of frame 2 hold an occupancy of a few 1e-9 whose sign
        # the jitted JAX spline and the port's (bitwise equal to the eager
        # JAX one) round apart near |x| = 1, so they are fluid in one
        # package only; the projection then differs there, and FLIP carries
        # the velocity difference into the positions (measured 1.75e-3 after
        # 3 frames).  Every other check holds as on water_cube_drop.
        atol = 2.5e-3
    else:
        assert apart_cells == 0
        atol = 1e-3
    np.testing.assert_allclose(tpos, jpos, atol=atol)
    assert np.isfinite(tpos).all() and np.abs(tpos).max() < FLIP_BOUND


@pytest.mark.parametrize("scene", ["mpm_double_balls", "mpm_block_drop",
                                   "mpm_sphere"])
def test_mpm_scene_matches_fast_path(scene):
    jsim = jmpm.MpmSim(scene, density=MPM_DENSITY,
                       params=jmpm.MpmParams(fast_transfer=True))
    tsim = tmpm.MpmSim(scene, density=MPM_DENSITY, device="cpu")
    np.testing.assert_array_equal(tsim.state.pos.numpy(),
                                  np.asarray(jsim.state.pos))
    assert tsim.params.hessian == "full" and tsim.params.walls_only_solid
    for _ in range(MPM_FRAMES):
        j, t = jsim.step(), tsim.step()
        _assert_frame_matches(t, j, tsim, jsim, 1)
        assert t["cg_iters"] > 0 and t["spd_fallback"] == 0
        assert float(t["min_det_fp"]) > 0
    assert int(tsim.state.frame) == MPM_FRAMES
