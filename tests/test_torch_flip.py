"""The port's FLIP frame (``models/flip.py``) against the JAX package's
production branch: ``FlipSim`` with ``pallas_transfer=True`` in Pallas
interpret mode, from the same seed.

Tolerances: kinetic energy per frame rtol 1e-4 and final positions atol
1e-3 (f32 transfer and CG sums in another order, compounded over frames);
the outer and CG iteration counts must be equal (same predicates).
Advection is elementwise and selects per particle, so it must agree
exactly.
"""

import inspect

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


def _jax_sim(mode="flip"):
    scene = jget_scene("water_cube_drop", bound=BOUND, density=DENSITY)
    params = jflip.FlipParams(bound=BOUND, wall=scene.spec.wall,
                              dx=scene.spec.dx, gravity=tuple(scene.gravity),
                              pallas_transfer=True, mode=mode)
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


@pytest.mark.parametrize("mode", ["flip", "apic"])
def test_one_frame_from_a_carried_jax_state(mode, request):
    """Start both packages from a JAX state: FLIP's after the run above,
    APIC's (with its affine matrices) after one frame."""
    if mode == "flip":
        jsim = request.getfixturevalue("runs")[0]
    else:
        jsim = _jax_sim("apic")
        with pltpu.force_tpu_interpret_mode():
            jsim.step()
    keys = _STATE_KEYS + (("aff",) if mode == "apic" else ())
    d = {k: np.asarray(getattr(jsim.state, k)) for k in keys}
    state = interop.state_from_numpy(d, device="cpu")
    back = interop.state_to_numpy(state)
    assert set(back) == set(keys)
    for k in keys:
        np.testing.assert_array_equal(back[k], d[k])
    tsim = tflip.FlipSim.from_state(jsim.scene, state, device="cpu",
                                    mode=mode)
    with pltpu.force_tpu_interpret_mode():
        jm = jsim.step()
    tm = tsim.step()
    np.testing.assert_allclose(float(tm["kinetic_energy"]),
                               float(jm["kinetic_energy"]), rtol=1e-4)
    assert tm["outer_iters"] == int(jm["outer_iters"])
    assert tm["cg_iters"] == int(jm["cg_iters"])
    np.testing.assert_allclose(tsim.state.pos.numpy(),
                               np.asarray(jsim.state.pos), atol=1e-3)
    if mode == "apic":
        np.testing.assert_allclose(tsim.state.aff.numpy(),
                                   np.asarray(jsim.state.aff), atol=1e-3)


def test_frame_profile_covers_the_phases():
    """The frame profiler reads the frame's own spans: every phase of an
    APIC frame, the CG's applies and preconditioner, the host waits, with
    the same frames in each of its runs and no module attribute swapped."""
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.utils import frame_profile

    sort = tk.sort_by_cell
    sim = tflip.FlipSim("water_cube_drop", bound=6, density=2.0,
                        device="cpu", mode="apic")
    sim.step()
    out = frame_profile.profile_frames(sim, frames=2)
    waits = {"wait:" + site for site in ("pcg.test", "project.outer",
                                         "project.scale", "upload.max_dt")}
    assert set(out["spans"]) == {"frame", "sort", "weights", "P2G",
                                 "projection", "pcg", "pcg.apply",
                                 "pcg.precond", "G2P", "advection"} | waits
    assert out["spans"]["frame"]["calls_per_frame"] == 1
    assert out["spans"]["pcg.apply"]["calls_per_frame"] > 1
    assert all(v["device_ms"] == 0 for v in out["spans"].values())
    assert out["device_ms_per_frame"] == 0 and out["ms_per_frame"] > 0
    assert out["idle_share"] == 1.0 and out["wait_idle_ms_per_frame"] == 0
    assert out["first_frame"] == 2 and len(out["frame_ms"]) == 2
    assert len(out["cg_iters"]) == 2 and out["cg_iters"][0] > 0
    assert out["host_waits_per_frame"]["pcg.test"] == (
        sum(out["cg_iters"]) + sum(out["outer_iters"])) / 2
    assert tk.sort_by_cell is sort and int(sim.state.frame) == 3


def test_frame_profile_wraps_the_mpm_phases():
    """An MPM frame opens the spans that the frame profiler reports, in
    order, and leaves no module attribute swapped; a run reports the
    frame's fallback and CG counts (one frame outside the profiler: under
    it an MPM frame's thousands of small operations take seconds on the
    CPU, which tests/test_torch_tracing.py spends once)."""
    from fluidsim_tpu_torch.models import mpm
    from fluidsim_tpu_torch.utils import frame_profile, profiling

    pcg = mpm.pcg
    sim = mpm.MpmSim("mpm_cone", density=10.0, device="cpu")
    start = sim.state
    opened = []
    real = profiling.record_function

    class Recorded:
        def __init__(self, name):
            opened.append(name)
            self.range = real(name)

        def __enter__(self):
            return self.range.__enter__()

        def __exit__(self, *exc):
            return self.range.__exit__(*exc)

    profiling.record_function = Recorded
    try:
        with profiling.tracing():
            ms, frame_ms, counts = frame_profile._run(sim, start, 1,
                                                      lambda: None)
    finally:
        profiling.record_function = real
    top = [n for n in opened if not n.startswith(("fs:pcg", "fs:apply",
                                                  "fs:wait", "fs:stress"))]
    assert top == ["fs:" + n for n in (
        "frame", "sort", "stencil", "cell ranges", "chunk plan", "P2G",
        "density", "hardening", "solve", "gradV", "F update", "FLIP delta",
        "advection")]
    assert opened.count("fs:apply.gather") == counts[0][1] + 1
    assert mpm.pcg is pcg and ms > 0 and len(frame_ms) == 1
    assert counts[0][0] == 0 and counts[0][1] > 0      # (spd_fallback, cg)
    assert frame_profile._kind(sim) == "mpm" and int(sim.state.frame) == 1


def test_entry_points_default_to_the_card():
    """No device argument means "cuda", never a pick by availability."""
    for fn in (tflip.FlipSim, tflip.FlipSim.from_state,
               interop.state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


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
