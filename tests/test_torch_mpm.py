"""The port's MPM frame (``models/mpm.py``) against the JAX package's
``mpm_step`` and against the C++ oracle, at ``mpm_cone`` bound 15.

- Five frames from the seed against the JAX fast path
  (``MpmParams(fast_transfer=True)``, XLA).
- One frame of the Pallas branch (``pallas_transfer=True`` in interpret
  mode) with ``hessian="full"`` and one with ``hessian="hybrid",
  cg_hybrid_cap=1``, which must take the SPD fallback; both from the fast
  path's state after 3 frames, carried into the port by ``interop``.
- The kinetic-energy trace of ``native/ref_mpm``, as
  ``tests/test_ke_parity.py`` holds the JAX package to it.

Tolerances are the JAX package's own for its Pallas frame
(``tests/test_mpm_pallas.py``): kinetic energy rtol 1e-4, equal
``num_active_cells``, positions atol 1e-4, FE atol 1e-5; and equal
``spd_fallback`` with ``cg_iters`` within 1 per solve, since f32 sums in
another order can move CG's stopping test by one iteration.  Measured: the
five fast-path frames agree in every iteration count (12-14), kinetic
energy within 2.3e-5 relative, positions within 3.8e-6 and FE within
2.6e-6 after frame 5; the two Pallas frames in iteration counts (13; 14
with the fallback), kinetic energy within 1.1e-7 relative, positions
within 9.6e-7 and FE within 7.2e-7; against ``ref_mpm`` (1,545
particles) the median relative KE error is 5.3e-5, the largest 1.3e-4.
"""

import inspect
import json
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.models import mpm as jmpm
from fluidsim_tpu_torch import interop
from fluidsim_tpu_torch.models import mpm as tmpm

DENSITY = 40.0
_MPM_KEYS = ("pos", "vel", "FE", "FP", "volume", "dt", "t", "frame")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_MPM = os.path.join(HERE, "native", "ref_mpm")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's CPU frames: they run thousands
    of small grid operations, and with the other test processes on the same
    cores, spreading each over every core costs far more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_state(sim):
    return {k: np.array(getattr(sim.state, k)) for k in _MPM_KEYS}


def _assert_frame_matches(t, j, tsim, jsim, solves):
    np.testing.assert_allclose(float(t["kinetic_energy"]),
                               float(j["kinetic_energy"]), rtol=1e-4)
    assert int(t["num_active_cells"]) == int(j["num_active_cells"])
    assert t["spd_fallback"] == int(j["spd_fallback"])
    assert abs(t["cg_iters"] - int(j["cg_iters"])) <= solves
    np.testing.assert_allclose(float(t["dt"]), float(j["dt"]), rtol=1e-5)
    np.testing.assert_allclose(tsim.state.pos.numpy(),
                               np.asarray(jsim.state.pos), atol=1e-4)
    np.testing.assert_allclose(tsim.state.FE.numpy(),
                               np.asarray(jsim.state.FE), atol=1e-5)


@pytest.fixture(scope="module")
def fast_runs():
    """Five frames of the JAX fast path and of the port from seed 0, with
    the JAX state after frame 3."""
    jsim = jmpm.MpmSim("mpm_cone", density=DENSITY,
                       params=jmpm.MpmParams(fast_transfer=True))
    tsim = tmpm.MpmSim("mpm_cone", density=DENSITY, device="cpu")
    np.testing.assert_array_equal(tsim.state.pos.numpy(),
                                  np.asarray(jsim.state.pos))
    assert tsim.params.hessian == "full" and tsim.params.walls_only_solid
    jm, tm, after3 = [], [], None
    for f in range(5):
        jm.append(jsim.step())
        tm.append(tsim.step())
        _assert_frame_matches(tm[-1], jm[-1], tsim, jsim, 1)
        if f == 2:
            after3 = _jax_state(jsim)
    return jm, tm, after3


def test_frames_match_fast_path(fast_runs):
    jm, tm, _ = fast_runs
    # the port's one count beyond the JAX package's: the SPD solve's own
    # iterations
    assert set(tm[0]) == set(jm[0]) | {"spd_iters"}
    assert all(m["cg_iters"] > 0 and m["spd_fallback"] == 0
               and m["spd_iters"] == 0 for m in tm)
    assert all(float(m["min_det_fp"]) > 0 for m in tm)


@pytest.mark.parametrize("hessian", ["full", "hybrid"])
def test_frame_matches_pallas_branch(fast_runs, hessian):
    """Each frame must match the Pallas branch (see the module docstring
    for the measured differences); the capped hybrid frame must fall
    back."""
    *_, after3 = fast_runs
    cap = dict(cg_hybrid_cap=1) if hessian == "hybrid" else {}
    jsim = jmpm.MpmSim("mpm_cone", density=DENSITY, params=jmpm.MpmParams(
        pallas_transfer=True, pallas_interpret=True, hessian=hessian, **cap))
    jsim.state = jmpm.MpmState(**{k: jnp.asarray(v) for k, v in after3.items()})
    tsim = tmpm.MpmSim("mpm_cone", density=DENSITY, device="cpu",
                       params=tmpm.MpmParams(hessian=hessian, **cap))
    tsim.state = interop.mpm_state_from_numpy(after3, device="cpu")
    jm, tm = jsim.step(), tsim.step()
    solves = 1 + tm["spd_fallback"]
    _assert_frame_matches(tm, jm, tsim, jsim, solves)
    assert tm["spd_fallback"] == (1 if hessian == "hybrid" else 0)
    assert int(tsim.state.frame) == 4


def test_mpm_state_round_trip(fast_runs):
    *_, after3 = fast_runs
    state = interop.mpm_state_from_numpy(after3, device="cpu")
    assert state.frame.dtype == torch.int32 and state.volume.shape == (
        after3["pos"].shape[0],)
    back = interop.mpm_state_to_numpy(state)
    assert set(back) == set(_MPM_KEYS)
    for k in _MPM_KEYS:
        np.testing.assert_array_equal(back[k], after3[k])
    assert (after3["volume"] > 0).all()     # set at frame 0, carried since


def test_entry_points_default_to_the_card():
    for fn in (tmpm.MpmSim, interop.mpm_state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_params_and_run():
    with pytest.raises(ValueError):
        tmpm.MpmParams(hessian="newton")
    assert tmpm.MpmParams(bound=15).operator == "full"
    assert tmpm.MpmParams(bound=63).operator == "hybrid"
    sim = tmpm.MpmSim("mpm_cone", density=10.0, device="cpu")
    seen = []
    out = sim.run(2, callback=lambda f, s, m: seen.append(f))
    assert seen == [0, 1] and np.isfinite(float(out["kinetic_energy"]))
    assert sim.num_particles == sim.state.FE.shape[0]


def _build_ref_mpm():
    if not os.path.exists(REF_MPM):
        try:
            subprocess.check_call(["make", "-C", os.path.dirname(REF_MPM),
                                   os.path.basename(REF_MPM)],
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL)
        except (OSError, subprocess.CalledProcessError):
            return False
    return os.path.exists(REF_MPM)


def test_mpm_ke_trace_matches_cpp_port(tmp_path):
    """The port's CPU path against ``native/ref_mpm`` on the reference
    cone (bound 15, density 100), 12 frames, with the JAX package's own
    bounds (``tests/test_ke_parity.py``)."""
    if not _build_ref_mpm():
        pytest.skip("ref_mpm not buildable")
    frames = 12
    sim = tmpm.MpmSim("mpm_cone", density=100.0, device="cpu")
    pfile = str(tmp_path / "particles.f32")
    np.ascontiguousarray(sim.state.pos.numpy()).tofile(pfile)
    out = subprocess.check_output([REF_MPM, "15", "100", str(frames), pfile],
                                  text=True)
    cpp = [json.loads(l) for l in out.strip().splitlines() if l.startswith("{")]
    assert len(cpp) == frames
    ke, dt = [], []
    for _ in range(frames):
        m = sim.step()
        ke.append(float(m["kinetic_energy"]))
        dt.append(float(m["dt"]))
    ke_cpp = np.asarray([r["ke"] for r in cpp])
    rel = np.abs(np.asarray(ke) - ke_cpp) / np.maximum(ke_cpp, 1.0)
    assert np.median(rel) < 5e-4, f"MPM KE mismatch: {rel}"
    assert rel.max() < 5e-3, f"MPM KE mismatch: {rel}"
    np.testing.assert_allclose(dt, [r["dt"] for r in cpp], rtol=1e-4)
