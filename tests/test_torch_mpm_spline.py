"""The port's MPM frame on the FLIP transfer spline
(``MpmParams(kernel="flip")``) against the JAX package's naive path, the
one JAX path that honours the field: ``mpm_cone`` at bound 15, density 40
(619 particles), 3 frames from the seed, and a config with ``wall = bound
- 1``.

On the CPU the JAX ``MpmSim`` resolves to the naive path
(``pallas_transfer`` False, ``fast_transfer`` False), which the tests
assert.  Its mass P2G keeps the positive weights over the non-solid cells,
its momentum and stiffness P2G the non-solid cells within ``|c| <= bound -
2``; the port follows both (``mpm_kernels.p2g_flip_spline``).

Tolerances are ``tests/test_torch_mpm.py``'s ``_assert_frame_matches``
(kinetic energy rtol 1e-4, equal active cells and SPD fallbacks, dt rtol
1e-5, positions atol 1e-4, FE atol 1e-5), except for the CG count, which
is held within 5% of JAX's (and at least one iteration per solve).  On
the FLIP spline the count moves with last-bit differences in the sums:
at frame 2 of the "none" case the port stops at 69 here, 68 on another
CPU and 66 on an H100 (``chip_smoke.py`` phase 36c), JAX at 66, with the
kinetic energies within 4e-7.

Measured against JAX (port / JAX):

- ``precond="none"``: CG 21/21, 32/33, 69/66; kinetic energy within
  3.8e-7 relative, positions within 9.5e-7, FE within 1.6e-6.
- ``precond="jacobi"``: CG 49/49, 91/93, 93/96; kinetic energy within
  2.8e-7, positions 1.9e-6, FE 1.8e-6.  Frames 4 and 5 give 92/92 and
  108/106 (kinetic energy within 1.3e-6); with one K1 on the FLIP table
  for both mass and momentum (no positive-weight mass) frame 4 gives 98
  against 92.
- ``hessian="hybrid", cg_hybrid_cap=20``: every frame takes the SPD
  fallback on both sides; CG 41/41, 54/55, 99/100; kinetic energy within
  3.8e-7, positions 9.5e-7, FE 1.4e-6.
- ``wall = bound - 1`` (a box at the floor thrown down at 300 cells/s):
  heavy cells at ``|c| = bound - 1`` from frame 1 on, whose momentum the
  window drops; CG 49/49, 29/29, 21/21, positions within 2.4e-6, FE
  1.8e-6.  With the non-solid mask of the MPM spline's P2G instead the
  positions end 1.5e-2 apart and FE 0.12.
"""

import math

import numpy as np
import pytest
import torch

from fluidsim_tpu import config as jconfig
from fluidsim_tpu.models import mpm as jmpm
from fluidsim_tpu_torch import config as tconfig
from fluidsim_tpu_torch.models import mpm as tmpm
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from test_torch_mpm import DENSITY, _assert_frame_matches

FRAMES = 3
# a box at the floor of a box whose wall is one cell from the boundary,
# thrown down so that it reaches |c| = bound - 1 within the frames
WALL_CFG = {"kind": "mpm", "bound": 15, "wall": 14, "density": 40,
            "initial_velocity": [0, -300, 0],
            "seed": [{"box": [[-2, -13, -2], [2, -11, 2]]}],
            "params": {"kernel": "flip"}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's CPU frames (see
    ``tests/test_torch_mpm.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cg_slack(jax_iters, solves):
    return max(solves, math.ceil(0.05 * jax_iters))


def _run_against_jax(tsim, jsim):
    """``FRAMES`` frames of both sims from the same seed, each held to the
    module's tolerances; returns the port's metrics."""
    assert jsim.params.pallas_transfer is False
    assert not jsim.params.fast_transfer
    np.testing.assert_array_equal(tsim.state.pos.numpy(),
                                  np.asarray(jsim.state.pos))
    out = []
    for _ in range(FRAMES):
        j, t = jsim.step(), tsim.step()
        solves = 1 + t["spd_fallback"] if tsim.params.hessian == "hybrid" \
            else 1
        _assert_frame_matches(t, j, tsim, jsim,
                              _cg_slack(int(j["cg_iters"]), solves))
        out.append(t)
    return out


@pytest.mark.parametrize("kw", [
    dict(precond="none"), dict(precond="jacobi"),
    dict(hessian="hybrid", cg_hybrid_cap=20)],
    ids=["none", "jacobi", "hybrid"])
def test_flip_spline_frames_match_jax_naive_path(kw):
    jsim = jmpm.MpmSim("mpm_cone", density=DENSITY,
                       params=jmpm.MpmParams(kernel="flip", **kw))
    tsim = tmpm.MpmSim("mpm_cone", density=DENSITY, device="cpu",
                       params=tmpm.MpmParams(kernel="flip", **kw))
    assert tsim.params.kernel == "flip"
    frames = _run_against_jax(tsim, jsim)
    if "cg_hybrid_cap" in kw:
        assert all(m["spd_fallback"] == 1 for m in frames)
    assert all(float(m["min_det_fp"]) > 0 for m in frames)


def test_flip_spline_window_mask_matches_jax_naive_path():
    """``wall = bound - 1``: the cells at ``|c| = bound - 1`` are not
    solid but lie outside the momentum's ``|c| <= bound - 2`` window, and
    the frames must take heavy cells there."""
    jsim = jconfig.make_sim(WALL_CFG)
    tsim = tconfig.make_sim(WALL_CFG, device="cpu")
    assert tsim.params.kernel == "flip" and tsim.params.wall == 14
    frames = _run_against_jax(tsim, jsim)
    b = tsim.params.bound
    outside = ~tk._box_within(b, b - 2, "cpu") & ~tsim.solid
    heavy = [int((m["occupancy"][outside] > tsim.params.mass_threshold).sum())
             for m in frames]
    assert heavy[-1] > 0, heavy


def test_mpm_spline_builds_no_second_table(monkeypatch):
    """``kernel="mpm"`` builds the MPM table alone; ``kernel="flip"`` the
    FLIP spline's beside it."""
    kernels = []
    real = tk.masked_weights_cm

    def spy(pos, bound, kernel="flip"):
        kernels.append(kernel)
        return real(pos, bound, kernel)

    monkeypatch.setattr(tk, "masked_weights_cm", spy)
    sim = tmpm.MpmSim("mpm_cone", density=5.0, device="cpu")
    sim.step()
    assert kernels == ["mpm"]
    kernels.clear()
    sim = tmpm.MpmSim("mpm_cone", density=5.0, device="cpu",
                      params=tmpm.MpmParams(kernel="flip"))
    sim.step()
    assert kernels == ["mpm", "flip"]
