"""The port's validation entry points (``fluidsim_tpu_torch/validation``):
their oracles on the recorded traces, each entry point at a small size on
the CPU, and the soak protocol beside the JAX package's sims from the
same compat seeding.

Tolerances: kinetic energy per frame within rtol 1e-4, the same outer
passes and CG iterations (MPM: the same CG counts, det FP within 1e-5).
The FLIP soak is held to the JAX ``FlipSim``'s frame run eagerly
(``jax.disable_jit``): the port is within 8.5e-8 of it over 5 frames of
the compat-seeded cube at bound 8, where the jitted frame (7 outer
passes at frame 1, 65 CG iterations against 66) rounds 5.1e-4 apart from
both (its fused sums, as ``ROADMAP.md`` records for ``pea_fluid``). The
MPM soaks are held to the jitted JAX frames (measured within 2.7e-5).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from fluidsim_tpu.compat.scatter import seed_particles_compat as jcompat
from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu.models import mpm as jmpm
from fluidsim_tpu_torch.validation import (ke_parity, soak_500, soak_mpm,
                                           soak_mpm_scaled, traces,
                                           validate_config5,
                                           validate_mpm_shape)

FRAMES = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's CPU frames (as
    ``tests/test_torch_config.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the oracles on the recorded traces ----------------------------------

def test_flip_parity_oracle_on_the_recorded_runs():
    rec = traces.load(traces.FLIP_PARITY)
    jax_run = traces.flip_parity_oracle(rec["tpu"], rec["cpp"])
    assert jax_run["pass"]
    # docs/validation.md: 1.6e-5 in free fall, median 9.1e-5, r 0.9999992
    assert jax_run["fall_rel_max"] == pytest.approx(1.6e-5, rel=0.05)
    assert jax_run["rel_median"] == pytest.approx(9.1e-5, rel=0.05)
    assert jax_run["correlation"] == pytest.approx(0.9999992, abs=1e-7)
    off = np.asarray(rec["cpp"]) * np.where(np.arange(40) < 8, 1.1, 1.0)
    bad = traces.flip_parity_oracle(off, rec["cpp"])
    assert not bad["pass"] and bad["fall_rel_max"] == pytest.approx(0.1)


def test_mpm_parity_oracle_on_the_recorded_run():
    rec = traces.load(traces.MPM_PARITY)
    args = (rec["jax_dt"], rec["ref_ke"], rec["ref_dt"])
    jax_run = traces.mpm_parity_oracle(rec["jax_ke"], *args)
    assert jax_run["pass"]
    assert jax_run["rel_median"] == pytest.approx(rec["median_rel_ke_err"],
                                                  rel=1e-3)
    assert not traces.mpm_parity_oracle(np.asarray(rec["jax_ke"]) * 1.1,
                                        *args)["pass"]
    late = np.asarray(rec["jax_dt"]) * (1 + 2e-4)
    assert not traces.mpm_parity_oracle(rec["jax_ke"], late, rec["ref_ke"],
                                        rec["ref_dt"])["pass"]


@pytest.mark.parametrize("name,early", [(traces.FLIP_SOAK, (1, 15)),
                                        (traces.MPM_SOAK, (0, 20))])
def test_soak_oracle_on_the_recorded_runs(name, early):
    ke = np.asarray([row["ke"] for row in traces.load(name)])
    assert traces.soak_oracle(ke, ke, early)["pass"]
    off = ke.copy()
    off[early[0] + 3] *= 1.02
    assert not traces.soak_oracle(off, ke, early)["pass"]
    assert not traces.soak_oracle(ke * 20.0, ke, early)["pass"]
    # the first 60 frames alone: the tail is those frames
    assert traces.soak_oracle(ke[:60], ke, early)["frames_compared"] == 60


def test_trajectory_oracle():
    f = np.arange(500.0)
    ke = 0.2 + np.exp(-((f - 150.0) / 60.0) ** 2)   # rise, peak, decay
    ok = traces.trajectory_oracle(ke, 127)
    assert ok["pass"] and ok["rise"] and ok["decay"]
    assert ok["ke_peak_frame"] == 150
    rising = traces.trajectory_oracle(f + 1.0, 127)
    assert rising["decay"] is False and not rising["pass"]
    # 255^3 also needs the tail under the 50 frames after the peak
    assert traces.trajectory_oracle(ke, 255)["pass"]
    short = traces.trajectory_oracle(ke[:20], 127)
    assert short["decay"] is None and short["pass"] is None   # not tested
    assert not traces.trajectory_oracle(np.r_[ke[:20], np.nan], 127)["pass"]


def test_confined():
    pos = np.zeros((4, 3), np.float32)
    assert traces.confined(pos, 8)["confined"]
    pos[2, 1] = 8.5
    assert not traces.confined(pos, 8)["confined"]
    pos[2, 1] = np.nan
    assert not traces.confined(pos, 8)["finite_pos"]


# ---- the soaks beside the JAX package's sims ------------------------------

def _ke(rows):
    return np.asarray([r["kinetic_energy"] for r in rows])


def test_soak_500_beside_jax_flipsim():
    frames = 5                  # frame 1 takes 7 outer passes
    sim, rows, secs = soak_500.run(frames, bound=8, density=4.0,
                                   device="cpu")
    jsim = jflip.FlipSim("water_cube_drop", bound=8, density=4.0,
                         seeder=jcompat)
    state, jm = jsim.state, []
    with jax.disable_jit():
        for _ in range(frames):
            state, m = jflip.flip_step(jsim.params, jsim.solid, state)
            jm.append(m)
    np.testing.assert_allclose(
        _ke(rows), [float(m["kinetic_energy"]) for m in jm], rtol=1e-4)
    for key in ("outer_iters", "cg_iters"):
        assert [r[key] for r in rows] == [int(m[key]) for m in jm], key
    np.testing.assert_allclose(sim.state.pos.numpy(), np.asarray(state.pos),
                               atol=1e-3)
    figs = soak_500.figures(sim, rows, secs, "cpu", recorded=False)
    assert figs["pass"] and figs["trace"] is None
    assert figs["outer"] == [r["outer_iters"] for r in rows]


@pytest.mark.parametrize("module", ["soak_mpm", "soak_mpm_scaled"])
def test_mpm_soaks_beside_jax_mpmsim(module):
    if module == "soak_mpm":
        sim, rows, secs = soak_mpm.run(FRAMES, density=40.0, device="cpu")
        jsim = jmpm.MpmSim("mpm_cone", density=40.0, seeder=jcompat)
        figs = soak_mpm.figures(sim, rows, secs, "cpu", recorded=False)
    else:
        sim, rows, seed_secs, cum = soak_mpm_scaled.run(FRAMES, bound=8,
                                                        device="cpu")
        jsim = jmpm.MpmSim("mpm_cone", bound=8)
        figs = soak_mpm_scaled.figures(sim, rows, seed_secs, cum, "cpu")
        assert figs["oracle"]["decay"] is None and figs["sound"]
        assert [p["phase"] for p in figs["phases"]] == ["fall"]
    # the scaled soak's trajectory is untested in FRAMES frames
    assert figs["pass"] is (None if module == "soak_mpm_scaled" else True)
    assert figs["particles"] == jsim.num_particles
    jm = [jsim.step() for _ in range(FRAMES)]
    np.testing.assert_allclose(
        _ke(rows), [float(m["kinetic_energy"]) for m in jm], rtol=1e-4)
    assert [int(r["cg_iters"]) for r in rows] == [int(m["cg_iters"])
                                                  for m in jm]
    np.testing.assert_allclose([r["min_det_fp"] for r in rows],
                               [float(m["min_det_fp"]) for m in jm],
                               atol=1e-5)
    np.testing.assert_allclose(sim.state.pos.numpy(),
                               np.asarray(jsim.state.pos), atol=1e-4)


# ---- the sharded validators at world size 1, in this process --------------

def test_validate_config5_world_1_equals_flipsim():
    figs, sim, last = validate_config5.run(bound=10, density=2.0, frames=3,
                                           device="cpu", keep=True)
    assert figs["pass"], figs["failures"]
    assert figs["world"] == 1 and figs["particles"] == sim.num_particles
    assert figs["state_bitwise"] == {"pos": True, "vel": True,
                                     "pressure": True}
    assert figs["ke_rel"] == [0.0, 0.0, 0.0]
    assert last["occupancy"].shape == (21, 21, 21)


def test_validate_mpm_shape_world_1_equals_mpmsim():
    figs, sim, _ = validate_mpm_shape.run(bound=15, frames=2, device="cpu",
                                          keep=True)
    assert figs["pass"], figs["failures"]
    assert all(figs["state_bitwise"].values())
    assert set(figs["state_bitwise"]) == {"pos", "vel", "FE", "FP",
                                          "volume"}
    assert figs["cg_iters_single"] == figs["cg_iters_sharded"]


# ---- the command lines ----------------------------------------------------

_DOCS = traces.DOCS


def _docs_snapshot():
    return {p: os.stat(os.path.join(_DOCS, p)).st_mtime_ns
            for p in os.listdir(_DOCS)}


@pytest.mark.parametrize("module,argv", [
    (soak_500, ["--bound", "6", "--density", "2", "--frames", "2"]),
    (soak_mpm, ["--density", "10", "--frames", "2"]),
    (soak_mpm_scaled, ["--bound", "6", "--frames", "2"]),
    (validate_config5, ["--bound", "6", "--density", "2", "--frames", "2"]),
    (validate_mpm_shape, ["--bound", "6", "--frames", "2"]),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_command_lines_on_the_cpu(module, argv, tmp_path, capsys):
    before = _docs_snapshot()
    out = tmp_path / "figures.json"
    code = module.main(argv + ["--device", "cpu", "--out", str(out)])
    said = capsys.readouterr()
    printed = json.loads(said.out.strip().splitlines()[-1])
    assert printed == json.loads(out.read_text())
    if module is soak_mpm_scaled:
        # 2 frames cannot test the trajectory: pass null, exit 1, a message
        assert code == 1 and printed["pass"] is None and printed["sound"]
        assert "not tested" in said.err
    else:
        assert code == 0 and printed["pass"]
    assert printed["device"] == "cpu"
    assert _docs_snapshot() == before        # the records are read only


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        soak_mpm.main(["--density", "5", "--frames", "1"])


def test_ke_parity_needs_a_record_or_the_native_port():
    with pytest.raises(ValueError, match="--native"):
        ke_parity.flip(frames=2, bound=8, density=2.0, device="cpu")
    with pytest.raises(ValueError, match="--native"):
        ke_parity.mpm(frames=70, device="cpu")
