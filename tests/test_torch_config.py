"""Config-driven runs of the port against the JAX package: the parameter
dataclasses, ``config.py``, the clean and Jacobi projections and the
bit-exact compat seeding (``compat/``).  MPM's Jacobi preconditioner is in
``tests/test_torch_mpm_precond.py``.

Tolerances:
- The dataclasses' fields and defaults, the config scenes, the seeded
  particles and the compat streams are exact: compared bit for bit.
- The schedule fields change nothing on the port's path: frames bit for
  bit against the default's.
- ``project``: ``tests/test_torch_project.py``'s (velocities and pressure
  atol 5e-4, rtol 1e-3, equal outer and CG counts).
- ``make_sim`` frames against JAX's ``make_sim`` on the Pallas branch in
  interpret mode: ``tests/test_torch_flip.py``'s (kinetic energy rtol
  1e-4, equal outer and CG counts, positions atol 1e-3), with the fluid
  cells allowed to differ only where both occupancies are below 1e-6
  (``tests/test_torch_parity_scenes.py``'s rule) and, after such a cell,
  positions atol 1e-2 (see ``test_make_sim_frames_match_pallas_branch``).
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fluidsim_tpu import config as jconfig
from fluidsim_tpu.compat import mt19937 as jmt
from fluidsim_tpu.compat import scatter as jscatter
from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu.models import mpm as jmpm
from fluidsim_tpu.scenes import get_scene as jget_scene
from fluidsim_tpu.seeding import seed_particles as jseed
from fluidsim_tpu_torch import config as tconfig
from fluidsim_tpu_torch.compat import mt19937 as tmt
from fluidsim_tpu_torch.compat import scatter as tscatter
from fluidsim_tpu_torch.models import flip as tflip
from fluidsim_tpu_torch.models import mpm as tmpm
from fluidsim_tpu_torch.scenes import get_scene as tget_scene
from fluidsim_tpu_torch.seeding import seed_particles as tseed
from test_torch_multigrid import _grid, assert_projection_matches

# a FLIP box with an obstacle under the seed: not walls-only
CFG = {"kind": "flip", "bound": 8, "density": 3,
       "seed": [{"box": [[-3, -3, -3], [3, 3, 3]]},
                {"sphere": {"center": [0, 4, 0], "radius": 2}}],
       "solid": [{"box": [[-2, -6, -2], [2, -5, 2]]}]}
# every key that config.py reads
FULL_CFG = {"kind": "flip", "name": "every key", "bound": 10, "wall": 7,
            "dx": 0.5, "density": 4.5, "gravity": [0.0, -9.8, 1.0],
            "initial_velocity": [1.0, 0.0, -2.0],
            "seed": [{"box": [[-4, 0, -4], [4, 5, 4]]},
                     {"sphere": {"center": [2, -3, 1], "radius": 3.5}}],
            "solid": [{"box": [[-1, -7, -1], [1, -4, 1]]},
                      {"sphere": {"center": [-4, -5, 3], "radius": 1.5}}],
            "params": {"max_dt": 0.05, "preconditioner": "jacobi"}}
MPM_CFG = {"kind": "mpm", "bound": 15, "density": 50,
           "seed": [{"sphere": {"center": [0, -10, 0], "radius": 3}}],
           "params": {"precond": "jacobi", "precond_gamma": 2.0}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's CPU frames, as the other MPM
    test files: with the other test processes on the same cores, spreading
    each small grid operation over every core costs far more than it
    saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["FlipParams", "MpmParams"])
def test_params_fields_match_jax(name):
    tcls = getattr(tflip if name == "FlipParams" else tmpm, name)
    jcls = getattr(jflip if name == "FlipParams" else jmpm, name)
    fields = lambda cls: [(f.name, f.default)
                          for f in dataclasses.fields(cls)]
    assert fields(tcls) == fields(jcls)


@pytest.mark.parametrize("cls, kw", [
    (tflip.FlipParams, dict(preconditioner="ilu")),
    (tflip.FlipParams, dict(kernel="cubic")),
    (tflip.FlipParams, dict(mode="mac")),
    (tmpm.MpmParams, dict(precond="ilu")),
    (tmpm.MpmParams, dict(kernel="cubic")),
    (tmpm.MpmParams, dict(hessian="newton"))])
def test_params_reject_what_they_cannot_run(cls, kw):
    with pytest.raises(ValueError):
        cls(**kw)


@pytest.mark.parametrize("dtype", [torch.float64, "float16", np.int32])
def test_sims_run_float32_only(dtype):
    with pytest.raises(ValueError, match="float32"):
        tflip.FlipSim("water_cube_drop", bound=6, density=2.0, device="cpu",
                      dtype=dtype)
    with pytest.raises(ValueError, match="float32"):
        tmpm.MpmSim("mpm_cone", density=5.0, device="cpu", dtype=dtype)


_FLIP_SCHEDULES = dict(fast_transfer=False, transfer_chunks=4,
                       pallas_transfer=True, pallas_interpret=True,
                       transfer_window=256, transfer_chunk=1024,
                       stencil_bx_cap=16)
_MPM_SCHEDULES = dict(fast_transfer=True, pallas_transfer=True,
                      pallas_interpret=True, sort_particles=False)


def _flip_frames(**params):
    sim = tconfig.make_sim(dict(CFG, params=params), device="cpu",
                           dtype=np.float32)
    return [sim.step() for _ in range(2)], sim.state


def _mpm_frames(**params):
    sim = tmpm.MpmSim("mpm_cone", density=10.0, device="cpu",
                      params=tmpm.MpmParams(**params))
    return [sim.step() for _ in range(2)], sim.state


@pytest.fixture(scope="module")
def default_frames():
    return {"flip": _flip_frames(), "mpm": _mpm_frames()}


def _assert_bitwise(a, b):
    (ma, sa), (mb, sb) = a, b
    for fa, fb in zip(ma, mb):
        for k in fa:
            ta, tb = torch.as_tensor(fa[k]), torch.as_tensor(fb[k])
            assert torch.equal(ta, tb), k
    for f in dataclasses.fields(sa):
        va, vb = getattr(sa, f.name), getattr(sb, f.name)
        assert (va is None and vb is None) or torch.equal(va, vb), f.name


@pytest.mark.parametrize("kind, field", [
    *(("flip", f) for f in _FLIP_SCHEDULES),
    *(("mpm", f) for f in _MPM_SCHEDULES)])
def test_schedule_fields_change_nothing(default_frames, kind, field):
    value = (_FLIP_SCHEDULES if kind == "flip" else _MPM_SCHEDULES)[field]
    run = _flip_frames if kind == "flip" else _mpm_frames
    _assert_bitwise(run(**{field: value}), default_frames[kind])


@pytest.mark.parametrize("params", [
    dict(preconditioner="jacobi"),
    dict(compat_projection=False),
    dict(compat_projection=False, cheb_degree=4, cheb_ratio=50.0)],
    ids=["jacobi", "clean", "clean-cheb4"])
def test_project_matches_pallas_branch(params):
    out = assert_projection_matches(*_grid(8), **params)
    if not params.get("compat_projection", True):
        assert out[2] == 1


def _scenes_equal(t, j):
    for f in dataclasses.fields(j):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if isinstance(jv, np.ndarray):
            assert tv.dtype == jv.dtype, f.name
            np.testing.assert_array_equal(tv, jv, err_msg=f.name)
        elif f.name == "spec":
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        else:
            assert tv == jv, f.name


@pytest.mark.parametrize("cfg", [CFG, FULL_CFG, MPM_CFG],
                         ids=["obstacle", "every-key", "mpm"])
def test_scene_from_config_matches_jax(cfg, tmp_path):
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(cfg))
    for src in (copy.deepcopy(cfg), str(path)):
        tscene, tover = tconfig.scene_from_config(src)
        jscene, jover = jconfig.scene_from_config(copy.deepcopy(cfg))
        _scenes_equal(tscene, jscene)
        assert tover == jover
    for seed in (0, 3):
        for a, b in zip(tseed(tscene, seed=seed), jseed(jscene, seed=seed)):
            np.testing.assert_array_equal(a, b)


def test_config_rejects_bad_regions():
    for cfg in ({"kind": "flip", "bound": 10, "seed": []},
                {"kind": "flip", "bound": 10,
                 "seed": [{"cone": {"radius": 2}}]}):
        with pytest.raises(ValueError):
            tconfig.scene_from_config(cfg)


def test_make_sim_builds_the_jax_sim():
    """The same parameters, solid and particles; an obstacle turns the
    analytic bounce probe off, a walls-only config turns it on."""
    for cfg in (CFG, FULL_CFG, MPM_CFG,
                {"kind": "flip", "bound": 8, "density": 2,
                 "seed": [{"box": [[-2, -2, -2], [2, 2, 2]]}]}):
        tsim = tconfig.make_sim(copy.deepcopy(cfg), device="cpu", seed=4)
        jsim = jconfig.make_sim(copy.deepcopy(cfg), seed=4)
        tp, jp = dataclasses.asdict(tsim.params), dataclasses.asdict(jsim.params)
        if cfg["kind"] == "flip":
            jp["pallas_transfer"] = None    # set by the JAX sim's backend
        else:                               # resolved by the JAX sim
            tp["pallas_transfer"] = jp["pallas_transfer"]
        assert tp == jp
        assert tsim.params.walls_only_solid == ("solid" not in cfg)
        np.testing.assert_array_equal(tsim.solid.numpy(),
                                      np.asarray(jsim.solid))
        np.testing.assert_array_equal(tsim.state.pos.numpy(),
                                      np.asarray(jsim.state.pos))
        np.testing.assert_array_equal(tsim.state.vel.numpy(),
                                      np.asarray(jsim.state.vel))


def test_make_sim_frames_match_pallas_branch():
    """Two frames of the obstacle config with the MPM spline.  At frame 1
    four cells of occupancy +-2.6e-8 .. +-3.1e-11 are fluid in JAX only:
    the spline's outer piece cancels to f32 noise near ``|x - 0.5| = 1``,
    where the port equals eager JAX and the jitted JAX frame rounds apart
    (as the FLIP spline does near ``|x| = 1``,
    ``tests/test_torch_parity_scenes.py``).  The solve then sees another
    fluid set, and the positions end up to 8.2e-3 apart (measured)."""
    params = {"kernel": "mpm"}
    jsim = jconfig.make_sim(dict(CFG, params=dict(params,
                                                  pallas_transfer=True)))
    tsim = tconfig.make_sim(dict(CFG, params=params), device="cpu")
    assert not tsim.params.walls_only_solid
    assert_frames_match(tsim, jsim, pos_atol=(1e-3, 1e-2))


def assert_frames_match(tsim, jsim, pos_atol=(1e-3, 1e-3)):
    """One frame per entry of ``pos_atol``, each held to the module's
    frame tolerances with its positions to that entry; fluid cells may
    differ only where both occupancies are below 1e-6 in magnitude."""
    np.testing.assert_array_equal(tsim.state.pos.numpy(),
                                  np.asarray(jsim.state.pos))
    solid = tsim.solid.numpy()
    for f, atol in enumerate(pos_atol):
        with pltpu.force_tpu_interpret_mode():
            j = jsim.step()
        t = tsim.step()
        np.testing.assert_allclose(float(t["kinetic_energy"]),
                                   float(j["kinetic_energy"]), rtol=1e-4,
                                   err_msg=f"frame {f}")
        assert t["outer_iters"] == int(j["outer_iters"]), f
        assert t["cg_iters"] == int(j["cg_iters"]), f
        to, jo = t["occupancy"].numpy(), np.asarray(j["occupancy"])
        apart = ((to > 0) != (jo > 0)) & ~solid
        assert (np.abs(to[apart]) < 1e-6).all(), f
        assert (np.abs(jo[apart]) < 1e-6).all(), f
        np.testing.assert_allclose(tsim.state.pos.numpy(),
                                   np.asarray(jsim.state.pos), atol=atol,
                                   err_msg=f"frame {f}")


# ---- the compat seeding -------------------------------------------------

def test_compat_streams_match_jax():
    """Raw words, integer and real draws, interleaved, from several seeds
    (the cases of ``tests/test_compat_rng.py``)."""
    for seed in (0, 7, 42):
        t, j = tmt.Mt19937(seed), jmt.Mt19937(seed)
        np.testing.assert_array_equal(t.raw(10), j.raw(10))
        np.testing.assert_array_equal(t.uniform_int(1000, 68920),
                                      j.uniform_int(1000, 68920))
        np.testing.assert_array_equal(t.uniform_real(8), j.uniform_real(8))
        for _ in range(5):
            np.testing.assert_array_equal(t.uniform_int(1, 15),
                                          j.uniform_int(1, 15))
            np.testing.assert_array_equal(t.uniform_real(1),
                                          j.uniform_real(1))
    # the libstdc++ oracle of tests/test_compat_rng.py
    np.testing.assert_array_equal(
        tmt.Mt19937(0).raw(10),
        [2357136044, 2546248239, 3071714933, 3626093760, 2588848963,
         3684848379, 2340255427, 3638918503, 1819583497, 2678185683])


@pytest.mark.parametrize("name, kw", [
    ("water_cube_drop", dict(bound=30, density=4.0)),   # leaves and tiles
    ("water_cube_drop", dict(bound=12, density=4.0)),   # leaves only
    ("mpm_cone", {}), ("mpm_sphere", {})])
def test_seed_particles_compat_matches_jax(name, kw):
    tsc, jsc = tget_scene(name, **kw), jget_scene(name, **kw)
    b = tsc.spec.bound
    assert (tscatter._detect_fill_box(tsc.seed_mask, b) is None) == (
        jscatter._detect_fill_box(jsc.seed_mask, b) is None)
    tp, tv = tscatter.seed_particles_compat(tsc)
    jp, jv = jscatter.seed_particles_compat(jsc)
    assert tp.dtype == np.float32 and tp.shape[0] > 0
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tv, jv)


def test_voxel_items_match_jax():
    """The per-voxel topology (the fill topology shows in the water cube's
    particles above)."""
    ti = tscatter._voxel_items(tget_scene("mpm_cone").seed_mask, 15)
    ji = jscatter._voxel_items(jget_scene("mpm_cone").seed_mask, 15)
    assert len(ti) == len(ji) > 0
    for (tkey, torg, tsize), (jkey, jorg, jsize) in zip(ti, ji):
        assert tkey == jkey and tsize == jsize
        np.testing.assert_array_equal(torg, jorg)


def test_sims_take_the_compat_seeder():
    """FlipSim and MpmSim seed through ``seeder=``, as JAX's do; one frame
    runs from it."""
    from fluidsim_tpu_torch.compat.scatter import seed_particles_compat
    scene = tget_scene("water_cube_drop", bound=12, density=4.0)
    tsim = tflip.FlipSim(scene, seeder=seed_particles_compat, device="cpu")
    jsim = jflip.FlipSim(jget_scene("water_cube_drop", bound=12, density=4.0),
                         seeder=jscatter.seed_particles_compat)
    np.testing.assert_array_equal(tsim.state.pos.numpy(),
                                  np.asarray(jsim.state.pos))
    assert np.isfinite(float(tsim.step()["kinetic_energy"]))
    msim = tmpm.MpmSim("mpm_cone", seeder=seed_particles_compat,
                       device="cpu")
    np.testing.assert_array_equal(
        msim.state.pos.numpy(),
        jscatter.seed_particles_compat(jget_scene("mpm_cone"))[0])
    assert tconfig.make_sim(copy.deepcopy(CFG), device="cpu",
                            seeder=seed_particles_compat).num_particles > 0
