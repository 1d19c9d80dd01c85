"""The port's slab-sharded FLIP (``parallel/flip_sharded.py``) against the
JAX package's ``ShardedFlipSim`` on its kernel path (``pallas_transfer=True``
in Pallas interpret mode), at 1, 2 and 4 ranks (gloo) and as many virtual
CPU devices, from one state carried by ``interop.sharded_state_from_numpy``.

Tolerances, per frame over 3 frames of ``water_cube_drop`` at bound 8:
kinetic energy rtol 1e-4, the same outer and CG counts, no particle lost,
the same number of fluid cells; the final positions within atol 1e-3
compared as sets (the JAX slab sort is not stable, so a cell's particles
may sit in another order; the sums then differ in their last bits).  At
world size 1 the sharded frame also runs in this process against the
port's ``FlipSim``, whose state it keeps bit for bit, and 4 ranks with
an x drift that migrates particles every frame run against one.
"""

import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu.parallel import flip_sharded as jsharded
from fluidsim_tpu.scenes import get_scene as jget_scene
from fluidsim_tpu_torch import FlipSim, interop
from fluidsim_tpu_torch.parallel import dryrun
from fluidsim_tpu_torch.parallel.flip_sharded import (SENTINEL,
                                                      ShardedFlipSim)

BOUND, DENSITY, FRAMES = 8, 3.0, 3
SPAWN_TIMEOUT_S = 180
_SCENE = dict(scene="water_cube_drop", bound=BOUND, density=DENSITY)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_sim(world):
    scene = jget_scene("water_cube_drop", bound=BOUND, density=DENSITY)
    params = jflip.FlipParams(bound=BOUND, wall=scene.spec.wall,
                              pallas_transfer=True, pallas_interpret=True)
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("x",))
    return jsharded.ShardedFlipSim(scene, params=params, mesh=mesh)


def _jax_state(sim):
    return {f: np.asarray(getattr(sim.state, f))
            for f in ("pos", "vel", "alive", "dt", "t", "frame", "pressure")}


def _alive_sorted(pos, alive):
    p = pos[alive.astype(bool)]
    return p[np.lexsort(p.T)]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_flip_matches_jax(world, tmp_path):
    jsim = _jax_sim(world)
    state_path = str(tmp_path / "state.npz")
    np.savez(state_path, **_jax_state(jsim))
    out_path = str(tmp_path / "port.npz")
    dryrun.run_ranks(dryrun.sim_rank, world, "cpu",
                     ("flip", FRAMES, state_path, out_path, _SCENE),
                     timeout_s=SPAWN_TIMEOUT_S)
    port = np.load(out_path)
    assert int(port["cap"]) == jsim.cap
    assert int(port["mig_cap"]) == jsim.mig_cap
    assert bool(port["tail_insert"]) == jsim.tail_insert
    for f in range(FRAMES):
        m = jsim.step()
        np.testing.assert_allclose(port["kinetic_energy"][f],
                                   float(m["kinetic_energy"]), rtol=1e-4,
                                   err_msg=f"frame {f}")
        for key in ("outer_iters", "cg_iters", "num_fluid_cells", "num_alive",
                    "migrated"):
            assert port[key][f] == int(m[key]), (key, f)
        assert port["lost"][f] == 0 == int(m["lost"])
        np.testing.assert_allclose(port["dt"][f], float(m["dt"]), rtol=1e-5)
    assert port["cg_iters"][1] > 0
    jst = _jax_state(jsim)
    np.testing.assert_allclose(
        _alive_sorted(port["state_pos"], port["state_alive"]),
        _alive_sorted(jst["pos"], jst["alive"]), atol=1e-3)
    dead = ~port["state_alive"].astype(bool)
    assert (port["state_pos"][dead] == SENTINEL).all()


def _params(scene, **kw):
    from fluidsim_tpu_torch import FlipParams

    return FlipParams(bound=BOUND, wall=scene.spec.wall, dx=scene.spec.dx,
                      gravity=tuple(scene.gravity), **kw)


@pytest.mark.parametrize("kernel", ["flip", "mpm"])
def test_world_one_matches_flip_sim(kernel):
    """One rank, no process group: the slab is the box with its halos, on
    either transfer spline."""
    from fluidsim_tpu_torch import get_scene

    scene = get_scene("water_cube_drop", bound=BOUND, density=DENSITY)
    single = FlipSim(scene, params=_params(scene, kernel=kernel),
                     device="cpu")
    sim = ShardedFlipSim(scene, params=_params(scene, kernel=kernel),
                         device="cpu")
    assert sim.params.kernel == single.params.kernel == kernel
    assert sim.num_particles == single.num_particles
    assert sim.slab.rows == 2 * BOUND + 1 + 4
    for f in range(FRAMES):
        ms, mp = single.step(), sim.step()
        np.testing.assert_allclose(float(mp["kinetic_energy"]),
                                   float(ms["kinetic_energy"]), rtol=1e-5)
        assert mp["cg_iters"] == ms["cg_iters"]
        assert mp["outer_iters"] == ms["outer_iters"]
        assert int(mp["num_fluid_cells"]) == int(ms["num_fluid_cells"])
        assert int(mp["lost"]) == 0
    # one rank holds the box: its alive prefix is FlipSim's state, bit for
    # bit (the energies differ in the last bits: they sum over the slots)
    p = single.num_particles
    assert bool(sim.state.alive[:p].all()) and not bool(sim.state.alive[p:].any())
    for field in ("pos", "vel"):
        assert torch.equal(getattr(sim.state, field)[:p],
                           getattr(single.state, field)), field
    assert torch.equal(sim.state.pressure, single.state.pressure)


def test_world_one_mpm_spline_matches_jax_xla_path():
    """``kernel="mpm"`` at world size 1, in this process, against the JAX
    sharded step on one CPU device on its XLA path (``fast_transfer=False,
    pallas_transfer=False``), the one JAX sharded path that honours
    ``kernel``.  Its occupancy keeps the positive weights only (the port's,
    as its fused and Pallas paths, every weight), so fluid cells may differ
    where both occupancies are below 1e-6 in magnitude; its unstable slab
    sort may order a cell's particles otherwise, so the positions compare
    as sets, within 2e-3.  Measured: kinetic energy 173.70, 10,790.08,
    16,834.13 against 173.70, 10,790.81, 16,835.05 (6.8e-5 and 5.5e-5
    relative at frames 1-2; the port's ``FlipSim(kernel="mpm")`` gives
    10,790.08 and 16,834.13 too), outer passes 1, 7, 2 and CG iterations
    0, 60, 18 on both sides, 239 fluid cells against 243 at frame 1 (the 4
    apart of occupancy below 1e-6), positions within 1.5e-3 after frame
    2."""
    scene = jget_scene("water_cube_drop", bound=BOUND, density=DENSITY)
    jparams = jflip.FlipParams(bound=BOUND, wall=scene.spec.wall,
                               fast_transfer=False, pallas_transfer=False,
                               kernel="mpm")
    jsim = jsharded.ShardedFlipSim(
        scene, params=jparams, mesh=Mesh(np.asarray(jax.devices()[:1]),
                                         ("x",)))
    sim = ShardedFlipSim(device="cpu", params=_params(scene, kernel="mpm"),
                         **_SCENE)
    p = sim.num_particles
    np.testing.assert_array_equal(sim.state.pos[:p].numpy(),
                                  np.asarray(jsim.state.pos)[:p])
    solid = scene.solid
    for f in range(FRAMES):
        m, j = sim.step(), jsim.step()
        np.testing.assert_allclose(float(m["kinetic_energy"]),
                                   float(j["kinetic_energy"]), rtol=1e-4,
                                   err_msg=f"frame {f}")
        for key in ("outer_iters", "cg_iters", "num_alive"):
            assert m[key] == int(j[key]), (key, f)
        assert int(m["lost"]) == 0 == int(j["lost"])
        to, jo = m["occupancy"].numpy(), np.asarray(j["occupancy"])
        apart = ((to > 0) != (jo > 0)) & ~solid
        assert (np.abs(to[apart]) < 1e-6).all(), f
        assert (np.abs(jo[apart]) < 1e-6).all(), f
    jst = _jax_state(jsim)
    np.testing.assert_allclose(
        _alive_sorted(sim.state.pos.numpy(), sim.state.alive.numpy()),
        _alive_sorted(jst["pos"], jst["alive"]), atol=2e-3)


def test_migration_across_four_ranks_matches_one_rank(tmp_path):
    """An x drift of 5 carries particles across the slab edges every frame
    (at bound 8 the ranks migrate with ``migrate_neighbors``): 4 ranks
    against one, which keeps ``FlipSim``'s state (above)."""
    drift = 5.0
    out_path = str(tmp_path / "port.npz")
    dryrun.run_ranks(dryrun.sim_rank, 4, "cpu",
                     ("flip", FRAMES, "", out_path, _SCENE, drift),
                     timeout_s=SPAWN_TIMEOUT_S)
    port = np.load(out_path)
    assert not bool(port["tail_insert"])
    one = ShardedFlipSim(device="cpu", **_SCENE)
    one.state.vel[one.state.alive, 0] += drift
    for f in range(FRAMES):
        m = one.step()
        np.testing.assert_allclose(port["kinetic_energy"][f],
                                   float(m["kinetic_energy"]), rtol=1e-4)
        for key in ("outer_iters", "cg_iters", "num_fluid_cells",
                    "num_alive"):
            assert port[key][f] == int(m[key]), (key, f)
        assert port["migrated"][f] > 0 and port["lost"][f] == 0
    np.testing.assert_allclose(
        _alive_sorted(port["state_pos"], port["state_alive"]),
        _alive_sorted(one.state.pos.numpy(), one.state.alive.numpy()),
        atol=1e-3)


def test_state_round_trip_and_repack():
    jsim = _jax_sim(2)
    d = _jax_state(jsim)
    for rank in range(2):
        st = interop.sharded_state_from_numpy(d, rank, 2, device="cpu")
        assert st.pos.shape == (jsim.cap, 3)
        np.testing.assert_array_equal(
            st.pos.numpy(), np.split(d["pos"], 2)[rank])
        np.testing.assert_array_equal(st.pressure.numpy(),
                                      np.split(d["pressure"], 2)[rank])
        back = interop.sharded_state_to_numpy(st)
        np.testing.assert_array_equal(back["alive"],
                                      np.split(d["alive"], 2)[rank])
        # into more slots: the alive rows first, then dead ones
        big = interop.sharded_state_from_numpy(d, rank, 2, cap=jsim.cap + 40,
                                               device="cpu")
        k = int(np.split(d["alive"], 2)[rank].sum())
        assert bool(big.alive[:k].all()) and not bool(big.alive[k:].any())
        assert bool((big.pos[k:] == SENTINEL).all())


def test_process_group_backend_follows_the_device(tmp_path):
    """On a gloo group a CPU sim steps (nothing is sent at world size 1)
    and a CUDA sim is refused."""
    dist.init_process_group("gloo", init_method="file://" + str(tmp_path /
                                                                "store"),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="nccl"):
            ShardedFlipSim("water_cube_drop", bound=6, density=2.0,
                           device="cuda")
        sim = ShardedFlipSim("water_cube_drop", bound=6, density=2.0,
                             device="cpu")
        m = sim.step()
        assert np.isfinite(float(m["kinetic_energy"]))
        assert int(m["num_alive"]) == sim.num_particles
    finally:
        dist.destroy_process_group()


def test_lost_particles_warn_or_raise(monkeypatch):
    sim = ShardedFlipSim("water_cube_drop", bound=6, density=2.0,
                         device="cpu")
    sim._note_lost({"lost": torch.tensor(3)})
    with pytest.warns(RuntimeWarning, match="dropped 3"):
        sim._note_lost({"lost": torch.tensor(0)})
    monkeypatch.setenv("FLUIDSIM_STRICT_MIGRATION", "1")
    sim._note_lost({"lost": torch.tensor(2)})
    with pytest.raises(RuntimeError, match="dropped 2"):
        sim._flush_lost()
    assert sim.lost_total == 5


@pytest.mark.parametrize("field", ["mode", "preconditioner"])
def test_sharded_flip_refuses_what_jax_does_not_run(field):
    from fluidsim_tpu_torch import FlipParams

    value = {"mode": "apic", "preconditioner": "multigrid"}[field]
    params = FlipParams(bound=6, wall=4, **{field: value})
    with pytest.raises(ValueError, match=field):
        ShardedFlipSim("water_cube_drop", params=params, bound=6,
                       density=2.0, device="cpu")
