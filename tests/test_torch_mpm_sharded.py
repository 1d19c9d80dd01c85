"""The port's slab-sharded MPM (``parallel/mpm_sharded.py``) against the JAX
package's ``ShardedMpmSim`` on its kernel path (``pallas_transfer=True``
in Pallas interpret mode), at 2 and 4 ranks (gloo) and as many virtual CPU
devices, from one state carried by
``interop.sharded_mpm_state_from_numpy``: ``mpm_cone`` at bound 15,
density 40, 2 frames.

Tolerances are ``tests/test_torch_mpm.py``'s ``_assert_frame_matches``:
kinetic energy rtol 1e-4, the same active cells and SPD fallbacks, CG
iterations within one per solve, dt rtol 1e-5, positions within atol 1e-4
and FE within 1e-5 (compared as sets of particles: the slab sort of
either package may order a cell's particles otherwise).

The migration band: the JAX sim sizes it from the seed-time population of
the slab-boundary rows only, which is 0 for the cone at 3 ranks; a cone
moved next to a boundary and drifting across it then loses particles
there.  The port floors the band with ``8 cap / nl`` and loses none.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fluidsim_tpu.models import mpm as jmpm
from fluidsim_tpu.parallel import mpm_sharded as jsharded
from fluidsim_tpu.scenes import get_scene as jget_scene
from fluidsim_tpu_torch import MpmSim
from fluidsim_tpu_torch.parallel import dryrun
from fluidsim_tpu_torch.parallel.mpm_sharded import (ShardedMpmSim,
                                                     mpm_migration_sizing)

DENSITY, FRAMES = 40.0, 2
SPAWN_TIMEOUT_S = 180
_SCENE = dict(scene="mpm_cone", density=DENSITY)
_KEYS = ("pos", "vel", "FE", "FP", "volume", "alive", "dt", "t", "frame")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), ("x",))


def _jax_state(sim):
    return {k: np.array(getattr(sim.state, k)) for k in _KEYS}


def _by_position(st):
    """The alive particles' positions and FE, ordered by position."""
    alive = st["alive"].astype(bool)
    pos, fe = st["pos"][alive], st["FE"][alive]
    order = np.lexsort(pos.T)
    return pos[order], fe[order]


def _run_port(world, state, tmp_path, scene=_SCENE, frames=FRAMES):
    state_path = str(tmp_path / "state.npz")
    np.savez(state_path, **state)
    out_path = str(tmp_path / "port.npz")
    dryrun.run_ranks(dryrun.sim_rank, world, "cpu",
                     ("mpm", frames, state_path, out_path, scene),
                     timeout_s=SPAWN_TIMEOUT_S)
    return np.load(out_path)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_mpm_matches_jax(world, tmp_path):
    jsim = jsharded.ShardedMpmSim(
        jget_scene("mpm_cone", density=DENSITY),
        params=jmpm.MpmParams(pallas_transfer=True, pallas_interpret=True),
        mesh=_mesh(world))
    port = _run_port(world, _jax_state(jsim), tmp_path)
    for f in range(FRAMES):
        m = jsim.step()
        np.testing.assert_allclose(port["kinetic_energy"][f],
                                   float(m["kinetic_energy"]), rtol=1e-4,
                                   err_msg=f"frame {f}")
        for key in ("num_active_cells", "spd_fallback", "num_alive",
                    "migrated"):
            assert port[key][f] == int(m[key]), (key, f)
        assert abs(port["cg_iters"][f] - int(m["cg_iters"])) <= 1
        assert port["lost"][f] == 0 == int(m["lost"])
        assert port["min_det_fp"][f] > 0
        np.testing.assert_allclose(port["dt"][f], float(m["dt"]), rtol=1e-5)
    assert port["cg_iters"].min() > 0
    got = {k[len("state_"):]: port[k] for k in port.files
           if k.startswith("state_")}
    pos_p, fe_p = _by_position(got)
    pos_j, fe_j = _by_position(_jax_state(jsim))
    np.testing.assert_allclose(pos_p, pos_j, atol=1e-4)
    np.testing.assert_allclose(fe_p, fe_j, atol=1e-5)


def test_edge_band_floor_keeps_the_migrants(tmp_path):
    """The cone moved 5 cells right, to the boundary of slabs 1 and 2 at 3
    ranks, drifting right at one cell a frame: the JAX sizing (band 64,
    no boundary row occupied at seed time) drops the migrants of its
    first frame, the port's band carries them all."""
    world = 3
    scene = jget_scene("mpm_cone", density=DENSITY)
    jsim = jsharded.ShardedMpmSim(scene, mesh=_mesh(world))
    assert jsim.mig_cap == 64
    st = _jax_state(jsim)
    alive = st["alive"]
    st["pos"][alive, 0] += 5.0
    st["vel"][alive, 0] += 1000.0
    jsim.state = jsharded.ShardedMpmState(
        **{k: jax.numpy.asarray(v) for k, v in st.items()})
    jm = jsim.step()
    assert int(jm["lost"]) > 0
    port = _run_port(world, st, tmp_path, frames=1)
    assert int(port["mig_cap"]) > 64
    assert port["lost"][0] == 0
    assert port["migrated"][0] > int(jsim.mig_cap)
    assert port["num_alive"][0] == alive.sum()


@pytest.mark.parametrize("world", [2, 4])
def test_sizing_is_jax_sizing_with_the_floor(world):
    """The port's band is the JAX sim's or the floor, whichever is larger,
    and its cap keeps the tail insert's room."""
    scene = jget_scene("mpm_cone", density=DENSITY)
    jsim = jsharded.ShardedMpmSim(scene, mesh=_mesh(world))
    pos = np.asarray(jsim.state.pos)[np.asarray(jsim.state.alive)]
    nl, b = jsim.nl, scene.spec.bound
    xcell = (np.floor(np.abs(pos[:, 0]) + 0.5) * np.sign(pos[:, 0])
             + b).astype(int)
    owner = np.clip(xcell // nl, 0, world - 1)
    cap, mig, tail = mpm_migration_sizing(owner, xcell, nl, world, 1.35,
                                          0.06)
    cap0 = int(np.ceil(np.bincount(owner).max() * 1.35 / 8) * 8)
    assert mig == max(jsim.mig_cap, min(cap0, 8 * (cap0 // nl)))
    assert tail and jsim.tail_insert
    if mig == jsim.mig_cap:
        assert cap == jsim.cap
    assert 2 * mig <= cap - int(np.bincount(owner).max() * 1.15)


def test_world_one_matches_mpm_sim():
    single = MpmSim("mpm_cone", density=DENSITY, device="cpu")
    sim = ShardedMpmSim("mpm_cone", density=DENSITY, device="cpu")
    assert sim.num_particles == single.num_particles
    for _ in range(FRAMES):
        ms, mp = single.step(), sim.step()
        np.testing.assert_allclose(float(mp["kinetic_energy"]),
                                   float(ms["kinetic_energy"]), rtol=1e-5)
        assert mp["cg_iters"] == ms["cg_iters"]
        assert int(mp["num_active_cells"]) == int(ms["num_active_cells"])
        assert int(mp["lost"]) == 0
        np.testing.assert_allclose(float(mp["min_det_fp"]),
                                   float(ms["min_det_fp"]), rtol=1e-6)
    # one rank holds the box: its alive prefix is MpmSim's state, bit for bit
    p = single.num_particles
    for field in ("pos", "vel", "FE", "FP", "volume"):
        assert torch.equal(getattr(sim.state, field)[:p],
                           getattr(single.state, field)), field


def test_sharded_mpm_refuses_the_flip_spline():
    """No JAX sharded MPM path transfers on the FLIP spline, so the port
    has no reference for that frame and refuses it."""
    from fluidsim_tpu_torch import MpmParams

    with pytest.raises(ValueError, match="kernel"):
        ShardedMpmSim("mpm_cone", density=5.0, device="cpu",
                      params=MpmParams(kernel="flip"))
