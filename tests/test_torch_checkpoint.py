"""Checkpoints of the port (``fluidsim_tpu_torch/io/checkpoint.py``) against
the JAX package's: a checkpoint written by either package loads in the
other, FLIP, APIC (with ``aff``) and MPM, with every array bit for bit and
the same ``meta["params"]``; resume on the port is bit-exact; a checkpoint
of another state class is refused.

The JAX sims resolve ``pallas_transfer=None`` by their backend (False on
the CPU, True on a TPU) where the port keeps None, so both sides are given
``pallas_transfer=False``; every other field takes the scene's defaults."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.io import checkpoint as jckpt
from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu.models import mpm as jmpm
from fluidsim_tpu_torch.io import checkpoint as ckpt
from fluidsim_tpu_torch.models import flip, mpm
from fluidsim_tpu_torch.scenes import get_scene


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the frames are many small ops, and the
    other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sim(kind, frames=2):
    """(port sim stepped ``frames`` frames, the JAX sim's params)."""
    if kind == "mpm":
        scene = get_scene("mpm_cone", density=10.0)
        base = dict(bound=scene.spec.bound, wall=scene.spec.wall,
                    dx=scene.spec.dx, gravity=tuple(scene.gravity),
                    pallas_transfer=False)
        sim = mpm.MpmSim(scene, params=mpm.MpmParams(**base), device="cpu")
        jparams = jmpm.MpmSim("mpm_cone", params=jmpm.MpmParams(**base),
                              density=10.0).params
    else:
        scene = get_scene("water_cube_drop", bound=6, density=2.0)
        base = dict(bound=6, wall=scene.spec.wall, dx=scene.spec.dx,
                    gravity=tuple(scene.gravity), mode=kind,
                    pallas_transfer=False)
        sim = flip.FlipSim(scene, params=flip.FlipParams(**base), device="cpu")
        jparams = jflip.FlipSim("water_cube_drop", bound=6, density=2.0,
                                params=jflip.FlipParams(**base)).params
    for _ in range(frames):
        sim.step()
    return sim, jparams


def _arrays(state):
    """A state's fields as numpy arrays (None stays None)."""
    return {f.name: (None if getattr(state, f.name) is None
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def _assert_states_equal(port_state, arrays):
    for name, v in _arrays(port_state).items():
        w = arrays[name]
        if v is None:
            assert w is None, name
            continue
        assert v.dtype == w.dtype and v.shape == w.shape, name
        np.testing.assert_array_equal(v.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8),
                                      err_msg=name)


@pytest.mark.parametrize("kind", ["flip", "apic", "mpm"])
def test_checkpoints_cross_load(kind, tmp_path):
    sim, jparams = _sim(kind)
    cls = mpm.MpmState if kind == "mpm" else flip.FlipState
    jcls = jmpm.MpmState if kind == "mpm" else jflip.FlipState
    assert dataclasses.asdict(sim.params) == dataclasses.asdict(jparams)
    if kind == "apic":
        assert sim.state.aff is not None and bool(sim.state.aff.any())
    jstate = jcls(**{k: None if v is None else jnp.asarray(v)
                     for k, v in _arrays(sim.state).items()})

    # the JAX package writes, the port reads
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, jstate, jparams, extra={"by": "jax"})
    state, meta = ckpt.load_checkpoint(jpath, cls, device="cpu")
    _assert_states_equal(state, _arrays(sim.state))
    assert meta["extra"] == {"by": "jax"}

    # the port writes, the JAX package reads
    ppath = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(ppath, sim.state, sim.params)
    jloaded, pmeta = jckpt.load_checkpoint(ppath, jcls)
    _assert_states_equal(sim.state, _arrays(jloaded))
    assert pmeta["params"] == meta["params"]
    assert pmeta["state_class"] == meta["state_class"] == cls.__name__

    # the JAX checkpoint steps on the port as the state it was made from
    resumed, _ = _sim(kind, frames=0)
    resumed.state = state
    a, b = resumed.step(), sim.step()
    _assert_states_equal(resumed.state, _arrays(sim.state))
    assert float(a["kinetic_energy"]) == float(b["kinetic_energy"])


@pytest.mark.parametrize("kind", ["flip", "mpm"])
def test_resume_bit_exact(kind, tmp_path):
    sim, _ = _sim(kind)
    cls = mpm.MpmState if kind == "mpm" else flip.FlipState
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, sim.state, sim.params)
    for _ in range(2):
        sim.step()
    fresh, _ = _sim(kind, frames=0)
    fresh.state, meta = ckpt.load_checkpoint(path, cls, dtype=np.float32,
                                             device="cpu")
    assert meta["params"]["bound"] == sim.params.bound
    for _ in range(2):
        fresh.step()
    _assert_states_equal(fresh.state, _arrays(sim.state))


def test_checkpoint_wrong_class_rejected(tmp_path):
    sim, _ = _sim("flip", frames=0)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, sim.state, sim.params)
    with pytest.raises(ValueError, match="FlipState"):
        ckpt.load_checkpoint(path, mpm.MpmState, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        ckpt.load_checkpoint(path, flip.FlipState, dtype=np.float64,
                             device="cpu")
