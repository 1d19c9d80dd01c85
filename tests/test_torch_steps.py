"""``FlipSim.steps(k)`` / ``MpmSim.steps(k)`` and ``run(..., chunk=)`` of the
port: ``steps(k)`` is ``k`` calls of ``step()`` bit for bit (state and
stacked metrics), returns the JAX package's ``steps`` keys on a leading
(k,) axis without ``occupancy``, and ``run(chunk=)`` calls back once per
chunk with the chunk's last state, as the JAX contract says."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu.models import mpm as jmpm
from fluidsim_tpu_torch.models import flip, mpm


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the frames are many small ops, and the
    other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sim(kind):
    if kind == "mpm":
        return mpm.MpmSim("mpm_cone", density=10.0, device="cpu")
    return flip.FlipSim("water_cube_drop", bound=6, density=2.0,
                        device="cpu", mode=kind)


def _jax_steps_keys(kind):
    """The keys of the JAX package's ``steps`` (its frame's metrics, traced
    without running, less ``occupancy``)."""
    if kind == "mpm":
        sim = jmpm.MpmSim("mpm_cone", density=10.0)
        step = lambda s, st: jmpm.mpm_step(sim.params, s, st)  # noqa: E731
    else:
        sim = jflip.FlipSim("water_cube_drop", bound=6, density=2.0,
                            params=jflip.FlipParams(bound=6, wall=4,
                                                    mode=kind))
        step = lambda s, st: jflip.flip_step(sim.params, s, st)  # noqa: E731
    _, metrics = jax.eval_shape(step, sim.solid, sim.state)
    return set(metrics) - {"occupancy"}


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.reshape(-1).view(torch.uint8),
                    b.reshape(-1).view(torch.uint8)))


@pytest.mark.parametrize("kind", ["flip", "apic", "mpm"])
def test_steps_equal_step_calls(kind):
    k = 3
    a, b = _sim(kind), _sim(kind)
    stacked = a.steps(k)
    frames = [b.step() for _ in range(k)]
    for f in dataclasses.fields(a.state):
        assert _same(getattr(a.state, f.name), getattr(b.state, f.name)), f.name
    assert set(stacked) == set(frames[0]) - {"occupancy"}
    # the MPM frame counts its SPD solve's iterations beyond JAX's metrics
    assert set(stacked) == _jax_steps_keys(kind) | (
        {"spd_iters"} if kind == "mpm" else set())
    for key, v in stacked.items():
        assert v.shape[0] == k, key
        want = [f[key] for f in frames]
        if isinstance(want[0], torch.Tensor):
            assert _same(v, torch.stack(want)), key
        else:                              # host-side counts: int32, as JAX's
            assert v.dtype == torch.int32 and v.tolist() == want, key


@pytest.mark.parametrize("kind", ["flip", "mpm"])
def test_run_chunk_calls_back_per_chunk(kind):
    a, b = _sim(kind), _sim(kind)
    calls = []
    out = a.run(5, callback=lambda fr, st, m: calls.append(
        (fr, int(st.frame), m["kinetic_energy"].shape)), chunk=2)
    assert calls == [(1, 2, (2,)), (3, 4, (2,)), (4, 5, (1,))]
    assert out["kinetic_energy"].shape == (1,)
    per_frame = []
    b.run(5, callback=lambda fr, st, m: per_frame.append(fr))
    assert per_frame == [0, 1, 2, 3, 4]
    assert _same(a.state.pos, b.state.pos) and _same(a.state.vel, b.state.vel)


def test_run_chunk_checks_the_last_frame():
    sim = _sim("flip")
    sim.steps = lambda k: {"kinetic_energy": torch.tensor([1.0, np.nan]),
                           "dt": torch.tensor([0.1, 0.1])}
    with pytest.raises(FloatingPointError, match="non-finite"):
        sim.run(2, chunk=2)


def test_profiling_sync_and_phase_timer():
    """``sync`` hands back what it waited for; a phase is timed by its span,
    a shared no-op outside ``tracing()`` and a ``record_function`` range
    inside it."""
    from fluidsim_tpu_torch.utils import profiling
    from fluidsim_tpu_torch.utils.profiling import sync

    x = {"a": torch.ones(3), "b": 2}
    assert sync(x) is x and sync([torch.zeros(1)])[0].shape == (1,)
    assert profiling.span("step") is profiling.span("other")
    with profiling.tracing():
        with profiling.span("step") as phase:
            sync(torch.ones(4) * 2)
        assert phase is not None and phase.name == "fs:step"
    assert profiling.span("step") is profiling.span("other")