"""The landing cell's system (``benchmark/systems/mpm_resumed.py``) and the
hybrid solve's SPD fallback (``mpm.spd_resolve``) from the program's own
state mid-run, held to the benchmark's plain reference on the CPU at a
small size: the ``mpm255_resumed`` configuration cut to the cone at bound
15 and density 400, its hybrid solve capped at ``CAP`` exact CG
iterations, so that every frame falls back, the particles drawn from
positions seed 0 in an order drawn from the run's seed
(``traffic.cell_order``), a lead-in of ``LEAD_IN`` of the program's frames
stepped in set-up, and the span of ``SPAN`` frames started from their end.

Each frame of the span is held to ``benchmark/reference/mpm.py`` within
the cell's limits (``limits/mpm255_resumed.landing.json``), the SPD flag
included; the reference in bfloat16 in the program's place fails them; two
restores replay the span bit for bit; and two run seeds start the span
from one state, bit for bit, since the run's seed shuffles whole cells
only.
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness
from benchmark.systems import mpm_resumed

CONFIG = "mpm255_resumed"
LIMITS = "mpm255_resumed.landing"
SEED = 2 ** 31 + 26
CAP = 2             # the bound-15 cone's exact solve takes 4-6 iterations
LEAD_IN, SPAN = 2, 3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _system(seed: int = SEED):
    """The small cone's system, its start the state after ``LEAD_IN``
    frames."""
    cfg = json.loads((harness.HERE / "configs" / f"{CONFIG}.json")
                     .read_text())
    cfg.update(bound=15, density=400.0)
    cfg["params"]["cg_hybrid_cap"] = CAP
    mix = json.loads((harness.HERE / "traffic" / "landing.json").read_text())
    mix.update(lead_in={"mpm": LEAD_IN}, frames={"mpm": SPAN})
    return mpm_resumed.System(cfg, mix, seed, torch.device("cpu"))


def _limits():
    return json.loads((harness.HERE / "limits" / f"{LIMITS}.json")
                      .read_text())["limits"]


@pytest.fixture(scope="module")
def span():
    """(system, [(state before, frame metrics, state after)] over the
    span)."""
    system = _system()
    system.restore()
    frames = []
    for _ in range(system.frames):
        before = system.snapshot()
        metrics = system.sim.step()
        frames.append((before, metrics, system.snapshot()))
    return system, frames


def test_span_starts_after_the_lead_in(span):
    system, frames = span
    assert system.frames == SPAN
    assert int(system.start["frame"]) == LEAD_IN
    assert float(system.start["t"]) > 0
    assert all(int(before["frame"]) == LEAD_IN + i
               for i, (before, _m, _a) in enumerate(frames))


def test_span_follows_the_reference_with_its_spd_fallback(span):
    system, frames = span
    limits = _limits()
    for before, metrics, after in frames:
        want = system.reference(before)
        assert metrics["spd_fallback"] == 1
        assert metrics["spd_iters"] == metrics["cg_iters"] - CAP > 0
        assert want["spd"] == [True]
        for name, v in system.gaps(after, want).items():
            assert v <= limits[name], (name, v)


def test_bfloat16_control_fails_the_limits(span):
    system, frames = span
    before = frames[0][0]
    want = system.reference(before)
    gaps = system.gaps(system.reference(before, torch.bfloat16), want)
    limits = _limits()
    assert any(not v <= limits[name] for name, v in gaps.items()), gaps


def test_restores_replay_the_span_bit_for_bit(span):
    system, frames = span
    system.restore()
    for before, metrics, after in frames:
        again = system.step()
        assert again["cg_iters"] == metrics["cg_iters"]
        assert again["spd_iters"] == metrics["spd_iters"]
        state = system.snapshot()
        for key, v in after.items():
            assert torch.equal(state[key], v), key


def test_run_seeds_start_from_one_state(span):
    system, _frames = span
    other = _system(SEED + 1)
    assert set(other.start) == set(system.start)
    for key, v in system.start.items():
        assert torch.equal(other.start[key], v), key
