"""The plain references against the program's CPU path at a small size,
frame by frame from the program's own state, and the control: the same
reference in bfloat16 fails the cell's limits."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness, small

SEED = 2 ** 31 + 7
CELLS = ["flip257.fall", "flip257.impact", "mpm255.fall"]


def _limits(cell):
    return json.loads((harness.HERE / "limits" / f"{cell}.json")
                      .read_text())["limits"]


def _frames(cell, frames=2):
    """(system, [(program state before, after)]) for each frame."""
    system = small.system(cell, SEED, frames=frames)
    system.restore()
    pairs = []
    for _ in range(frames):
        before = system.snapshot()
        system.step()
        pairs.append((before, system.snapshot()))
    return system, pairs


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_program(cell):
    system, pairs = _frames(cell)
    for before, after in pairs:
        gaps = system.gaps(after, system.reference(before))
        assert gaps, cell
        for name, v in gaps.items():
            assert v <= 1e-5, (cell, name, v)


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_fails_the_limits(cell):
    system, pairs = _frames(cell, frames=1)
    before, _after = pairs[0]
    want = system.reference(before)
    low = system.reference(before, torch.bfloat16)
    gaps = system.gaps(low, want)
    limits = _limits(cell)
    assert any(not v <= limits[name] for name, v in gaps.items()), gaps
