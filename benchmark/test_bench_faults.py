"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
small size, once for each fault that a cell can have (``small.plant``);
the cell of several cards over its ranks on gloo."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from benchmark import harness, small

ONE_CARD = ["flip257.fall", "flip257.impact", "mpm255.fall"]
SLABS = "mpm255_slab4.fall"


@pytest.mark.parametrize("fault", small.FAULTS[:4])
@pytest.mark.parametrize("cell", ONE_CARD)
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    system = small.system(cell, small.SEED, frames=3)
    small.plant(cell, fault, monkeypatch.setattr)
    out = harness.run(harness.HERE.parent, cell, small.SEED, 0.2, False,
                      time.time(), device="cpu", system=system)
    assert out["correct"] is (fault == "sound"), out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", small.FAULTS)
def test_a_broken_slab_step_is_not_correct(fault):
    done = subprocess.run([sys.executable, "-m", "benchmark.small", SLABS,
                           fault], cwd=harness.HERE.parent,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] is (fault == "sound"), out["checks"]
    assert out["device"]["count"] == 4
