"""CPU test of ``spans.py``, the tool that runs a cell's profiled pass with
the program's spans off and on: both turns read the same counts, and only
the turn with the spans on reads them."""

from __future__ import annotations

import torch

from benchmark import harness, small, spans


def test_profiled_pass_reads_the_counters_in_both_turns():
    system = small.system("flip257.fall", small.SEED, frames=2)
    warm = harness.warm_up(system)
    off, on = (spans.profiled_pass(system, torch.device("cpu"), turn)
               for turn in (False, True))
    assert off["cg_iters_per_frame"] == on["cg_iters_per_frame"] == sum(
        c["cg_iters"] for c in warm) / 2
    assert off["host_waits_by_site"] == on["host_waits_by_site"]
    sites = on["host_waits_by_site"]
    assert sites["pcg.test"] > on["cg_iters_per_frame"]
    assert sites["project.scale"] == sites["upload.max_dt"] == 1
    assert off["comm_mb_per_frame"] == on["comm_mb_per_frame"] == 0
    assert "span_ms_per_frame" in on and "span_ms_per_frame" not in off
    assert on["device_idle_share"] == 100.0     # the CPU has no device
