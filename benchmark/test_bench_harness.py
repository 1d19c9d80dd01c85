"""CPU tests of the harness's pieces: the seeder, the start states, span
replay, the trace arithmetic, the metric readers and the byte counts."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from benchmark import harness, scenes, small, tracing, traffic, work_bytes
from benchmark.metrics import (device_idle_share, frame_ms_p95,
                               frames_per_s, host_syncs_per_frame,
                               kernels_roofline)

SEED = 2 ** 31 + 99


@pytest.mark.parametrize("scene,bound,density", [
    ("water_cube_drop", 16, 4.0), ("water_cube_drop", 20, 16.0),
    ("mpm_cone", 15, 400.0), ("mpm_cone", 31, 400.0)])
def test_seeder_follows_the_seeding_rule(scene, bound, density):
    from fluidsim_tpu_torch.scenes import get_scene
    from fluidsim_tpu_torch.seeding import seed_particles

    sc = get_scene(scene, bound=bound, density=density)
    assert np.array_equal(scenes.seed_mask(scene, bound, "cpu").numpy(),
                          sc.seed_mask)
    theirs, _ = seed_particles(sc, seed=0)
    ours = scenes.seed_particles(scene, bound, density, SEED, "cpu")
    assert ours.dtype == torch.float32
    assert bool((ours.abs() < bound - 2).all())
    if scene == "water_cube_drop":     # nothing is filtered: the count is exact
        assert ours.shape[0] == theirs.shape[0]
    else:                              # the floor layer's jitter is filtered
        assert abs(ours.shape[0] - theirs.shape[0]) < 5 * math.sqrt(
            theirs.shape[0])
    again = scenes.seed_particles(scene, bound, density, SEED, "cpu")
    assert torch.equal(ours, again)


def test_pre_impact_start_is_free_fall_to_one_cell_above_the_floor():
    spec = harness.load(harness.HERE.parent, "flip257.impact")
    cfg = dict(spec["cfg"], bound=12, density=4.0)
    mix = spec["mix"]
    seeded = scenes.seed_particles("water_cube_drop", 12, 4.0,
                                   mix["positions_seed"], "cpu")
    pos, vel, dt = traffic.start_particles(cfg, mix, SEED, "cpu")
    plane = -(12 - 2) - 0.5
    assert float(pos[:, 1].min()) == pytest.approx(plane + 1.0, abs=1e-5)
    drop = float(seeded[:, 1].min() - pos[:, 1].min())
    # the same particles moved down rigidly, in the seed's order
    for axis, shift in ((0, 0.0), (1, drop), (2, 0.0)):
        assert torch.allclose(torch.sort(seeded[:, axis]).values - shift,
                              torch.sort(pos[:, axis]).values, atol=1e-5)
    other, _, _ = traffic.start_particles(cfg, mix, SEED + 1, "cpu")
    assert not torch.equal(other, pos)
    assert torch.equal(torch.sort(other[:, 0]).values,
                       torch.sort(pos[:, 0]).values)
    # whole cells shuffled: the frame's stable sort by cell gives one
    # sequence for every seed
    from fluidsim_tpu_torch.ops.transfer_kernels import sort_by_cell
    mine = sort_by_cell(pos, vel, 12)
    theirs = sort_by_cell(other, vel, 12)
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)
    speed = math.sqrt(2 * 10.0 * drop)
    assert torch.allclose(vel, torch.tensor([0.0, -speed, 0.0]).expand_as(vel))
    assert dt == pytest.approx(min(0.1, 1.0 / speed))


@pytest.mark.parametrize("cell", ["flip257.fall", "mpm255.fall"])
def test_span_replays_bit_for_bit(cell):
    system = small.system(cell, SEED, frames=3)
    passes = []
    for _ in range(2):
        system.restore()
        counts = [system.step() for _ in range(system.frames)]
        passes.append(([c["cg_iters"] for c in counts], system.snapshot()))
    assert passes[0][0] == passes[1][0]
    for key, v in passes[0][1].items():
        assert torch.equal(v, passes[1][1][key]), key


def _event(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_trace_summary_arithmetic():
    cuda = DeviceType.CUDA
    events = [
        _event(tracing.WINDOW, 0, 1000),
        _event(tracing.WINDOW, 0, 1000, cuda),        # its device-side copy
        _event(tracing.FRAME, 10, 500), _event(tracing.FRAME, 500, 990),
        _event("phase:projection", 100, 550),
        _event("cudaStreamSynchronize", 150, 200),
        _event("cudaStreamSynchronize", 995, 999),    # outside the frames
        _event("cudaMemcpyAsync", 120, 121),           # not a wait
        _event("cudaDeviceSynchronize", 600, 650),
        _event("k1", 50, 150, cuda), _event("k2", 100, 300, cuda),
        _event("k1", 700, 800, cuda), _event("k3", -50, 20, cuda),
    ]
    s = tracing.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-6)
    # union: [0, 20], [50, 300], [700, 800]
    assert s["busy_s"] == pytest.approx(370e-6)
    assert s["device_s"] == pytest.approx((100 + 200 + 100 + 20) * 1e-6)
    assert s["host_syncs"] == 2
    assert s["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    gaps = [g for _, g in s["idle_gaps"]]
    assert gaps == pytest.approx([400e-6, 200e-6, 30e-6])
    assert s["idle_gaps"][0][0] == "projection"
    assert s["idle_gaps"][1][0] == "between phases"
    rec = harness.Record(trace=s, traced_frames=2, frame_bytes=[3.35e12 * 1e-4],
                         frames=0, window_s=1.0, frame_ms=[])
    assert device_idle_share.read(rec) == pytest.approx(63.0)
    assert host_syncs_per_frame.read(rec) == 1.0
    assert kernels_roofline.read(rec) == pytest.approx(100 * 1e-4 / 420e-6)
    assert frames_per_s.read(rec) is None


def test_p95_is_over_all_frames():
    ms = [10.0] * 90 + [300.0] * 10
    rec = harness.Record(frame_ms=ms, frames=100, window_s=3.9)
    assert frame_ms_p95.read(rec) == pytest.approx(300.0)
    assert frames_per_s.read(rec) == pytest.approx(100 / 3.9)
    ms = list(range(1, 101))
    assert frame_ms_p95.read(harness.Record(frame_ms=ms)) == pytest.approx(95.05)


def test_byte_counts_match_the_kernel_table():
    # PERF.md's kernel table at 129^3 / 1,987,675 particles and the 127^3
    # cone / 473,798: K1 281.5 MB, K2 255.9 MB (91,134 cells read), K1 fg
    # 203.3 MB
    assert work_bytes.p2g(1_987_675, 129) / 1e6 == pytest.approx(281.5, abs=0.05)
    assert work_bytes.g2p(1_987_675, 91_134) / 1e6 == pytest.approx(255.9,
                                                                    abs=0.05)
    assert work_bytes.force_scatter(473_798, 127) / 1e6 == pytest.approx(
        203.3, abs=0.05)
    one = work_bytes.flip_frame(1000, 33, 500, 1, 10)
    assert work_bytes.flip_frame(1000, 33, 500, 2, 10) - one == \
        work_bytes.outer_pass(500)
    assert work_bytes.flip_frame(1000, 33, 500, 1, 11) - one == \
        work_bytes.cg_iteration(500)


@pytest.mark.parametrize("cg", [(0, 255, 42, 30, 30), (4,) * 10])
def test_checked_frames_hold_the_start_and_the_heaviest(cg):
    counts = [{"cg_iters": c} for c in cg]
    chosen = harness.frames_to_check(counts, SEED)
    heavy = max(range(len(cg)), key=lambda f: (cg[f], -f))
    assert 0 in chosen and heavy in chosen
    assert len(chosen) == harness.CHECKED == len(set(chosen))
    assert chosen == harness.frames_to_check(counts, SEED)


def test_window_copies_nothing_of_the_state():
    system = small.system("flip257.fall", SEED, frames=2)
    harness.warm_up(system)

    def refuse():
        raise AssertionError("a copy of the state in the window")
    system.snapshot = refuse
    window_s, frame_ms, counts = harness._window(system, 0.0, lambda: None,
                                                 torch.device("cpu"))
    assert len(frame_ms) == len(counts) == 1 and window_s > 0


@pytest.mark.parametrize("cell", ["flip257.fall", "mpm255.fall"])
def test_comparison_is_blind_to_the_particles_order(cell):
    system = small.system(cell, SEED, frames=1)
    system.restore()
    system.step()
    state = system.snapshot()
    perm = torch.randperm(state["pos"].shape[0],
                          generator=torch.Generator().manual_seed(3))
    shuffled = {k: (v[perm] if v.dim() and v.shape[0] == perm.shape[0]
                    else v) for k, v in state.items()}
    gaps = system.gaps(shuffled, state)
    assert set(gaps) >= {"moved_share", "pos_gap_cells", "vel_gap"}
    for name, v in gaps.items():
        assert v == pytest.approx(0.0, abs=1e-12), name


def test_keep_worst_keeps_a_nan():
    d = {}
    harness.keep_worst(d, {"a": 1.0, "b": float("nan")})
    harness.keep_worst(d, {"a": 2.0, "b": 5.0})
    harness.keep_worst(d, {"a": 0.5, "b": 6.0})
    assert d["a"] == 2.0 and math.isnan(d["b"])
