"""The program's trace spans and host-wait counter (``utils/profiling.py``):
where the frames open their spans, what the counters count, that tracing
off changes nothing, and how ``profiling.attribute`` reads a trace.

One frame each of ``FlipSim``, ``MpmSim`` and ``ShardedMpmSim`` (two gloo
ranks, spawned by ``parallel/dryrun.py``) runs at a small size under a CPU
``torch.profiler`` with the spans traced; the trace's ``fs:`` ranges are
read back as the profiler recorded them.  ``attribute`` is held to
synthetic events, since the CPU has no device timeline.
"""

import dataclasses
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fluidsim_tpu_torch.models.flip import FlipSim
from fluidsim_tpu_torch.models.mpm import MpmParams, MpmSim, frame_solves
from fluidsim_tpu_torch.parallel import dryrun
from fluidsim_tpu_torch.parallel.flip_sharded import W
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.utils import profiling

SPAWN_TIMEOUT_S = 180
# the MPM frames: few CG iterations, so that the profiler's record of their
# eager operations stays small
MPM_RTOL = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _traced_step(sim, on: bool = True):
    """One ``step()`` under a CPU profiler, the spans traced when ``on``:
    (its metrics, the trace's ``fs:`` ranges as (name, start, end), the
    host waits it made by site)."""
    before = Counter(profiling.host_wait.counts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if on:
            with profiling.tracing():
                m = sim.step()
        else:
            m = sim.step()
    ranges = [(e.name[len(profiling.PREFIX):], e.time_range.start,
               e.time_range.end) for e in prof.events()
              if e.name.startswith(profiling.PREFIX)]
    return m, ranges, profiling.host_wait.counts - before


def _parents(ranges):
    """Each range's enclosing ranges' names, innermost first."""
    out = []
    for name, a, b in ranges:
        around = sorted((r for r in ranges if r[1] <= a and b <= r[2]
                         and r != (name, a, b)), key=lambda r: -r[1])
        out.append((name, [r[0] for r in around]))
    return out


def _assert_nests(ranges, chain, every=True):
    """Every range named ``chain[-1]`` (with ``every`` False: one at least)
    lies inside the others of ``chain`` in that order (not necessarily
    directly)."""
    held = []
    for name, around in _parents(ranges):
        if name == chain[-1]:
            idx = [around.index(c) if c in around else -1
                   for c in chain[:-1]]
            held.append(-1 not in idx and idx == sorted(idx, reverse=True))
    assert held and (all(held) if every else any(held)), chain


def _assert_waits_in_frames(ranges):
    waits = [(n, around) for n, around in _parents(ranges)
             if n.startswith(profiling.WAIT)]
    assert waits and all("frame" in around for _n, around in waits)


def _states_equal(a, b):
    for key, v in vars(a).items():
        w = getattr(b, key)
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, w), key


def _flip():
    sim = FlipSim("water_cube_drop", bound=6, density=2.0, device="cpu")
    sim.step()
    return sim


def _mpm():
    scene = get_scene("mpm_cone", density=10.0)
    params = MpmParams(bound=scene.spec.bound, wall=scene.spec.wall,
                       gravity=tuple(scene.gravity), hessian="hybrid",
                       cg_rtol=MPM_RTOL)
    return MpmSim(scene, params, device="cpu")


def test_flip_frame_spans_nest_and_count_the_waits():
    sim = _flip()
    m, ranges, waits = _traced_step(sim)
    names = {r[0] for r in ranges}
    assert {"frame", "sort", "weights", "P2G", "projection", "G2P",
            "advection", "pcg", "pcg.apply", "pcg.precond"} <= names
    assert sum(r[0] == "frame" for r in ranges) == 1
    _assert_nests(ranges, ["frame", "projection", "pcg", "pcg.apply"])
    _assert_nests(ranges, ["frame", "projection", "pcg", "pcg.precond"])
    _assert_waits_in_frames(ranges)
    # each solve stops before its cap, so tests once more than it iterates
    assert m["outer_iters"] < sim.params.max_outer
    assert waits == {"pcg.test": m["cg_iters"] + m["outer_iters"],
                     "project.outer": m["outer_iters"],
                     "project.scale": 1, "upload.max_dt": 1}
    assert Counter(r[0][len(profiling.WAIT):] for r in ranges
                   if r[0].startswith(profiling.WAIT)) == waits


def test_mpm_frame_spans_nest_and_count_the_waits():
    sim = _mpm()
    m, ranges, waits = _traced_step(sim)
    for chain in (["frame", "solve", "pcg", "pcg.apply", "apply.gather"],
                  ["frame", "solve", "pcg", "pcg.apply", "apply.stress"],
                  ["frame", "solve", "pcg", "pcg.apply", "apply.scatter"],
                  ["frame", "hardening"], ["frame", "F update"],
                  ["frame", "stress"]):
        _assert_nests(ranges, chain)
    # the polar decomposition in the frame, the explicit force's sigma in
    # the solve
    assert sorted(around[0] for name, around in _parents(ranges)
                  if name == "stress") == ["frame", "solve"]
    assert "pcg.precond" not in {r[0] for r in ranges}
    applies = sum(r[0] == "pcg.apply" for r in ranges)
    solves, stopped = frame_solves(sim.params, m["cg_iters"],
                                   m["spd_fallback"])
    assert applies == m["cg_iters"] + solves
    _assert_waits_in_frames(ranges)
    assert waits == {"pcg.test": m["cg_iters"] + int(stopped),
                     "solve.hybrid_check": 1, "upload.gravity": 1,
                     "upload.cg_rtol": 1, "upload.max_dt": 1}


@pytest.mark.parametrize("cap", [1, 150])
def test_mpm_hybrid_solve_spans_its_two_operators(cap):
    """The exact CG opens ``solve.full`` once in every hybrid frame; a
    fallback (forced here by a cap of one iteration) opens ``solve.spd``
    once, and ``spd_iters`` counts the SPD solve's iterations alone."""
    sim = _mpm()
    sim.params = dataclasses.replace(sim.params, cg_hybrid_cap=cap)
    m, ranges, _waits = _traced_step(sim)
    names = Counter(r[0] for r in ranges)
    assert names["solve.full"] == 1
    _assert_nests(ranges, ["frame", "solve", "solve.full", "pcg"],
                  every=False)
    if cap == 1:
        assert m["spd_fallback"] == 1 and names["solve.spd"] == 1
        assert m["spd_iters"] == m["cg_iters"] - cap > 0
        _assert_nests(ranges, ["frame", "solve", "solve.spd", "pcg"],
                      every=False)
    else:
        assert m["spd_fallback"] == 0 and "solve.spd" not in names
        assert m["spd_iters"] == 0 and m["cg_iters"] < cap
    assert names["pcg"] == 1 + m["spd_fallback"]


@pytest.mark.parametrize("kind", ["flip", "mpm"])
def test_tracing_off_enters_no_range_and_changes_nothing(kind):
    """From the same state, a frame with tracing off opens no ``fs:`` range
    and leaves the state that the frame with tracing on leaves, bit for
    bit, with the same host waits."""
    sim = _flip() if kind == "flip" else _mpm()
    start = sim.state
    m_on, ranges_on, waits_on = _traced_step(sim, on=True)
    state_on = sim.state
    sim.state = start
    m_off, ranges_off, waits_off = _traced_step(sim, on=False)
    assert ranges_on and not ranges_off
    assert waits_on == waits_off and m_on["cg_iters"] == m_off["cg_iters"]
    _states_equal(state_on, sim.state)


def test_sharded_mpm_frame_counts_its_collectives(tmp_path):
    """Two gloo ranks: the slab frame's spans nest as one card's, the
    exchanges and reductions run in theirs, and the bytes each rank hands
    the collectives are those of the slab's shapes: per rank at world 2,
    one neighbour each."""
    out = str(tmp_path / "trace.npz")
    params = MpmParams(hessian="hybrid", cg_rtol=MPM_RTOL)
    dryrun.run_ranks(dryrun.trace_rank, 2, "cpu",
                     (out, dict(scene="mpm_cone", density=10.0,
                                params=params)),
                     timeout_s=SPAWN_TIMEOUT_S)
    d = np.load(out)
    ranges = list(zip(d["names"].tolist(), d["starts"], d["ends"]))
    ranges = [(n[len(profiling.PREFIX):], a, b) for n, a, b in ranges]
    for chain in (["frame", "solve", "pcg", "pcg.apply", "apply.gather",
                   "halo"],
                  ["frame", "solve", "pcg", "pcg.apply", "apply.scatter",
                   "halo"],
                  ["frame", "solve", "pcg", "all_reduce"],
                  ["frame", "migrate", "halo"], ["frame", "P2G", "halo"]):
        _assert_nests(ranges, chain, every=False)
    _assert_nests(ranges, ["frame", "halo"])
    _assert_nests(ranges, ["frame", "all_reduce"])
    _assert_waits_in_frames(ranges)
    cg, spd = int(d["cg_iters"]), int(d["spd_fallback"])
    solves = 1 + spd
    _, stopped = frame_solves(MpmParams(hessian="hybrid"), cg, spd)
    waits = {k[len("wait_"):]: int(d[k]) for k in d.files
             if k.startswith("wait_") and int(d[k])}
    assert waits == {"pcg.test": cg + int(stopped), "solve.hybrid_check": 1,
                     "upload.gravity": 1, "upload.cg_rtol": 1,
                     "upload.max_dt": 1, "migrate.lost": 1}

    n, f4 = int(d["n"]), 4
    plane = W * n * n
    applies = cg + solves
    # f32 fields of (channels) planes: P2G fold 4, mass 1, f0 fold 3, each
    # apply's halo and fold 3 + 3, gradV 3, the FLIP delta's two halos 3 + 3
    fields = 4 + 1 + 3 + 6 * applies + 3 + 6
    f = min(int(d["mig_cap"]), int(d["cap"]))
    assert bool(d["tail_insert"])
    band = f * 25 * f4 + f                 # payload rows and uint8 mask
    assert int(d["shift_pair.bytes"]) == fields * plane * f4 + plane + band
    # P2G, mass, active mask, f0; two an apply; gradV, two FLIP delta;
    # migration
    assert int(d["shift_pair.calls"]) == 4 + 2 * applies + 3 + 1
    # each solve: |b|^2 and the first pair, then a dot and a pair an
    # iteration; |b|^2 of the hybrid check, max speed, KE, 4 int64 counts,
    # min det FP
    assert int(d["all_reduce.bytes"]) == (12 * solves + 12 * cg + 4 + 4 + 4
                                          + 32 + 4)
    assert int(d["all_reduce.calls"]) == 2 * solves + 2 * cg + 5


def _ev(name, start, end, *, device=False, id=0, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU, id=id,
        is_user_annotation=annotation)


def _synthetic_trace():
    """A frame (0-100 us on the host) with a projection, a CG solve inside
    it and a host wait inside that; kernels launched in each."""
    return [
        _ev("fs:frame", 0, 100, id=1, annotation=True),
        _ev("fs:projection", 10, 90, id=2, annotation=True),
        _ev("fs:pcg", 20, 80, id=3, annotation=True),
        _ev("fs:wait:pcg.test", 50, 70, id=4, annotation=True),
        # the device-side copies of two ranges: no device work
        _ev("fs:pcg", 25, 75, device=True, id=3, annotation=True),
        _ev("fs:frame", 5, 150, device=True, id=1, annotation=True),
        # an op in the frame's self part and its launch (the op's own id
        # may equal a kernel's: only the launch call's counts)
        _ev("aten::add", 2, 4, id=502),
        _ev("cudaLaunchKernel", 3, 4, id=501),
        _ev("add_kernel", 30, 40, device=True, id=501),
        # a launch in the solve: its kernel counts for pcg, not projection
        _ev("cuLaunchKernel", 22, 23, id=502),
        _ev("k3", 40, 55, device=True, id=502),
        # a launch in the projection's self part
        _ev("cudaMemsetAsync", 12, 14, id=503),
        _ev("memset", 60, 62, device=True, id=503),
        # a kernel whose launch the trace does not hold
        _ev("nccl_kernel", 95, 99, device=True, id=504),
    ]


def test_attribute_gives_kernels_to_the_innermost_span_of_their_launch():
    out = profiling.attribute(_synthetic_trace(), window=(0, 100))
    assert out["spans"] == pytest.approx({"frame": 10e-6, "pcg": 15e-6,
                                          "projection": 2e-6})
    assert out["unattributed_s"] == pytest.approx(4e-6)
    # the device-side copies of ranges are neither device time nor busy
    assert out["device_s"] == pytest.approx(31e-6)
    assert out["busy_s"] == pytest.approx(31e-6)     # 30-55, 60-62, 95-99
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["calls"] == {"frame": 1, "projection": 1, "pcg": 1,
                            "wait:pcg.test": 1}


def test_attribute_counts_wait_idle_in_gaps_that_start_in_a_wait():
    # gaps: 0-30 (starts outside), 55-60 (starts at 55, in the wait 50-70),
    # 62-95 (starts at 62, in the wait), 99-100 (outside)
    out = profiling.attribute(_synthetic_trace(), window=(0, 100))
    assert out["wait_idle_s"] == pytest.approx((5 + 33) * 1e-6)
    assert out["wait_idle"] == pytest.approx({"pcg.test": 38e-6})
    no_wait = [e for e in _synthetic_trace()
               if not e.name.startswith("fs:wait:")]
    assert profiling.attribute(no_wait, window=(0, 100))["wait_idle_s"] == 0
    # the default window: the first range's start to the last end
    assert profiling.attribute(_synthetic_trace())["window_s"] == \
        pytest.approx(100e-6)


def test_host_wait_counts_every_call_and_spans_only_while_tracing():
    before = profiling.host_wait.counts["test.site"]
    x = torch.tensor([3.0])
    assert profiling.host_wait("test.site", float, x) == 3.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.tracing():
            with profiling.tracing():
                profiling.host_wait("test.site", bool, x > 0)
            assert profiling.span("a") is not profiling.span("a")
        profiling.host_wait("test.site", int, x)
    assert profiling.host_wait.counts["test.site"] == before + 3
    names = [e.name for e in prof.events() if e.name.startswith("fs:")]
    assert names == ["fs:wait:test.site"]
    assert profiling.span("a") is profiling.span("b")
