"""The MPM implicit solve on the FLIP transfer spline, traced iteration by
iteration in both packages: ``mpm_cone`` at bound 15, density 40, with
``MpmParams(kernel="flip")`` and ``precond="none"``, frame 2 (the input of
``tests/test_torch_mpm_spline.py``, where JAX stops at 66 CG iterations
and the port at 68-69 on the CPU, 66 on an H100).

Both frames start from the JAX state after frames 0 and 1, so the two
solves differ only in the order of their f32 sums.  Each package's
``pcg`` runs as its frame calls it, with a preconditioner wrapped around
the frame's own (none: the identity) that records ``sum(r * r)`` of every
residual it is given: once for the initial residual and once per
iteration, the value the loop's stopping test reads.  The wrap is outside
either package; the JAX frame with it equals the frame without it bit for
bit.

What the trace shows (bound 15, frame 2, torch on one thread): each
solver stops at the first iteration whose residual meets its tolerance;
the residual is not monotone on this operator and hovers within 1-50x
the tolerance for its last ~15 iterations (JAX: 2.94x, 2.25x, then
0.947x at 66; the port: 1.14x, 1.06x, then 0.414x at 68; on torch's
default threads its sums run in another order and it stops at 69).  The
two sequences part slowly from the first iteration (7.7e-6 relative at
iteration 0, 1e-2 by 20, O(1) past 45).  The same JAX frame on the same
particles in another order (a random permutation: the sorts keep each
cell's particles in input order, so only the order of the sums changes)
parts from itself as fast and stops at 68, 69 and 69: from iteration 4
on, where those departures reach the port's initial 7.7e-6, the port's
stays within 1.46x of theirs.  The gap in the count is the f32
summation order, not a fault of the port.
"""

import numpy as np
import pytest
import torch
from functools import partial

import jax
import jax.numpy as jnp

from fluidsim_tpu.models import mpm as jmpm
from fluidsim_tpu.ops import pcg as jpcg
from fluidsim_tpu_torch import interop
from fluidsim_tpu_torch.models import mpm as tmpm
from fluidsim_tpu_torch.ops import pcg as tpcg

DENSITY = 40.0
PERMUTATIONS = 3
_KEYS = ("pos", "vel", "FE", "FP", "volume", "dt", "t", "frame")
_PARTICLE_KEYS = ("pos", "vel", "FE", "FP", "volume")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_recording_pcg(logs):
    """JAX ``pcg`` with a preconditioner that records ``sum(r * r)`` and
    ``sum(b * b)`` on the host for each residual it is given, into
    ``logs[-1]`` (one trace serves every run)."""
    def pcg(apply_a, b, x0=None, precond=None, rtol=1e-5, maxiter=200,
            **kw):
        inner = precond or (lambda r: r)

        def rec(r):
            jax.debug.callback(
                lambda rr, bb: logs[-1].append((float(rr), float(bb))),
                jnp.sum((r * r).astype(jnp.float32)),
                jnp.sum((b * b).astype(jnp.float32)), ordered=True)
            return inner(r)
        return jpcg.pcg(apply_a, b, x0=x0, precond=rec, rtol=rtol,
                        maxiter=maxiter, **kw)
    return pcg


def _torch_recording_pcg(log):
    """The port's ``pcg`` with the same recording preconditioner."""
    def pcg(apply_a, b, x0=None, precond=None, rtol=1e-5, maxiter=200,
            **kw):
        inner = precond or (lambda r: r)
        bb = float(torch.sum((b * b).to(torch.float32)))

        def rec(r):
            log.append((float(torch.sum((r * r).to(torch.float32))), bb))
            return inner(r)
        return tpcg.pcg(apply_a, b, x0=x0, precond=rec, rtol=rtol,
                        maxiter=maxiter, **kw)
    return pcg


@pytest.fixture(scope="module")
def traces():
    params = dict(kernel="flip", precond="none")
    jsim = jmpm.MpmSim("mpm_cone", density=DENSITY,
                       params=jmpm.MpmParams(**params))
    tsim = tmpm.MpmSim("mpm_cone", density=DENSITY, device="cpu",
                       params=tmpm.MpmParams(**params))
    for _ in range(2):
        jsim.step()
    state = {k: np.array(getattr(jsim.state, k)) for k in _KEYS}
    rtol = jsim.params.cg_rtol
    assert tsim.params.cg_rtol == rtol

    jstate = lambda st: jmpm.MpmState(**{k: jnp.asarray(v)
                                         for k, v in st.items()})
    ref = jsim.step()                     # the frame as the sim runs it
    runs = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jmpm, "pcg", _jax_recording_pcg(runs))
    recorded = jax.jit(partial(jmpm.mpm_step, jsim.params))

    def record(st):
        runs.append([])
        new, m = recorded(jsim.solid, jstate(st))
        jax.effects_barrier()
        return runs[-1], new, int(m["cg_iters"])

    logs, iters = {}, {}
    logs["jax"], rec_state, iters["jax"] = record(state)
    # the recording leaves the JAX frame as it was
    assert iters["jax"] == int(ref["cg_iters"])
    np.testing.assert_array_equal(np.asarray(rec_state.vel),
                                  np.asarray(jsim.state.vel))
    rng = np.random.default_rng(0)
    for i in range(PERMUTATIONS):
        perm = rng.permutation(state["pos"].shape[0])
        logs[f"perm{i}"], _, iters[f"perm{i}"] = record(
            {k: (v[perm] if k in _PARTICLE_KEYS else v)
             for k, v in state.items()})

    tsim.state = interop.mpm_state_from_numpy(state, device="cpu")
    logs["port"] = []
    mp.setattr(tmpm, "pcg", _torch_recording_pcg(logs["port"]))
    iters["port"] = tsim.step()["cg_iters"]
    mp.undo()
    return logs, iters, rtol, jsim.params.cg_maxiter


def _rr(log):
    return np.asarray([rr for rr, _ in log], np.float64)


def test_each_solver_stops_where_its_residual_first_meets_the_tolerance(
        traces):
    logs, iters, rtol, maxiter = traces
    for name, log in logs.items():
        # the initial residual and one per iteration
        assert len(log) == iters[name] + 1, name
        rr = _rr(log)
        tol2 = np.float32(rtol) ** 2 * np.float32(log[0][1])
        met = np.flatnonzero(rr <= tol2)
        assert iters[name] < maxiter
        assert met.size and met[0] == iters[name], (name, met[:3])
        # the end hovers near the tolerance: every one of the last 10
        # residuals before the stop within 50x of it
        assert (rr[iters[name] - 10:iters[name]] / tol2 < 50).all(), name


def test_port_residuals_part_from_jax_as_jax_parts_from_itself(traces):
    """The initial residuals agree within 1e-4 relative (``r0 = b - A b``
    cancels to ``beta dt^2 H b / m``: its f32 sums keep ~5 digits).
    From the iteration where the JAX frame on permuted particles has
    parted from itself by as much, up to the first stop, the port's
    largest relative departure from the JAX residuals so far stays within
    2x the largest departure of the permuted frames so far."""
    logs, iters, _, _ = traces
    stop = min(iters.values())
    ref = _rr(logs["jax"])[:stop + 1]

    def departure(name):
        rr = _rr(logs[name])[:stop + 1]
        return np.maximum.accumulate(np.abs(rr - ref) / ref)

    port = departure("port")
    envelope = np.max([departure(f"perm{i}") for i in range(PERMUTATIONS)],
                      axis=0)
    assert port[0] < 1e-4
    start = int(np.argmax(envelope >= port[0]))
    assert envelope[start] >= port[0] and start < stop // 4
    assert (port[start:] <= 2.0 * envelope[start:]).all(), start
    # the permuted frames stop apart from the unpermuted one too
    assert any(iters[f"perm{i}"] != iters["jax"]
               for i in range(PERMUTATIONS))


def test_cg_trace_records_what_the_loop_tests():
    """``cg_trace.recording_pcg``: one entry per solve, ``rr`` the initial
    residual and one per iteration, the last the first at or under
    ``tol2``; the solve is the same as without the recording."""
    from fluidsim_tpu_torch.validation import cg_trace

    g = torch.Generator().manual_seed(0)
    m = torch.randn(40, 40, generator=g)
    a = m @ m.T + 40.0 * torch.eye(40)
    b = torch.randn(40, generator=g)
    solves = []
    res = cg_trace.recording_pcg(solves)(lambda x: a @ x, b, rtol=1e-6,
                                         maxiter=100)
    assert len(solves) == 1 and len(solves[0]["rr"]) == res.iters + 1
    rr = np.asarray(solves[0]["rr"])
    assert (rr[:-1] > solves[0]["tol2"]).all()
    assert rr[-1] <= solves[0]["tol2"]
    again = tpcg.pcg(lambda x: a @ x, b, rtol=1e-6, maxiter=100)
    assert again.iters == res.iters and torch.equal(again.x, res.x)


def test_cg_trace_reruns_frames_bit_for_bit():
    from fluidsim_tpu_torch.validation import cg_trace

    out = cg_trace.run(bound=8, frames=2, device="cpu", every=True)
    assert [t["frame"] for t in out["traced"]] == [0, 1]
    for t in out["traced"]:
        assert t["rerun_same"]
        (solve,) = t["solves"]
        assert solve["iters"] == t["cg_iters"] and solve["end"] <= 1.0
    assert tmpm.pcg is tpcg.pcg             # the frame's solver restored
