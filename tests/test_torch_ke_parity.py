"""Cross-implementation kinetic-energy parity of the port — the counterpart
of ``tests/test_ke_parity.py``: the port's FLIP and MPM frames and the C++
ports of the reference (``native/ref_cpu``, ``native/ref_mpm``) run the
same initial particles, through ``validation.ke_parity`` with
``native=True``, and their per-frame kinetic-energy traces must track each
other with that test's bounds and skip rule.

FLIP: ``water_cube_drop`` at bound 16, density 4 (5,324 particles), 25
frames: the free-fall frames 0-7 within 5% (measured 4.4e-7), the median
over the run under 25% (1.9e-5), correlation above 0.99 (0.99982).
MPM: ``mpm_cone`` at bound 15, density 100 (1,545 particles), 12 frames:
the median relative error under 5e-4 (5.1e-5), the largest under 5e-3
(1.3e-4), dt within rtol 1e-4.  And the recorded MPM trace beside the
JAX package's frames on this CPU (the last case).

Run as a script, the file measures how fast the port and the JAX package
part over a longer run on this CPU (torch on one thread), beside the JAX
package's recorded TPU run where there is one:

    PYTHONPATH=. python tests/test_torch_ke_parity.py [--frames 100] \
        [--bound 31]

It prints one JSON line: the compat-seeded 31^3 cone (``soak_mpm``'s run)
for ``--frames`` frames, port against JAX, JAX and the port against the
TPU record ``docs/mpm_trace_500frames.json``; with ``--bound`` also the
default-seeded cone at that bound, port against JAX.  Each as the
relative kinetic-energy departure at every 10th frame and the largest.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from fluidsim_tpu_torch.validation import ke_parity


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _buildable(name):
    try:
        ke_parity.native_binary(name)
    except Exception:
        return False
    return True


@pytest.mark.skipif(not _buildable("ref_cpu"), reason="ref_cpu not buildable")
def test_ke_trace_matches_cpp_port():
    res = ke_parity.flip(frames=25, bound=16, density=4.0, seeder="default",
                         device="cpu", native=True)
    par = res["parity"]
    assert res["particles"] == 5324 and par["frames"] == 25
    assert par["fall_rel_max"] < 0.05, par
    assert par["rel_median"] < 0.25, par
    assert par["correlation"] > 0.99, par
    assert res["pass"] and res["oracle_source"] == "native/ref_cpu"


@pytest.mark.skipif(not _buildable("ref_mpm"), reason="ref_mpm not buildable")
def test_mpm_ke_trace_matches_cpp_port():
    res = ke_parity.mpm(frames=12, density=100.0, device="cpu", native=True)
    par = res["parity"]
    assert res["particles"] == 1545 and par["frames"] == 12
    assert par["rel_median"] < 5e-4, par
    assert par["rel_max"] < 5e-3, par
    assert par["dt_rel_max"] <= 1e-4, par
    assert res["pass"]


def _jax_ke(frames, bound=None, compat=False):
    """The JAX package's ``MpmSim`` on ``mpm_cone`` (its default bound, or
    ``bound``; compat-seeded on request) on this CPU: per-frame kinetic
    energy."""
    from fluidsim_tpu.compat.scatter import seed_particles_compat
    from fluidsim_tpu.models import mpm as jmpm

    kw = {} if bound is None else {"bound": bound}
    if compat:
        kw["seeder"] = seed_particles_compat
    jsim = jmpm.MpmSim("mpm_cone", **kw)
    return [float(jsim.step()["kinetic_energy"]) for _ in range(frames)]


def test_mpm_cone_record_against_the_jax_package_on_the_cpu():
    """``ke_parity mpm`` on its record (``docs/mpm_parity_cone.json``, the
    default 31^3 cone, 6,206 particles) for 31 frames, beside the JAX
    package's ``MpmSim`` on this CPU: the port tracks the JAX frames
    within rtol 1e-4, and both stand about as far from the C++ record
    (median relative error over frames 0-30: 5.9e-5 the port, 4.5e-5 JAX)
    and farther than the JAX run the record keeps (``jax_ke``, on a TPU:
    1.3e-5)."""
    from fluidsim_tpu_torch.validation import traces

    frames = 31
    res = ke_parity.mpm(frames=frames, device="cpu")
    assert res["pass"] and res["particles"] == 6206
    jke = _jax_ke(frames)
    np.testing.assert_allclose(res["ke"], jke, rtol=1e-4)
    rec = traces.load(traces.MPM_PARITY)
    ref = rec["ref_ke"][:frames]
    med = lambda ke: float(np.median(traces.rel_err(ke, ref, 1.0)))
    assert med(rec["jax_ke"][:frames]) < min(med(jke), med(res["ke"]))


def _departure(ke, ref) -> dict:
    from fluidsim_tpu_torch.validation import traces

    rel = traces.rel_err(ke, ref)
    return {"rel_every10": rel[::10].tolist(), "rel_max": float(rel.max())}


def main(argv=None) -> dict:
    import jax

    from fluidsim_tpu_torch.models.mpm import MpmSim
    from fluidsim_tpu_torch.validation import soak_mpm, traces

    ap = argparse.ArgumentParser(description="the port and the JAX package "
                                 "on this CPU over a longer MPM run")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--bound", type=int, default=None)
    a = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    _, rows, _ = soak_mpm.run(a.frames, device="cpu")
    port = [r["kinetic_energy"] for r in rows]
    jke = _jax_ke(a.frames, compat=True)
    rec = [r["ke"] for r in traces.load(traces.MPM_SOAK)][:a.frames]
    out = {"frames": a.frames, "cone31_compat": {
        "port_vs_jax": _departure(port, jke),
        "jax_vs_tpu_record": _departure(jke, rec),
        "port_vs_tpu_record": _departure(port, rec)}}
    if a.bound is not None:
        sim = MpmSim("mpm_cone", bound=a.bound, device="cpu")
        port = [float(sim.step()["kinetic_energy"]) for _ in range(a.frames)]
        out[f"cone_bound{a.bound}"] = {
            "particles": sim.num_particles, "hessian": sim.params.hessian,
            "port_vs_jax": _departure(port, _jax_ke(a.frames, a.bound))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
