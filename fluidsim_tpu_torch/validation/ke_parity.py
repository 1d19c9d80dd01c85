"""Kinetic-energy parity with the C++ ports of the reference — the port's
counterpart of ``tests/test_ke_parity.py`` and ``scripts/mpm_parity.py``.

    python -m fluidsim_tpu_torch.validation.ke_parity flip [--frames 40]
    python -m fluidsim_tpu_torch.validation.ke_parity mpm [--frames 60]
    python -m fluidsim_tpu_torch.validation.ke_parity flip --device cpu \\
        --bound 16 --density 4 --seeder default --frames 25 --native

``flip``: ``water_cube_drop`` at bound 60 (121^3) with the reference's
seeding stream (689,210 particles), against the C++ trace recorded in
``docs/parity_full_121cube.json`` (``cpp``, 40 frames), or with
``--native`` against ``native/ref_cpu`` run on the same particle file.
The gates are ``tests/test_ke_parity.py``'s: free fall (frames 0-7)
within 5%, the median over the run under 25%, correlation above 0.99.

``mpm``: ``mpm_cone`` at its default 31^3 (6,206 particles), against
``docs/mpm_parity_cone.json`` (``ref_ke``, ``ref_dt``, 60 frames) or
``native/ref_mpm``: the median relative error under 5e-4, the largest
under 5e-3, dt within rtol 1e-4.

The recorded JAX run's figures on the same record (``tpu``, ``jax_ke``)
are reported beside the port's.  ``--native`` builds the C++ port with
``make -C native`` when it is absent.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from fluidsim_tpu_torch.compat.scatter import seed_particles_compat
from fluidsim_tpu_torch.models.flip import FlipSim
from fluidsim_tpu_torch.models.mpm import MpmSim
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.seeding import seed_particles
from fluidsim_tpu_torch.validation import traces

NATIVE = traces.ROOT / "native"
FLIP_FRAMES, FLIP_BOUND, FLIP_DENSITY = 40, 60, 10.0     # the record's
MPM_FRAMES, MPM_BOUND, MPM_DENSITY = 60, 15, 400.0       # the record's
SEEDERS = {"compat": seed_particles_compat, "default": seed_particles}


def native_binary(name: str) -> str:
    """``native/<name>``, built by ``make -C native <name>`` when absent;
    raises if it cannot be built."""
    path = NATIVE / name
    if not path.exists():
        subprocess.run(["make", "-C", str(NATIVE), name], check=True,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    if not path.exists():
        raise FileNotFoundError(f"{path} did not build")
    return str(path)


def run_native(name: str, args, pos: np.ndarray) -> list[dict]:
    """Run the C++ port ``name`` with ``args`` on the positions ``pos``
    (written as the (P, 3) f32 file it reads); returns its per-frame
    rows."""
    binary = native_binary(name)
    with tempfile.TemporaryDirectory() as tmp:
        pfile = os.path.join(tmp, "particles.f32")
        np.ascontiguousarray(pos, np.float32).tofile(pfile)
        out = subprocess.run([binary, *map(str, args), pfile], check=True,
                             capture_output=True, text=True).stdout
    return [row for row in map(json.loads, (line for line in
                                            out.splitlines()
                                            if line.startswith("{")))
            if "ke" in row]


def _frames(sim, frames: int, device):
    rows, secs = traces.record_frames(sim, frames,
                                      ("kinetic_energy", "dt"), device)
    return ([r["kinetic_energy"] for r in rows], [r["dt"] for r in rows],
            secs)


def flip(frames: int = FLIP_FRAMES, bound: int = FLIP_BOUND,
         density: float = FLIP_DENSITY, seeder: str = "compat",
         device="cuda", native: bool = False, ke=None) -> dict:
    """FLIP against the C++ port (see the module docstring).  ``ke``: the
    kinetic energies of a run of this configuration made elsewhere (the
    soak's), compared instead of stepping a sim here."""
    scene = get_scene("water_cube_drop", bound=bound, density=density)
    recorded = ((bound, density, seeder) == (FLIP_BOUND, FLIP_DENSITY,
                                             "compat")
                and frames <= FLIP_FRAMES)
    if not (native or recorded):
        raise ValueError("no recorded C++ trace of this configuration: "
                         "pass --native")
    out = {"run": "ke_parity flip", "grid": 2 * bound + 1, "frames": frames,
           "seeder": seeder}
    pos = vel = None
    if ke is None or native:
        t0 = time.perf_counter()
        pos, vel = SEEDERS[seeder](scene, seed=0, dtype="float32")
        out["seed_secs"] = time.perf_counter() - t0
    if ke is None:
        sim = FlipSim(scene, seeder=traces.fixed_seeder(pos, vel),
                      device=device)
        out.update(device=str(sim.device), particles=sim.num_particles)
        ke, _, secs = _frames(sim, frames, device)
        out.update(secs)
    ke = np.asarray(ke[:frames])
    if native:
        cpp = [r["ke"] for r in run_native("ref_cpu", (bound, density,
                                                        frames), pos)]
        out["oracle_source"] = "native/ref_cpu"
    else:
        rec = traces.load(traces.FLIP_PARITY)
        cpp = rec["cpp"][:frames]
        out["oracle_source"] = "docs/" + traces.FLIP_PARITY
        out["jax_recorded"] = traces.flip_parity_oracle(rec["tpu"][:frames],
                                                        cpp)
    out["parity"] = traces.flip_parity_oracle(ke, cpp)
    out["ke"] = ke.tolist()
    out["pass"] = out["parity"]["pass"]
    return out


def mpm(frames: int = MPM_FRAMES, bound: int = MPM_BOUND,
        density: float = MPM_DENSITY, device="cuda",
        native: bool = False) -> dict:
    """MPM against the C++ port (see the module docstring)."""
    recorded = ((bound, density) == (MPM_BOUND, MPM_DENSITY)
                and frames <= MPM_FRAMES)
    if not (native or recorded):
        raise ValueError("no recorded C++ trace of this configuration: "
                         "pass --native")
    sim = MpmSim("mpm_cone", bound=bound, density=density, device=device)
    out = {"run": "ke_parity mpm", "device": str(sim.device),
           "grid": 2 * bound + 1, "particles": sim.num_particles,
           "frames": frames, "hessian": sim.params.hessian}
    pos = sim.state.pos.cpu().numpy()
    ke, dt, secs = _frames(sim, frames, device)
    out.update(secs)
    if native:
        rows = run_native("ref_mpm", (bound, density, frames), pos)
        ref_ke, ref_dt = [r["ke"] for r in rows], [r["dt"] for r in rows]
        out["oracle_source"] = "native/ref_mpm"
    else:
        rec = traces.load(traces.MPM_PARITY)
        ref_ke, ref_dt = rec["ref_ke"][:frames], rec["ref_dt"][:frames]
        out["oracle_source"] = "docs/" + traces.MPM_PARITY
        out["jax_recorded"] = traces.mpm_parity_oracle(
            rec["jax_ke"][:frames], rec["jax_dt"][:frames], ref_ke, ref_dt)
    out["parity"] = traces.mpm_parity_oracle(ke, dt, ref_ke, ref_dt)
    out["ke"] = list(ke)
    out["pass"] = out["parity"]["pass"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", choices=("flip", "mpm"))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--bound", type=int, default=None)
    ap.add_argument("--density", type=float, default=None)
    ap.add_argument("--seeder", choices=tuple(SEEDERS), default="compat",
                    help="flip: the particles' stream (mpm: the default)")
    ap.add_argument("--native", action="store_true",
                    help="run the C++ port instead of reading its record")
    a = traces.common_args(ap).parse_args(argv)
    if a.kind == "flip":
        res = flip(a.frames or FLIP_FRAMES, a.bound or FLIP_BOUND,
                   a.density or FLIP_DENSITY, a.seeder, a.device, a.native)
    else:
        res = mpm(a.frames or MPM_FRAMES, a.bound or MPM_BOUND,
                  a.density or MPM_DENSITY, a.device, a.native)
    return traces.report(res, a.out)


if __name__ == "__main__":
    sys.exit(main())
