"""The sharded MPM at shape — the port's counterpart of
``scripts/validate_mpm_shape.py``: ``ShardedMpmSim`` on ``mpm_cone`` at
255^3 (bound 127, 3,939,805 particles, the "hybrid" operator) beside
``MpmSim`` on the same device.

    python -m fluidsim_tpu_torch.validation.validate_mpm_shape [--frames 5]
    torchrun --nproc-per-node=4 -m \\
        fluidsim_tpu_torch.validation.validate_mpm_shape
    python -m fluidsim_tpu_torch.validation.validate_mpm_shape \\
        --device cpu --bound 15 --frames 2

As ``validate_config5``: at world size 1 (without a launcher) the frames
are held to ``MpmSim``'s, kinetic energy within rtol 1e-4, CG iterations
within one per solve, the same SPD fallbacks, det FP > 0, every solve
converged before its cap, no particle lost, and after the frames the
state bit for bit ``MpmSim``'s; under a launcher rank 0 steps ``MpmSim``
and the same checks hold but the last.  Nothing is appended to
``docs/``.
"""

from __future__ import annotations

import argparse
import sys

from fluidsim_tpu_torch.models.mpm import MpmSim, frame_solves
from fluidsim_tpu_torch.parallel import dryrun
from fluidsim_tpu_torch.parallel.mpm_sharded import ShardedMpmSim
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.validation import traces
from fluidsim_tpu_torch.validation.validate_config5 import beside

FRAMES, BOUND = 5, 127
KEYS = ("kinetic_energy", "cg_iters", "spd_fallback", "min_det_fp",
        "num_active_cells")


def _mpm_frame_fails(f, got, ref, world, sim, occupancies) -> list[str]:
    n, converged = frame_solves(sim.params, got["cg_iters"],
                                got["spd_fallback"])
    ke, ke_s = got["kinetic_energy"], ref["kinetic_energy"]
    fails = []
    if abs(ke - ke_s) > 1e-4 * abs(ke_s):
        fails.append(f"frame {f}: kinetic energy {ke} against {ke_s}")
    if (abs(got["cg_iters"] - ref["cg_iters"]) > n or not converged
            or got["spd_fallback"] != ref["spd_fallback"]):
        fails.append(f"frame {f}: CG {got['cg_iters']} (SPD fallback "
                     f"{got['spd_fallback']}) against {ref['cg_iters']} "
                     f"({ref['spd_fallback']})")
    if not got["min_det_fp"] > 0:
        fails.append(f"frame {f}: det FP {got['min_det_fp']}")
    return fails


def run(bound: int = BOUND, frames: int = FRAMES, device="cuda",
        keep: bool = False):
    """The sharded MPM beside ``MpmSim`` in the current process group (none:
    world size 1).  Returns ``beside``'s (figures, ``MpmSim``, its last
    metrics)."""
    scene = get_scene("mpm_cone", bound=bound)
    return beside(
        "validate_mpm_shape", scene,
        lambda seeder: MpmSim(scene, seeder=seeder, device=device),
        lambda seeder: ShardedMpmSim(scene, seeder=seeder, device=device),
        frames, device, KEYS, _mpm_frame_fails,
        ("pos", "vel", "FE", "FP", "volume"), (), keep)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bound", type=int, default=BOUND)
    ap.add_argument("--frames", type=int, default=FRAMES)
    a = traces.common_args(ap).parse_args(argv)
    with dryrun.process_group(a.device) as (rank, _):
        figs, _, _ = run(a.bound, a.frames, a.device)
        if rank == 0:
            return traces.report(figs, a.out)
        return 0 if figs["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
