"""The port runs where JAX is not installed: in a fresh interpreter that
can import neither ``jax`` nor ``fluidsim_tpu``, import
``fluidsim_tpu_torch`` and step one frame on CPU, in FLIP and APIC mode
and of the MPM cone, and two FLIP frames on the bucket path."""

import subprocess
import sys
from pathlib import Path

import pytest

_SCRIPT = """
import sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["fluidsim_tpu"] = None
import fluidsim_tpu_torch
import torch
torch.set_num_threads(1)           # the other test processes share the cores
from fluidsim_tpu_torch import FlipParams, FlipSim, MpmSim, get_scene
from fluidsim_tpu_torch.ops import bucket_sort
if sys.argv[1] == "mpm":
    m = MpmSim("mpm_cone", density=10.0, device="cpu").step()
    assert m["cg_iters"] >= 1
elif sys.argv[1] == "flip-bucket":
    scene = get_scene("water_cube_drop", bound=16, density=8.0)
    sim = FlipSim(scene, device="cpu", params=FlipParams(
        bound=16, wall=scene.spec.wall, gravity=tuple(scene.gravity),
        sort_method="bucket"))
    sim.step()
    m = sim.step()                 # the second frame takes the bucket order
    assert bucket_sort.bucket_or_sort.fallbacks == 1
else:
    sim = FlipSim("water_cube_drop", bound=6, density=2.0, device="cpu",
                  mode=sys.argv[1])
    m = sim.step()
    assert m["outer_iters"] >= 1
assert not any(k == "jax" or k.startswith(("jax.", "fluidsim_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ke", float(m["kinetic_energy"]))
"""


@pytest.mark.parametrize("mode", ["flip", "apic", "mpm", "flip-bucket"])
def test_port_runs_without_jax(mode):
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _SCRIPT, mode], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ke ")
