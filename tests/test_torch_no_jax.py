"""The port runs where JAX is not installed: in a fresh interpreter that
cannot import ``jax``, import ``fluidsim_tpu_torch`` and step one frame on
CPU."""

import subprocess
import sys
from pathlib import Path

_SCRIPT = """
import sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
import fluidsim_tpu_torch
from fluidsim_tpu_torch.models.flip import FlipSim
sim = FlipSim("water_cube_drop", bound=6, density=2.0, device="cpu")
m = sim.step()
assert m["outer_iters"] >= 1
assert not any(k == "jax" or k.startswith(("jax.", "fluidsim_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ke", float(m["kinetic_energy"]))
"""


def test_port_runs_without_jax():
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ke ")
