"""The port runs where JAX is not installed: in a fresh interpreter that
can import neither ``jax`` nor ``fluidsim_tpu``, import
``fluidsim_tpu_torch`` and step one frame on CPU, in FLIP and APIC mode
and of the MPM cone, two FLIP frames on the bucket path, and the
materialised G2P (``fused_table=False``) and ``ops/shift.py`` after a
FLIP frame, the row-layout transfers of ``utils/transfer_parts.py``, and
the synthetic K5 and K1 inputs of ``utils/synthetic.py`` with the K1 chunk
plan and the order of the three K1 modes."""

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
elif sys.argv[1] == "flip-table":
    from fluidsim_tpu_torch.ops import apic, shift, transfer_kernels as tk
    sim = FlipSim("water_cube_drop", bound=6, density=2.0, device="cpu")
    m = sim.step()
    b, wall = sim.params.bound, sim.params.wall
    pos_s, vel_s, flat = tk.sort_by_cell(sim.state.pos, sim.state.vel, b)
    w27t = tk.masked_weights_cm(pos_s, b)
    vc = torch.sin(torch.arange(3 * (2 * b + 1) ** 3,
                                dtype=torch.float32)).reshape(3, *(2 * b + 1,) * 3)
    assert torch.equal(tk.g2p(w27t, flat, vc, b, wall),
                       tk.g2p(w27t, flat, vc, b, wall, fused_table=False))
    va, ca = apic.g2p_apic(w27t, flat, pos_s, vc, b, wall)
    vb, cb = apic.g2p_apic(w27t, flat, pos_s, vc, b, wall, fused_table=False)
    assert torch.equal(va, vb) and torch.equal(ca, cb)
    rows = shift.g2p_table_expand(vc[0, :, :, :, None].expand(-1, -1, -1, 4).contiguous(),
                                  2 * b + 1)
    assert shift.p2g_shift_reduce(rows, 2 * b + 1).shape == (2 * b + 1,) * 3 + (4,)
elif sys.argv[1] == "rows":
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.utils import transfer_parts as tparts
    st = tparts.frame_state(6, 2.0, "cpu")
    u_rows = tparts.row_build(st)
    d, acc = tparts.row_p2g(st, u_rows)
    fm = tparts.field_build(st, torch.ones((3, st.n, st.n, st.n)))
    rows, out = tparts.row_g2p(st, tparts.row_table(fm), u_rows)
    assert torch.equal(out, tk.g2p_gather(fm, st.w27t, st.flat))
    tparts.sweep_inputs(st)
    m = {"kinetic_energy": acc[0].sum()}
elif sys.argv[1] == "synthetic":
    from fluidsim_tpu_torch.ops import transfer_kernels as tk
    from fluidsim_tpu_torch.utils import synthetic
    key_s, pay_s, tbl, _ = synthetic.bucket_tables(0, 6000, 6)
    kf, _ = bucket_sort.bucket_move(key_s, pay_s, tbl, 6000, 1024)
    gradw, m9, cs, _ = synthetic.skewed_force_state(0, 12, 300)
    plan = tk.chunk_plan(cs, m9.shape[0])
    out = tk.p2g_scatter_force_chunked(gradw, m9, plan, 12)
    w27t, vel, aff, cs, _ = synthetic.skewed_wv_state(0, 12, 300)
    plan = tk.chunk_plan(cs, vel.shape[0])
    out = out.abs().sum() + tk.p2g_scatter_chunked(w27t, vel, plan, 12).sum()
    out = out + tk.p2g_scatter_affine_chunked(w27t, vel, aff, plan, 12).sum()
    m = {"kinetic_energy": out + kf.shape[0]}
else:
    sim = FlipSim("water_cube_drop", bound=6, density=2.0, device="cpu",
                  mode=sys.argv[1])
    m = sim.step()
    assert m["outer_iters"] >= 1
assert not any(k == "jax" or k.startswith(("jax.", "fluidsim_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ke", float(m["kinetic_energy"]))
"""


@pytest.mark.parametrize("mode", ["flip", "apic", "mpm", "flip-bucket",
                                  "flip-table", "rows", "synthetic"])
def test_port_runs_without_jax(mode):
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _SCRIPT, mode], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ke ")
