"""The port runs where JAX is not installed: in a fresh interpreter that
can import neither ``jax`` nor ``fluidsim_tpu``, import
``fluidsim_tpu_torch`` and step one frame on CPU, in FLIP and APIC mode
and of the MPM cone, two FLIP frames on the bucket path, and the
materialised G2P (``fused_table=False``) and ``ops/shift.py`` after a
FLIP frame, the row-layout transfers of ``utils/transfer_parts.py``, and
the synthetic K5, K1 and K8b inputs of ``utils/synthetic.py`` with the K1
chunk plan, the order of the three K1 modes and K8b's tile plan, and a
``config.make_sim`` run (multigrid, compat seeding) with ``extrapolate``
and a Jacobi-preconditioned MPM frame, a sharded FLIP and MPM frame
on a one-rank gloo group, and the tools: one public function of each
tool module, the ``raytrace`` and ``view`` commands on a small ``.vdb``
and the package's four lazy names; and every ``validation`` module, with
an oracle on a recorded trace, a scaled-soak frame and both sharded
validators at world size 1."""

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
    fm = vc[0, :, :, :, None].expand(-1, -1, -1, 4).contiguous()
    rows = shift.g2p_table_expand(fm, 2 * b + 1)
    assert torch.equal(rows, shift.g2p_table_expand_rows_plain(fm, 2 * b + 1))
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
    from fluidsim_tpu_torch.ops import rows as rw
    u_rows, flat, _ = synthetic.skewed_row_state(0, 12, 300)
    out = out + rw.scatter_rows_cm(u_rows, flat, 12 ** 3).sum()
    assert rw.scatter_tile_starts_plain(flat, 12 ** 3)[-1] == flat.shape[0]
    m = {"kinetic_energy": out + kf.shape[0]}
elif sys.argv[1] == "config":
    from fluidsim_tpu_torch import MpmParams, config
    from fluidsim_tpu_torch.compat.scatter import seed_particles_compat
    from fluidsim_tpu_torch.ops import extrapolate
    sim = config.make_sim({"kind": "flip", "bound": 8, "density": 2,
                           "seed": [{"box": [[-3, -3, -3], [3, 3, 3]]}],
                           "solid": [{"box": [[-2, -6, -2], [2, -5, 2]]}],
                           "params": {"preconditioner": "multigrid"}},
                          device="cpu", seeder=seed_particles_compat)
    m = sim.step()
    assert m["cg_iters"] >= 1 and not sim.params.walls_only_solid
    vel = torch.ones((17, 17, 17, 3))
    v, d = extrapolate.extrapolate(vel, m["occupancy"] > 0)
    assert bool(d.all()) and torch.equal(v, vel)
    mm = MpmSim("mpm_cone", density=10.0, device="cpu",
                params=MpmParams(precond="jacobi")).step()
    assert mm["cg_iters"] >= 1
elif sys.argv[1] == "sharded":
    import datetime
    import tempfile
    import torch.distributed as dist
    from fluidsim_tpu_torch.parallel.flip_sharded import ShardedFlipSim
    from fluidsim_tpu_torch.parallel.mpm_sharded import ShardedMpmSim
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120))
        try:
            f = ShardedFlipSim("water_cube_drop", bound=6, density=2.0,
                               device="cpu").step()
            m = ShardedMpmSim("mpm_cone", density=10.0, device="cpu").step()
        finally:
            dist.destroy_process_group()
    assert int(f["lost"]) == 0 == int(m["lost"]) and m["cg_iters"] >= 1
elif sys.argv[1] == "cli":
    import os
    import tempfile
    from fluidsim_tpu_torch import cli
    from fluidsim_tpu_torch.io import native
    from fluidsim_tpu_torch.io.vdb import read_vdb
    assert native.available()          # the native writer builds
    with tempfile.TemporaryDirectory() as out:
        base = ["fluid", "--device", "cpu", "--bound", "6", "--density", "2",
                "--echo-every", "100"]
        args = cli.build_parser().parse_args(
            base + ["--frames", "2", "--out", out, "--checkpoint-every", "1"])
        summary = cli.run("flip", args)
        assert summary["exporter"]["python_fallbacks"] == 0
        assert cli.main(base + ["--frames", "1", "--out", out, "--resume",
                                os.path.join(out, "ckpt_0.npz")]) == 0
        assert len(read_vdb(os.path.join(out, "mygrids.vdb"))) == 1
        m = {"kinetic_energy": float(read_vdb(
            os.path.join(out, "mygrids1.vdb"))[0].values.sum())}
elif sys.argv[1] == "tools":
    import contextlib
    import io
    import os
    import tempfile
    import numpy as np
    from fluidsim_tpu_torch import cli
    from fluidsim_tpu_torch.io import viewer
    from fluidsim_tpu_torch.io.vdb import VdbGrid, write_vdb
    from fluidsim_tpu_torch.ops import (
        advect_volume, composite, diagnostics, fd, gridops, levelset,
        levelset_tools, mesh, morphology, partition, platonic, raytrace,
        resample, statistics, volume_to_mesh, volume_to_spheres)
    names = [getattr(fluidsim_tpu_torch, n) for n in (
        "ShardedFlipSim", "mesh_to_sdf", "raytrace_levelset",
        "volume_to_mesh")]
    phi = levelset.sphere_sdf(None, 6, (0.0, 0.0, 0.0), 3.5, device="cpu")
    pos = torch.rand(40, 3) * 8 - 4
    vc = torch.zeros(13, 13, 13, 3)
    out = [advect_volume.advect_volume(phi, vc, 1.0, 6),
           composite.signed_flood_fill(phi, 2.0),
           fd.d1(phi, 0, 1.0, "fd_hjweno5"),
           gridops.mean_curvature(phi),
           levelset_tools.filter_median(levelset_tools.redistance(phi, 3)),
           mesh.mesh_to_sdf(*mesh.icosphere((0, 0, 0), 3.0, 1), 6,
                            device="cpu"),
           morphology.dilate(phi < 0, 1, morphology.NN_FACE_EDGE),
           partition.partition_by_cell(pos, 6).counts,
           platonic.platonic_sdf(8, 6, 4.0, device="cpu"),
           raytrace.raytrace_levelset(phi, 6, (0, 0, -12), (0, 0, 0),
                                      width=16, height=16)[0],
           resample.affine_resample(phi, torch.eye(3), (1.0, 0.0, 0.0), 6),
           statistics.histogram(phi, 8, -4.0, 4.0),
           volume_to_spheres.fill_with_spheres(phi, 3, 6)[1]]
    assert all(bool(torch.isfinite(o.float()).all()) for o in out)
    assert not diagnostics.check_finite_grid(phi).failed
    verts, quads = volume_to_mesh.volume_to_mesh(phi, bound=6)
    assert len(verts) - len(quads) == 2
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        vdb = os.path.join(tmp, "s.vdb")
        write_vdb(vdb, [VdbGrid(values=phi.numpy(), origin=(-6,) * 3,
                                background=3.0)])
        assert len(viewer._frame_points(vdb)) == 13 ** 3
        assert cli.main(["raytrace", vdb, "-o", os.path.join(tmp, "r.png"),
                         "--size", "16", "16", "--device", "cpu"]) == 0
        assert cli.main(["view", vdb, "-o", os.path.join(tmp, "v.png"),
                         "--orbit", "2", "--size", "8", "8",
                         "--device", "cpu"]) == 0
        assert os.path.exists(os.path.join(tmp, "v_0001.png"))
    m = {"kinetic_energy": out[0].sum()}
elif sys.argv[1] == "validation":
    from fluidsim_tpu_torch.validation import (
        cg_trace, ke_parity, soak_500, soak_mpm, soak_mpm_scaled, traces,
        validate_config5, validate_mpm_shape)
    rec = traces.load(traces.FLIP_PARITY)
    assert traces.flip_parity_oracle(rec["tpu"], rec["cpp"])["pass"]
    assert ke_parity.SEEDERS and soak_500.KEYS and soak_mpm.KEYS
    assert cg_trace.RECORDS
    assert soak_mpm_scaled.run(1, 4, "cpu")[1][0]["kinetic_energy"] > 0
    assert validate_config5.run(6, 2.0, 1, "cpu")[0]["pass"]
    figs = validate_mpm_shape.run(6, 1, "cpu")[0]
    assert figs["pass"]
    m = {"kinetic_energy": figs["kinetic_energy_single"][0]}
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
                                  "flip-table", "rows", "synthetic",
                                  "config", "cli", "sharded", "tools",
                                  "validation"])
def test_port_runs_without_jax(mode):
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _SCRIPT, mode], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ke ")
