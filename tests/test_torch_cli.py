"""The port's command line (``fluidsim_tpu_torch/cli.py``) on the CPU: the
frames it writes decode, through the JAX package's reader, to a direct
rerun's ``occupancy * ~solid`` (FLIP) or the MPM persistence rule, bit for
bit; its JSONL has the JAX CLI's keys; resume continues the files bit for
bit; ``print``, ``render``, ``lod`` and ``scenes`` give the JAX CLI's output
for the same file (no JAX frame is run); ``--surface`` writes the
particle fog and ``--trace-dir`` a trace; the default device is ``cuda``."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from fluidsim_tpu import cli as jcli
from fluidsim_tpu.io.vdb import read_vdb as jread_vdb
from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu_torch import FlipSim, MpmSim, cli, get_scene
from fluidsim_tpu_torch.io.vdb import read_vdb
from fluidsim_tpu_torch.ops.levelset import particles_to_levelset, sdf_to_fog
from fluidsim_tpu_torch.utils.profiling import TRACE_FILE

FLUID = ["fluid", "--device", "cpu", "--bound", "8", "--density", "3",
         "--echo-every", "100"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the frames are many small ops, and the
    other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _on_box(path, bound):
    """The one grid of a frame file on the sim's box, read by the JAX
    package's reader."""
    (g,) = jread_vdb(path)
    n = 2 * bound + 1
    out = np.zeros((n, n, n), np.float32)
    lo = [int(o) + bound for o in g.origin]
    src = tuple(slice(max(0, -lo[d]), min(g.values.shape[d], n - lo[d]))
                for d in range(3))
    dst = tuple(slice(lo[d] + src[d].start, lo[d] + src[d].stop)
                for d in range(3))
    out[dst] = g.values[src]
    return out


def _flip_grids(frames, surface=False):
    """A direct rerun's per-frame export grids, as numpy."""
    sim = FlipSim(get_scene("water_cube_drop", bound=8, density=3.0),
                  seed=0, device="cpu")
    solid = sim.solid.numpy()
    out = []
    for _ in range(frames):
        m = sim.step()
        grid = (sdf_to_fog(particles_to_levelset(sim.state.pos, 8))
                if surface else m["occupancy"])
        out.append(np.where(solid, np.float32(0), grid.numpy()))
    return out


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def test_cli_fluid_files_equal_direct_frames(tmp_path):
    out, metrics = str(tmp_path / "sim"), str(tmp_path / "m.jsonl")
    assert cli.main(FLUID + ["--frames", "3", "--out", out,
                             "--metrics", metrics]) == 0
    for i, want in enumerate(_flip_grids(3)):
        np.testing.assert_array_equal(
            _bits(_on_box(os.path.join(out, f"mygrids{i}.vdb"), 8)),
            _bits(want))
    assert len(jread_vdb(os.path.join(out, "mygrids.vdb"))) == 3
    lines = [json.loads(ln) for ln in open(metrics)]
    assert [ln["frame"] for ln in lines] == [0, 1, 2]
    # the JAX CLI's keys: frame, wall_time and each 0-d metric of its frame
    jsim = jflip.FlipSim("water_cube_drop", bound=8, density=3.0)
    _, jm = jax.eval_shape(lambda s, st: jflip.flip_step(jsim.params, s, st),
                           jsim.solid, jsim.state)
    want = {"frame", "wall_time"} | {k for k, v in jm.items() if v.ndim == 0}
    assert all(set(ln) == want for ln in lines)


def test_cli_mpm_files_follow_persistence_rule(tmp_path):
    out = str(tmp_path / "sim")
    assert cli.main(["mpm", "--device", "cpu", "--scene", "mpm_pea",
                     "--frames", "2", "--out", out, "--no-accum",
                     "--echo-every", "100"]) == 0
    sim = MpmSim("mpm_pea", seed=0, device="cpu")
    solid = sim.solid.numpy()
    persistent = np.zeros(solid.shape, np.float32)
    bound = sim.params.bound
    for i in range(2):
        mass = sim.step()["occupancy"].numpy()
        upd = ~solid & (mass > 0.1)
        persistent[upd] = mass[upd]
        got = _on_box(os.path.join(out, f"mygrids{i}.vdb"), bound)
        np.testing.assert_array_equal(_bits(got), _bits(persistent))
    assert not os.path.exists(os.path.join(out, "mygrids.vdb"))


def test_cli_resume_continues_bit_for_bit(tmp_path):
    first, second = str(tmp_path / "a"), str(tmp_path / "b")
    assert cli.main(FLUID + ["--frames", "4", "--out", first,
                             "--checkpoint-every", "2"]) == 0
    ck = os.path.join(first, "ckpt_1.npz")
    assert os.path.exists(ck) and os.path.exists(
        os.path.join(first, "ckpt_3.npz"))
    metrics = str(tmp_path / "resumed.jsonl")
    args = cli.build_parser().parse_args(
        FLUID + ["--frames", "2", "--out", second, "--resume", ck,
                 "--metrics", metrics])
    summary = cli.run("flip", args)
    assert summary["first_frame"] == 2 and len(summary["frame_ms"]) == 2
    assert summary["exporter"]["python_fallbacks"] == 0
    assert summary["exporter"]["tail_fetches"] == 0
    lines = [json.loads(ln) for ln in open(metrics)]
    assert [ln["frame"] for ln in lines] == [2, 3]
    for i in (2, 3):
        a = read_vdb(os.path.join(first, f"mygrids{i}.vdb"))[0]
        b = read_vdb(os.path.join(second, f"mygrids{i}.vdb"))[0]
        assert a.origin == b.origin
        np.testing.assert_array_equal(_bits(a.values), _bits(b.values))
        np.testing.assert_array_equal(a.active, b.active)
    assert not os.path.exists(os.path.join(second, "mygrids1.vdb"))


@pytest.fixture(scope="module")
def frame_file(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sim"))
    assert cli.main(FLUID + ["--frames", "2", "--out", out, "--no-accum"]) == 0
    return os.path.join(out, "mygrids1.vdb")


@pytest.mark.parametrize("cmd", ["print", "render", "lod", "scenes"])
def test_inspection_commands_equal_jax(cmd, frame_file, tmp_path, capsys):
    def argv(tag):
        if cmd == "print":
            return ["print", frame_file]
        if cmd == "scenes":
            return ["scenes"]
        ext = "png" if cmd == "render" else "vdb"
        return [cmd, frame_file, "-o", str(tmp_path / f"{tag}.{ext}")]

    assert cli.main(argv("port")) == 0
    ours = capsys.readouterr().out
    assert jcli.main(argv("jax")) == 0
    theirs = capsys.readouterr().out
    assert ours.replace("port.", "jax.") == theirs
    if cmd == "render":
        with open(tmp_path / "port.png", "rb") as a, \
                open(tmp_path / "jax.png", "rb") as b:
            assert a.read() == b.read()
    if cmd == "lod":
        ga = read_vdb(str(tmp_path / "port.vdb"))
        gb = jread_vdb(str(tmp_path / "jax.vdb"))
        assert [(g.name, g.origin, g.voxel_size) for g in ga] == \
            [(g.name, g.origin, g.voxel_size) for g in gb]
        for a, b in zip(ga, gb):
            np.testing.assert_array_equal(a.values, b.values)


def test_cli_surface_writes_particle_fog(tmp_path):
    out = str(tmp_path / "sim")
    assert cli.main(FLUID + ["--frames", "1", "--out", out, "--surface",
                             "--no-accum"]) == 0
    (want,) = _flip_grids(1, surface=True)
    got = _on_box(os.path.join(out, "mygrids0.vdb"), 8)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert 0 < got.max() <= 1.0


def test_cli_trace_dir_writes_a_trace(tmp_path):
    trace_dir = str(tmp_path / "trace")
    assert cli.main(FLUID + ["--frames", "1", "--out", str(tmp_path / "sim"),
                             "--no-vdb", "--trace-dir", trace_dir]) == 0
    path = os.path.join(trace_dir, TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_cli_default_device_is_cuda(tmp_path):
    args = cli.build_parser().parse_args(["fluid"])
    assert args.device == "cuda" and args.frames == 500
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["fluid", "--bound", "4", "--density", "1", "--frames", "1",
                  "--out", str(tmp_path / "sim")])


def test_metrics_logger_records_equal_jax(tmp_path, capsys):
    import jax.numpy as jnp

    from fluidsim_tpu.io.metrics import MetricsLogger as JaxLogger
    from fluidsim_tpu_torch.io.metrics import MetricsLogger

    rng = np.random.default_rng(0)
    vals = rng.random(4).astype(np.float32)
    port = {"error": torch.tensor(vals[0]), "dt": torch.tensor(vals[1]),
            "kinetic_energy": torch.tensor(vals[2]), "cg_iters": 12,
            "num_fluid_cells": torch.tensor(319),
            "spd_fallback": torch.tensor(False),
            "occupancy": torch.ones(3, 3, 3)}
    ref = {"error": jnp.float32(vals[0]), "dt": jnp.float32(vals[1]),
           "kinetic_energy": jnp.float32(vals[2]), "cg_iters": jnp.int32(12),
           "num_fluid_cells": jnp.int32(319),
           "spd_fallback": jnp.bool_(False),
           "occupancy": jnp.ones((3, 3, 3))}
    recs = []
    for cls, metrics, name in ((MetricsLogger, port, "p"),
                               (JaxLogger, ref, "j")):
        path = str(tmp_path / f"{name}.jsonl")
        logger = cls(path, echo_every=1)
        logger.log(3, metrics)
        logger.close()
        with open(path) as f:
            rec = json.loads(f.read())
        rec.pop("wall_time")
        recs.append(rec)
        err = capsys.readouterr().err
        recs.append(err.split("]", 1)[1])          # the console line
    assert recs[0] == recs[2] and list(recs[0]) == list(recs[2])
    assert recs[1] == recs[3]
