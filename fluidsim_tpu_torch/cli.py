"""Command-line interface of the port — the counterpart of
``fluidsim_tpu/cli.py``: the framework's ``run.sh {fluid,mpm}``
(``run.sh:3-7``) plus the inspection tools the reference gets from
``vdb_print`` (``openvdb/cmd/openvdb_print``).

  python -m fluidsim_tpu_torch.cli fluid  [--scene water_cube_drop] [--frames 500] ...
  python -m fluidsim_tpu_torch.cli mpm    [--scene mpm_cone] ...
  python -m fluidsim_tpu_torch.cli print  simulation/mygrids0.vdb
  python -m fluidsim_tpu_torch.cli raytrace simulation/mygrids0.vdb -o ray.png
  python -m fluidsim_tpu_torch.cli view   simulation/mygrids0.vdb -o turn.gif
  python -m fluidsim_tpu_torch.cli scenes

Per frame the output grid is written to ``<out>/mygrids<i>.vdb`` and all
frames are accumulated into ``<out>/mygrids.vdb``, matching the reference's
output layout (``fluid.cc:1364-1371,1503-1509``).  The frames, and the
sphere tracer of the ``raytrace`` and ``view`` commands, run on
``--device`` (``cuda`` unless given; ``cpu`` runs the kernels' plain
versions).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _add_run_args(p):
    p.add_argument("--frames", type=int, default=500)
    p.add_argument("--out", default="simulation",
                   help="output directory for per-frame .vdb files")
    p.add_argument("--no-vdb", action="store_true", help="skip VDB export")
    p.add_argument("--ref-topology", action="store_true",
                   help="emit reference-faithful dense-active VDB topology "
                        "(all non-solid voxels active, fluid.cc:1443-1445) "
                        "instead of the compact nonzero-active default")
    p.add_argument("--no-accum", action="store_true",
                   help="skip the accumulated mygrids.vdb (large)")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None, help="checkpoint to resume from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bound", type=int, default=None,
                   help="override scene size (e.g. 63 for a 127^3 box)")
    p.add_argument("--density", type=float, default=None)
    p.add_argument("--echo-every", type=int, default=1)
    p.add_argument("--surface", action="store_true",
                   help="export a particle level-set fog volume instead of "
                        "raw occupancy (smoother renders)")
    p.add_argument("--config", default=None,
                   help="JSON scene config (overrides --scene; see "
                        "fluidsim_tpu_torch.config)")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--device", default="cuda",
                   help="device the frames run on (default cuda)")


def run(kind: str, args) -> dict:
    """The ``fluid`` / ``mpm`` frame loop.  Returns a summary: the first
    frame's index, the particle count, each frame's host wall in ms (step,
    metrics, export submit), the checkpoint seconds and the exporter's
    counters (None without export)."""
    from fluidsim_tpu_torch.io.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    from fluidsim_tpu_torch.io.metrics import MetricsLogger
    from fluidsim_tpu_torch.scenes import get_scene
    from fluidsim_tpu_torch.utils.profiling import trace

    if args.config:
        from fluidsim_tpu_torch.config import make_sim
        sim = make_sim(args.config, seed=args.seed, device=args.device)
        scene = sim.scene
        kind = "flip" if scene.kind == "flip" else "mpm"
    else:
        scene_kwargs = {}
        if args.bound is not None:
            scene_kwargs["bound"] = args.bound
        if args.density is not None:
            scene_kwargs["density"] = args.density
        scene = get_scene(args.scene, **scene_kwargs)
        if kind == "flip":
            from fluidsim_tpu_torch.models.flip import FlipSim
            sim = FlipSim(scene, seed=args.seed, device=args.device)
        else:
            from fluidsim_tpu_torch.models.mpm import MpmSim
            sim = MpmSim(scene, seed=args.seed, device=args.device)
    if kind == "flip":
        from fluidsim_tpu_torch.models.flip import FlipState
        state_cls = FlipState
    else:
        from fluidsim_tpu_torch.models.mpm import MpmState
        state_cls = MpmState

    if args.resume:
        sim.state, _ = load_checkpoint(args.resume, state_cls,
                                       device=sim.device)
    # the frame index lives on the host from here on: one read at the start
    first = int(sim.state.frame)
    if args.resume:
        print(f"resumed from {args.resume} at frame {first}", file=sys.stderr)

    os.makedirs(args.out, exist_ok=True)   # vdb frames and/or checkpoints
    exporter = None
    surface_fn = None
    if not args.no_vdb:
        from fluidsim_tpu_torch.io.export import AsyncFrameExporter
        spec = scene.spec
        if args.surface:
            from fluidsim_tpu_torch.ops.levelset import (
                particles_to_levelset, sdf_to_fog)

            def surface_fn(pos):
                return sdf_to_fog(particles_to_levelset(pos, spec.bound))
        # The exporter applies the reference's outputGrid persistence rule
        # (FLIP overwrites every non-solid cell, fluid.cc:1434-1448; MPM
        # only cells with mass > 0.1, mpm.cc:1368-1382), fetches frames
        # sparsely and writes them on background threads (io/export.py).
        # --surface fog replaces every non-solid cell each frame ("flip"
        # rule; solid cells stay at the 0 background).
        exporter = AsyncFrameExporter(
            spec, scene.solid, mode=("flip" if args.surface else kind),
            accum=not args.no_accum, ref_topology=args.ref_topology)

    print(f"{kind}: scene={scene.name} particles={sim.num_particles} "
          f"grid={scene.spec.n}^3 frames={args.frames}", file=sys.stderr)

    frame_ms = []
    checkpoint_s = 0.0
    with MetricsLogger(args.metrics, echo_every=args.echo_every) as logger, \
            trace(args.trace_dir):
        try:
            for frame in range(first, first + args.frames):
                t0 = time.perf_counter()
                metrics = sim.step()
                logger.log(frame, metrics)
                if exporter is not None:
                    grid = (surface_fn(sim.state.pos) if surface_fn
                            else metrics["occupancy"])
                    exporter.submit(
                        os.path.join(args.out, f"mygrids{frame}.vdb"), grid)
                frame_ms.append(1e3 * (time.perf_counter() - t0))
                if (args.checkpoint_every
                        and (frame + 1) % args.checkpoint_every == 0):
                    t0 = time.perf_counter()
                    save_checkpoint(
                        os.path.join(args.out, f"ckpt_{frame}.npz"),
                        sim.state, sim.params)
                    checkpoint_s += time.perf_counter() - t0
            if exporter is not None:
                exporter.flush()
                if not args.no_accum:
                    from fluidsim_tpu_torch.io.vdb import write_vdb
                    write_vdb(os.path.join(args.out, "mygrids.vdb"),
                              exporter.accum_grids)
        finally:
            if exporter is not None:
                exporter.close()
    return {"first_frame": first, "particles": sim.num_particles,
            "frame_ms": frame_ms, "checkpoint_s": checkpoint_s,
            "exporter": None if exporter is None else exporter.counters()}


def _print_vdb(args) -> int:
    """vdb_print equivalent: dump archive metadata."""
    from fluidsim_tpu_torch.io.vdb import read_vdb
    for path in args.files:
        grids = read_vdb(path)
        print(f"{path}: {len(grids)} grid(s)")
        for g in grids:
            act = int(g.active.sum()) if g.active is not None else g.values.size
            print(f"  '{g.name}' float {g.values.shape} origin={g.origin} "
                  f"voxel_size={g.voxel_size} background={g.background} "
                  f"active={act} min={g.values.min():.4g} max={g.values.max():.4g}")
    return 0


def _render(args) -> int:
    """vdb_render equivalent: fog light model to an image."""
    from fluidsim_tpu_torch.io.render import render_volume, write_image
    from fluidsim_tpu_torch.io.vdb import read_vdb
    g = read_vdb(args.file)[args.grid]
    img = render_volume(
        g.values, axis=args.axis,
        absorption=(args.absorb if args.absorb is not None
                    else args.absorption),
        scatter=args.scatter, gain=args.gain, cutoff=args.cutoff)
    out = args.output or (os.path.splitext(args.file)[0] + ".png")
    write_image(out, img)
    print(f"wrote {out} ({img.shape[1]}x{img.shape[0]})")
    return 0


def _lod(args) -> int:
    """vdb_lod equivalent: a mean-pooled mip pyramid."""
    from fluidsim_tpu_torch.io.render import build_lod
    from fluidsim_tpu_torch.io.vdb import VdbGrid, read_vdb, write_vdb
    g = read_vdb(args.file)[0]
    pyramid = build_lod(g.values, args.levels)
    out = args.output or (os.path.splitext(args.file)[0] + "_lod.vdb")
    grids = [VdbGrid(values=v, origin=tuple(int(o) // (2 ** i) for o in g.origin),
                     name=f"{g.name}_lod{i}", background=g.background,
                     voxel_size=g.voxel_size * (2 ** i))
             for i, v in enumerate(pyramid)]
    write_vdb(out, grids)
    print(f"wrote {out} ({len(grids)} levels)")
    return 0


def _levelset_cube(g, fog_half_width=None, warn=True):
    """Embed a stored dense grid block in an odd cube ready for the
    sphere tracer ([-b, b] index convention), converting ``--surface``
    fog volumes back to signed distances when asked.  Returns
    (cube, bound, offset) with ``offset`` mapping sim index space to the
    cube's centred coordinates."""
    vals = np.asarray(g.values, np.float32)
    if fog_half_width is not None:
        # invert sdf_to_fog's ramp at the 0.5 iso-level; outside the band
        # the fog is 0, giving a constant (conservative) positive step
        vals = (0.5 - vals) * fog_half_width
        bg = 0.5 * fog_half_width
    else:
        if warn and vals.min() >= 0.0 and vals.max() <= 1.0:
            print("warning: grid has no negative values — it looks like "
                  "a fog volume (--surface output), not a signed "
                  "distance field; pass --fog-half-width to convert",
                  file=sys.stderr)
        bg = float(max(g.background, 1e-3))
    # the stored dense block is leaf-padded with an index-space origin;
    # embed it in an odd cube so the tracer's [-b, b] convention holds
    n = max(vals.shape)
    n += 1 - n % 2
    cube = np.full((n, n, n), bg, np.float32)
    cube[:vals.shape[0], :vals.shape[1], :vals.shape[2]] = vals
    bound = (n - 1) // 2
    # sim index-space point p sits at array coord p - origin - bound
    off = np.asarray(g.origin, np.float64) + bound
    return cube, bound, off


def _trace(path, args, warn=True):
    """The grid ``args.grid`` of ``path`` as a level-set cube on
    ``args.device``, with its bound and offset."""
    import torch

    from fluidsim_tpu_torch.io.vdb import read_vdb
    g = read_vdb(path)[args.grid]
    cube, bound, off = _levelset_cube(g, args.fog_half_width, warn=warn)
    return torch.as_tensor(cube, device=args.device), bound, off


def _raytrace(args) -> int:
    """vdb_render's level-set camera (LevelSetRayTracer) to an image."""
    from fluidsim_tpu_torch.io.render import write_image
    from fluidsim_tpu_torch.ops.raytrace import focal_to_fov, raytrace_levelset
    cube, bound, off = _trace(args.file, args)
    eye = np.asarray(args.eye if args.eye is not None
                     else (0.0, 0.3 * bound, -2.2 * bound), np.float64)
    look = np.asarray(args.look, np.float64)
    fov = args.fov
    if args.focal is not None:
        fov = focal_to_fov(args.focal, args.aperture)
    cam = "orthographic" if args.camera.startswith("ortho") else "perspective"
    img, hit, _ = raytrace_levelset(
        cube, bound, tuple(eye - off), tuple(look - off),
        width=args.size[0], height=args.size[1], fov_deg=fov,
        camera=cam, frame=args.ortho_frame, samples=args.samples,
        znear=args.near, zfar=args.far,
        up_hint=tuple(args.up) if args.up is not None else None)
    out = args.output or (os.path.splitext(args.file)[0] + "_ray.png")
    write_image(out, img.cpu().numpy() * 255.0)
    print(f"wrote {out} ({args.size[0]}x{args.size[1]}, "
          f"{float(hit.float().mean()):.1%} coverage)")
    return 0


def _view(args) -> int:
    """Viewer — the capability answer to ``vdb_view``
    (``openvdb/viewer/Viewer.h:59-66``).  Two modes:

    ``--interactive``: LIVE viewer (``io.viewer``) — local WebGL page with
    mouse orbit/zoom, clip-plane sliders (``ClipBox.h``), frame playback.

    default: offline — orbit the camera around one grid, or play an
    animation over many frame files with a fixed camera, writing an
    animated GIF (or, without pillow, a PNG sequence) through the sphere
    tracer of the ``raytrace`` command."""
    if args.interactive:
        from fluidsim_tpu_torch.io.viewer import serve

        serve(args.files, port=args.port)
        return 0
    from fluidsim_tpu_torch.ops.raytrace import raytrace_levelset

    def render(cube, bound, eye, look):
        img, _, _ = raytrace_levelset(
            cube, bound, tuple(eye), tuple(look),
            width=args.size[0], height=args.size[1], fov_deg=args.fov)
        return img.cpu().numpy()

    frames = []
    if len(args.files) == 1 and args.orbit > 1:
        cube, bound, off = _trace(args.files[0], args)
        look = np.zeros(3) - off
        r = 2.2 * bound
        for k in range(args.orbit):
            th = 2.0 * np.pi * k / args.orbit
            eye = np.asarray([r * np.sin(th), 0.4 * bound,
                              -r * np.cos(th)]) - off
            frames.append(render(cube, bound, eye, look))
    else:
        for path in args.files:
            cube, bound, off = _trace(path, args, warn=path == args.files[0])
            eye = np.asarray([0.0, 0.3 * bound, -2.2 * bound]) - off
            frames.append(render(cube, bound, eye, np.zeros(3) - off))

    out = args.output or (os.path.splitext(args.files[0])[0] + "_view.gif")
    if out.endswith(".gif"):
        try:
            from PIL import Image
        except ImportError:
            print("GIF output needs pillow; falling back to a PNG sequence",
                  file=sys.stderr)
            out = os.path.splitext(out)[0] + ".png"
    if out.endswith(".gif"):
        ims = [Image.fromarray(np.clip(f * 255.0, 0, 255).astype(np.uint8))
               for f in frames]
        ims[0].save(out, save_all=True, append_images=ims[1:],
                    duration=args.frame_ms, loop=0)
    else:
        from fluidsim_tpu_torch.io.render import write_image
        base, ext = os.path.splitext(out)
        for i, f in enumerate(frames):
            write_image(f"{base}_{i:04d}{ext}", f * 255.0)
    print(f"wrote {out} ({len(frames)} frames, "
          f"{args.size[0]}x{args.size[1]})")
    return 0


def _scenes(args) -> int:
    from fluidsim_tpu_torch.scenes import REGISTRY, get_scene
    for name in REGISTRY:
        sc = get_scene(name)
        print(f"{name:20s} kind={sc.kind:4s} grid={sc.spec.n}^3 "
              f"seed_voxels={int(np.asarray(sc.seed_mask).sum())}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fluidsim_tpu_torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    pf = sub.add_parser("fluid", help="run the FLIP liquid solver (fluid.cc)")
    pf.add_argument("--scene", default="water_cube_drop")
    _add_run_args(pf)

    pm = sub.add_parser("mpm", help="run the MPM solid solver (mpm.cc)")
    pm.add_argument("--scene", default="mpm_cone")
    _add_run_args(pm)

    pp = sub.add_parser("print", help="dump .vdb archive info (vdb_print)")
    pp.add_argument("files", nargs="+")

    pr_ = sub.add_parser("render", help="render a .vdb density grid to PNG "
                                        "(vdb_render)")
    pr_.add_argument("file")
    pr_.add_argument("-o", "--output", default=None)
    pr_.add_argument("--axis", type=int, default=2)
    pr_.add_argument("--absorption", type=float, default=0.1)
    # vdb_render fog light-model options (cmd/openvdb_render/main.cc:82-111)
    pr_.add_argument("--absorb", type=float, nargs=3, default=None,
                     help="-absorb: per-RGB absorption (overrides "
                          "--absorption)")
    pr_.add_argument("--scatter", type=float, default=1.5,
                     help="-scatter: in-scatter coefficient")
    pr_.add_argument("--gain", type=float, default=0.2,
                     help="-gain: light multiplier")
    pr_.add_argument("--cutoff", type=float, default=0.005,
                     help="-cutoff: transmittance early-out threshold")
    pr_.add_argument("--grid", type=int, default=0,
                     help="grid index within the archive")

    pt = sub.add_parser("raytrace", help="sphere-trace a level-set grid to "
                                         "PNG (vdb_render -camera / "
                                         "LevelSetRayTracer)")
    pt.add_argument("file")
    pt.add_argument("-o", "--output", default=None)
    pt.add_argument("--grid", type=int, default=0)
    pt.add_argument("--eye", type=float, nargs=3, default=None,
                    help="camera position in index space (default: auto)")
    pt.add_argument("--look", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    pt.add_argument("--size", type=int, nargs=2, default=(512, 512))
    pt.add_argument("--fov", type=float, default=40.0)
    # vdb_render camera/film options (cmd/openvdb_render/main.cc:73-106):
    pt.add_argument("--camera", default="perspective",
                    choices=["perspective", "persp", "orthographic", "ortho"],
                    help="-camera: perspective or orthographic")
    pt.add_argument("--focal", type=float, default=None,
                    help="-focal: perspective focal length in mm "
                         "(with --aperture, overrides --fov)")
    pt.add_argument("--aperture", type=float, default=41.2136,
                    help="-aperture: film aperture in mm (default 41.2136)")
    pt.add_argument("--ortho-frame", type=float, default=None,
                    help="-frame: orthographic frame half-width in index "
                         "units (default: grid bound)")
    pt.add_argument("--samples", type=int, default=1,
                    help="-samples: supersamples per pixel")
    pt.add_argument("--near", type=float, default=1e-3,
                    help="-near: ray start depth")
    pt.add_argument("--far", type=float, default=None,
                    help="-far: ray clip depth (default 4x bound)")
    pt.add_argument("--up", type=float, nargs=3, default=None,
                    help="-up: camera up-vector hint")
    pt.add_argument("--fog-half-width", type=float, default=None,
                    help="treat the grid as fog (0..1) written by --surface "
                         "and convert back to a signed distance first")
    pt.add_argument("--device", default="cuda",
                    help="device the tracer runs on (default cuda)")

    pv = sub.add_parser("view", help="viewer (vdb_view): --interactive for "
                                     "the live WebGL orbit/clip viewer, or "
                                     "offline to an animated GIF / PNG "
                                     "sequence")
    pv.add_argument("files", nargs="+")
    pv.add_argument("--interactive", action="store_true",
                    help="serve the live viewer (mouse orbit, clip planes, "
                         "frame playback) on --port")
    pv.add_argument("--port", type=int, default=8611)
    pv.add_argument("-o", "--output", default=None,
                    help=".gif for animation, other extensions for a "
                         "numbered image sequence")
    pv.add_argument("--grid", type=int, default=0)
    pv.add_argument("--orbit", type=int, default=24,
                    help="turntable frame count when viewing a single file")
    pv.add_argument("--size", type=int, nargs=2, default=(384, 384))
    pv.add_argument("--fov", type=float, default=40.0)
    pv.add_argument("--frame-ms", type=int, default=80)
    pv.add_argument("--fog-half-width", type=float, default=None)
    pv.add_argument("--device", default="cuda",
                    help="device the tracer runs on (default cuda)")

    pl = sub.add_parser("lod", help="write a mean-pooled mip pyramid "
                                    "(vdb_lod)")
    pl.add_argument("file")
    pl.add_argument("-o", "--output", default=None)
    pl.add_argument("--levels", type=int, default=None)

    sub.add_parser("scenes", help="list registered scenes")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd in ("fluid", "mpm"):
        summary = run("flip" if args.cmd == "fluid" else "mpm", args)
        if summary["exporter"] is not None:
            print("export:", json.dumps(summary["exporter"]), file=sys.stderr)
        return 0
    return {"print": _print_vdb, "render": _render, "raytrace": _raytrace,
            "view": _view, "lod": _lod, "scenes": _scenes}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
