"""JSON scene/run configuration — the counterpart of
``fluidsim_tpu/config.py``: the same JSON builds the same scene, bit for
bit, and a sim of the port with the same parameters.

The reference has no config system — every parameter is a hardcoded literal
and scenes are swapped by (un)commenting code blocks (SURVEY.md §5).  Here a
JSON file can define a complete custom scene (box size, seed regions, solid
obstacles, physics constants) without touching code:

```json
{
  "kind": "flip",
  "bound": 40,
  "density": 10,
  "gravity": [0, -10, 0],
  "seed": [{"box": [[-10, -10, -10], [10, 10, 10]]},
           {"sphere": {"center": [0, 20, 0], "radius": 6}}],
  "solid": [{"box": [[-5, -38, -5], [5, -20, 5]]}],
  "params": {"max_dt": 0.05, "mode": "apic"}
}
```
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from fluidsim_tpu_torch.core.gridspec import GridSpec
from fluidsim_tpu_torch.models.flip import FlipParams, FlipSim
from fluidsim_tpu_torch.models.mpm import MpmParams, MpmSim
from fluidsim_tpu_torch.scenes import Scene


def _region_mask(spec: GridSpec, region: dict) -> np.ndarray:
    c = spec.coords()
    if "box" in region:
        lo, hi = region["box"]
        m = np.ones(spec.shape, bool)
        for d in range(3):
            ax = (c >= lo[d]) & (c <= hi[d])
            shape = [1, 1, 1]
            shape[d] = spec.n
            m &= ax.reshape(shape)
        return m
    if "sphere" in region:
        ctr = np.asarray(region["sphere"]["center"], float)
        r = float(region["sphere"]["radius"])
        g = np.stack(np.meshgrid(c, c, c, indexing="ij"), axis=-1)
        return np.linalg.norm(g - ctr, axis=-1) <= r
    raise ValueError(f"unknown region type: {list(region)}")


def scene_from_config(cfg: dict | str) -> tuple:
    """Build (Scene, params_overrides) from a config dict or JSON path."""
    if isinstance(cfg, str):
        with open(cfg) as f:
            cfg = json.load(f)
    kind = cfg.get("kind", "flip")
    bound = int(cfg.get("bound", 60 if kind == "flip" else 15))
    spec = GridSpec(bound=bound, wall=int(cfg.get("wall", bound - 2)),
                    dx=float(cfg.get("dx", 1.0)))

    seed_mask = np.zeros(spec.shape, bool)
    for region in cfg.get("seed", []):
        seed_mask |= _region_mask(spec, region)
    if not seed_mask.any():
        raise ValueError("config defines no seed region")

    solid = spec.wall_mask()
    for region in cfg.get("solid", []):
        solid |= _region_mask(spec, region)
    seed_mask &= ~solid

    scene = Scene(
        name=cfg.get("name", "custom"), kind=kind, spec=spec, solid=solid,
        normals=spec.wall_normals(), seed_mask=seed_mask,
        density=float(cfg.get("density", 10.0 if kind == "flip" else 400.0)),
        gravity=tuple(cfg.get("gravity", (0.0, -10.0, 0.0))),
        initial_velocity=tuple(cfg.get("initial_velocity",
                                       (0.0, 0.0, 0.0) if kind == "flip"
                                       else (0.0, -50.0, 0.0))))
    return scene, dict(cfg.get("params", {}))


def make_sim(cfg: dict | str, **kwargs):
    """Build a ready-to-run sim (``FlipSim`` or ``MpmSim``) from a config.
    ``kwargs`` go to the sim: ``seed``, ``seeder``, ``dtype`` and
    ``device`` (``"cuda"`` unless given, as for the sims)."""
    scene, overrides = scene_from_config(cfg)
    if scene.kind == "flip":
        params = FlipParams(bound=scene.spec.bound, wall=scene.spec.wall,
                            dx=scene.spec.dx, gravity=tuple(scene.gravity))
        params = dataclasses.replace(params, **overrides)
        return FlipSim(scene, params=params, **kwargs)
    params = MpmParams(bound=scene.spec.bound, wall=scene.spec.wall,
                       dx=scene.spec.dx, gravity=tuple(scene.gravity))
    params = dataclasses.replace(params, **overrides)
    return MpmSim(scene, params=params, **kwargs)
