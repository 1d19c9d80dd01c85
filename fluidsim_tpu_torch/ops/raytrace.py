"""Level-set ray tracer — the counterpart of ``fluidsim_tpu/ops/raytrace.py``
(the ``LevelSetRayTracer`` / ``RayIntersector`` family of the vendored
OpenVDB, ``reference/openvdb/tools/RayTracer.h``).

One sphere trace over the whole image at once: rays are a (H*W, 3) batch,
each pass advances every live ray by the trilinearly sampled SDF value,
and shading is a batched central-difference normal + Lambertian.  The
march is a fixed loop of ``max_steps + 1`` passes: a ray that hit, left
the clip range or ran out of steps keeps its depth, so the result equals
a loop that stops when no ray is live, with no read of the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fluidsim_tpu_torch.ops.advect_volume import sample_trilinear


def _sample(sdf, p, bound):
    """Trilinear SDF sample at index-space points ``p`` (Q, 3); points
    outside the lattice read a large positive distance (empty space)."""
    v = sample_trilinear(sdf[..., None], p, bound)[..., 0]
    outside = torch.any(torch.abs(p) > bound - 1.001, dim=-1)
    return torch.where(outside, 3.0, v)


def _unit(v):
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def focal_to_fov(focal_mm: float, aperture_mm: float = 41.2136) -> float:
    """``PerspectiveCamera::focalLengthToFieldOfView`` (the conversion the
    reference CLI applies to its -focal/-aperture options,
    ``cmd/openvdb_render/main.cc:178``): fov = 2 atan(aperture / 2 focal),
    in degrees."""
    return math.degrees(2.0 * math.atan2(aperture_mm, 2.0 * focal_mm))


def raytrace_levelset(sdf, bound: int, eye, look_at,
                      width: int = 256, height: int = 256,
                      fov_deg: float = 40.0, max_steps: int = 128,
                      light_dir=(0.5, 1.0, 0.3), hit_eps: float = 5e-3,
                      camera: str = "perspective", frame: float | None = None,
                      samples: int = 1, znear: float = 1e-3,
                      zfar: float | None = None, up_hint=None):
    """Render an SDF grid with sphere tracing, on the device of ``sdf``.

    Camera/film options mirror the reference ``vdb_render`` CLI
    (``cmd/openvdb_render/main.cc:73-106,178-196``): perspective or
    orthographic ``camera``; perspective FOV from ``fov_deg`` (use
    ``focal_to_fov`` for -focal/-aperture); ``frame`` = orthographic frame
    half-width in index units; ``samples`` = supersamples per pixel
    (stratified ceil(sqrt(N))^2 grid); ``znear``/``zfar`` = ray clip
    range (-near/-far); ``up_hint`` overrides the automatic up vector.

    Args:
      sdf: (N, N, N) signed distance in index space (``mesh_to_sdf`` /
        ``particles_to_levelset`` output).
      eye, look_at: camera position / target in index space.
    Returns:
      (H, W, 3) float32 image in [0, 1] (grey Lambertian on sky gradient),
      (H, W) bool hit mask, (H, W) float32 ray depth (inf where missed).
    """
    dtype, dev = sdf.dtype, sdf.device

    def vec(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    eye = vec(eye)
    fwd = _unit(vec(look_at) - eye)
    if up_hint is None:
        up0 = torch.where(torch.abs(fwd[1]) > 0.99, vec([1.0, 0.0, 0.0]),
                          vec([0.0, 1.0, 0.0]))
    else:
        up0 = vec(up_hint)
    right = _unit(torch.linalg.cross(fwd, up0))
    up = torch.linalg.cross(right, fwd)

    # stratified sub-pixel offsets (reference -samples antialiasing)
    ss = max(1, int(np.ceil(np.sqrt(samples))))
    offs = [((i + 0.5) / ss - 0.5, (j + 0.5) / ss - 0.5)
            for i in range(ss) for j in range(ss)]
    rows = torch.arange(height, dtype=dtype, device=dev)
    cols = torch.arange(width, dtype=dtype, device=dev)

    def pixel_axes(dx, dy):
        ys = 0.5 - (rows + 0.5 + dy) / height
        xs = (cols + 0.5 + dx) / width - 0.5
        return xs, ys

    d_list, o_list = [], []
    if camera.startswith("ortho"):
        hw = vec(bound if frame is None else frame)
        for dx, dy in offs:
            xs, ys = pixel_axes(dx, dy)
            org = (eye[None, None]
                   + (xs * 2 * hw * (width / height))[None, :, None]
                   * right[None, None]
                   + (ys * 2 * hw)[:, None, None] * up[None, None])
            o_list.append(org.reshape(-1, 3))
            d_list.append(fwd.expand(height * width, 3))
    else:
        half = torch.tan(torch.deg2rad(vec(fov_deg)) / 2)
        for dx, dy in offs:
            xs, ys = pixel_axes(dx, dy)
            dirs = (fwd[None, None]
                    + (xs * 2 * half * (width / height))[None, :, None]
                    * right[None, None]
                    + (ys * 2 * half)[:, None, None] * up[None, None])
            d_list.append(_unit(dirs).reshape(-1, 3))
            o_list.append(eye.expand(height * width, 3))
    d = torch.cat(d_list, dim=0)
    origins = torch.cat(o_list, dim=0)
    q = d.shape[0]
    tmax = vec(4.0 * bound if zfar is None else zfar)

    t = torch.full((q,), znear, dtype=dtype, device=dev)
    live = torch.ones((q,), dtype=torch.bool, device=dev)
    for _ in range(max_steps + 1):
        dist = _sample(sdf, origins + t[:, None] * d, bound)
        hit = dist < hit_eps
        t = torch.where(live & ~hit, t + torch.clamp(dist, min=hit_eps), t)
        live = live & ~hit & ~(t > tmax)

    p = origins + t[:, None] * d
    hit = (_sample(sdf, p, bound) < 2 * hit_eps) & (t < tmax)

    # central-difference normal
    comps = []
    for ax in range(3):
        e = torch.zeros(3, dtype=dtype, device=dev)
        e[ax] = 0.5
        comps.append(_sample(sdf, p + e, bound) - _sample(sdf, p - e, bound))
    nrm = torch.stack(comps, dim=-1)
    nrm = nrm / torch.clamp(torch.sqrt(torch.sum(nrm * nrm, dim=-1,
                                                 keepdim=True)), min=1e-12)

    ld = _unit(vec(light_dir))
    lam = torch.clamp(torch.sum(nrm * ld[None], -1), 0.0, 1.0)
    shade = 0.15 + 0.85 * lam
    surf = shade[:, None] * vec([0.55, 0.75, 0.95])[None]

    sky_t = 0.5 * (d[:, 1] + 1.0)
    sky = ((1 - sky_t)[:, None] * vec([1.0, 1.0, 1.0])
           + sky_t[:, None] * vec([0.45, 0.62, 0.85]))

    img_s = torch.where(hit[:, None], surf, sky).reshape(-1, height, width, 3)
    img = torch.mean(img_s, dim=0)
    hit_g = hit.reshape(-1, height, width)
    t_g = torch.where(hit, t, torch.inf).reshape(-1, height, width)
    # primary-sample hit/depth (sub-pixel 0 = the reference single-sample
    # behaviour); the averaged image carries the AA
    return img.to(torch.float32), hit_g[0], t_g[0]
