"""The port's sphere tracer (``fluidsim_tpu_torch/ops/raytrace.py``) and its
``raytrace`` and ``view`` commands against the JAX package's, on the same
inputs: one case for each tracer and CLI case of
``tests/test_mesh_raytrace.py``.

The image rule: the port's march and the JAX one sum the same f32
distances, so a ray's hit test can flip only where its sample sits within
f32 noise of ``hit_eps``.  At most ``FLIPS`` pixels (0.5% of the image,
at least 2) may differ in hit or by more than ``IMG_TOL`` in colour;
everywhere else the colours agree within ``IMG_TOL`` and the depths of
rays that both hit within ``DEPTH_TOL`` (four ``hit_eps`` steps).  PNG
and GIF frames hold ``floor(255 * colour)``: there, 1 level."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fluidsim_tpu import cli as jcli
from fluidsim_tpu.io.vdb import VdbGrid, write_vdb
from fluidsim_tpu.ops import levelset as jls
from fluidsim_tpu.ops import mesh as jmesh
from fluidsim_tpu.ops import raytrace as jrt
from fluidsim_tpu_torch import cli
from fluidsim_tpu_torch.ops import mesh
from fluidsim_tpu_torch.ops import raytrace as rt

B = 12
IMG_TOL = 1e-3
DEPTH_TOL = 0.02


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the other test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flips(npix):
    return max(2, npix // 200)


def _same_image(got, want):
    """The image rule of the module docstring on (img, hit, depth)."""
    img, hit, depth = (np.asarray(x) for x in got)
    jimg, jhit, jdepth = (np.asarray(x) for x in want)
    assert img.shape == jimg.shape and img.dtype == np.float32
    bad = (hit != jhit) | (np.abs(img - jimg).max(axis=-1) > IMG_TOL)
    assert bad.sum() <= _flips(hit.size), (bad.sum(), _flips(hit.size))
    both = hit & jhit & ~bad
    np.testing.assert_allclose(depth[both], jdepth[both], rtol=0,
                               atol=DEPTH_TOL)
    assert np.isinf(depth[~hit]).all()


def _same_pixels(a, b):
    """Two 8-bit frames under the image rule."""
    a = np.asarray(a, np.int16)
    b = np.asarray(b, np.int16)
    assert a.shape == b.shape
    bad = np.abs(a - b).reshape(-1, a.shape[-1]).max(axis=-1) > 1
    assert bad.sum() <= _flips(bad.size), bad.sum()


def _noisy_sphere(bound, center, r, seed):
    sdf = np.asarray(jls.sphere_sdf(None, bound, center, r))
    rng = np.random.default_rng(seed)
    return (sdf + rng.normal(0.0, 0.05, sdf.shape)).astype(np.float32)


def _both(sdf, bound, eye, look, **kw):
    got = rt.raytrace_levelset(torch.as_tensor(sdf), bound, eye, look, **kw)
    want = jrt.raytrace_levelset(jnp.asarray(sdf), bound, eye, look, **kw)
    _same_image(got, want)
    return [x.numpy() for x in got]


def test_raytrace_sphere_geometry():
    r = 5.0
    sdf = np.array(jls.sphere_sdf(None, B, (0.0, 0.0, 0.0), r))
    img, hit, depth = _both(sdf, B, (0.0, 0.0, -10.0), (0.0, 0.0, 0.0),
                            width=64, height=64, fov_deg=60.0)
    assert img.shape == (64, 64, 3) and img.min() >= 0 and img.max() <= 1
    assert hit[32, 32] and abs(depth[32, 32] - (10.0 - r)) < 0.15
    assert not hit[0, 0] and not hit[-1, -1]
    assert 0.6 < hit.mean() < 0.85
    # an off-centre noisy sphere from an oblique eye, and a look straight
    # down the y axis (the automatic up vector's other branch)
    noisy = _noisy_sphere(B, (0.5, -0.3, 0.2), 5.0, 0)
    _both(noisy, B, (1.0, 2.0, -20.0), (0.0, 0.0, 0.0), width=48, height=40)
    _both(noisy, B, (0.0, 20.0, 0.0), (0.0, 0.0, 0.0), width=32, height=32)


def test_raytrace_mesh_sdf_end_to_end():
    v, t = mesh.icosphere((0.0, 2.0, 0.0), 4.0, subdivisions=2)
    sdf = mesh.mesh_to_sdf(v, t, B, chunk=4096, device="cpu")
    jsdf = jmesh.mesh_to_sdf(v, t, B, chunk=4096)
    np.testing.assert_allclose(sdf.numpy(), np.asarray(jsdf), rtol=0,
                               atol=1e-5)
    got = rt.raytrace_levelset(sdf, B, (0.0, 2.0, -9.0), (0.0, 2.0, 0.0),
                               width=48, height=48)
    want = jrt.raytrace_levelset(jsdf, B, (0.0, 2.0, -9.0), (0.0, 2.0, 0.0),
                                 width=48, height=48)
    _same_image(got, want)
    assert bool(got[1][24, 24]) and math.isfinite(float(got[2][24, 24]))


@pytest.mark.parametrize("case", ["ortho", "samples", "zfar", "up", "focal"])
def test_camera_film_options(case):
    assert rt.focal_to_fov(50.0, 41.2136) == jrt.focal_to_fov(50.0, 41.2136)
    b = 16
    sdf = _noisy_sphere(b, (0.0, 0.0, 0.0), 8.0, 1)
    kw = {"ortho": dict(width=64, height=64, camera="orthographic",
                        frame=12.0),
          "samples": dict(width=32, height=32, samples=4),
          "zfar": dict(width=32, height=32, zfar=20.0),
          "up": dict(width=32, height=24, up_hint=(0.3, 1.0, 0.1),
                     znear=2.0, light_dir=(-1.0, 0.5, 0.2)),
          "focal": dict(width=32, height=32,
                        fov_deg=rt.focal_to_fov(35.0, 36.0))}[case]
    img, hit, _ = _both(sdf, b, (0, 0, -40), (0, 0, 0), **kw)
    if case == "ortho":
        expected = math.pi * (8 / 12 * 32) ** 2      # analytic silhouette
        assert 0.8 < hit.sum() / expected < 1.2
    if case == "zfar":
        assert hit.sum() == 0                         # far plane first
    assert np.isfinite(img).all()


def _fluid_surface_vdb(tmp_path):
    out = str(tmp_path / "sim")
    assert cli.main(["fluid", "--device", "cpu", "--scene", "water_cube_drop",
                     "--bound", "10", "--density", "3", "--frames", "1",
                     "--out", out, "--no-accum", "--surface",
                     "--echo-every", "100"]) == 0
    return os.path.join(out, "mygrids0.vdb")


def test_cli_raytrace_from_surface_vdb(tmp_path):
    vdb = _fluid_surface_vdb(tmp_path)
    args = ["-o", None, "--fog-half-width", "1.5", "--size", "64", "48",
            "--eye", "0", "4", "-24"]
    pngs = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        png = str(tmp_path / f"{name}.png")
        args[1] = png
        assert main(["raytrace", vdb] + args + extra) == 0
        data = open(png, "rb").read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 400
        pngs.append(np.asarray(Image.open(png)))
    _same_pixels(*pngs)
    assert pngs[0].shape == (48, 64, 3)


def test_cli_view_turntable_and_sequence(tmp_path):
    n = 33
    ax = np.arange(n) - 16.0
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = (np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 9.0).astype(np.float32)
    vdb = str(tmp_path / "sphere.vdb")
    write_vdb(vdb, [VdbGrid(values=sdf, origin=(-16,) * 3, background=3.0)])

    gifs = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        gif = str(tmp_path / f"{name}.gif")
        assert main(["view", vdb, "-o", gif, "--orbit", "3",
                     "--size", "64", "64"] + extra) == 0
        with Image.open(gif) as im:
            assert im.n_frames == 3 and im.size == (64, 64)
            frames = []
            for k in range(3):
                im.seek(k)
                frames.append(np.asarray(im.convert("RGB")))
        gifs.append(frames)
    for a, b in zip(*gifs):
        _same_pixels(a, b)

    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        assert main(["view", vdb, vdb, "-o", str(tmp_path / f"{name}.png"),
                     "--size", "48", "48"] + extra) == 0
    for i in range(2):
        _same_pixels(Image.open(tmp_path / f"port_{i:04d}.png"),
                     Image.open(tmp_path / f"jax_{i:04d}.png"))


def test_cli_default_device_is_cuda(tmp_path):
    # no fallback: without a card the default device raises
    vdb = str(tmp_path / "s.vdb")
    write_vdb(vdb, [VdbGrid(values=np.ones((5, 5, 5), np.float32),
                            origin=(-2,) * 3, background=3.0)])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        cli.main(["raytrace", vdb, "-o", str(tmp_path / "r.png"),
                  "--size", "8", "8"])
