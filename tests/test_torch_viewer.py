"""The port's viewer server (``fluidsim_tpu_torch/io/viewer.py``, a copy of
the JAX package's reading frames with the port's ``.vdb`` reader) against
the JAX package's: one case for each case of ``tests/test_viewer.py``.
``_frame_points`` and the ``/frame/i`` bytes agree bit for bit."""

import gzip
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from fluidsim_tpu.io import viewer as jviewer
from fluidsim_tpu_torch.io import vdb, viewer


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        vals = rng.random((12, 12, 12)).astype(np.float32)
        act = vals > 0.5
        vals[~act] = 0.0
        p = str(d / f"f{i}.vdb")
        vdb.write_vdb(p, [vdb.VdbGrid(values=vals, origin=(-6, -6, -6),
                                      active=act, name="density")])
        paths.append(p)
    # a Vec3 grid and a particle checkpoint, the other two frame kinds
    vec = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)
    p = str(d / "vec.vdb")
    vdb.write_vdb(p, [vdb.VdbGrid(values=vec, origin=(0, -4, 2), name="v")])
    paths.append(p)
    p = str(d / "ckpt.npz")
    np.savez(p, pos=rng.normal(size=(50, 3)).astype(np.float32))
    paths.append(p)
    return paths


def test_frame_points_shape(frames):
    for path in frames:
        pts = viewer._frame_points(path)
        np.testing.assert_array_equal(pts, jviewer._frame_points(path))
        assert pts.dtype == np.float32 and pts.shape[1] == 4
        assert pts.shape[0] > 0
        assert 0.0 <= pts[:, 3].min() and pts[:, 3].max() <= 1.0
    # the subsample past max_points draws the same rows
    np.testing.assert_array_equal(
        viewer._frame_points(frames[0], max_points=100),
        jviewer._frame_points(frames[0], max_points=100))


def _get(url):
    resp = urllib.request.urlopen(url, timeout=10)
    raw = resp.read()
    if resp.headers.get("Content-Encoding") == "gzip":
        raw = gzip.decompress(raw)
    return raw


def test_server_endpoints(frames):
    srv = viewer.serve(frames[:2], port=0, block=False)   # port 0: ephemeral
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        html = _get(f"{base}/").decode()
        assert html == jviewer._PAGE and "webgl" in html and "clip" in html
        info = json.loads(_get(f"{base}/info"))
        assert info["frames"] == [0, 1] and info["bound"] >= 6
        for i in (1, 0, 1):                      # cached on the second read
            pts = np.frombuffer(_get(f"{base}/frame/{i}"), np.float32)
            want = jviewer._frame_points(frames[i])
            assert pts.tobytes() == want.tobytes()
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/frame/9")
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
