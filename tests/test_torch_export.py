"""The port's frame exporter (``fluidsim_tpu_torch/io/export.py``) against
the JAX package's: ``pack_active`` gives the same buffer bit for bit
(solid mask, truncation, signed zeros and a cap past the cell count
included), and ``AsyncFrameExporter`` writes files that decode to the same
values and active masks, with the same accumulated grids, in the "flip"
and "mpm" persistence rules, the reference topology and the dense
fallback of a truncated packet."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.io import export as jexport
from fluidsim_tpu.io.vdb import read_vdb as jread_vdb
from fluidsim_tpu_torch.io import export
from fluidsim_tpu_torch.io.vdb import read_vdb


class _Spec:
    def __init__(self, n, bound):
        self.shape = (n, n, n)
        self.bound = bound
        self.dx = 1.0


def _field(n, frac, seed, signed_zeros=False):
    rng = np.random.default_rng(seed)
    vals = rng.random((n, n, n)).astype(np.float32) + 0.1
    vals[rng.random((n, n, n)) > frac] = 0.0
    if signed_zeros:                      # inactive cells holding -0.0
        vals[(vals == 0) & (rng.random((n, n, n)) < 0.5)] = -0.0
    return vals


def _on_box(g, bound, n):
    """A decoded (leaf-aligned) grid's values on the sim's (n, n, n) box."""
    out = np.zeros((n, n, n), np.float32)
    lo = [int(o) + bound for o in g.origin]
    src = tuple(slice(max(0, -lo[d]), min(g.values.shape[d], n - lo[d]))
                for d in range(3))
    dst = tuple(slice(lo[d] + src[d].start, lo[d] + src[d].stop)
                for d in range(3))
    out[dst] = g.values[src]
    return out


def _solid(n):
    solid = np.zeros((n, n, n), bool)
    solid[0] = solid[-1] = True
    solid[:, :2] = True
    return solid


@pytest.mark.parametrize("n,frac,cap,with_solid,signed_zeros", [
    (21, 0.2, None, False, False),      # cap = ncells // 4
    (21, 0.2, None, True, True),
    (17, 0.5, 10, False, False),        # truncated: count > cap
    (17, 0.5, 10, True, True),
    (13, 0.3, 5000, True, False),       # cap past the cell count
    (9, 0.0, None, False, False),       # nothing active
    (11, 1.0, None, False, False),      # everything active, truncated
])
def test_pack_active_bitwise_equal_jax(n, frac, cap, with_solid,
                                       signed_zeros):
    dense = _field(n, frac, n, signed_zeros)
    cap = cap or max(1, n ** 3 // 4)
    solid = _solid(n).reshape(-1) if with_solid else None
    ref = np.asarray(jexport.pack_active(
        jnp.asarray(dense), None if solid is None else jnp.asarray(solid),
        cap))
    out = export.pack_active(
        torch.as_tensor(dense), None if solid is None else torch.as_tensor(
            solid), cap)
    assert out.dtype == torch.uint8
    assert out.shape[0] == export.packed_size(n ** 3, cap) == ref.shape[0]
    np.testing.assert_array_equal(out.numpy(), ref)


def test_unpack_active_roundtrip_and_truncation():
    n = 21
    dense = _field(n, 0.2, 0)
    count = int((dense != 0).sum())
    buf = export.pack_active(torch.as_tensor(dense), None, count + 5).numpy()
    out, c = export.unpack_active(buf, (n, n, n), count + 5)
    assert c == count
    np.testing.assert_array_equal(out, dense)
    buf = export.pack_active(torch.as_tensor(dense), None, 10).numpy()
    out, c = export.unpack_active(buf, (n, n, n), 10)
    assert out is None and c == count


def _run(module, spec, solid, frames, out_dir, to_dev, **kw):
    os.makedirs(out_dir)
    with module.AsyncFrameExporter(spec, solid, accum=True, **kw) as ex:
        for i, f in enumerate(frames):
            ex.submit(str(out_dir / f"mygrids{i}.vdb"), to_dev(f))
        ex.flush()
        counters = (ex.fallback_frames, ex.tail_fetches)
        grids = ex.accum_grids
    return counters, grids


@pytest.mark.parametrize("mode,ref_topology,cap", [
    ("flip", False, None), ("mpm", False, None), ("flip", True, None),
    ("flip", False, 8), ("mpm", False, 8)])
def test_exporter_equals_jax(mode, ref_topology, cap, tmp_path):
    n, bound = 21, 10
    spec = _Spec(n, bound)
    solid = _solid(n)
    frames = [_field(n, 0.08 + 0.05 * i, 10 + i) for i in range(4)]
    kw = dict(mode=mode, ref_topology=ref_topology, cap=cap)
    (fb, tail), grids = _run(export, spec, solid, frames, tmp_path / "port",
                             torch.as_tensor, **kw)
    (jfb, _), jgrids = _run(jexport, spec, solid, frames, tmp_path / "jax",
                            jnp.asarray, **kw)
    assert fb == jfb == (len(frames) if cap else 0)
    assert tail == 0
    assert len(grids) == len(jgrids) == len(frames)
    for g, jg in zip(grids, jgrids):
        np.testing.assert_array_equal(g.values, jg.values)
        np.testing.assert_array_equal(g.active, jg.active)
        assert (g.origin, g.voxel_size) == (jg.origin, jg.voxel_size)
    for i in range(len(frames)):
        name = f"mygrids{i}.vdb"
        (a,) = read_vdb(str(tmp_path / "port" / name))
        (b,) = jread_vdb(str(tmp_path / "jax" / name))
        assert a.origin == b.origin
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.active, b.active)


def test_exporter_dense_fetch_and_counters(tmp_path):
    n, bound = 17, 8
    spec = _Spec(n, bound)
    solid = _solid(n)
    dense = _field(n, 0.3, 5)
    with export.AsyncFrameExporter(spec, solid, dense_fetch=True) as ex:
        ex.submit(str(tmp_path / "f.vdb"), torch.as_tensor(dense))
        ex.flush()
        c = ex.counters()
    assert c["fallback_frames"] == 0 and c["python_fallbacks"] == 0
    assert set(c) == {"fallback_frames", "tail_fetches", "max_pending",
                      "fetch_secs", "proc_secs", "submit_block_secs",
                      "backpressure_secs", "python_fallbacks"}
    (g,) = read_vdb(str(tmp_path / "f.vdb"))
    np.testing.assert_array_equal(_on_box(g, bound, n),
                                  np.where(solid, 0.0, dense))


def test_exporter_rejects_wrong_shape(tmp_path):
    with export.AsyncFrameExporter(_Spec(9, 4), np.zeros((9, 9, 9), bool)) as ex:
        with pytest.raises(ValueError, match="shape"):
            ex.submit(str(tmp_path / "f.vdb"), torch.zeros(8, 9, 9))
