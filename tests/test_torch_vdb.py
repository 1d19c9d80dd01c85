"""The port's ``.vdb`` writer, reader and native writer against the JAX
package's: the same grid and uuid give the same bytes in every
compression, half-float and vec3 grids included; each package reads the
other's files to equal arrays; the native writer (built from the port's
own ``csrc/vdbio.cc``) gives both Python writers' bytes, and its build is
required to succeed here."""

import os
import uuid as uuid_mod

import numpy as np
import pytest

import fluidsim_tpu.io.vdb as jvdb
from fluidsim_tpu_torch.io import native, vdb

UUID = "01234567-89ab-cdef-0123-456789abcdef"
COMPRESSIONS = [vdb.COMPRESS_NONE, vdb.COMPRESS_ZIP, vdb.COMPRESS_ACTIVE_MASK,
                vdb.COMPRESS_BLOSC, vdb.COMPRESS_ZIP | vdb.COMPRESS_ACTIVE_MASK]
NATIVE_COMPRESSIONS = [vdb.COMPRESS_NONE, vdb.COMPRESS_ZIP,
                       vdb.COMPRESS_ACTIVE_MASK,
                       vdb.COMPRESS_ZIP | vdb.COMPRESS_ACTIVE_MASK]


class _Fixed:
    def __str__(self):
        return UUID


def _bytes(module, grids, compression, tmp_path):
    """``module.write_vdb``'s file with ``uuid.uuid4`` fixed."""
    path = os.path.join(tmp_path, f"{module.__name__}.vdb")
    orig = uuid_mod.uuid4
    uuid_mod.uuid4 = lambda: _Fixed()
    try:
        module.write_vdb(path, grids, compression=compression)
    finally:
        uuid_mod.uuid4 = orig
    with open(path, "rb") as f:
        return f.read()


def _grids(module, kind, seed=0):
    """The same grids as ``module.VdbGrid``s, from a seed."""
    rng = np.random.default_rng(seed)
    shape = (21, 19, 23)
    act = rng.random(shape) < 0.4
    if kind == "vec3":
        vals = rng.normal(size=shape + (3,)).astype(np.float32)
        vals[~act] = 0.0
        return [module.VdbGrid(values=vals, origin=(-10, -9, 3), active=act,
                               name="v", background=(0.0, 0.0, 0.0))]
    vals = rng.random(shape).astype(np.float32)
    vals[~act] = 0.0
    g = module.VdbGrid(values=vals, origin=(-10, -9, 3), active=act,
                       name="density", voxel_size=0.5,
                       save_half=kind == "half")
    # a second grid, and an instance of the first (same arrays)
    g2 = module.VdbGrid(values=vals * 2, origin=(0, 0, 0), name="")
    g3 = module.VdbGrid(values=vals, origin=(-10, -9, 3), active=act,
                        name="density_copy", voxel_size=0.5,
                        save_half=kind == "half")
    return [g, g2, g3]


@pytest.mark.parametrize("kind", ["float", "half", "vec3"])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_write_vdb_bytes_equal_jax(kind, compression, tmp_path):
    port = _bytes(vdb, _grids(vdb, kind), compression, tmp_path)
    ref = _bytes(jvdb, _grids(jvdb, kind), compression, tmp_path)
    assert port == ref


@pytest.mark.parametrize("kind", ["float", "half", "vec3"])
def test_read_vdb_both_directions(kind, tmp_path):
    comp = vdb.COMPRESS_ZIP | vdb.COMPRESS_ACTIVE_MASK
    p_port = str(tmp_path / "port.vdb")
    p_jax = str(tmp_path / "jax.vdb")
    vdb.write_vdb(p_port, _grids(vdb, kind), compression=comp)
    jvdb.write_vdb(p_jax, _grids(jvdb, kind), compression=comp)
    for path in (p_port, p_jax):
        ours, theirs = vdb.read_vdb(path), jvdb.read_vdb(path)
        assert len(ours) == len(theirs) == len(_grids(vdb, kind))
        for a, b in zip(ours, theirs):
            assert (a.name, a.origin, a.voxel_size) == (b.name, b.origin,
                                                        b.voxel_size)
            np.testing.assert_array_equal(a.values, b.values)
            np.testing.assert_array_equal(a.active, b.active)
    # what the port wrote reads back as what it was given
    g = _grids(vdb, kind)[0]
    r = vdb.read_vdb(p_port)[0]
    o = np.asarray(g.origin) - np.asarray(r.origin)
    s = tuple(slice(int(o[d]), int(o[d]) + g.values.shape[d]) for d in range(3))
    np.testing.assert_array_equal(r.active[s], g.active)
    want = (g.values.astype(np.float16).astype(np.float32) if kind == "half"
            else g.values)
    np.testing.assert_array_equal(r.values[s][g.active], want[g.active])


def test_open_vdb_delayed_load(tmp_path):
    path = str(tmp_path / "d.vdb")
    grids = _grids(vdb, "float")
    vdb.write_vdb(path, grids)
    delayed = vdb.open_vdb(path)
    assert [d.name for d in delayed] == [g.name for g in vdb.read_vdb(path)]
    np.testing.assert_array_equal(delayed[1].grid.values,
                                  vdb.read_vdb(path)[1].values)


def test_native_build_succeeds():
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libvdbio_")
    assert native.available()


@pytest.mark.parametrize("compression", NATIVE_COMPRESSIONS)
def test_encode_native_equals_both_python_writers(compression, tmp_path):
    rng = np.random.default_rng(1)
    vals = rng.random((21, 21, 21)).astype(np.float32)
    act = rng.random(vals.shape) < 0.6
    vals[~act] = 0.0
    port = vdb.VdbGrid(values=vals, origin=(-10, -10, -10), active=act,
                       name="g")
    ref = jvdb.VdbGrid(values=vals, origin=(-10, -10, -10), active=act,
                       name="g")
    nat = native.encode_native(port, compression, UUID)
    assert nat == _bytes(vdb, [port], compression, tmp_path)
    assert nat == _bytes(jvdb, [ref], compression, tmp_path)


def test_async_writer_native_queue(tmp_path):
    grids = [vdb.VdbGrid(values=np.full((9, 9, 9), i + 1.0, np.float32),
                         origin=(-4, -4, -4)) for i in range(4)]
    paths = [str(tmp_path / f"f{i}.vdb") for i in range(4)]
    with native.AsyncVdbWriter() as w:
        for p, g in zip(paths, grids):
            w.submit(p, g)
        w.flush()
        assert w.pending() == 0
        assert w.python_fallbacks == 0
    for i, p in enumerate(paths):
        (r,) = jvdb.read_vdb(p)
        assert r.values.max() == i + 1.0


def test_failed_build_reports_first_error_line(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("int f() { return undefined_name; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.BuildError) as err:
        native.build()
    assert "error" in err.value.first_line
    assert "undefined_name" in err.value.first_line
    assert not list((tmp_path / "build").glob("*.so"))


def test_writer_falls_back_to_python_counted_and_printed(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", native.BuildError(
        "vdbio.cc:1:1: error: boom", "vdbio.cc:1:1: error: boom"))
    g = vdb.VdbGrid(values=np.full((9, 9, 9), 2.0, np.float32),
                    origin=(-4, -4, -4))
    with native.AsyncVdbWriter() as w:
        w.submit(str(tmp_path / "f.vdb"), g)
        w.flush()
        assert w.python_fallbacks == 1 and w.pending() == 0
    err = capsys.readouterr().err.strip().splitlines()
    assert err == ["vdbio: the native writer did not build, writing frames "
                   "with the Python writer: vdbio.cc:1:1: error: boom"]
    (r,) = vdb.read_vdb(str(tmp_path / "f.vdb"))
    assert r.values.max() == 2.0
    with pytest.raises(native.BuildError):
        native.encode_native(g, vdb.COMPRESS_ZIP)
