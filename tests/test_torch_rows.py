"""The port's row layer (``ops/rows.py``) and the row-layout transfer
pipeline (``utils/transfer_parts.py``) against the JAX package, with the
Pallas kernels in interpret mode:

- ``pad_rows_with_ids`` and ``attach_ids`` against the JAX functions;
- K8a ``gather_rows_cm`` and K8b ``scatter_rows_cm`` against
  ``pallas_transfer.gather_rows_cm`` / ``scatter_rows_cm``, on random
  sorted ids (with empty windows, and a cell of more rows than a chunk)
  and on the haloed ids of ``transfer_pallas.sort_by_cell_h``;
- the pipeline of ``scripts/profile_p2g_parts.py`` (row build, K8b, K6b;
  field build, K7b, K8a) against the JAX one on ``HaloLayout``, unhaloed;
- on the port alone: the row P2G equals K6a and the row G2P equals K7a and
  K2.

On CPU tensors the wrappers run their plain PyTorch versions; the CUDA
kernels are compared with those on the card by ``chip_smoke.py``.

Tolerances: the gather and the row padding are copies: bitwise.  The
scatter's sums run over each cell's rows in array order, the JAX kernel's
as one-hot dot products per chunk added into the window: atol/rtol 1e-5
on the payload, rtol 1e-6 on lane 127 (the sums of the f32 ids, exact in
both).  The port's row P2G adds the same f32 products per cell in the same
order as K6a, and its contraction K7a's products in K7a's order: bitwise.

Both packages read the rows' cells here from ids of the whole grid
(``idmod=0``): the JAX kernels read them from lane 127, the port from
``flat_s``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fluidsim_tpu.ops import pallas_shift as ps
from fluidsim_tpu.ops import pallas_transfer as pt
from fluidsim_tpu.ops import transfer_pallas as tp
from fluidsim_tpu_torch.ops import rows as rw
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.utils import synthetic
from fluidsim_tpu_torch.utils import transfer_parts as tparts

T = 256         # the JAX kernels' particle chunk: small interpret grids


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in ``tests/test_torch_table.py``: the other
    test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a):
    """The f32 bit patterns of an array, so that equality is bitwise."""
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.uint32)


# ---- pad_rows_with_ids, attach_ids -------------------------------------------

def _sorted_ids(rng, p, ncells):
    return np.sort(rng.integers(0, ncells, p)).astype(np.int32)


@pytest.mark.parametrize("channels", [None, 108], ids=["no-values", "108ch"])
@pytest.mark.parametrize("idmod", [0, 512])
def test_pad_rows_with_ids_matches_jax(idmod, channels):
    rng = np.random.default_rng(idmod + (channels or 0))
    p = 1003
    flat = _sorted_ids(rng, p, 5000)
    vals = (None if channels is None
            else rng.normal(size=(p, channels)).astype(np.float32))
    ref, ref_pad = pt.pad_rows_with_ids(
        jnp.asarray(flat), None if vals is None else jnp.asarray(vals), T,
        idmod=idmod)
    out, p_pad = rw.pad_rows_with_ids(
        torch.as_tensor(flat), None if vals is None else torch.as_tensor(vals),
        T, idmod=idmod)
    assert p_pad == ref_pad == -(-p // 8) * 8 + T + 8
    assert out.shape == (p_pad, 128) and out.dtype == torch.float32
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert (out[p:, 127] == -1).all() and out[:p, 127].max() > 0


def test_attach_ids_matches_jax():
    rng = np.random.default_rng(7)
    p, p_pad = 777, 777 + 300
    flat = _sorted_ids(rng, p, 3000)
    buf = rng.normal(size=(p_pad, 128)).astype(np.float32)
    ref = pt.attach_ids(jnp.asarray(buf), jnp.asarray(flat))
    out = rw.attach_ids(torch.as_tensor(buf), torch.as_tensor(flat))
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    np.testing.assert_array_equal(out[:, :127].numpy(), buf[:, :127])


def test_pad_rows_with_ids_refuses_128_channels():
    with pytest.raises(ValueError, match="channels"):
        rw.pad_rows_with_ids(torch.zeros(4, dtype=torch.int32),
                             torch.zeros((4, 128)), T)


# ---- K8a, K8b on sets of sorted ids ------------------------------------------

def _ids_case(kind):
    """(flat, ncells): sorted int32 ids and a grid of ncells % 512 == 0."""
    rng = np.random.default_rng(len(kind))
    if kind == "random":
        # windows 0, 1, 3 of 4 hold rows; window 2 is empty
        ncells = 2048
        ids = np.concatenate([rng.integers(0, 1024, 2000),
                              rng.integers(1536, 2048, 1000)])
    elif kind == "split-chunk":
        # cell 700 holds 600 rows, more than a T-row chunk
        ncells = 2048
        ids = np.concatenate([rng.integers(0, 2048, 1500), np.full(600, 700)])
    else:
        # the haloed ids of sort_by_cell_h at bound 8
        bound, n = 8, 17
        lay = tp.HaloLayout(n)
        pos = rng.uniform(-(bound - 1.5), bound - 1.5, (1200, 3)).astype(np.float32)
        _, _, flat = tp.sort_by_cell_h(jnp.asarray(pos), jnp.asarray(pos),
                                       bound, lay)
        return np.array(flat), lay.ncells
    return np.sort(ids).astype(np.int32), ncells


ID_CASES = ["random", "split-chunk", "haloed"]


@pytest.mark.parametrize("kind", ID_CASES)
def test_k8a_gather_rows_cm_matches_jax_bitwise(kind):
    flat, ncells = _ids_case(kind)
    p = flat.shape[0]
    rng = np.random.default_rng(p)
    table = rng.normal(size=(128, ncells)).astype(np.float32)
    vals = rng.normal(size=(p, 127)).astype(np.float32)
    init, _ = pt.pad_rows_with_ids(jnp.asarray(flat), jnp.asarray(vals), T)
    init = np.array(init)
    ref = np.asarray(pt.gather_rows_cm(jnp.asarray(table), jnp.asarray(init),
                                       jnp.asarray(flat), t=T, interpret=True))
    before = rw.gather_rows_cm.launches
    out = rw.gather_rows_cm(torch.as_tensor(table), torch.as_tensor(init),
                            torch.as_tensor(flat)).numpy()
    assert rw.gather_rows_cm.launches == before          # plain on the CPU
    assert out.shape == ref.shape == init.shape
    np.testing.assert_array_equal(_bits(out), _bits(ref))          # 128 lanes
    np.testing.assert_array_equal(out[:p], table[:, flat].T)
    np.testing.assert_array_equal(_bits(out[p:]), _bits(init[p:]))


@pytest.mark.parametrize("kind", ID_CASES)
def test_k8b_scatter_rows_cm_matches_jax(kind):
    flat, ncells = _ids_case(kind)
    p = flat.shape[0]
    rng = np.random.default_rng(p + 1)
    # positive values, as the weights of P2G: 600 values of mixed sign
    # cancel to sums where the two orders differ by more than 1e-5
    vals = rng.random((p, 127)).astype(np.float32)
    u, _ = pt.pad_rows_with_ids(jnp.asarray(flat), jnp.asarray(vals), T)
    ref = np.asarray(pt.scatter_rows_cm(u, jnp.asarray(flat), ncells, t=T,
                                        interpret=True))
    before = rw.scatter_rows_cm.launches
    out = rw.scatter_rows_cm(torch.as_tensor(np.array(u)),
                             torch.as_tensor(flat), ncells).numpy()
    assert rw.scatter_rows_cm.launches == before         # plain on the CPU
    assert out.shape == ref.shape == (128, ncells)
    np.testing.assert_allclose(out[:127], ref[:127], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[127], ref[127], rtol=1e-6)
    counts = np.bincount(flat, minlength=ncells)
    np.testing.assert_array_equal(out[127], (counts * np.arange(ncells))
                                  .astype(np.float32))
    assert not out[:, counts == 0].any() and out[:127].max() > 2.0


@pytest.mark.parametrize("which", ["gather", "scatter"])
@pytest.mark.parametrize("bad", [-1, 2048])
def test_k8_ids_outside_the_grid_raise(which, bad):
    flat = np.sort(np.append(np.arange(0, 2000, 7), bad)).astype(np.int32)
    rows, _ = rw.pad_rows_with_ids(torch.as_tensor(flat),
                                   torch.ones((flat.shape[0], 4)), T)
    with pytest.raises(ValueError, match="outside"):
        if which == "gather":
            rw.gather_rows_cm(torch.zeros((128, 2048)), rows,
                              torch.as_tensor(flat))
        else:
            rw.scatter_rows_cm(rows, torch.as_tensor(flat), 2048)


def test_k8_take_any_grid_size_and_no_rows():
    """No ``ncells % 512`` or ``ncells < 2^24`` limit; P = 0 gives the
    initial rows and a zero grid."""
    flat = torch.tensor([0, 0, 3, 6], dtype=torch.int32)
    rows, _ = rw.pad_rows_with_ids(flat, torch.ones((4, 2)), 8)
    d = rw.scatter_rows_cm(rows, flat, 7)
    assert d.shape == (128, 7)
    np.testing.assert_array_equal(d[0].numpy(), [2, 0, 0, 1, 0, 0, 1])
    back = rw.gather_rows_cm(d, rows, flat)
    np.testing.assert_array_equal(back[:4, 0].numpy(), [2, 2, 1, 1])
    empty = torch.zeros(0, dtype=torch.int32)
    init, _ = rw.pad_rows_with_ids(empty, None, 8)
    assert torch.equal(rw.gather_rows_cm(d, init, empty), init)
    assert not rw.scatter_rows_cm(init, empty, 7).any()


@pytest.mark.parametrize("name", ["gather_rows_cm", "scatter_rows_cm"])
def test_k8_wrappers_take_the_plain_version_on_cpu_only(name):
    flat = torch.tensor([1, 2, 2, 5], dtype=torch.int32)
    rows, _ = rw.pad_rows_with_ids(flat, torch.ones((4, 3)), 8)
    fn = getattr(rw, name)
    args = ((torch.ones((128, 6)), rows, flat) if name == "gather_rows_cm"
            else (rows, flat, 6))
    before = fn.launches
    assert torch.isfinite(fn(*args)).all() and fn.launches == before
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError):
        fn(*meta)


# ---- K8b's tile plan and its order -------------------------------------------

def _tile_case(kind):
    """Sorted ids and ncells: random sorted ids (ncells a multiple of the
    tile), the skewed row state (a cell of 2,000 rows, the upper half
    empty, a ragged last tile), no rows, and an odd ncells."""
    rng = np.random.default_rng(11)
    if kind == "skewed":
        _, flat, _ = synthetic.skewed_row_state(3, 17, 2000)
        return flat.numpy(), 17 ** 3
    ncells = {"sorted": 4096, "empty": 1000, "odd": 2001}[kind]
    p = {"sorted": 3000, "empty": 0, "odd": 5000}[kind]
    return _sorted_ids(rng, p, ncells), ncells


@pytest.mark.parametrize("kind", ["sorted", "skewed", "empty", "odd"])
def test_k8b_tile_plan_against_numpy(kind):
    flat, ncells = _tile_case(kind)
    ts = rw.scatter_tile_starts_plain(torch.as_tensor(flat), ncells)
    ntiles = -(-ncells // rw.SCATTER_CELLS)
    edges = np.minimum(np.arange(ntiles + 1) * rw.SCATTER_CELLS, ncells)
    assert ts.dtype == torch.int32 and ts.shape == (ntiles + 1,)
    np.testing.assert_array_equal(ts.numpy(),
                                  np.searchsorted(flat, edges, side="left"))
    assert ts[0] == 0 and ts[-1] == flat.size
    tile = flat // rw.SCATTER_CELLS      # every row lies in its tile's range
    np.testing.assert_array_equal(ts.numpy()[tile] <= np.arange(flat.size),
                                  True)
    np.testing.assert_array_equal(np.arange(flat.size) < ts.numpy()[tile + 1],
                                  True)


def test_k8b_skewed_state_and_its_sums_in_array_order():
    """The skewed row state's shape, and the plain K8b on it bitwise equal
    to a numpy loop that adds each cell's rows in array order from +0 (the
    kernel's order, which chip_smoke.py holds the kernel to)."""
    n = 17
    rows, flat, counts = synthetic.skewed_row_state(3, n, 2000)
    centre = (n // 2 * n + n // 2) * n + n // 2
    assert counts[centre] == 2000 and not counts[centre + 1:-200].any()
    assert (counts[-200:] >= 1).all() and (n ** 3) % rw.SCATTER_CELLS
    assert rows.shape == (counts.sum() + 8, 128)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.repeat(np.arange(n ** 3), counts))
    ref = np.zeros((n ** 3, 128), np.float32)
    np.add.at(ref, flat.numpy(), rows.numpy()[:flat.shape[0]])
    out = rw.scatter_rows_cm(rows, flat, n ** 3)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref.T))


# ---- the profile_p2g_parts pipeline -------------------------------------------

@pytest.fixture(scope="module", params=[8, 12], ids=lambda b: f"bound{b}")
def pipeline(request):
    """``transfer_parts`` on the 3-frame ``water_cube_drop`` state at bound
    8 (375 particles) and 12 (2,187), and the JAX pipeline of
    ``profile_p2g_parts.py`` on the same particles in ``HaloLayout``."""
    bound = request.param
    st = tparts.frame_state(bound, 3.0, "cpu")
    n = st.n
    grid = np.arange(n ** 3, dtype=np.float32).reshape(n, n, n)
    fields = torch.as_tensor(np.stack([np.sin(grid * (0.1 + d))
                                       for d in range(3)]))
    launches = (rw.gather_rows_cm.launches, rw.scatter_rows_cm.launches)
    u_rows = tparts.row_build(st)
    d, acc = tparts.row_p2g(st, u_rows)
    fm = tparts.field_build(st, fields)
    rows, out = tparts.row_g2p(st, tparts.row_table(fm), u_rows)
    assert (rw.gather_rows_cm.launches,
            rw.scatter_rows_cm.launches) == launches     # plain on the CPU

    lay = tp.HaloLayout(n)
    jpos, jvel, jflat = tp.sort_by_cell_h(jnp.asarray(st.pos_s.numpy()),
                                          jnp.asarray(st.vel_s.numpy()),
                                          bound, lay)
    np.testing.assert_array_equal(np.asarray(jpos), st.pos_s.numpy())
    p = jpos.shape[0]
    w = tp.masked_weights(jpos, bound, "flip")
    u = jnp.concatenate([w[..., None], w[..., None] * jvel[:, None, :]],
                        axis=-1).reshape(p, 108)
    ju, _ = pt.pad_rows_with_ids(jflat, u, tparts.ROW_T)
    jd = pt.scatter_rows_cm(ju, jflat, lay.ncells, t=T, interpret=True)
    jacc = ps.reduce_haloed(jd.reshape(128, lay.xr, lay.lwr), n, bx=lay.bx,
                            lblk=lay.lblk, interpret=True, lh=lay.lh)
    fm_h = jnp.pad(jnp.asarray(fm.numpy().reshape(4, n, n * n)),
                   ((0, 0), (ps._XH, lay.xr - n - ps._XH),
                    (lay.lh, lay.lwr - n * n - lay.lh)))
    jtable = ps.expand_haloed(fm_h, n, bx=lay.bx, lblk=lay.lblk,
                              interpret=True, lh=lay.lh)
    jrows = pt.gather_rows_cm(jtable.reshape(128, lay.ncells), ju, jflat,
                              t=T, interpret=True)
    return dict(st=st, fields=fields, fm=fm, u_rows=u_rows, d=d, acc=acc,
                rows=rows, out=out, lay=lay, ju=np.asarray(ju),
                jd=np.asarray(jd), jacc=np.asarray(jacc)[:, :n, :n * n],
                jrows=np.asarray(jrows))


def test_row_build_matches_jax(pipeline):
    """The 108 values bitwise; lane 127 holds the port's dense ids, the JAX
    rows their haloed ones."""
    u, flat = pipeline["u_rows"], pipeline["st"].flat
    p = flat.shape[0]
    np.testing.assert_array_equal(_bits(u[:, :127]), _bits(pipeline["ju"][:, :127]))
    np.testing.assert_array_equal(u[:p, 127].numpy(), flat.numpy())
    assert (u[p:, 127] == -1).all()


def test_row_p2g_matches_jax(pipeline):
    st, lay = pipeline["st"], pipeline["lay"]
    n = st.n
    jd = pipeline["jd"].reshape(128, lay.xr, lay.lwr)
    jd = jd[:108, ps._XH:ps._XH + n, lay.lh:lay.lh + n * n]
    np.testing.assert_allclose(pipeline["d"][:108].numpy().reshape(jd.shape),
                               jd, atol=1e-5, rtol=1e-5)
    acc = pipeline["acc"].numpy()
    assert acc.shape == (4, n, n, n) and acc[0].max() > 1.0
    np.testing.assert_allclose(acc.reshape(4, n, n * n), pipeline["jacc"],
                               atol=1e-5, rtol=1e-5)


def test_row_g2p_rows_match_jax_bitwise(pipeline):
    rows, jrows = pipeline["rows"].numpy(), pipeline["jrows"]
    p = pipeline["st"].flat.shape[0]
    assert rows.shape == jrows.shape
    np.testing.assert_array_equal(_bits(rows[:p, :108]), _bits(jrows[:p, :108]))
    np.testing.assert_array_equal(rows[p:], pipeline["u_rows"][p:].numpy())
    assert np.abs(rows[:p, :108]).max() > 0.5


def test_row_p2g_equals_k6a_bitwise(pipeline):
    st = pipeline["st"]
    n = st.n
    base = tk.p2g_scatter_base(st.w27t, st.vel_s, st.flat,
                               tk.window_starts(st.flat, n), n)
    d = pipeline["d"]
    np.testing.assert_array_equal(_bits(d[:108].view(27, 4, n, n, n)),
                                  _bits(base))
    np.testing.assert_array_equal(_bits(pipeline["acc"]),
                                  _bits(tk.shift_reduce(base)))
    assert not d[108:127].any()


def test_row_g2p_equals_k7a_and_k2_bitwise(pipeline):
    st, fm, out = pipeline["st"], pipeline["fm"], pipeline["out"]
    k7a = tk.g2p_gather_table(tk.shift_expand(fm), st.w27t, st.flat)
    k2 = tk.g2p_gather(fm, st.w27t, st.flat)
    np.testing.assert_array_equal(_bits(out), _bits(k7a))
    np.testing.assert_array_equal(_bits(out), _bits(k2))
    assert float(out.abs().max()) > 0.5


def test_transfer_parts_main_on_cpu(capsys):
    assert tparts.main(["--bound", "4", "--density", "2",
                        "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"sweep scatter_rows_cm"' in last and '"cpu (host clock)"' in last
