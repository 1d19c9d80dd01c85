"""The port's materialised G2P and the span and unhaloed shift entry points
against the JAX package, with the Pallas kernels in interpret mode:

- K7b ``shift_expand`` against ``pallas_shift.expand_haloed``;
- K7a ``g2p_gather_table`` / ``g2p_moments_table`` against
  ``pallas_transfer.gather_wv_cm`` (``nout=8`` / ``24``);
- ``g2p`` / ``apic.g2p_apic`` with ``fused_table=False`` against
  ``g2p_pallas`` / ``g2p_apic_pallas(fused_table=False)``, and against the
  port's own fused path;
- K9a/K9b ``p2g_scatter_spans`` / ``g2p_gather_spans`` against
  ``scatter_wv_spans`` / ``gather_wv_spans``;
- K10a-d (``ops/shift.py``) against ``p2g_shift_reduce``,
  ``g2p_table_expand``, ``to_channel_major`` and ``from_channel_major``.

On CPU tensors the wrappers run their plain PyTorch versions; the CUDA
kernels are compared with those on the card by ``chip_smoke.py``.

Layouts: the JAX kernels work on the haloed layout of ``HaloLayout(n)``
(table row ``4o + g``, x at ``_XH + x``, lane ``lh + y*n + z``); the port on
dense (27, 4, n, n, n) tables.  The JAX lane rolls wrap y/z edge shifts into
the next row where the port reads 0, so every input here is zero on the box
faces (as the callers' wall masks make it), and the results must then agree
on every cell.

Tolerances: the table build and the transposes are copies, and the
unhaloed shift-reduce adds the 27 offsets in the same order from 0 as the
port: bitwise.  The gathers and the base-cell scatter are f32 sums in
another order than the TPU kernels' one-hot matmuls: atol/rtol 1e-5.  The
normalised G2P: velocities atol 1e-5 / rtol 1e-4, APIC C atol 5e-4, as
``tests/test_torch_apic.py`` says why.  The port's materialised G2P adds the
same products in K2's order, so it equals its fused G2P bit for bit.

The JAX ``p2g_shift_reduce`` and ``g2p_table_expand`` leave lanes past the
last whole 512-lane block unwritten when ceil128(n^2) is not a multiple of
512; they are compared at n = 45, where they are right, and the port is
held to a numpy reference at n = 25, where they are not.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fluidsim_tpu.core.splines import cround
from fluidsim_tpu.ops import pallas_shift as ps
from fluidsim_tpu.ops import pallas_transfer as pt
from fluidsim_tpu.ops import transfer_pallas as tp
from fluidsim_tpu.ops.svd3 import mv3
from fluidsim_tpu.scenes import get_scene as jget_scene
from fluidsim_tpu_torch.ops import apic
from fluidsim_tpu_torch.ops import shift
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.transfer import _OFFSETS

SPAN_T = 256          # the span kernels' particle chunk: small interpret grids


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in ``tests/test_torch_bucket.py``: the other
    test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[8, 12], ids=lambda b: f"bound{b}")
def case(request):
    """Particles over the interior sorted by both packages, a smooth field
    masked to the scene's wall with its mask (K2's input), and the
    neighbourhood tables of both packages."""
    bound = request.param
    n = 2 * bound + 1
    wall = jget_scene("water_cube_drop", bound=bound).spec.wall
    rng = np.random.default_rng(bound)
    p = 1500 if bound == 8 else 3000
    pos = rng.uniform(-(bound - 1.5), bound - 1.5, (p, 3)).astype(np.float32)
    vel = rng.normal(scale=3.0, size=(p, 3)).astype(np.float32)
    aff = rng.normal(scale=0.5, size=(p, 9)).astype(np.float32)
    lay = tp.HaloLayout(n)
    jsorted = tp.sort_by_cell_h(jnp.asarray(pos), jnp.asarray(vel), bound, lay,
                                extra=jnp.asarray(aff))
    tsorted = tk.sort_by_cell(torch.as_tensor(pos), torch.as_tensor(vel), bound,
                              extra=torch.as_tensor(aff))
    grid = np.arange(n ** 3, dtype=np.float32).reshape(n, n, n)
    fields = torch.as_tensor(np.stack([np.sin(grid * (0.1 + d))
                                       for d in range(3)]))
    fm = tk.gather_fields(fields, bound, wall)
    # the haloed fields exactly as transfer_pallas.g2p_pallas pads them
    fm_h = jnp.pad(jnp.asarray(fm.numpy().reshape(4, n, n * n)),
                   ((0, 0), (ps._XH, lay.xr - n - ps._XH),
                    (lay.lh, lay.lwr - n * n - lay.lh)))
    jtable = ps.expand_haloed(fm_h, n, bx=lay.bx, lblk=lay.lblk,
                              interpret=True, lh=lay.lh)
    return dict(bound=bound, n=n, wall=wall, lay=lay, jsorted=jsorted,
                tsorted=tsorted, fields=fields, fm=fm, jtable=jtable,
                table=tk.shift_expand(fm),
                w27t=tk.masked_weights_cm(tsorted[0], bound))


def _unhalo(a, c, lay, n):
    """Channels ``:c`` of a (C', XR, LWR) or (C', XR * LWR) haloed array as
    (c, n, n, n)."""
    a = np.asarray(a).reshape(-1, lay.xr, lay.lwr)
    return a[:c, ps._XH:ps._XH + n, lay.lh:lay.lh + n * n].reshape(c, n, n, n)


# ---- K7b, K7a ---------------------------------------------------------------

def test_k7b_shift_expand_matches_expand_haloed(case):
    n, lay = case["n"], case["lay"]
    table = case["table"]
    assert table.shape == (27, 4, n, n, n)
    np.testing.assert_array_equal(
        table.numpy().reshape(108, n, n, n),
        _unhalo(case["jtable"], 108, lay, n))
    assert not np.asarray(case["jtable"])[108:].any()
    # every offset's slice is its shifted copy of the fields
    assert float(table[13].abs().max()) > 0.5
    np.testing.assert_array_equal(table[13].numpy(), case["fm"].numpy())


@pytest.mark.parametrize("nout", [8, 24])
def test_k7a_gather_table_matches_gather_wv_cm(case, nout):
    lay, bound = case["lay"], case["bound"]
    jp, _, jflat, _ = case["jsorted"]
    _, _, tflat, _ = case["tsorted"]
    p = jp.shape[0]
    wv, _ = pt.pack_wv_rows(jflat, tp.masked_weights(jp, bound), None, lay.t,
                            w=lay.w)
    ref = np.asarray(pt.gather_wv_cm(case["jtable"].reshape(128, lay.ncells),
                                     wv, jflat, w=lay.w, t=lay.t,
                                     interpret=True, nout=nout))[:, :p]
    gather = tk.g2p_gather_table if nout == 8 else tk.g2p_moments_table
    out = gather(case["table"], case["w27t"], tflat).numpy()
    rows = 4 if nout == 8 else tk.MOMENT_ROWS
    assert out.shape == (rows, p)
    np.testing.assert_allclose(out, ref[:rows], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(ref[rows:], 0.0)
    assert np.abs(out).max() > 0.5


@pytest.mark.parametrize("mode", ["flip", "apic"])
def test_materialised_g2p_matches_g2p_pallas(case, mode):
    bound, wall, lay = case["bound"], case["wall"], case["lay"]
    jp, _, jflat, _ = case["jsorted"]
    tpos, _, tflat, _ = case["tsorted"]
    jfields = jnp.asarray(case["fields"].numpy())
    if mode == "flip":
        ref = tp.g2p_pallas(jp, jflat, jfields, bound, wall, lay, "flip",
                            interpret=True, channel_major=True,
                            fused_table=False)
        out = tk.g2p(case["w27t"], tflat, case["fields"], bound, wall,
                     fused_table=False)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-4)
        assert float(out.abs().max()) > 0.5
        return
    rv, rc = tp.g2p_apic_pallas(jp, jflat, jfields, bound, wall, lay, "flip",
                                interpret=True, channel_major=True,
                                fused_table=False)
    v, c = apic.g2p_apic(case["w27t"], tflat, tpos, case["fields"], bound,
                         wall, fused_table=False)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=5e-4)
    assert float(c.abs().max()) > 0.1


@pytest.mark.parametrize("mode", ["flip", "apic"])
def test_materialised_g2p_equals_fused_bitwise(case, mode):
    bound, wall = case["bound"], case["wall"]
    tpos, _, tflat, _ = case["tsorted"]
    before = (tk.shift_expand.launches, tk.g2p_gather_table.launches,
              tk.g2p_moments_table.launches)
    if mode == "flip":
        fused, table = (tk.g2p(case["w27t"], tflat, case["fields"], bound,
                               wall, fused_table=f) for f in (True, False))
        np.testing.assert_array_equal(table.numpy(), fused.numpy())
        np.testing.assert_array_equal(
            tk.g2p_gather_table(case["table"], case["w27t"], tflat).numpy(),
            tk.g2p_gather(case["fm"], case["w27t"], tflat).numpy())
    else:
        (vf, cf), (vt, ct) = (apic.g2p_apic(case["w27t"], tflat, tpos,
                                            case["fields"], bound, wall,
                                            fused_table=f)
                              for f in (True, False))
        np.testing.assert_array_equal(vt.numpy(), vf.numpy())
        np.testing.assert_array_equal(ct.numpy(), cf.numpy())
        np.testing.assert_array_equal(
            tk.g2p_moments_table(case["table"], case["w27t"], tflat).numpy(),
            tk.g2p_moments(case["fm"], case["w27t"], tflat).numpy())
    assert (tk.shift_expand.launches, tk.g2p_gather_table.launches,
            tk.g2p_moments_table.launches) == before   # plain on the CPU


# ---- K9a, K9b ---------------------------------------------------------------

def _global_id_rows(jflat, values):
    """The span kernels' packed rows: global ids in the last lane."""
    rows, _ = pt.pad_rows_with_ids(jflat, jnp.concatenate(values, axis=1),
                                   SPAN_T, idmod=0)
    return rows


@pytest.mark.parametrize("kind", ["scatter-flip", "scatter-apic", "gather-8",
                                  "gather-24"])
def test_k9_spans_match_the_span_kernels(case, kind):
    bound, n, lay = case["bound"], case["n"], case["lay"]
    jp, jv, jflat, jaff = case["jsorted"]
    tpos, tvel, tflat, taff = case["tsorted"]
    p = jp.shape[0]
    assert lay.ncells < 2 ** 24
    w27 = tp.masked_weights(jp, bound)
    ones = jnp.ones((p, 1), jnp.float32)
    if kind.startswith("scatter"):
        apic_mode = kind == "scatter-apic"
        vel = jv
        if apic_mode:   # veff = v + C (base - pos), as p2g_pallas forms it
            vel = jv + mv3(jaff.reshape(-1, 3, 3), cround(jp) - jp)
            tvel = torch.as_tensor(np.array(vel))
        rows = _global_id_rows(jflat, [w27, ones, vel]
                               + ([jaff] if apic_mode else []))
        ref = pt.scatter_wv_spans(rows, jflat, lay.ncells, w=lay.w, t=SPAN_T,
                                  interpret=True)
        out = tk.p2g_scatter_spans(case["w27t"], tvel, tflat, n,
                                   aff_s=taff if apic_mode else None).numpy()
        assert out.shape == (27, 4, n, n, n)
        np.testing.assert_allclose(out.reshape(108, n, n, n),
                                   _unhalo(ref, 108, lay, n), atol=1e-5,
                                   rtol=1e-5)
        assert not np.asarray(ref)[108:].any()
    else:
        nout = int(kind.split("-")[1])
        rows = _global_id_rows(jflat, [w27, ones])
        ref = np.asarray(pt.gather_wv_spans(
            case["jtable"].reshape(128, lay.ncells), rows, jflat, w=lay.w,
            t=SPAN_T, interpret=True, nout=nout))
        assert ref.shape[1] == -(-p // SPAN_T) * SPAN_T
        out = tk.g2p_gather_spans(case["table"], case["w27t"], tflat,
                                  moments=nout == 24).numpy()
        np.testing.assert_allclose(out, ref[:out.shape[0], :p], atol=1e-5,
                                   rtol=1e-5)
    assert np.abs(out).max() > 0.5


def test_k9_spans_refuse_an_unsorted_order(case):
    n = case["n"]
    _, tvel, tflat, _ = case["tsorted"]
    perm = torch.as_tensor(np.random.default_rng(0).permutation(len(tflat)))
    with pytest.raises(ValueError, match="sorted"):
        tk.p2g_scatter_spans(case["w27t"][:, perm], tvel[perm], tflat[perm], n)
    with pytest.raises(ValueError, match="sorted"):
        tk.g2p_gather_spans(case["table"], case["w27t"][:, perm], tflat[perm])


# ---- K10a-d -----------------------------------------------------------------

def _zero_faces(a):
    """Zero the cells on the box faces of an (n, n, n, ...) array."""
    for ax in range(3):
        idx = [slice(None)] * a.ndim
        idx[ax] = [0, -1]
        a[tuple(idx)] = 0.0
    return a


@pytest.mark.parametrize("which", ["reduce", "expand"])
def test_k10_shift_entry_points_match_jax_at_n45(which):
    n = 45
    rng = np.random.default_rng(45)
    if which == "reduce":
        d = _zero_faces(rng.normal(size=(n, n, n, 108)).astype(np.float32))
        d = d.reshape(n ** 3, 108)
        ref = np.asarray(ps.p2g_shift_reduce(jnp.asarray(d), n, interpret=True))
        out = shift.p2g_shift_reduce(torch.as_tensor(d), n)
        assert out.shape == (n, n, n, 4)
    else:
        fm = _zero_faces(rng.normal(size=(n, n, n, 4)).astype(np.float32))
        ref = np.asarray(ps.g2p_table_expand(jnp.asarray(fm), n,
                                             interpret=True))
        out = shift.g2p_table_expand(torch.as_tensor(fm), n)
        assert out.shape == (n ** 3, 108)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("which", ["reduce", "expand"])
def test_k10_shift_entry_points_match_numpy_at_n25(which):
    """Every cell, faces included, at a size where the JAX functions leave
    lanes unwritten: against 27 zero-padded numpy shifts in offset order."""
    n = 25
    rng = np.random.default_rng(25)
    if which == "reduce":
        d = rng.normal(size=(n, n, n, 27, 4)).astype(np.float32)
        dp = np.pad(d, ((1, 1),) * 3 + ((0, 0), (0, 0)))
        ref = np.zeros((n, n, n, 4), np.float32)
        for o, (ox, oy, oz) in enumerate(_OFFSETS):     # d[cell - off_o]
            ref = ref + dp[1 - ox:1 - ox + n, 1 - oy:1 - oy + n,
                           1 - oz:1 - oz + n, o]
        out = shift.p2g_shift_reduce(torch.as_tensor(d.reshape(n ** 3, 108)), n)
    else:
        fm = rng.normal(size=(n, n, n, 4)).astype(np.float32)
        fp = np.pad(fm, ((1, 1),) * 3 + ((0, 0),))
        ref = np.stack([fp[1 + ox:1 + ox + n, 1 + oy:1 + oy + n,
                           1 + oz:1 + oz + n]
                        for ox, oy, oz in _OFFSETS], axis=3)  # fm[cell + off_o]
        ref = ref.reshape(n ** 3, 108)
        out = shift.g2p_table_expand(torch.as_tensor(fm), n)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("n", [17, 25, 45])
def test_k10a_row_plain_version_equals_the_transposed_one_bitwise(n):
    """``p2g_shift_reduce_rows_plain`` (27 shifted adds on the rows, the
    CUDA kernel's order) against ``p2g_shift_reduce_plain`` (K10c, K6b,
    K10d), every cell, n^3 a multiple of 32 or not."""
    d = torch.as_tensor(np.random.default_rng(n).normal(
        size=(n ** 3, 108)).astype(np.float32))
    rows = shift.p2g_shift_reduce_rows_plain(d, n)
    ref = shift.p2g_shift_reduce_plain(d, n)
    assert rows.shape == (n, n, n, 4)
    np.testing.assert_array_equal(rows.numpy().view(np.int32),
                                  ref.numpy().view(np.int32))
    with pytest.raises(ValueError):
        shift.p2g_shift_reduce_rows_plain(d[1:], n)


@pytest.mark.parametrize("n", [17, 25, 45])
def test_k10b_row_plain_version_equals_the_transposed_one_bitwise(n):
    """``g2p_table_expand_rows_plain`` (27 shifted copies into the rows, the
    CUDA kernel's function) against ``g2p_table_expand_plain`` (K10c, K7b,
    K10d), every cell, n^3 a multiple of the kernel's 128-cell blocks or
    not."""
    fm = torch.as_tensor(np.random.default_rng(n).normal(
        size=(n, n, n, 4)).astype(np.float32))
    rows = shift.g2p_table_expand_rows_plain(fm, n)
    ref = shift.g2p_table_expand_plain(fm, n)
    assert rows.shape == (n ** 3, 108)
    np.testing.assert_array_equal(rows.numpy().view(np.int32),
                                  ref.numpy().view(np.int32))
    with pytest.raises(ValueError):
        shift.g2p_table_expand_rows_plain(fm[1:], n)


@pytest.mark.parametrize("n3,c,r", [(1000, 108, 256), (4096, 108, 2048),
                                    (3000, 4, 2048)])
def test_k10_transposes_match_jax(n3, c, r):
    x = np.random.default_rng(n3).normal(size=(n3, c)).astype(np.float32)
    ref = np.asarray(ps.to_channel_major(jnp.asarray(x), r=r, interpret=True))
    y = shift.to_channel_major(torch.as_tensor(x), r=r)
    assert y.shape == (c, -(-n3 // r) * r)
    np.testing.assert_array_equal(y.numpy(), ref)
    assert not y[:, n3:].any()
    back = shift.from_channel_major(y, n3, r=r)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(ps.from_channel_major(jnp.asarray(ref), n3, r=r,
                                         interpret=True)))
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError):
        shift.from_channel_major(y[:, :-1].contiguous(), n3, r=r)


# ---- the wrappers on the CPU --------------------------------------------------

def _small_inputs():
    n = 5
    rng = np.random.default_rng(5)
    fm = torch.as_tensor(rng.normal(size=(4, n, n, n)).astype(np.float32))
    flat = torch.as_tensor(np.sort(rng.integers(0, n ** 3, 40)).astype(np.int32))
    w27t = torch.as_tensor(rng.random((27, 40)).astype(np.float32))
    vel = torch.as_tensor(rng.normal(size=(40, 3)).astype(np.float32))
    return n, fm, tk.shift_expand_plain(fm), flat, w27t, vel


_WRAPPERS = {
    "shift_expand": (tk.shift_expand, lambda n, fm, t, f, w, v: (fm,)),
    "g2p_gather_table": (tk.g2p_gather_table, lambda n, fm, t, f, w, v: (t, w, f)),
    "g2p_moments_table": (tk.g2p_moments_table,
                          lambda n, fm, t, f, w, v: (t, w, f)),
    "p2g_scatter_spans": (tk.p2g_scatter_spans,
                          lambda n, fm, t, f, w, v: (w, v, f, n)),
    "g2p_gather_spans": (tk.g2p_gather_spans, lambda n, fm, t, f, w, v: (t, w, f)),
    "to_channel_major": (shift.to_channel_major,
                         lambda n, fm, t, f, w, v: (t.reshape(108, -1).T.contiguous(),)),
    "from_channel_major": (shift.from_channel_major,
                           lambda n, fm, t, f, w, v: (t.reshape(108, -1), n ** 3, 1)),
    "p2g_shift_reduce": (shift.p2g_shift_reduce,
                         lambda n, fm, t, f, w, v: (t.reshape(108, -1).T.contiguous(), n)),
    "g2p_table_expand": (shift.g2p_table_expand,
                         lambda n, fm, t, f, w, v: (fm.permute(1, 2, 3, 0).contiguous(), n)),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrapper_takes_the_plain_version_on_cpu_only(name):
    fn, make_args = _WRAPPERS[name]
    args = make_args(*_small_inputs())
    before = fn.launches
    out = fn(*args)
    assert fn.launches == before and torch.isfinite(out).all()
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError):
        fn(*meta)


def test_the_k10_row_layout_is_the_table_transposed():
    """``g2p_table_expand`` is K7b's table in (n^3, 108) rows, and
    ``p2g_shift_reduce`` K6b's sums in (n, n, n, 4) cells."""
    n, fm, table, *_ = _small_inputs()
    rows = shift.g2p_table_expand(fm.permute(1, 2, 3, 0).contiguous(), n)
    np.testing.assert_array_equal(rows.T.reshape(27, 4, n, n, n).numpy(),
                                  table.numpy())
    acc = shift.p2g_shift_reduce(rows, n)
    np.testing.assert_array_equal(acc.permute(3, 0, 1, 2).numpy(),
                                  tk.shift_reduce_plain(table).numpy())
