"""K2's and K2 moments' plain versions (``transfer_kernels.g2p_gather_plain``
and ``g2p_moments_plain``, what the wrappers take for CPU tensors) against
the JAX package's fused gather (``pallas_transfer.gather_wv_fused``,
``nout=8`` and ``nout=24``, in interpret mode) on the
edge cases of the CUDA kernels' tiles of 128 sorted particles
(``kGatherTile`` in ``csrc/transfer.cu``): a run of dense cells whose
tiles cross (x, y) rows and an x plane, particles on every face, edge and
corner of the box, live counts of 0, of all rows and one that splits a
cell's particles, and an odd particle count.  The card holds the kernel to
the plain version bit for bit on the same kinds of cases (``chip_smoke.py``,
``utils/synthetic.gather_edge_cases``, with 127 and 129 rows on either side
of a tile's end) and counts which of its two paths each tile took.  K2
moments skips the terms whose offset factor is 0 and subtracts for a
factor of -1; a numpy loop in that order equals the plain version (which
adds every term) bit for bit on ``gather_edge_cases``.  Here also:
``card_inputs.read_cells``, the cells a gather's bound counts, against a
loop, and both wrappers refusing their kernels' path count on the CPU.

Fields: the JAX kernel's lane rolls wrap a z shift at the box's z faces
into the next y row, where the port reads nothing, so the fields given to
both are zero on the box faces, as the frame's wall mask makes them (the
mask channel is the within-wall mask).  With fields that are not zero there,
the plain version is held bit for bit to a numpy loop instead.

Tolerances: the gathered rows and moments are f32 sums of 27 products, the
JAX kernel's in another order (its one-hot matmuls): atol 1e-5 / rtol 1e-5,
the bound ``tests/test_torch_transfer.py`` holds the transfer sums to.
Rows past the live count, and the JAX kernel's rows 22-23, must be exactly
0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.ops import pallas_shift as ps
from fluidsim_tpu.ops import pallas_transfer as pt
from fluidsim_tpu.ops import transfer_pallas as tp
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.utils import card_inputs, synthetic

BOUNDS = (8, 12)
COUNTS = ("all", "zero", "split", "every")


def _positions(bound, rng):
    """Odd-count particle positions: 40 in each cell of a z run from the
    end of one (x, y) row into the next and across an x plane, 60 in each
    of 6 cells of one row (tiles that stage), one at every face, edge and
    corner cell's extreme corner, 600 on random face cells and a spread of
    random interior ones."""
    n = 2 * bound + 1
    cells = [(2, n - 1, z) for z in range(n - 6, n)]      # into plane 3
    cells += [(3, 0, z) for z in range(6)]
    cells += [(5, 4, z) for z in range(n - 4, n)]         # into row (5, 5)
    cells += [(5, 5, z) for z in range(4)]
    run = np.repeat(np.asarray(cells, np.float64), 40, axis=0)
    one_row = [(7, 7, z) for z in range(3, 9)]
    run = np.concatenate([run, np.repeat(np.asarray(one_row, np.float64), 60,
                                         axis=0)])
    run += rng.uniform(-0.45, 0.45, size=run.shape)
    axis = np.array([0, bound, 2 * bound], np.float64)
    faces = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                     -1).reshape(-1, 3)
    faces = faces[np.any(faces != bound, axis=1)]        # the 26 box cells
    side = rng.integers(0, 3, size=(600, 1)) == np.arange(3)
    on_face = np.where(side, rng.integers(0, 2, size=(600, 3)) * (n - 1),
                       rng.integers(0, n, size=(600, 3))).astype(np.float64)
    inner = rng.uniform(1.0, n - 2.0, size=(501, 3))
    pos = np.concatenate([run, faces, on_face, inner]) - bound
    pos = np.clip(pos, -bound, bound)
    assert pos.shape[0] % 2 == 1
    return pos.astype(np.float32)


def _count(case, flat):
    """The live count of a case: None (no count), 0, all rows, or one that
    falls inside a cell's run of particles."""
    p = flat.shape[0]
    if case == "all":
        return None
    if case == "zero":
        return 0
    if case == "every":
        return p
    starts = np.flatnonzero(np.diff(flat) != 0) + 1
    big = starts[:-1][np.diff(starts) > 8][0]        # a cell of 9 or more
    return int(big + 3)


@pytest.fixture(scope="module", params=BOUNDS)
def state(request):
    """Both packages' sorted particles and weights at one bound, random
    fields zero on the box faces (channel 3 the within-wall mask), and the
    JAX gather's 4 rows (``nout=8``) and 24 moment rows (``nout=24``) of
    them."""
    bound = request.param
    n = 2 * bound + 1
    rng = np.random.default_rng(18 + bound)
    pos = _positions(bound, rng)
    vel = np.zeros_like(pos)
    wall = bound - 1
    ok = np.abs(np.arange(-bound, bound + 1)) <= wall
    within = ok[:, None, None] & ok[None, :, None] & ok[None, None, :]
    fm = np.concatenate([rng.normal(size=(3, n, n, n)) * within,
                         within[None]]).astype(np.float32)

    lay = tp.HaloLayout(n)
    jp, _, jflat = tp.sort_by_cell_h(jnp.asarray(pos), jnp.asarray(vel),
                                     bound, lay)
    wv, _ = pt.pack_cols(jflat, tp.masked_weights_cm(jp, bound), None, lay.t,
                         w=lay.w)
    fm_hp = jnp.pad(jnp.asarray(fm).reshape(4, n, n * n),
                    ((0, 0), (ps._XH, lay.xr - n - ps._XH),
                     (2 * lay.lh, lay.lwr - n * n)))
    ref = pt.gather_wv_fused(fm_hp, wv, jflat, n, w=lay.w, t=lay.t,
                             interpret=True, cols=tp.cols_of(wv), lh=lay.lh)
    moments = pt.gather_wv_fused(fm_hp, wv, jflat, n, w=lay.w, t=lay.t,
                                 interpret=True, nout=24,
                                 cols=tp.cols_of(wv), lh=lay.lh)
    p = pos.shape[0]
    ref = np.asarray(ref)
    assert not ref[4:, :p].any()

    tpos, _, tflat = tk.sort_by_cell(torch.as_tensor(pos),
                                     torch.as_tensor(vel), bound)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jp))
    return dict(bound=bound, n=n, pos=tpos, flat=tflat,
                w27t=tk.masked_weights_cm(tpos, bound),
                fm=torch.as_tensor(fm), ref=ref[:4, :p],
                ref_moments=np.asarray(moments)[:, :p])


def test_moments_match_the_jax_gather(state):
    """K2 moments' 22 rows are the JAX gather's rows 0-21 (the 24-row
    contraction), whose rows 22-23 are 0."""
    jax_moments = state["ref_moments"]
    out = tk.g2p_moments(state["fm"], state["w27t"], state["flat"])
    assert out.shape == (tk.MOMENT_ROWS, state["flat"].shape[0])
    np.testing.assert_allclose(out.numpy(), jax_moments[:tk.MOMENT_ROWS],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(jax_moments[tk.MOMENT_ROWS:], 0.0)
    assert float(np.abs(jax_moments[7:16]).max()) > 0.1   # F is not all 0


@pytest.mark.parametrize("case", COUNTS)
def test_live_rows_match_the_jax_gather(state, case):
    """The first ``count`` rows are the JAX gather's (which has no count),
    the rest exactly 0; the dead slots past the count carry the id n^3, as
    a rank's dead slots sort last."""
    flat, n = state["flat"], state["n"]
    live = _count(case, flat.numpy())
    count = None if live is None else torch.tensor([live], dtype=torch.int32)
    if live is not None:
        flat = flat.clone()
        flat[live:] = n ** 3
    out = tk.g2p_gather(state["fm"], state["w27t"], flat, count)
    assert out.shape == (4, flat.shape[0]) and out.dtype == torch.float32
    live = flat.shape[0] if live is None else live
    np.testing.assert_allclose(out[:, :live].numpy(), state["ref"][:, :live],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(out[:, live:].numpy(), 0.0)
    if live:
        assert float(out[:, :live].abs().max()) > 0.5


def _numpy_gather(fm, w27t, flat, live):
    """K2's function as a numpy loop in K2's order: for each offset in
    turn, ``out += w * value`` in f32, a neighbour outside the grid and a
    row past ``live`` adding w * 0."""
    nx, n = fm.shape[1], fm.shape[-1]
    x, y, z = flat // (n * n), (flat // n) % n, flat % n
    rows = np.arange(flat.shape[0]) < live
    out = np.zeros((4, flat.shape[0]), np.float32)
    for o in range(27):
        cx, cy, cz = x + o // 9 - 1, y + (o // 3) % 3 - 1, z + o % 3 - 1
        inb = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < n) & (cz >= 0)
               & (cz < n) & rows)
        vals = fm[:, np.clip(cx, 0, nx - 1), np.clip(cy, 0, n - 1),
                  np.clip(cz, 0, n - 1)]
        out = out + w27t[o] * np.where(inb, vals, np.float32(0))
    return out


@pytest.mark.parametrize("case", ("all", "split"))
def test_faces_bitwise_to_a_numpy_loop(state, case):
    """Fields that are not zero on the box faces, where the JAX kernel
    wraps: the plain version equals the numpy loop bit for bit, on the
    cube and on a 5-row x slab of it (the ids past the slab dead)."""
    n = state["n"]
    rng = np.random.default_rng(state["bound"])
    fm = rng.normal(size=(4, n, n, n)).astype(np.float32)
    flat, w27t = state["flat"].numpy(), state["w27t"].numpy()
    live = _count(case, flat)
    for nx in (n, 5):
        cut = int(np.searchsorted(flat, nx * n * n))
        ids = flat.copy()
        ids[cut:] = nx * n * n
        rows = cut if live is None else min(live, cut)
        count = None if live is None and nx == n else torch.tensor(
            [rows], dtype=torch.int32)
        out = tk.g2p_gather(torch.as_tensor(fm[:, :nx]).contiguous(),
                            torch.as_tensor(w27t), torch.as_tensor(ids),
                            count)
        np.testing.assert_array_equal(
            out.numpy().view(np.int32),
            _numpy_gather(fm[:, :nx], w27t, ids, rows).view(np.int32))


def _cells_loop(flat, nx, n):
    """The distinct in-grid cells of the ids' 27-cell neighbourhoods, one
    id and one offset at a time."""
    cells = set()
    for f in flat.tolist():
        x, y, z = f // (n * n), (f // n) % n, f % n
        for o in range(27):
            c = (x + o // 9 - 1, y + (o // 3) % 3 - 1, z + o % 3 - 1)
            if 0 <= c[0] < nx and 0 <= c[1] < n and 0 <= c[2] < n:
                cells.add(c)
    return len(cells)


@pytest.mark.parametrize("case", COUNTS)
def test_read_cells_match_a_loop(state, case):
    """``card_inputs.read_cells`` of the live rows, on the cube and on a
    5-row x slab of it (the ids past the slab dead), equals a loop."""
    flat, n = state["flat"], state["n"]
    live = _count(case, flat.numpy())
    for nx in (n, 5):
        ids = flat.clone()
        cut = int(np.searchsorted(ids.numpy(), nx * n * n))
        ids[cut:] = nx * n * n
        rows = cut if live is None else min(live, cut)
        got = card_inputs.read_cells(ids, nx, n, rows)
        assert got == _cells_loop(ids[:rows].numpy(), nx, n)
        assert (got == 0) == (rows == 0)


@pytest.mark.parametrize("gather", ("g2p_gather", "g2p_moments"))
def test_paths_are_refused_on_the_cpu(state, gather):
    """The path count is the CUDA kernels': the CPU's plain versions have
    no tiles and refuse it."""
    with pytest.raises(ValueError, match="paths"):
        getattr(tk, gather)(state["fm"], state["w27t"], state["flat"],
                            paths=torch.zeros(2, dtype=torch.int32))


_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _numpy_moments(fm, w27t, flat):
    """K2 moments' function as a numpy loop in the CUDA kernel's order: for
    each offset in turn, ``wf = w * value`` in f32 (a neighbour outside the
    grid reading 0); den and vnum add ``wf``, and each other row adds it
    for an offset factor of 1, subtracts it for -1 and skips it for 0."""
    nx, n = fm.shape[1], fm.shape[-1]
    x, y, z = flat // (n * n), (flat // n) % n, flat % n
    out = np.zeros((tk.MOMENT_ROWS, flat.shape[0]), np.float32)
    for o in range(27):
        off = (o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1)
        cx, cy, cz = x + off[0], y + off[1], z + off[2]
        inb = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < n) & (cz >= 0)
               & (cz < n))
        vals = fm[:, np.clip(cx, 0, nx - 1), np.clip(cy, 0, n - 1),
                  np.clip(cz, 0, n - 1)]
        wf = w27t[o] * np.where(inb, vals, np.float32(0))
        terms = [(0, wf[3], 1)] + [(1 + c, wf[c], 1) for c in range(3)]
        terms += [(4 + k, wf[3], off[k]) for k in range(3)]
        terms += [(7 + 3 * c + k, wf[c], off[k]) for c in range(3)
                  for k in range(3)]
        terms += [(16 + i, wf[3], off[k] * off[m])
                  for i, (k, m) in enumerate(_PAIRS)]
        for r, t, sign in terms:
            if sign > 0:
                out[r] = out[r] + t
            elif sign < 0:
                out[r] = out[r] - t
    return out


@pytest.mark.parametrize("p", (1, 127, 129, 255, 257, 1001))
def test_moments_skip_zero_factors_bitwise(p):
    """``utils/synthetic.gather_edge_cases`` without a live count (the
    cases ``chip_smoke.py`` gives K2 moments on the card): the plain
    version, which adds ``wf * off`` for every offset, equals the numpy
    loop that skips a factor of 0 and subtracts for -1, bit for bit."""
    for name, fm, w27t, flat, count in synthetic.gather_edge_cases(
            p, n=13, device="cpu"):
        if count is not None:
            continue
        out = tk.g2p_moments(fm, w27t, flat)
        np.testing.assert_array_equal(
            out.numpy().view(np.int32),
            _numpy_moments(fm.numpy(), w27t.numpy(), flat.numpy().astype(
                np.int64)).view(np.int32), err_msg=name)


@pytest.mark.parametrize("p", (1, 127, 129, 255, 257, 1001))
def test_synthetic_edge_cases_on_the_cpu(p):
    """``utils/synthetic.gather_edge_cases``, which ``chip_smoke.py`` gives
    the card: the plain version equals the numpy loop on each."""
    for name, fm, w27t, flat, count in synthetic.gather_edge_cases(
            p, n=13, device="cpu"):
        live = flat.shape[0] if count is None else int(count[0])
        out = tk.g2p_gather(fm, w27t, flat, count)
        np.testing.assert_array_equal(
            out.numpy().view(np.int32),
            _numpy_gather(fm.numpy(), w27t.numpy(), flat.numpy().astype(
                np.int64), live).view(np.int32), err_msg=name)
