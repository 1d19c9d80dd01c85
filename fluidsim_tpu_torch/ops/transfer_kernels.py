"""Sorted particle <-> grid transfers of the FLIP frame, with the P2G (K1)
and G2P (K2) kernels — the counterpart of ``fluidsim_tpu/ops/transfer_pallas.py``
(``sort_by_cell_h``, ``masked_weights_cm``, ``p2g_pallas``, ``g2p_pallas``) and
``fluidsim_tpu/ops/pallas_transfer.py`` (``scatter_wv_fused``,
``gather_wv_fused``).  The APIC modes of those two kernels (the affine
scatter, ``aff=``, and the 24-moment gather, ``nout=24``) are
``p2g_scatter_affine`` and ``g2p_moments``; ``ops.apic`` wraps them.  The
MPM modes (the force scatter, ``expand='fg'``, and the gradW gather,
``contract='gw'``) are ``p2g_scatter_force`` and ``g2p_gather_gw``;
``ops.mpm_kernels`` wraps them.  The unfused P2G of
``p2g_pallas(fused_scatter=False)`` — the 108-channel base-cell scatter
(K6a, ``scatter_wv_cm``) and the 27-offset shift-reduce (K6b,
``pallas_shift.reduce_haloed``) — is ``p2g_scatter_base`` and
``shift_reduce``; it serves the window-grouped order of
``sort_by_cell(method="bucket")``.  The unfused G2P of
``g2p_pallas(fused_table=False)`` — the 27-offset neighbourhood table (K7b,
``pallas_shift.expand_haloed``) and the gather from it (K7a,
``gather_wv_cm``, 4 rows or the 22 moments) — is ``shift_expand``,
``g2p_gather_table`` and ``g2p_moments_table``, reached by
``g2p(fused_table=False)`` and ``apic.g2p_apic(fused_table=False)``.  The
span-chunked entry points of ``scatter_wv_spans`` and ``gather_wv_spans``
(K9a, K9b) are ``p2g_scatter_spans`` and ``g2p_gather_spans``.

Particles are sorted by the plain flat id ``(x*n + y)*n + z`` of their
clipped base cell; ``cell_start`` (n^3 + 1 offsets into the sorted arrays)
gives each cell's particle range.  The (27, P) stencil weights are computed
once per frame and shared by both directions.  The TPU path's window layout
(haloed ids, packed columns, one-hot matmuls) is not needed here.

The three K1 modes run one chunked pull: ``chunk_plan`` cuts the cells'
particle ranges into chunks once per frame (``chunk_fill`` writes its
lists), and ``p2g_scatter_chunked``, ``p2g_scatter_affine_chunked`` and
``p2g_scatter_force_chunked`` are the kernels' summation order in PyTorch.

Each kernel wrapper (``p2g_scatter``, ``p2g_scatter_affine``,
``p2g_scatter_force``, ``chunk_fill``, ``p2g_scatter_base``, ``shift_reduce``,
``shift_expand``, ``g2p_gather``, ``g2p_moments``, ``g2p_gather_gw``,
``g2p_gather_table``, ``g2p_moments_table``, ``p2g_scatter_spans``,
``g2p_gather_spans``) launches its CUDA kernel of ``csrc/transfer.cu``
(``shift_reduce``, ``shift_expand``: ``csrc/stencil.cu``) for CUDA tensors
and uses its plain PyTorch version only for CPU tensors; anything else
raises.  Each counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fluidsim_tpu_torch import native
from fluidsim_tpu_torch.core.splines import cround
from fluidsim_tpu_torch.ops import bucket_sort
from fluidsim_tpu_torch.ops.smallmat import apply_mat27, outer_sum27
from fluidsim_tpu_torch.ops.transfer import _KERNELS, _OFFSETS

WINDOW = 512    # cells per window of the bucket order and of K6a
# Runs of (window, chunk) that one 1024-row output block of the bucket sort
# may meet before it falls back.  The JAX package's 8 sized its TPU kernel's
# double-buffered block loads; K5 reads each block's runs from memory in a
# loop, and at 129^3 / 2M particles a block meets up to ~20 runs once the
# cube moves (``chip_smoke.py`` phase 14 prints the count), so the JAX cap
# would send every such frame to the full sort.
BUCKET_EMAX = 64


def sort_by_cell(pos: torch.Tensor, vel: torch.Tensor, bound: int,
                 extra: torch.Tensor | None = None, method: str = "full"):
    """Sort particles by the flat id of their clipped base cell.

    Returns ``(pos_s, vel_s, flat_s)`` with ``flat_s`` int32, and with
    ``extra`` (an optional (P, k) payload, e.g. the flattened APIC C) its
    sorted rows as a fourth element.  Particles outside the box clip to the
    boundary cell; their weights vanish (``masked_weights_cm``).

    ``method="full"``: the stable sort by id.  The JAX package's haloed ids
    give the same order, and its sort is stable too, so both sort into the
    same sequence.  ``method="bucket"``: the rows grouped by ``WINDOW``-cell
    window of their id (``bucket_sort.bucket_or_sort``, the full sort when
    its caps trip), each cell's particles in the order the full sort gives
    them; only the unfused P2G (``p2g(fused_scatter=False)``) and the
    order-free G2P may read that order.
    """
    n = 2 * bound + 1
    bc = torch.clamp(cround(pos).to(torch.int32) + bound, 0, n - 1)
    flat = (bc[:, 0] * n + bc[:, 1]) * n + bc[:, 2]
    if method == "bucket":
        cols = [pos.T, vel.T] + ([] if extra is None else [extra.T])
        flat_s, co = bucket_sort.bucket_or_sort(flat, torch.cat(cols, 0),
                                                w=WINDOW, emax=BUCKET_EMAX)
        out = (co[0:3].T.contiguous(), co[3:6].T.contiguous(), flat_s)
        return out if extra is None else out + (co[6:].T.contiguous(),)
    if method != "full":
        raise ValueError(f"sort method {method!r}: expected 'full' or 'bucket'")
    flat_s, perm = torch.sort(flat, stable=True)
    if extra is None:
        return pos[perm], vel[perm], flat_s
    return pos[perm], vel[perm], flat_s, extra[perm]


def cell_starts(flat_s: torch.Tensor, n: int) -> torch.Tensor:
    """(n^3 + 1,) int32: first sorted index of every cell id, plus P."""
    ids = torch.arange(n ** 3 + 1, dtype=torch.int32, device=flat_s.device)
    return torch.searchsorted(flat_s, ids, out_int32=True)


def window_starts(flat_s: torch.Tensor, n: int) -> torch.Tensor:
    """(ceil(n^3 / WINDOW) + 1,) int32: first index of every ``WINDOW``-cell
    window of ids, plus P — the counterpart of ``build_chunks``' window
    edges.  Exact on a window-grouped order too: every id of window b lies
    in [b W, (b+1) W), so disorder inside a window flips no comparison with
    an edge."""
    nwin = -(-n ** 3 // WINDOW)
    edges = torch.arange(nwin + 1, dtype=torch.int32,
                         device=flat_s.device) * WINDOW
    return torch.searchsorted(flat_s, edges, out_int32=True)


def masked_weights_cm(pos_s: torch.Tensor, bound: int,
                      kernel: str = "flip") -> torch.Tensor:
    """(27, P) stencil weights ``w_o(p)``, zero for particles whose base
    cell lies outside the box.  Same f32 operations in the same order as the
    JAX function (``pos - (base + off)``, then the x*y*z product)."""
    kfn = _KERNELS[kernel]
    base = cround(pos_s)
    valid = torch.all(torch.abs(base) <= bound, dim=-1)[None]
    wax = [[kfn(pos_s[:, a] - (base[:, a] + (q - 1))) for q in range(3)]
           for a in range(3)]
    rows = torch.stack([wax[0][o // 9] * wax[1][(o // 3) % 3] * wax[2][o % 3]
                        for o in range(27)], dim=0)
    return torch.where(valid, rows, 0.0)


def _shift3(a: torch.Tensor, d) -> torch.Tensor:
    """result[..., j] = a[..., j - d] over the last three axes, zero-padded."""
    out = torch.zeros_like(a)
    src, dst = [], []
    for s, n_ax in zip(d, a.shape[-3:]):
        s = int(s)
        src.append(slice(max(-s, 0), n_ax - max(s, 0)))
        dst.append(slice(max(s, 0), n_ax - max(-s, 0)))
    out[(..., *dst)] = a[(..., *src)]
    return out


_OFF = torch.as_tensor(_OFFSETS, dtype=torch.float32)       # (27, 3)


def _wv_values(w27t: torch.Tensor, vel_s: torch.Tensor,
               aff_s: torch.Tensor | None = None) -> torch.Tensor:
    """The (P, 27, 4) per-(particle, offset) values ``w * [1, v]`` of the
    FLIP and APIC scatters; with ``aff_s`` ((P, 9), row-major C) the
    velocity of offset o is ``v + C off_o`` (``v_i + C[i,0] off_0 +
    C[i,1] off_1 + C[i,2] off_2``, summed in that order)."""
    v = vel_s[:, None, :]
    if aff_s is not None:
        off = _OFF.to(w27t.device)
        c = aff_s.reshape(-1, 1, 3, 3)
        v = (v + c[..., 0] * off[None, :, 0, None]
             + c[..., 1] * off[None, :, 1, None]
             + c[..., 2] * off[None, :, 2, None])             # (P, 27, 3)
    w = w27t.T[..., None]
    return torch.cat([w, w * v], dim=-1)


def _base_cell_sums(u: torch.Tensor, flat_s: torch.Tensor,
                    n: int) -> torch.Tensor:
    """One ``index_add_`` of the (P, 27, C) values onto the particles' base
    cells: a (27, C, n, n, n) view, each cell's sum taken over its particles
    in array order on the CPU."""
    p, _, c = u.shape
    d = torch.zeros((n ** 3, 27 * c), dtype=u.dtype, device=u.device)
    d.index_add_(0, flat_s.to(torch.int64), u.reshape(p, 27 * c))
    return d.T.reshape(27, c, n, n, n)


def _scatter27_plain(u: torch.Tensor, cell_start: torch.Tensor,
                     n: int) -> torch.Tensor:
    """The plain schedule of the K1 modes (``transfer_fast.p2g_fused``):
    the base-cell sums of the (P, 27, C) values (``_base_cell_sums``), then
    the 27 shifted adds (``shift_reduce_plain``).  Returns (C, n, n, n)."""
    counts = (cell_start[1:] - cell_start[:-1]).to(torch.int64)
    flat = torch.repeat_interleave(
        torch.arange(n ** 3, device=u.device), counts)
    return shift_reduce_plain(_base_cell_sums(u, flat, n))


# ---- the chunk plan and the chunked pull of every K1 mode -----------------

# Most particles in one chunk of a K1 plan: a crowded cell's range is cut
# into chunks of at most this many particles, each summed by its own warp.
CHUNK = 128


class ChunkPlan(NamedTuple):
    """The chunks of a K1 launch (``p2g_scatter``, ``p2g_scatter_affine``,
    ``p2g_scatter_force``): every occupied cell's particle range cut into
    chunks of at most ``CHUNK`` particles, listed in (cell, chunk) order.
    ``cell_start`` is the tensor the plan was built from; ``chunk_start``
    (n^3 + 1,) int32 is each cell's first chunk, its last entry the number
    of chunks ``nch``; ``chunk_first`` and ``chunk_cell`` (nch + 1,) int32
    are each chunk's first particle and its cell, with P and n^3 in their
    last entry."""
    cell_start: torch.Tensor
    chunk_start: torch.Tensor
    chunk_first: torch.Tensor
    chunk_cell: torch.Tensor


def chunk_fill_plain(cell_start: torch.Tensor, chunk_start: torch.Tensor,
                     p: int):
    """Plain PyTorch chunk lists of a plan: ``(chunk_first, chunk_cell)``,
    (p + 1,) int32 each, entries ``0..nch`` as ``ChunkPlan`` holds them and
    the rest (P, n^3)."""
    dev = cell_start.device
    i32 = dict(dtype=torch.int32, device=dev)
    ncell = cell_start.shape[0] - 1
    idx = torch.arange(p, **i32)
    cell = torch.searchsorted(cell_start, idx, right=True, out_int32=True) - 1
    r = idx - cell_start[cell]
    head = r % CHUNK == 0
    slot = torch.where(head, chunk_start[cell] + r // CHUNK, p).to(torch.int64)
    chunk_first = torch.full((p + 1,), p, **i32)
    chunk_first.scatter_(0, slot, torch.where(head, idx, p))
    chunk_cell = torch.full((p + 1,), ncell, **i32)
    chunk_cell.scatter_(0, slot, torch.where(head, cell, ncell))
    return chunk_first, chunk_cell


def chunk_fill(cell_start: torch.Tensor, chunk_start: torch.Tensor, p: int):
    """The chunk lists of a plan, ``(chunk_first, chunk_cell)``: (p + 1,)
    int32 each, of which entries ``0..nch`` are the plan's (a plan has at
    most P chunks).  CUDA tensors launch ``fs_chunk_fill``
    (``csrc/transfer.cu``: one thread per cell writes its chunks), whose
    entries ``0..nch`` equal ``chunk_fill_plain``'s and the rest are left
    unwritten; CPU tensors take ``chunk_fill_plain``."""
    if cell_start.device.type == "cpu":
        return chunk_fill_plain(cell_start, chunk_start, p)
    native.require_cuda(cell_start, "chunk_fill")
    dev = cell_start.device
    ncell = cell_start.shape[0] - 1
    native.check_tensor("cell_start", cell_start, torch.int32, (ncell + 1,), dev)
    native.check_tensor("chunk_start", chunk_start, torch.int32, (ncell + 1,),
                        dev)
    chunk_first = torch.empty((p + 1,), dtype=torch.int32, device=dev)
    chunk_cell = torch.empty((p + 1,), dtype=torch.int32, device=dev)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_chunk_fill(cell_start.data_ptr(), chunk_start.data_ptr(),
                               chunk_first.data_ptr(), chunk_cell.data_ptr(),
                               ncell, CHUNK, native.stream_ptr(dev))
    native.check_launch("chunk_fill", rc)
    chunk_fill.launches += 1
    return chunk_first, chunk_cell


chunk_fill.launches = 0


def _chunk_lists(cell_start: torch.Tensor, p: int):
    """The device work of ``chunk_plan``, queued with no host read:
    ``(chunk_start, chunk_first, chunk_cell)``, the lists P + 1 long."""
    ncell = cell_start.shape[0] - 1
    counts = cell_start[1:] - cell_start[:-1]
    chunk_start = torch.zeros((ncell + 1,), dtype=torch.int32,
                              device=cell_start.device)
    torch.cumsum((counts + (CHUNK - 1)) // CHUNK, 0, dtype=torch.int32,
                 out=chunk_start[1:])
    return (chunk_start,) + chunk_fill(cell_start, chunk_start, p)


def chunk_plan(cell_start: torch.Tensor, p: int) -> ChunkPlan:
    """The ``ChunkPlan`` of the sorted particles that ``cell_start`` (n^3 +
    1 offsets, the last ``p``) ranges, built on ``cell_start``'s device,
    once per frame for all of the frame's K1 launches.  All of its device
    work (``_chunk_lists``) is queued before its one host read, the chunk
    count (4 bytes), which sizes the lists (views of the P + 1 long ones)
    and the kernels' scratch.  Counts its builds in ``.builds``."""
    chunk_start, chunk_first, chunk_cell = _chunk_lists(cell_start, p)
    nch = int(chunk_start[-1])
    chunk_plan.builds += 1
    return ChunkPlan(cell_start, chunk_start, chunk_first[:nch + 1],
                     chunk_cell[:nch + 1])


chunk_plan.builds = 0


def _scatter27_chunked(u: torch.Tensor, plan: ChunkPlan,
                       n: int) -> torch.Tensor:
    """The K1 modes' CUDA order in PyTorch, over the (P, 27, C) values
    ``u``: each chunk's sums in particle order from +0, each cell's record
    the sum of its chunks' in chunk order, then the 27 shifted adds of the
    records in offset order (``shift_reduce_plain``).  It differs from
    ``_scatter27_plain`` only in the order of the sums.  Reads the longest
    chunk and chunk run on the host.  Returns (C, n, n, n)."""
    p, _, c = u.shape
    w = 27 * c
    u = torch.cat([u.reshape(p, w), u.new_zeros((1, w))])    # row p: zeros
    nch = plan.chunk_first.shape[0] - 1
    first = plan.chunk_first.to(torch.int64)
    sums = u.new_zeros((nch, w))
    for j in range(int((first[1:] - first[:-1]).max()) if nch else 0):
        row = first[:-1] + j
        sums = sums + u[torch.where(row < first[1:], row, p)]
    sums = torch.cat([sums, u.new_zeros((1, w))])            # row nch: zeros
    start = plan.chunk_start.to(torch.int64)
    count = start[1:] - start[:-1]
    rec = u.new_zeros((n ** 3, w))
    for j in range(int(count.max()) if nch else 0):
        rec = rec + sums[torch.where(j < count, start[:-1] + j, nch)]
    return shift_reduce_plain(rec.T.reshape(27, c, n, n, n))


def _launch_chunked(name: str, entry: str, values: tuple, nc: int,
                    cell_start: torch.Tensor, n: int, p: int,
                    plan: ChunkPlan | None) -> torch.Tensor:
    """Launch K1 mode ``entry`` of ``csrc/transfer.cu`` on its value inputs
    ``values`` (checked by the caller) with the chunk lists of ``plan`` and
    (nch, 27 nc) scratch.  A plan given is checked and refused when built
    from another tensor than ``cell_start``; with None one is built here,
    after everything else the launch needs, so that only the scratch and
    the launch follow its host read.  Returns (nc, n, n, n)."""
    dev = cell_start.device
    native.check_tensor("cell_start", cell_start, torch.int32, (n ** 3 + 1,), dev)
    if p >= 2 ** 31 or n ** 3 >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 - 1 particles or cells")
    if plan is not None:
        if (plan.cell_start.data_ptr() != cell_start.data_ptr()
                or plan.cell_start.shape != cell_start.shape):
            raise ValueError(f"{name}: plan was not built from this "
                             "cell_start")
        nch = plan.chunk_first.shape[0] - 1
        native.check_tensor("plan.chunk_start", plan.chunk_start,
                            torch.int32, (n ** 3 + 1,), dev)
        for field in ("chunk_first", "chunk_cell"):
            native.check_tensor(f"plan.{field}", getattr(plan, field),
                                torch.int32, (nch + 1,), dev)
    out = torch.empty((nc, n, n, n), dtype=torch.float32, device=dev)
    launch = getattr(native.library(), entry)
    args = [t.data_ptr() for t in values]
    with torch.cuda.device(dev):
        stream = native.stream_ptr(dev)
        if plan is None:
            plan = chunk_plan(cell_start, p)
        nch = plan.chunk_first.shape[0] - 1
        sums = torch.empty((nch, 27 * nc), dtype=torch.float32, device=dev)
        rc = launch(*args, plan.chunk_first.data_ptr(),
                    plan.chunk_cell.data_ptr(), plan.chunk_start.data_ptr(),
                    sums.data_ptr(), out.data_ptr(), n, p, nch, stream)
    native.check_launch(name, rc)
    return out


# ---- K1: FLIP P2G scatter --------------------------------------------------

def p2g_scatter_plain(w27t: torch.Tensor, vel_s: torch.Tensor,
                      cell_start: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch K1: the 27x4 per-particle values ``w * [1, v]``
    through ``_scatter27_plain``.  Returns (4, n, n, n)."""
    return _scatter27_plain(_wv_values(w27t, vel_s), cell_start, n)


def p2g_scatter_chunked(w27t: torch.Tensor, vel_s: torch.Tensor,
                        plan: ChunkPlan, n: int) -> torch.Tensor:
    """K1 in the order of its CUDA kernels (``_scatter27_chunked`` of
    ``_wv_values``), which equal it bit for bit.  Returns (4, n, n, n)."""
    return _scatter27_chunked(_wv_values(w27t, vel_s), plan, n)


def p2g_scatter(w27t: torch.Tensor, vel_s: torch.Tensor,
                cell_start: torch.Tensor, n: int,
                plan: ChunkPlan | None = None) -> torch.Tensor:
    """K1: ``out[g, c] = sum_o sum_{p: base(p) = c - off_o} w27t[o, p] *
    [1, v_p][g]`` over sorted particles, dropping contributions outside the
    box.  ``plan``: the ``chunk_plan`` of ``cell_start``, built here when
    not given.  (4, n, n, n) f32.  CUDA tensors launch ``fs_p2g_scatter``
    (``csrc/transfer.cu``: the chunk sums and the cells' records, then the
    pull), equal to ``p2g_scatter_chunked`` bit for bit; CPU tensors take
    ``p2g_scatter_plain`` and ignore ``plan``."""
    if w27t.device.type == "cpu":
        return p2g_scatter_plain(w27t, vel_s, cell_start, n)
    native.require_cuda(w27t, "p2g_scatter")
    p = vel_s.shape[0]
    native.check_tensor("w27t", w27t, torch.float32, (27, p), w27t.device)
    native.check_tensor("vel_s", vel_s, torch.float32, (p, 3), w27t.device)
    out = _launch_chunked("p2g_scatter", "fs_p2g_scatter", (w27t, vel_s), 4,
                          cell_start, n, p, plan)
    p2g_scatter.launches += 1
    return out


p2g_scatter.launches = 0


# ---- K1 aff: APIC P2G scatter ---------------------------------------------

def p2g_scatter_affine_plain(w27t: torch.Tensor, veff_s: torch.Tensor,
                             aff_s: torch.Tensor, cell_start: torch.Tensor,
                             n: int) -> torch.Tensor:
    """Plain PyTorch K1 aff: as ``p2g_scatter_plain`` with the velocity of
    offset o ``veff + C off_o`` (``_wv_values``).  ``aff_s`` is (P, 9),
    row-major C.  Returns (4, n, n, n)."""
    return _scatter27_plain(_wv_values(w27t, veff_s, aff_s), cell_start, n)


def p2g_scatter_affine_chunked(w27t: torch.Tensor, veff_s: torch.Tensor,
                               aff_s: torch.Tensor, plan: ChunkPlan,
                               n: int) -> torch.Tensor:
    """K1 aff in the order of its CUDA kernels (``_scatter27_chunked`` of
    ``_wv_values``), which equal it bit for bit.  Returns (4, n, n, n)."""
    return _scatter27_chunked(_wv_values(w27t, veff_s, aff_s), plan, n)


def p2g_scatter_affine(w27t: torch.Tensor, veff_s: torch.Tensor,
                       aff_s: torch.Tensor, cell_start: torch.Tensor,
                       n: int, plan: ChunkPlan | None = None) -> torch.Tensor:
    """K1 aff: ``out[g, c] = sum_o sum_{p: base(p) = c - off_o} w27t[o, p] *
    [1, veff_p + C_p off_o][g]``, dropping contributions outside the box.
    ``plan`` as in ``p2g_scatter``.  (4, n, n, n) f32.  CUDA tensors launch
    ``fs_p2g_scatter_affine`` (``csrc/transfer.cu``), equal to
    ``p2g_scatter_affine_chunked`` bit for bit; CPU tensors take
    ``p2g_scatter_affine_plain`` and ignore ``plan``."""
    if w27t.device.type == "cpu":
        return p2g_scatter_affine_plain(w27t, veff_s, aff_s, cell_start, n)
    native.require_cuda(w27t, "p2g_scatter_affine")
    dev = w27t.device
    p = veff_s.shape[0]
    native.check_tensor("w27t", w27t, torch.float32, (27, p), dev)
    native.check_tensor("veff_s", veff_s, torch.float32, (p, 3), dev)
    native.check_tensor("aff_s", aff_s, torch.float32, (p, 9), dev)
    out = _launch_chunked("p2g_scatter_affine", "fs_p2g_scatter_affine",
                          (w27t, veff_s, aff_s), 4, cell_start, n, p, plan)
    p2g_scatter_affine.launches += 1
    return out


p2g_scatter_affine.launches = 0


# ---- K2 and K7a: G2P gathers, fused and from the table ---------------------

def _neighbour_fields(fm: torch.Tensor, flat_s: torch.Tensor):
    """Yield ``(o, vals)`` for the 27 offsets in order: the (C, P) values of
    the (C, n, n, n) ``fm`` at ``base(p) + off_o``, 0 where that cell is
    outside the box."""
    n = fm.shape[1]
    bc = torch.stack([flat_s // (n * n), (flat_s // n) % n, flat_s % n], -1)
    fm_flat = fm.reshape(fm.shape[0], -1)
    for o in range(27):
        cell = bc + torch.as_tensor(_OFFSETS[o], device=fm.device)
        inb = torch.all((cell >= 0) & (cell < n), dim=-1)
        ids = ((cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]).clamp(0, n ** 3 - 1)
        yield o, torch.where(inb[None], fm_flat[:, ids], 0.0)


def _table_columns(table: torch.Tensor, flat_s: torch.Tensor):
    """Yield ``(o, vals)`` for the 27 offsets in order: the (C, P) columns
    of the (27, C, n, n, n) ``table`` at the particles' base cells — the
    values ``_neighbour_fields`` gives of the fields the table was built
    from (``shift_expand``)."""
    t = table.reshape(27, table.shape[1], -1)
    for o in range(27):
        yield o, t[o][:, flat_s]


def _gather_sums(neighbours, w27t: torch.Tensor) -> torch.Tensor:
    """The 4 rows ``sum_o w27t[o] * vals_o``, added in offset order from 0."""
    out = torch.zeros((4, w27t.shape[1]), dtype=w27t.dtype, device=w27t.device)
    for o, vals in neighbours:
        out = out + w27t[o][None] * vals
    return out


def g2p_gather_plain(fm: torch.Tensor, w27t: torch.Tensor,
                     flat_s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: 27 masked gathers of the 4 channels.  (4, P)."""
    return _gather_sums(_neighbour_fields(fm, flat_s), w27t)


def g2p_gather_table_plain(table: torch.Tensor, w27t: torch.Tensor,
                           flat_s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7a (4 rows): ``g2p_gather_plain`` reading the table's
    base-cell columns, in the same order.  (4, P)."""
    return _gather_sums(_table_columns(table, flat_s), w27t)


def _launch_gather(name: str, entry: str, src: torch.Tensor, lead: tuple,
                   w27t: torch.Tensor, flat_s: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """Launch a gather of ``csrc/transfer.cu`` that reads ``src`` of shape
    ``lead + (4, n, n, n)`` (the fields, or with ``lead = (27,)`` the
    table), (27, P) weights and (P,) sorted ids, and writes ``rows`` rows
    of P."""
    native.require_cuda(src, name)
    dev = src.device
    n = src.shape[-1]
    p = flat_s.shape[0]
    native.check_tensor("src", src, torch.float32, lead + (4, n, n, n), dev)
    native.check_tensor("w27t", w27t, torch.float32, (27, p), dev)
    native.check_tensor("flat_s", flat_s, torch.int32, (p,), dev)
    out = torch.empty((rows, p), dtype=torch.float32, device=dev)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(src.data_ptr(), w27t.data_ptr(),
                                 flat_s.data_ptr(), out.data_ptr(), n, p,
                                 native.stream_ptr(dev))
    native.check_launch(name, rc)
    return out


def g2p_gather(fm: torch.Tensor, w27t: torch.Tensor,
               flat_s: torch.Tensor) -> torch.Tensor:
    """K2: ``out[c, p] = sum_o w27t[o, p] * fm[c, base(p) + off_o]`` with
    neighbours outside the box reading 0; ``fm`` is (4, n, n, n).  (4, P)
    f32.  CUDA tensors launch ``fs_g2p_gather`` (``csrc/transfer.cu``); CPU
    tensors take ``g2p_gather_plain``."""
    if fm.device.type == "cpu":
        return g2p_gather_plain(fm, w27t, flat_s)
    out = _launch_gather("g2p_gather", "fs_g2p_gather", fm, (), w27t,
                         flat_s, 4)
    g2p_gather.launches += 1
    return out


g2p_gather.launches = 0


def g2p_gather_table(table: torch.Tensor, w27t: torch.Tensor,
                     flat_s: torch.Tensor) -> torch.Tensor:
    """K7a (4 rows): ``out[c, p] = sum_o w27t[o, p] * table[o, c,
    base(p)]`` for the (27, 4, n, n, n) table of ``shift_expand`` — K2's
    function and summation order on the materialised neighbourhood, so the
    result equals ``g2p_gather`` of the fields to the bit.  (4, P) f32.
    CUDA tensors launch ``fs_g2p_gather_table`` (``csrc/transfer.cu``); CPU
    tensors take ``g2p_gather_table_plain``."""
    if table.device.type == "cpu":
        return g2p_gather_table_plain(table, w27t, flat_s)
    out = _launch_gather("g2p_gather_table", "fs_g2p_gather_table", table,
                         (27,), w27t, flat_s, 4)
    g2p_gather_table.launches += 1
    return out


g2p_gather_table.launches = 0


# ---- K2 moments and K7a moments: APIC G2P offset moments -------------------

MOMENT_ROWS = 22
_SYM_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _moment_sums(neighbours, w27t: torch.Tensor) -> torch.Tensor:
    """The 22 live rows of the JAX package's ``_contract_mat(24)``, each
    summed over the 27 offsets in order, from ``wf = w27t[o] * vals_o``:

      row 0       den     = sum wf[3]                 (wf[3] = w * mask)
      rows 1-3    vnum_c  = sum wf[c]
      rows 4-6    mbar_k  = sum wf[3] off_k
      rows 7-15   F_{c,k} = sum wf[c] off_k           (row 7 + 3c + k)
      rows 16-21  M_{kl}  = sum wf[3] off_k off_l     (``_SYM_PAIRS``)
    """
    out = torch.zeros((MOMENT_ROWS, w27t.shape[1]), dtype=w27t.dtype,
                      device=w27t.device)
    for o, vals in neighbours:
        wf = w27t[o][None] * vals
        off = [int(v) for v in _OFFSETS[o]]
        terms = [wf[3], wf[0], wf[1], wf[2]]
        terms += [wf[3] * float(off[k]) for k in range(3)]
        terms += [wf[c] * float(off[k]) for c in range(3) for k in range(3)]
        terms += [wf[3] * float(off[k] * off[l]) for k, l in _SYM_PAIRS]
        out = out + torch.stack(terms)
    return out


def g2p_moments_plain(fm: torch.Tensor, w27t: torch.Tensor,
                      flat_s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2 moments (``_moment_sums`` of the fields at the 27
    neighbours).  Returns (22, P)."""
    return _moment_sums(_neighbour_fields(fm, flat_s), w27t)


def g2p_moments_table_plain(table: torch.Tensor, w27t: torch.Tensor,
                            flat_s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7a moments: ``g2p_moments_plain`` reading the table's
    base-cell columns, in the same order.  Returns (22, P)."""
    return _moment_sums(_table_columns(table, flat_s), w27t)


def g2p_moments(fm: torch.Tensor, w27t: torch.Tensor,
                flat_s: torch.Tensor) -> torch.Tensor:
    """K2 moments: the (22, P) f32 offset moments of ``g2p_moments_plain``
    (neighbours outside the box read 0).  CUDA tensors launch
    ``fs_g2p_moments`` (``csrc/transfer.cu``); CPU tensors take
    ``g2p_moments_plain``."""
    if fm.device.type == "cpu":
        return g2p_moments_plain(fm, w27t, flat_s)
    out = _launch_gather("g2p_moments", "fs_g2p_moments", fm, (), w27t,
                         flat_s, MOMENT_ROWS)
    g2p_moments.launches += 1
    return out


g2p_moments.launches = 0


def g2p_moments_table(table: torch.Tensor, w27t: torch.Tensor,
                      flat_s: torch.Tensor) -> torch.Tensor:
    """K7a moments: the (22, P) f32 offset moments of the (27, 4, n, n, n)
    table of ``shift_expand``, equal to ``g2p_moments`` of the fields to the
    bit.  CUDA tensors launch ``fs_g2p_moments_table``
    (``csrc/transfer.cu``); CPU tensors take ``g2p_moments_table_plain``."""
    if table.device.type == "cpu":
        return g2p_moments_table_plain(table, w27t, flat_s)
    out = _launch_gather("g2p_moments_table", "fs_g2p_moments_table", table,
                         (27,), w27t, flat_s, MOMENT_ROWS)
    g2p_moments_table.launches += 1
    return out


g2p_moments_table.launches = 0


# ---- K1 fg: MPM force scatter ----------------------------------------------

def _gradw_p27(gradw: torch.Tensor) -> torch.Tensor:
    """(81, P) gradW rows ``3o + k`` -> (P, 27, 3)."""
    return gradw.T.reshape(-1, 27, 3)


def _force_values(gradw: torch.Tensor, m9: torch.Tensor) -> torch.Tensor:
    """The (P, 27, 3) per-(particle, offset) force ``M gradW(o)``
    (``apply_mat27``, each row summed over k = 0, 1, 2 in order)."""
    return apply_mat27(m9.reshape(-1, 3, 3), _gradw_p27(gradw))


def p2g_scatter_force_plain(gradw: torch.Tensor, m9: torch.Tensor,
                            cell_start: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch K1 fg: ``_force_values`` through ``_scatter27_plain``.
    ``m9`` is (P, 9), row-major M.  Returns (3, n, n, n)."""
    return _scatter27_plain(_force_values(gradw, m9), cell_start, n)


def p2g_scatter_force_chunked(gradw: torch.Tensor, m9: torch.Tensor,
                              plan: ChunkPlan, n: int) -> torch.Tensor:
    """K1 fg in the order of its CUDA kernels (``_scatter27_chunked`` of
    ``_force_values``), which equal it bit for bit.  Returns (3, n, n,
    n)."""
    return _scatter27_chunked(_force_values(gradw, m9), plan, n)


def p2g_scatter_force(gradw: torch.Tensor, m9: torch.Tensor,
                      cell_start: torch.Tensor, n: int,
                      plan: ChunkPlan | None = None) -> torch.Tensor:
    """K1 fg: ``out[c, cell] = sum_o sum_{p: base(p) = cell - off_o}
    sum_k M_p[c, k] gradW_k(p, o)`` over sorted particles, dropping
    contributions outside the box.  ``gradw`` is (81, P) with row
    ``3o + k``; ``m9`` (P, 9) row-major M; ``plan`` as in ``p2g_scatter``.
    (3, n, n, n) f32.  CUDA tensors launch ``fs_p2g_scatter_force``
    (``csrc/transfer.cu``), equal to ``p2g_scatter_force_chunked`` bit for
    bit; CPU tensors take ``p2g_scatter_force_plain`` and ignore
    ``plan``."""
    if gradw.device.type == "cpu":
        return p2g_scatter_force_plain(gradw, m9, cell_start, n)
    native.require_cuda(gradw, "p2g_scatter_force")
    dev = gradw.device
    p = m9.shape[0]
    native.check_tensor("gradw", gradw, torch.float32, (81, p), dev)
    native.check_tensor("m9", m9, torch.float32, (p, 9), dev)
    out = _launch_chunked("p2g_scatter_force", "fs_p2g_scatter_force",
                          (gradw, m9), 3, cell_start, n, p, plan)
    p2g_scatter_force.launches += 1
    return out


p2g_scatter_force.launches = 0


# ---- K2 gw: MPM gradW gather -----------------------------------------------

def g2p_gather_gw_plain(fm: torch.Tensor, gradw: torch.Tensor,
                        flat_s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2 gw: the (P, 27, 3) neighbour values of ``fm``
    (27 masked gathers through ``_neighbour_fields``) contracted with
    gradW over the offsets (``outer_sum27``).  Returns (9, P), row
    ``3c + k``."""
    vals = torch.stack([v.T for _, v in _neighbour_fields(fm, flat_s)],
                       dim=1)                                  # (P, 27, 3)
    g = outer_sum27(vals, _gradw_p27(gradw))                   # (P, 3, 3)
    return g.reshape(-1, 9).T.contiguous()


def g2p_gather_gw(fm: torch.Tensor, gradw: torch.Tensor,
                  flat_s: torch.Tensor) -> torch.Tensor:
    """K2 gw: ``out[3c + k, p] = sum_o gradW_k(p, o) * fm[c, base(p) +
    off_o]`` for c, k < 3, neighbours outside the box reading 0; ``fm`` is
    (3, n, n, n), ``gradw`` (81, P) with row ``3o + k``.  These are the 9
    live rows of the TPU kernel's ``contract='gw'`` output (its rows
    ``4k + c``; its rows ``4k + 3`` contract the mask channel, which every
    caller drops).  ``out.reshape(3, 3, P).permute(2, 0, 1)`` is the
    (P, 3, 3) ``g[p, c, k]``.  (9, P) f32.  CUDA tensors launch
    ``fs_g2p_gather_gw`` (``csrc/transfer.cu``); CPU tensors take
    ``g2p_gather_gw_plain``."""
    if fm.device.type == "cpu":
        return g2p_gather_gw_plain(fm, gradw, flat_s)
    native.require_cuda(fm, "g2p_gather_gw")
    dev = fm.device
    n = fm.shape[1]
    p = flat_s.shape[0]
    native.check_tensor("fm", fm, torch.float32, (3, n, n, n), dev)
    native.check_tensor("gradw", gradw, torch.float32, (81, p), dev)
    native.check_tensor("flat_s", flat_s, torch.int32, (p,), dev)
    out = torch.empty((9, p), dtype=torch.float32, device=dev)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_g2p_gather_gw(fm.data_ptr(), gradw.data_ptr(),
                                  flat_s.data_ptr(), out.data_ptr(), n, p,
                                  native.stream_ptr(dev))
    native.check_launch("g2p_gather_gw", rc)
    g2p_gather_gw.launches += 1
    return out


g2p_gather_gw.launches = 0


# ---- K6a: the unfused P2G's base-cell scatter ------------------------------

def p2g_scatter_base_plain(w27t: torch.Tensor, vel_s: torch.Tensor,
                           flat_s: torch.Tensor, n: int,
                           aff_s: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K6a: one ``index_add_`` of the (P, 108) values
    ``w * [1, v (+ C off)]`` (``_wv_values``) onto the base cells.  Returns
    (27, 4, n, n, n)."""
    return _base_cell_sums(_wv_values(w27t, vel_s, aff_s), flat_s,
                           n).contiguous()


def p2g_scatter_base(w27t: torch.Tensor, vel_s: torch.Tensor,
                     flat_s: torch.Tensor, wstart: torch.Tensor, n: int,
                     aff_s: torch.Tensor | None = None) -> torch.Tensor:
    """K6a: ``out[o, c, cell] = sum_{p: flat(p) = cell} w27t[o, p] *
    [1, v_p (+ C_p off_o)][c]`` — the 108 per-offset channels summed on the
    base cells, each cell's particles in array order.  The particles must
    be grouped by ``WINDOW``-cell window (any order inside a window);
    ``wstart`` is ``window_starts(flat_s, n)``.  ``aff_s`` (P, 9): the APIC
    term, with ``vel_s`` then veff.  (27, 4, n, n, n) f32, every cell
    written.  CUDA tensors launch ``fs_p2g_scatter_base``
    (``csrc/transfer.cu``); CPU tensors take ``p2g_scatter_base_plain``."""
    if w27t.device.type == "cpu":
        return p2g_scatter_base_plain(w27t, vel_s, flat_s, n, aff_s)
    native.require_cuda(w27t, "p2g_scatter_base")
    dev = w27t.device
    p = vel_s.shape[0]
    nwin = -(-n ** 3 // WINDOW)
    native.check_tensor("w27t", w27t, torch.float32, (27, p), dev)
    native.check_tensor("vel_s", vel_s, torch.float32, (p, 3), dev)
    native.check_tensor("flat_s", flat_s, torch.int32, (p,), dev)
    native.check_tensor("wstart", wstart, torch.int32, (nwin + 1,), dev)
    if aff_s is not None:
        native.check_tensor("aff_s", aff_s, torch.float32, (p, 9), dev)
    if p >= 2 ** 31:
        raise ValueError("p2g_scatter_base: more than 2^31 - 1 particles")
    out = torch.empty((27, 4, n, n, n), dtype=torch.float32, device=dev)
    order = torch.empty((p,), dtype=torch.int32, device=dev)   # scratch
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_p2g_scatter_base(
            w27t.data_ptr(), vel_s.data_ptr(),
            None if aff_s is None else aff_s.data_ptr(), flat_s.data_ptr(),
            wstart.data_ptr(), order.data_ptr(), out.data_ptr(), n, p,
            native.stream_ptr(dev))
    native.check_launch("p2g_scatter_base", rc)
    p2g_scatter_base.launches += 1
    return out


p2g_scatter_base.launches = 0


# ---- K6b: the unfused P2G's shift-reduce -----------------------------------

def shift_reduce_plain(d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6b: ``acc = sum_o shift(d[o], off_o)``, 27 shifted
    adds in offset order from zero.  (27, C, n, n, n) -> (C, n, n, n)."""
    acc = torch.zeros(d.shape[1:], dtype=d.dtype, device=d.device)
    for o in range(27):
        acc = acc + _shift3(d[o], _OFFSETS[o])
    return acc


def shift_reduce(d: torch.Tensor) -> torch.Tensor:
    """K6b: ``acc[g, cell] = sum_o d[o, g, cell - off_o]`` over the 27
    offsets in order, sources outside the box dropped; ``d`` is K6a's
    (27, 4, n, n, n).  (4, n, n, n) f32.  CUDA tensors launch
    ``fs_shift_reduce`` (``csrc/stencil.cu``), bitwise equal to
    ``shift_reduce_plain``, which CPU tensors take."""
    if d.device.type == "cpu":
        return shift_reduce_plain(d)
    native.require_cuda(d, "shift_reduce")
    dev = d.device
    n = d.shape[-1]
    native.check_tensor("d", d, torch.float32, (27, 4, n, n, n), dev)
    out = torch.empty((4, n, n, n), dtype=torch.float32, device=dev)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_shift_reduce(d.data_ptr(), out.data_ptr(), n,
                                 native.stream_ptr(dev))
    native.check_launch("shift_reduce", rc)
    shift_reduce.launches += 1
    return out


shift_reduce.launches = 0


# ---- K7b: the unfused G2P's neighbourhood table ----------------------------

def shift_expand_plain(fm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7b: ``table[o] = shift(fm, -off_o)``, 27 zero-padded
    shifted copies in offset order.  (C, n, n, n) -> (27, C, n, n, n)."""
    return torch.stack([_shift3(fm, -_OFFSETS[o]) for o in range(27)])


def shift_expand(fm: torch.Tensor) -> torch.Tensor:
    """K7b: ``table[o, g, cell] = fm[g, cell + off_o]``, 0 where that
    neighbour is outside the box; ``fm`` is (4, n, n, n) (``gather_fields``).
    (27, 4, n, n, n) f32, K6a's layout.  CUDA tensors launch
    ``fs_shift_expand`` (``csrc/stencil.cu``), bitwise equal to
    ``shift_expand_plain``, which CPU tensors take."""
    if fm.device.type == "cpu":
        return shift_expand_plain(fm)
    native.require_cuda(fm, "shift_expand")
    dev = fm.device
    n = fm.shape[-1]
    native.check_tensor("fm", fm, torch.float32, (4, n, n, n), dev)
    out = torch.empty((27, 4, n, n, n), dtype=torch.float32, device=dev)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_shift_expand(fm.data_ptr(), out.data_ptr(), n,
                                 native.stream_ptr(dev))
    native.check_launch("shift_expand", rc)
    shift_expand.launches += 1
    return out


shift_expand.launches = 0


# ---- K9a, K9b: the span-chunked entry points -------------------------------
#
# The JAX package's span kernels are another TPU schedule of K6a's and K7a's
# sums (fixed-stride particle chunks looping over the windows each touches),
# for particles sorted by cell.  Here they check that order and run the K6a
# and K7a kernels.

def _require_sorted(flat_s: torch.Tensor, name: str):
    if flat_s.numel() > 1 and not bool((flat_s[1:] >= flat_s[:-1]).all()):
        raise ValueError(f"{name}: the particles must be sorted by cell id")


def p2g_scatter_spans(w27t: torch.Tensor, vel_s: torch.Tensor,
                      flat_s: torch.Tensor, n: int,
                      aff_s: torch.Tensor | None = None) -> torch.Tensor:
    """K9a, the counterpart of ``scatter_wv_spans``: ``p2g_scatter_base``'s
    function on particles fully sorted by cell (raises otherwise).
    (27, 4, n, n, n) f32.  CUDA tensors launch ``fs_p2g_scatter_base``;
    CPU tensors take ``p2g_scatter_base_plain``."""
    if w27t.device.type == "cpu":
        _require_sorted(flat_s, "p2g_scatter_spans")
        return p2g_scatter_base_plain(w27t, vel_s, flat_s, n, aff_s)
    native.require_cuda(w27t, "p2g_scatter_spans")
    _require_sorted(flat_s, "p2g_scatter_spans")
    out = p2g_scatter_base(w27t, vel_s, flat_s, window_starts(flat_s, n), n,
                           aff_s)
    p2g_scatter_spans.launches += 1
    return out


p2g_scatter_spans.launches = 0


def g2p_gather_spans(table: torch.Tensor, w27t: torch.Tensor,
                     flat_s: torch.Tensor, moments: bool = False) -> torch.Tensor:
    """K9b, the counterpart of ``gather_wv_spans``: ``g2p_gather_table``
    (``nout=8``) or, with ``moments``, ``g2p_moments_table`` (``nout=24``)
    on particles fully sorted by cell (raises otherwise).  (4, P) or (22, P)
    f32.  CUDA tensors launch ``fs_g2p_gather_table`` or
    ``fs_g2p_moments_table``; CPU tensors take their plain versions."""
    gather = g2p_moments_table if moments else g2p_gather_table
    if table.device.type == "cpu":
        _require_sorted(flat_s, "g2p_gather_spans")
        return gather(table, w27t, flat_s)
    native.require_cuda(table, "g2p_gather_spans")
    _require_sorted(flat_s, "g2p_gather_spans")
    out = gather(table, w27t, flat_s)
    g2p_gather_spans.launches += 1
    return out


g2p_gather_spans.launches = 0


# ---- the transfers around the kernels -------------------------------------

def _box_within(bound: int, m: int, device) -> torch.Tensor:
    """(N,N,N) bool: True where ``|c| <= m`` on all three axes."""
    ok = torch.arange(-bound, bound + 1, device=device).abs() <= m
    return ok[:, None, None] & ok[None, :, None] & ok[None, None, :]


def p2g(w27t: torch.Tensor, vel_s: torch.Tensor, flat_s: torch.Tensor,
        solid: torch.Tensor, bound: int, fused_scatter: bool = True):
    """Full P2G of sorted particles, then the reference's target-cell masks
    (``p2g_masks``).  ``fused_scatter``: K1 over the cell ranges of a full
    sort (on the card its wrapper builds the frame's one chunk plan); else
    K6a and K6b, which need only a window-grouped order (the
    counterpart of ``p2g_pallas(fused_scatter=False)``).  Returns
    ``weights`` (N,N,N), channel-major ``mom`` (3,N,N,N) and ``occ``
    (N,N,N)."""
    n = 2 * bound + 1
    if fused_scatter:
        accn = p2g_scatter(w27t, vel_s, cell_starts(flat_s, n), n)
    else:
        accn = shift_reduce(p2g_scatter_base(w27t, vel_s, flat_s,
                                             window_starts(flat_s, n), n))
    return p2g_masks(accn, solid, bound)


def p2g_masks(accn: torch.Tensor, solid: torch.Tensor, bound: int):
    """Split K1's (4, N, N, N) sums into (weights, mom, occ): weights and
    momentum keep cells within ``bound - 2`` that are not solid; occupancy
    keeps every non-solid cell."""
    p2g_mask = _box_within(bound, bound - 2, accn.device) & ~solid
    weights = torch.where(p2g_mask, accn[0], 0.0)
    mom = torch.where(p2g_mask[None], accn[1:4], 0.0)
    occ = torch.where(~solid, accn[0], 0.0)
    return weights, mom, occ


def gather_fields(fields: torch.Tensor, bound: int, wall: int) -> torch.Tensor:
    """K2's (4, N, N, N) input from channel-major cell fields (C<=3, N,N,N):
    the fields zeroed outside ``|c| <= wall`` (missing channels zero), then
    that mask itself."""
    c = fields.shape[0]
    within = _box_within(bound, wall, fields.device)
    chans = [torch.where(within, fields[d], 0.0) for d in range(c)]
    chans += [torch.zeros_like(within, dtype=fields.dtype)] * (3 - c)
    chans.append(within.to(fields.dtype))
    return torch.stack(chans, dim=0)


def g2p(w27t: torch.Tensor, flat_s: torch.Tensor, fields: torch.Tensor,
        bound: int, wall: int, fused_table: bool = True) -> torch.Tensor:
    """Weighted 27-point gather of channel-major cell fields (C<=3, N,N,N),
    normalised over the cells within ``|c| <= wall``: K2 on the masked
    fields plus the mask, then ``sum w*f / sum w`` (0 where the sum is 0).
    ``fused_table=False``: K7b's neighbourhood table, then K7a (the
    counterpart of ``g2p_pallas(fused_table=False)``); the same result to
    the bit.  Returns (P, C)."""
    c = fields.shape[0]
    fm = gather_fields(fields, bound, wall)
    if fused_table:
        out = g2p_gather(fm, w27t, flat_s)
    else:
        out = g2p_gather_table(shift_expand(fm), w27t, flat_s)
    num = out[:c].T
    den = out[3]
    nz = den != 0
    safe = torch.where(nz, den, 1.0)
    return torch.where(nz[:, None], num / safe[:, None], 0.0)
