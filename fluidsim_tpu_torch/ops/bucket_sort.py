"""Window-grouped bucket sort — the counterpart of
``fluidsim_tpu/ops/bucket_sort.py`` (``bucket_by_window``,
``bucket_or_sort``), with its row move (K5) as the CUDA kernel
``fs_bucket_move`` (``csrc/bucket.cu``).

The particle state is kept in the previous frame's order, and the CFL bound
moves a particle at most about one cell a frame, so a T-row chunk of that
order holds only a few distinct W-cell windows.  Grouping the rows by window
then takes

  1. a stable sort of each T-row chunk by key;
  2. the window runs of each sorted chunk, at most ``rmax`` per chunk;
  3. the run descriptors sorted by (window, chunk) with a stable sort and
     placed by an exclusive cumsum of their counts, so the output is the
     runs concatenated in (window, chunk) order;
  4. at most ``emax`` runs meeting each ``to``-row output block;
  5. the move of the rows (K5), block by block.

Steps 1-4 are PyTorch on the device; if a cap of step 2 or 4 trips, ``ok``
is False and ``bucket_or_sort`` takes the full stable sort instead (a host
``if``, counted in ``bucket_or_sort.fallbacks``), and K5 does not launch.

Within a window the rows of one key keep their input order (the chunk sort
is stable and the runs of one window are placed in chunk order), so every
key's rows come out in the order the full stable sort gives them; only the
keys inside a window are not sorted.

The JAX package parks the tail padding of the last chunk in window class
``2**16`` with ``minimum(win, 1 << 16)``, which also merges every real
window at or past ``2**16`` into that class; the port raises a
``ValueError`` for such keys instead.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch import native

PAD_KEY = 2 ** 30 - 1     # key of the tail-padding rows of the last chunk
DEAD_DST = 2 ** 30        # destination of the dead (zero-count) descriptors
MAX_WINDOWS = 1 << 16     # window class of the padding; real windows below
# K5's limits: a block's table fills at most 48 KB of shared memory, and an
# output block at most 65,535 thread blocks of 256 rows
MAX_EMAX = 4096
MAX_TO = 65535 * 256


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def bucket_plan(flat: torch.Tensor, cols: torch.Tensor, t: int = 512,
                w: int = 512, rmax: int = 8, emax: int = 8, to: int = 1024):
    """Steps 1-4: the chunk-sorted keys and payload and K5's per-block run
    table.

    ``flat``: (P,) int32 keys, ``0 <= key < w * 2**16``; ``cols``: (NC, P)
    f32 payload.  Returns ``(key_s, pay_s, tbl, stats)``: the keys and
    payload padded to a multiple of ``t`` rows (padding key ``PAD_KEY``,
    payload 0) and stably sorted within each ``t``-row chunk, (TC,) and
    (NC, TC); ``tbl`` (TC_out / to, 3, emax) int32, the (dst, src, cnt)
    rows of the runs meeting each output block, dead entries with dst
    ``DEAD_DST``; and ``stats``, (3,) int32 on the device: the most runs in
    a chunk, the most runs meeting an output block (meaningful only when
    the first is at most ``rmax``) and the largest window of ``flat``.  The
    plan holds when ``caps_hold(stats, rmax, emax)``."""
    dev = flat.device
    p, nc = flat.shape[0], cols.shape[0]
    tc = _ceil_to(p, t)
    nchunk = tc // t
    nout = _ceil_to(tc, to) // to
    i32 = dict(dtype=torch.int32, device=dev)

    key = torch.cat([flat, torch.full((tc - p,), PAD_KEY, **i32)])
    pay = torch.cat([cols, cols.new_zeros((nc, tc - p))], dim=1)

    # 1. stable sort of each chunk
    key_s, idx = torch.sort(key.reshape(nchunk, t), dim=1, stable=True)
    pay_s = torch.gather(pay.reshape(nc, nchunk, t), 2,
                         idx[None].expand(nc, nchunk, t)).reshape(nc, tc)
    win = key_s // w                                          # (C, T)

    # 2. runs of equal window in each sorted chunk
    newrun = torch.ones((nchunk, t), dtype=torch.bool, device=dev)
    newrun[:, 1:] = win[:, 1:] != win[:, :-1]
    ridx = torch.cumsum(newrun, dim=1, dtype=torch.int32) - 1
    rcount = ridx[:, -1] + 1
    # run tables (C, rmax): the window and first row of each run, as a min
    # over the run starts of each slot (runs past rmax share the last one)
    rr = torch.clamp(ridx, max=rmax - 1).to(torch.int64)
    q = torch.arange(t, **i32).expand(nchunk, t)
    win_cr = torch.full((nchunk, rmax), PAD_KEY, **i32).scatter_reduce(
        1, rr, torch.where(newrun, win, PAD_KEY), "amin")
    start_cr = torch.full((nchunk, rmax), t, **i32).scatter_reduce(
        1, rr, torch.where(newrun, q, t), "amin")
    nextstart = torch.cat([start_cr[:, 1:],
                           torch.full((nchunk, 1), t, **i32)], dim=1)
    live = torch.arange(rmax, device=dev)[None, :] < rcount[:, None]
    count_cr = torch.where(live, nextstart - start_cr, 0)

    # 3. place the runs by (window, chunk): the padding run in class 2^16,
    # the dead slots one past it, so they sort after every live row
    src = torch.arange(nchunk, **i32)[:, None] * t + start_cr
    wkey = torch.where(win_cr == PAD_KEY, MAX_WINDOWS + 1,
                       torch.clamp(win_cr, max=MAX_WINDOWS)).to(torch.int64)
    chunk = torch.arange(nchunk, device=dev)[:, None].expand(nchunk, rmax)
    order = torch.sort((wkey * nchunk + chunk).reshape(-1), stable=True)[1]
    src_p = src.reshape(-1)[order]
    cnt_p = count_cr.reshape(-1)[order]
    dst_p = torch.cumsum(cnt_p, 0, dtype=torch.int32) - cnt_p
    dst_p = torch.where(cnt_p > 0, dst_p, DEAD_DST)

    # 4. the runs meeting each output block, at most emax
    edges = torch.arange(nout, **i32) * to
    lo = torch.clamp(torch.searchsorted(dst_p, edges, right=True,
                                        out_int32=True) - 1, min=0)
    hi = torch.searchsorted(dst_p, edges + to, out_int32=True)
    stats = torch.stack([torch.max(rcount), torch.max(hi - lo),
                         torch.max(flat) // w])
    dst_p = torch.cat([dst_p, torch.full((emax,), DEAD_DST, **i32)])
    src_p = torch.cat([src_p, torch.zeros((emax,), **i32)])
    cnt_p = torch.cat([cnt_p, torch.zeros((emax,), **i32)])
    sl = lo[:, None] + torch.arange(emax, **i32)[None, :]
    tbl = torch.stack([dst_p[sl], src_p[sl], cnt_p[sl]], dim=1).contiguous()
    return key_s.reshape(tc), pay_s, tbl, stats


def caps_hold(stats, rmax: int = 8, emax: int = 8) -> bool:
    """Whether a plan's ``stats`` (host values) fit the caps."""
    return stats[0] <= rmax and stats[1] <= emax


# ---- K5: the row move ------------------------------------------------------

def move_permutation(tbl: torch.Tensor, p: int, to: int) -> torch.Tensor:
    """The (P,) int64 source row of each of the first ``p`` output rows of
    K5: every (block, run) entry of ``tbl`` expanded into the rows it covers
    with ``repeat_interleave``."""
    base = (torch.arange(tbl.shape[0], device=tbl.device) * to)[:, None]
    dst, src, cnt = (tbl[:, i].to(torch.int64) for i in range(3))
    a = torch.clamp(dst - base, min=0)
    length = torch.clamp(torch.clamp(dst + cnt - base, max=to) - a,
                         min=0).reshape(-1)
    first = torch.repeat_interleave((base + a).reshape(-1), length)
    k = torch.arange(first.shape[0], device=tbl.device)
    rows = first + k - torch.repeat_interleave(torch.cumsum(length, 0) - length,
                                               length)
    perm = torch.empty_like(rows)
    perm[rows] = rows + torch.repeat_interleave((src - dst).reshape(-1), length)
    return perm[:p]


def bucket_move_plain(key_s: torch.Tensor, pay_s: torch.Tensor,
                      tbl: torch.Tensor, p: int, to: int):
    """Plain PyTorch K5: ``index_select`` of the rows by
    ``move_permutation``.  Returns (key_out (P,), cols_out (NC, P))."""
    perm = move_permutation(tbl, p, to)
    return key_s.index_select(0, perm), pay_s.index_select(1, perm)


def bucket_move(key_s: torch.Tensor, pay_s: torch.Tensor, tbl: torch.Tensor,
                p: int, to: int):
    """K5: ``out[dst + i] = in[src + i]`` for ``i < cnt`` over the runs of
    ``tbl``, block by block, for the first ``p`` output rows: the int32 key
    column and the (NC, TC) f32 payload, bit for bit.  CUDA tensors launch
    ``fs_bucket_move`` (``csrc/bucket.cu``); CPU tensors take
    ``bucket_move_plain``.  Valid only for a table whose caps held, laid
    out as ``bucket_plan`` builds it: each block's entries in ``dst``
    order, the dead ones last."""
    if key_s.device.type == "cpu":
        return bucket_move_plain(key_s, pay_s, tbl, p, to)
    native.require_cuda(key_s, "bucket_move")
    dev = key_s.device
    tc = key_s.shape[0]
    nc = pay_s.shape[0]
    nout, _, emax = tbl.shape
    native.check_tensor("key_s", key_s, torch.int32, (tc,), dev)
    native.check_tensor("pay_s", pay_s, torch.float32, (nc, tc), dev)
    native.check_tensor("tbl", tbl, torch.int32, (nout, 3, emax), dev)
    if not p <= tc <= nout * to:
        raise ValueError(f"bucket_move: {p} rows, {tc} padded, {nout} "
                         f"blocks of {to}")
    if not (1 <= emax <= MAX_EMAX and 1 <= to <= MAX_TO):
        raise ValueError(f"bucket_move: emax {emax} (1..{MAX_EMAX}) or "
                         f"to {to} (1..{MAX_TO}) out of the kernel's range")
    key_out = torch.empty((p,), dtype=torch.int32, device=dev)
    cols_out = torch.empty((nc, p), dtype=torch.float32, device=dev)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_bucket_move(key_s.data_ptr(), pay_s.data_ptr(),
                                tbl.data_ptr(), key_out.data_ptr(),
                                cols_out.data_ptr(), nc, tc, p, nout, to, emax,
                                native.stream_ptr(dev))
    native.check_launch("bucket_move", rc)
    bucket_move.launches += 1
    return key_out, cols_out


bucket_move.launches = 0


# ---- the sorts -------------------------------------------------------------

def bucket_by_window(flat: torch.Tensor, cols: torch.Tensor, t: int = 512,
                     w: int = 512, rmax: int = 8, emax: int = 8,
                     to: int = 1024):
    """Group the rows of ``cols`` (NC, P) f32 by the window ``flat // w`` of
    their (P,) int32 keys.  Returns ``(flat_out, cols_out, ok)`` with
    ``flat_out // w`` non-decreasing and ``ok`` a Python bool; when a cap
    tripped (``ok`` False) the rows come back as given and K5 does not
    launch.  Raises ``ValueError`` for a key whose window is ``2**16`` or
    more.  Reads ``ok`` on the host."""
    key_s, pay_s, tbl, stats = bucket_plan(flat, cols, t, w, rmax, emax, to)
    stats = stats.tolist()
    if stats[2] >= MAX_WINDOWS:
        raise ValueError(f"bucket_by_window: window {stats[2]} of key width "
                         f"{w} is past the {MAX_WINDOWS} windows the sort "
                         "places")
    if not caps_hold(stats, rmax, emax):
        return flat, cols, False
    flat_out, cols_out = bucket_move(key_s, pay_s, tbl, flat.shape[0], to)
    return flat_out, cols_out, True


def bucket_or_sort(flat: torch.Tensor, cols: torch.Tensor, t: int = 512,
                   w: int = 512, rmax: int = 8, emax: int = 8,
                   to: int = 1024):
    """``bucket_by_window``, falling back to the full stable sort by key
    when a cap trips (the first frame from an arbitrary order, or a
    scramble); the fallbacks are counted in ``bucket_or_sort.fallbacks``.
    Returns ``(flat_out, cols_out)``."""
    flat_b, cols_b, ok = bucket_by_window(flat, cols, t, w, rmax, emax, to)
    if ok:
        return flat_b, cols_b
    bucket_or_sort.fallbacks += 1
    flat_s, perm = torch.sort(flat, stable=True)
    return flat_s, cols[:, perm]


bucket_or_sort.fallbacks = 0
