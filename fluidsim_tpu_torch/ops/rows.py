"""The row layer of the particle <-> grid transfers — the counterpart of
``fluidsim_tpu/ops/pallas_transfer.py``'s ``pad_rows_with_ids``,
``attach_ids``, ``gather_rows_cm`` (K8a) and ``scatter_rows_cm`` (K8b).

Particle rows are (P_pad, 128) f32, one row of 128 lanes per particle in
sorted order, with P_pad >= P spare rows at the end; the grid side is
channel-major (128, ncells) f32, cells on the minor axis, as the stencils
(``transfer_kernels.shift_reduce``, ``shift_expand``) lay out their 108
channels.  ``flat_s`` (P,) int32 holds each row's cell id, sorted
ascending.  The JAX kernels read a row's cell from its lane 127 (an exact
f32 id) and need ``ncells % 512 == 0`` and ``ncells < 2**24``; the port
reads the ids from ``flat_s`` and has neither limit.  ``pad_rows_with_ids``
and ``attach_ids`` still write the id lane, bitwise as the JAX functions do,
so the same rows feed both packages.

``gather_rows_cm`` and ``scatter_rows_cm`` launch their CUDA kernels of
``csrc/rows.cu`` for CUDA tensors and take their plain PyTorch versions
only for CPU tensors; anything else raises.  Each counts its kernel
launches in ``.launches``.  They take none of the JAX functions' TPU
schedule arguments (``w``, ``t``, ``wc``, ``interpret``, ``precision``,
``dynamic_grid``): ``"highest"`` precision is the function, ``"split3"``
equals it, and ``"default"`` rounds the values to bf16, a TPU shortcut
that is not ported.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch import native

LANES = 128       # lanes of a row: up to 127 payload channels and the id lane


def pad_rows_with_ids(flat_s: torch.Tensor, values: torch.Tensor | None,
                      t: int, idmod: int = 0):
    """(P, C <= 127) values -> ``(rows, P_pad)``: (P_pad, 128) f32 rows with
    the values in lanes ``:C`` (zeros elsewhere and below row P), the id
    ``flat_s[p]`` (``flat_s[p] % idmod`` with ``idmod`` > 0) as f32 in lane
    127, and -1 there for the padding rows.  ``P_pad = ceil8(P) + t + 8``:
    the JAX kernels' (T+8)-row windows of a ``t``-row chunk stay in range."""
    p = flat_s.shape[0]
    p_pad = -(-p // 8) * 8 + t + 8
    out = torch.zeros((p_pad, LANES), dtype=torch.float32, device=flat_s.device)
    if values is not None:
        if values.shape[1] > LANES - 1:
            raise ValueError(f"pad_rows_with_ids: {values.shape[1]} channels, "
                             f"at most {LANES - 1}")
        out[:p, :values.shape[1]] = values
    ids = flat_s % idmod if idmod else flat_s
    out[:p, LANES - 1] = ids.to(torch.float32)
    out[p:, LANES - 1] = -1.0
    return out, p_pad


def attach_ids(values_padded: torch.Tensor, flat_s: torch.Tensor) -> torch.Tensor:
    """A copy of the (P_pad, 128) rows with the id lane set: ``flat_s`` as
    f32 in rows below P, -1 below that."""
    p = flat_s.shape[0]
    out = values_padded.clone()
    out[:p, LANES - 1] = flat_s.to(torch.float32)
    out[p:, LANES - 1] = -1.0
    return out


def _check_ids(name: str, first: int, last: int, ncells: int):
    if first < 0 or last >= ncells:
        raise ValueError(f"{name}: cell ids from {first} to {last} lie outside "
                         f"[0, {ncells})")


def _copy_end_ids(flat_s: torch.Tensor):
    """Queue a copy of the first and last sorted id into pinned host memory
    on the current stream; return the buffer and an event recorded after
    the copy.  The caller launches its kernel behind the copy and then
    waits on the event, so the check holds the host back but not the
    device.  The ids are sorted, so the two ends bound all of them."""
    ends = torch.empty(2, dtype=torch.int32, pin_memory=True)
    ends[0:1].copy_(flat_s[:1], non_blocking=True)
    ends[1:2].copy_(flat_s[-1:], non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return ends, done


def _launch(wrapper, flat_s: torch.Tensor, ncells: int, launch):
    """Run ``launch(lib, stream)`` on ``flat_s``'s device behind the copy of
    its end ids and count it in ``wrapper.launches``; raise on a launch
    error or an id outside [0, ncells).  The kernels skip such ids, so they
    never read or write out of range."""
    name = wrapper.__name__
    dev = flat_s.device
    p = flat_s.shape[0]
    lib = native.library()
    with torch.cuda.device(dev):
        ends = _copy_end_ids(flat_s) if p else None
        rc = launch(lib, native.stream_ptr(dev))
    native.check_launch(name, rc)
    wrapper.launches += 1
    if ends is not None:
        buf, done = ends
        done.synchronize()
        _check_ids(name, int(buf[0]), int(buf[1]), ncells)


def _check_common(name: str, flat_s: torch.Tensor, rows: torch.Tensor):
    dev = rows.device
    p = flat_s.shape[0]
    native.check_tensor("flat_s", flat_s, torch.int32, (p,), dev)
    if p >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 - 1 particles")
    if rows.shape[0] < p:
        raise ValueError(f"{name}: {rows.shape[0]} rows for {p} particles")
    native.check_tensor("rows", rows, torch.float32, (rows.shape[0], LANES), dev)


# ---- K8a: the channel-major row gather ---------------------------------------

def gather_rows_cm_plain(table_cm: torch.Tensor, init_rows: torch.Tensor,
                         flat_s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K8a: ``index_select`` of the table's columns, then the
    tail rows of ``init_rows``.  (P_pad, 128)."""
    p = flat_s.shape[0]
    cols = table_cm.index_select(1, flat_s.to(torch.int64)).T
    return torch.cat([cols, init_rows[p:]])


def gather_rows_cm(table_cm: torch.Tensor, init_rows: torch.Tensor,
                   flat_s: torch.Tensor) -> torch.Tensor:
    """K8a: ``out[p, c] = table_cm[c, flat_s[p]]`` for p < P on all 128
    lanes — lane 127 too, where the table's row 127 replaces the id, as in
    the JAX kernel — and ``out[p] = init_rows[p]`` for P <= p < P_pad.

    ``table_cm`` (128, ncells) f32; ``init_rows`` (P_pad, 128) f32, P_pad >=
    P (the JAX function donates it; here it is only read); ``flat_s`` (P,)
    int32, sorted ascending, every id in [0, ncells) (raises otherwise; the
    order is the caller's contract and is not checked, as in JAX).  A new
    (P_pad, 128) f32 tensor.  CUDA tensors launch ``fs_gather_rows_cm``
    (``csrc/rows.cu``); CPU tensors take ``gather_rows_cm_plain``."""
    ncells = table_cm.shape[1]
    if table_cm.device.type == "cpu":
        if flat_s.numel():
            _check_ids("gather_rows_cm", int(flat_s[0]), int(flat_s[-1]), ncells)
        return gather_rows_cm_plain(table_cm, init_rows, flat_s)
    native.require_cuda(table_cm, "gather_rows_cm")
    dev = table_cm.device
    p, p_pad = flat_s.shape[0], init_rows.shape[0]
    native.check_tensor("table_cm", table_cm, torch.float32, (LANES, ncells), dev)
    _check_common("gather_rows_cm", flat_s, init_rows)
    out = torch.empty((p_pad, LANES), dtype=torch.float32, device=dev)
    _launch(gather_rows_cm, flat_s, ncells, lambda lib, stream:
            lib.fs_gather_rows_cm(table_cm.data_ptr(), init_rows.data_ptr(),
                                  flat_s.data_ptr(), out.data_ptr(), ncells,
                                  p, p_pad, stream))
    return out


gather_rows_cm.launches = 0


# ---- K8b: the channel-major row scatter-add ---------------------------------

SCATTER_CELLS = 128   # cells per K8b tile (kScatterCells in csrc/rows.cu)


def scatter_tile_starts_plain(flat_s: torch.Tensor, ncells: int,
                              cells: int = SCATTER_CELLS) -> torch.Tensor:
    """K8b's tile plan in PyTorch: ``tile_start[t]``, the first p with
    ``flat_s[p] >= min(t * cells, ncells)`` for t = 0 .. ntiles, so tile t's
    rows are ``[tile_start[t], tile_start[t + 1])``.  (ntiles + 1,) int32,
    ``ntiles = ceil(ncells / cells)``; the kernel's first pass writes the
    same numbers (``cells``: K8b's ``SCATTER_CELLS``, or the tiles of
    another kernel's plan)."""
    ntiles = -(-ncells // cells)
    edges = torch.clamp(torch.arange(ntiles + 1, device=flat_s.device)
                        * cells, max=ncells)
    return torch.searchsorted(flat_s.to(torch.int64), edges).to(torch.int32)


def scatter_rows_cm_plain(u_rows: torch.Tensor, flat_s: torch.Tensor,
                          ncells: int) -> torch.Tensor:
    """Plain PyTorch K8b: ``index_add_`` of the rows below P onto a
    (ncells, 128) zero tensor, then the transpose.  (128, ncells)."""
    p = flat_s.shape[0]
    d = torch.zeros((ncells, LANES), dtype=torch.float32, device=u_rows.device)
    d.index_add_(0, flat_s.to(torch.int64), u_rows[:p])
    return d.T.contiguous()


def scatter_rows_cm_launch(u_rows: torch.Tensor, flat_s: torch.Tensor,
                           ncells: int):
    """Launch K8b on CUDA tensors: ``(out, tile_start)``, the tile plan the
    kernel's first pass wrote (``scatter_tile_starts_plain``'s numbers on a
    sorted order).  ``scatter_rows_cm`` returns ``out``."""
    native.require_cuda(u_rows, "scatter_rows_cm")
    dev = u_rows.device
    p = flat_s.shape[0]
    _check_common("scatter_rows_cm", flat_s, u_rows)
    if u_rows.data_ptr() % 16:
        raise ValueError("scatter_rows_cm: the rows must be 16-byte aligned "
                         "(the kernel copies them in 512-byte rows)")
    out = torch.empty((LANES, ncells), dtype=torch.float32, device=dev)
    tile_start = torch.empty((-(-ncells // SCATTER_CELLS) + 1,),
                             dtype=torch.int32, device=dev)
    _launch(scatter_rows_cm, flat_s, ncells, lambda lib, stream:
            lib.fs_scatter_rows_cm(u_rows.data_ptr(), flat_s.data_ptr(),
                                   tile_start.data_ptr(), out.data_ptr(),
                                   ncells, p, stream))
    return out, tile_start


def scatter_rows_cm(u_rows: torch.Tensor, flat_s: torch.Tensor,
                    ncells: int) -> torch.Tensor:
    """K8b: ``out[c, i] = sum_{p < P : flat_s[p] = i} u_rows[p, c]`` on all
    128 lanes, 0 for a cell with no row; each sum runs over the cell's rows
    in array order from +0.  With the id lane of ``pad_rows_with_ids`` row
    127 is then the f32 sum of the ids, as in the JAX kernel.

    ``u_rows`` (P_pad, 128) f32, P_pad >= P (rows past P are ignored);
    ``flat_s`` (P,) int32, sorted ascending, every id in [0, ncells)
    (raises otherwise; the order is the caller's contract, as in JAX: on
    another order the result is undefined, but the kernel stays inside the
    arrays).  (128, ncells) f32.  CUDA tensors launch
    ``fs_scatter_rows_cm`` (``csrc/rows.cu``: the tile plan, then one block
    per 128-cell tile); CPU tensors take ``scatter_rows_cm_plain``."""
    if u_rows.device.type == "cpu":
        if flat_s.numel():
            _check_ids("scatter_rows_cm", int(flat_s[0]), int(flat_s[-1]), ncells)
        return scatter_rows_cm_plain(u_rows, flat_s, ncells)
    return scatter_rows_cm_launch(u_rows, flat_s, ncells)[0]


scatter_rows_cm.launches = 0
