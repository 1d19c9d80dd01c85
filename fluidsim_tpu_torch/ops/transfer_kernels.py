"""Sorted particle <-> grid transfers of the FLIP frame, with the P2G (K1)
and G2P (K2) kernels — the counterpart of ``fluidsim_tpu/ops/transfer_pallas.py``
(``sort_by_cell_h``, ``masked_weights_cm``, ``p2g_pallas``, ``g2p_pallas``) and
``fluidsim_tpu/ops/pallas_transfer.py`` (``scatter_wv_fused``,
``gather_wv_fused``).

Particles are sorted by the plain flat id ``(x*n + y)*n + z`` of their
clipped base cell; ``cell_start`` (n^3 + 1 offsets into the sorted arrays)
gives each cell's particle range.  The (27, P) stencil weights are computed
once per frame and shared by both directions.  The TPU path's window layout
(haloed ids, packed columns, one-hot matmuls) is not needed here.

``p2g_scatter`` and ``g2p_gather`` launch the CUDA kernels of
``csrc/transfer.cu`` for CUDA tensors and use their plain PyTorch versions
only for CPU tensors; anything else raises.  Each counts its kernel launches
in ``.launches``.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch import native
from fluidsim_tpu_torch.core.splines import cround
from fluidsim_tpu_torch.ops.transfer import _KERNELS, _OFFSETS


def sort_by_cell(pos: torch.Tensor, vel: torch.Tensor, bound: int):
    """Stable sort of particles by the flat id of their clipped base cell.

    Returns ``(pos_s, vel_s, flat_s)`` with ``flat_s`` int32.  Particles
    outside the box clip to the boundary cell; their weights vanish
    (``masked_weights_cm``).  The JAX package's haloed ids give the same
    order, and its sort is stable too, so both sort into the same sequence.
    """
    n = 2 * bound + 1
    bc = torch.clamp(cround(pos).to(torch.int32) + bound, 0, n - 1)
    flat = (bc[:, 0] * n + bc[:, 1]) * n + bc[:, 2]
    flat_s, perm = torch.sort(flat, stable=True)
    return pos[perm], vel[perm], flat_s


def cell_starts(flat_s: torch.Tensor, n: int) -> torch.Tensor:
    """(n^3 + 1,) int32: first sorted index of every cell id, plus P."""
    ids = torch.arange(n ** 3 + 1, dtype=torch.int32, device=flat_s.device)
    return torch.searchsorted(flat_s, ids, out_int32=True)


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
    """result[j] = a[j - d] over the leading three axes, zero-padded."""
    out = torch.zeros_like(a)
    src, dst = [], []
    for s, n_ax in zip(d, a.shape[:3]):
        s = int(s)
        src.append(slice(max(-s, 0), n_ax - max(s, 0)))
        dst.append(slice(max(s, 0), n_ax - max(-s, 0)))
    out[tuple(dst)] = a[tuple(src)]
    return out


# ---- K1: P2G scatter ------------------------------------------------------

def p2g_scatter_plain(w27t: torch.Tensor, vel_s: torch.Tensor,
                      cell_start: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch K1: one ``index_add_`` of the 27x4 per-particle values
    onto the base cell, then 27 shifted adds (the schedule of
    ``transfer_fast.p2g_fused``).  Returns (4, n, n, n)."""
    counts = (cell_start[1:] - cell_start[:-1]).to(torch.int64)
    flat = torch.repeat_interleave(
        torch.arange(n ** 3, device=w27t.device), counts)
    u = torch.cat([w27t.T[..., None], w27t.T[..., None] * vel_s[:, None, :]],
                  dim=-1)                                      # (P, 27, 4)
    d = torch.zeros((n ** 3, 27 * 4), dtype=w27t.dtype, device=w27t.device)
    d.index_add_(0, flat, u.reshape(-1, 27 * 4))
    d = d.reshape(n, n, n, 27, 4)
    acc = torch.zeros((n, n, n, 4), dtype=w27t.dtype, device=w27t.device)
    for o in range(27):
        acc = acc + _shift3(d[..., o, :], _OFFSETS[o])
    return acc.permute(3, 0, 1, 2).contiguous()


def p2g_scatter(w27t: torch.Tensor, vel_s: torch.Tensor,
                cell_start: torch.Tensor, n: int) -> torch.Tensor:
    """K1: ``out[g, c] = sum_o sum_{p: base(p) = c - off_o} w27t[o, p] *
    [1, v_p][g]`` over sorted particles, dropping contributions outside the
    box.  (4, n, n, n) f32.  CUDA tensors launch ``fs_p2g_scatter``
    (``csrc/transfer.cu``); CPU tensors take ``p2g_scatter_plain``."""
    if w27t.device.type == "cpu":
        return p2g_scatter_plain(w27t, vel_s, cell_start, n)
    native.require_cuda(w27t, "p2g_scatter")
    dev = w27t.device
    p = vel_s.shape[0]
    native.check_tensor("w27t", w27t, torch.float32, (27, p), dev)
    native.check_tensor("vel_s", vel_s, torch.float32, (p, 3), dev)
    native.check_tensor("cell_start", cell_start, torch.int32, (n ** 3 + 1,), dev)
    if p >= 2 ** 31:
        raise ValueError("p2g_scatter: more than 2^31 - 1 particles")
    out = torch.empty((4, n, n, n), dtype=torch.float32, device=dev)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_p2g_scatter(w27t.data_ptr(), vel_s.data_ptr(),
                                cell_start.data_ptr(), out.data_ptr(), n, p,
                                native.stream_ptr(dev))
    native.check_launch("p2g_scatter", rc)
    p2g_scatter.launches += 1
    return out


p2g_scatter.launches = 0


# ---- K2: G2P gather -------------------------------------------------------

def g2p_gather_plain(fm: torch.Tensor, w27t: torch.Tensor,
                     flat_s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: 27 masked gathers of the 4 channels.  (4, P)."""
    n = fm.shape[1]
    bc = torch.stack([flat_s // (n * n), (flat_s // n) % n, flat_s % n], -1)
    fm_flat = fm.reshape(4, -1)
    out = torch.zeros((4, flat_s.shape[0]), dtype=fm.dtype, device=fm.device)
    for o in range(27):
        cell = bc + torch.as_tensor(_OFFSETS[o], device=fm.device)
        inb = torch.all((cell >= 0) & (cell < n), dim=-1)
        ids = ((cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]).clamp(0, n ** 3 - 1)
        vals = torch.where(inb[None], fm_flat[:, ids], 0.0)
        out = out + w27t[o][None] * vals
    return out


def g2p_gather(fm: torch.Tensor, w27t: torch.Tensor,
               flat_s: torch.Tensor) -> torch.Tensor:
    """K2: ``out[c, p] = sum_o w27t[o, p] * fm[c, base(p) + off_o]`` with
    neighbours outside the box reading 0; ``fm`` is (4, n, n, n).  (4, P)
    f32.  CUDA tensors launch ``fs_g2p_gather`` (``csrc/transfer.cu``); CPU
    tensors take ``g2p_gather_plain``."""
    if fm.device.type == "cpu":
        return g2p_gather_plain(fm, w27t, flat_s)
    native.require_cuda(fm, "g2p_gather")
    dev = fm.device
    n = fm.shape[1]
    p = flat_s.shape[0]
    native.check_tensor("fm", fm, torch.float32, (4, n, n, n), dev)
    native.check_tensor("w27t", w27t, torch.float32, (27, p), dev)
    native.check_tensor("flat_s", flat_s, torch.int32, (p,), dev)
    out = torch.empty((4, p), dtype=torch.float32, device=dev)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_g2p_gather(fm.data_ptr(), w27t.data_ptr(),
                               flat_s.data_ptr(), out.data_ptr(), n, p,
                               native.stream_ptr(dev))
    native.check_launch("g2p_gather", rc)
    g2p_gather.launches += 1
    return out


g2p_gather.launches = 0


# ---- the transfers around the kernels -------------------------------------

def _box_within(bound: int, m: int, device) -> torch.Tensor:
    """(N,N,N) bool: True where ``|c| <= m`` on all three axes."""
    ok = torch.arange(-bound, bound + 1, device=device).abs() <= m
    return ok[:, None, None] & ok[None, :, None] & ok[None, None, :]


def p2g(w27t: torch.Tensor, vel_s: torch.Tensor, cell_start: torch.Tensor,
        solid: torch.Tensor, bound: int):
    """Full P2G: K1, then the reference's target-cell masks.

    Weights and momentum keep cells within ``bound - 2`` that are not solid;
    occupancy keeps every non-solid cell.  Returns ``weights`` (N,N,N),
    channel-major ``mom`` (3,N,N,N) and ``occ`` (N,N,N)."""
    n = 2 * bound + 1
    accn = p2g_scatter(w27t, vel_s, cell_start, n)
    p2g_mask = _box_within(bound, bound - 2, w27t.device) & ~solid
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
        bound: int, wall: int) -> torch.Tensor:
    """Weighted 27-point gather of channel-major cell fields (C<=3, N,N,N),
    normalised over the cells within ``|c| <= wall``: K2 on the masked
    fields plus the mask, then ``sum w*f / sum w`` (0 where the sum is 0).
    Returns (P, C)."""
    c = fields.shape[0]
    out = g2p_gather(gather_fields(fields, bound, wall), w27t, flat_s)
    num = out[:c].T
    den = out[3]
    nz = den != 0
    safe = torch.where(nz, den, 1.0)
    return torch.where(nz[:, None], num / safe[:, None], 0.0)
