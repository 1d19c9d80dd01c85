"""The unhaloed shift entry points — the counterpart of
``fluidsim_tpu/ops/pallas_shift.py``'s ``p2g_shift_reduce`` (K10a),
``g2p_table_expand`` (K10b), ``to_channel_major`` (K10c) and
``from_channel_major`` (K10d), with the JAX shapes.

K10a and K10b are K6b's and K7b's functions on the (n^3, 108) row layout
(column ``4o + g``), each one kernel on the rows with no transpose:
``fs_shift_reduce_rows`` and ``fs_shift_expand_rows`` (``csrc/stencil.cu``).
Every cell is computed, for every n: the JAX functions pad the lanes to a
multiple of 128 but launch 512-lane blocks, and leave lanes past the last
whole block unwritten when n^2 rounded up to 128 is not a multiple of 512
(n = 25: lanes 512-624 of every x row).

Each function launches its kernels for CUDA tensors and takes its plain
PyTorch version only for CPU tensors; anything else raises.  Each counts its
launches in ``.launches``.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch import native
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.transfer import _OFFSETS


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _transpose_pad(name: str, src: torch.Tensor, rows: int, cols: int,
                   ld: int, rows_pad: int) -> torch.Tensor:
    """(cols, rows_pad) f32: ``out[c, r] = src[r, c]`` for the (rows, cols)
    matrix whose rows start ``ld`` apart in ``src``, zero for r >= rows."""
    dev = src.device
    out = torch.empty((cols, rows_pad), dtype=torch.float32, device=dev)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_transpose_pad(src.data_ptr(), out.data_ptr(), rows, cols,
                                  ld, rows_pad, native.stream_ptr(dev))
    native.check_launch(name, rc)
    return out


# ---- K10c, K10d: the tiled transposes --------------------------------------

def to_channel_major_plain(x: torch.Tensor, r: int = 2048) -> torch.Tensor:
    """Plain PyTorch K10c: zero rows up to a multiple of ``r``, then the
    transpose.  (n3, C) -> (C, n3p)."""
    n3 = x.shape[0]
    return torch.nn.functional.pad(x, (0, 0, 0, _ceil_to(n3, r) - n3)).T.contiguous()


def to_channel_major(x: torch.Tensor, r: int = 2048) -> torch.Tensor:
    """K10c: (n3, C) -> (C, n3p), ``n3p`` the multiple of ``r`` at or past
    n3, the columns past n3 zero.  CUDA tensors launch ``fs_transpose_pad``
    (``csrc/layout.cu``), bitwise equal to ``to_channel_major_plain``,
    which CPU tensors take."""
    if x.device.type == "cpu":
        return to_channel_major_plain(x, r)
    native.require_cuda(x, "to_channel_major")
    n3, c = x.shape
    native.check_tensor("x", x, torch.float32, (n3, c), x.device)
    out = _transpose_pad("to_channel_major", x, n3, c, c, _ceil_to(n3, r))
    to_channel_major.launches += 1
    return out


to_channel_major.launches = 0


def _check_padded(y: torch.Tensor, n3: int, r: int):
    n3p = y.shape[1]
    if n3p % r or not 0 <= n3 <= n3p:
        raise ValueError(f"from_channel_major: {n3p} columns for n3 = {n3} "
                         f"and r = {r}")


def from_channel_major_plain(y: torch.Tensor, n3: int,
                             r: int = 2048) -> torch.Tensor:
    """Plain PyTorch K10d: the transpose of the first n3 columns.
    (C, n3p) -> (n3, C)."""
    _check_padded(y, n3, r)
    return y[:, :n3].T.contiguous()


def from_channel_major(y: torch.Tensor, n3: int, r: int = 2048) -> torch.Tensor:
    """K10d, the inverse of ``to_channel_major``: (C, n3p) -> (n3, C).
    CUDA tensors launch ``fs_transpose_pad`` (``csrc/layout.cu``), bitwise
    equal to ``from_channel_major_plain``, which CPU tensors take."""
    if y.device.type == "cpu":
        return from_channel_major_plain(y, n3, r)
    native.require_cuda(y, "from_channel_major")
    c, n3p = y.shape
    native.check_tensor("y", y, torch.float32, (c, n3p), y.device)
    _check_padded(y, n3, r)
    out = _transpose_pad("from_channel_major", y, c, n3, n3p, c)
    from_channel_major.launches += 1
    return out


from_channel_major.launches = 0


# ---- K10a, K10b: the 27-offset stencils on the row layout ------------------

def _check_rows(name: str, t: torch.Tensor, shape: tuple):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def p2g_shift_reduce_plain(d: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch K10a: ``p2g_shift_reduce`` through the plain versions
    of the transposes and K6b.  (n^3, 108) -> (n, n, n, 4)."""
    _check_rows("p2g_shift_reduce", d, (n ** 3, 108))
    acc = tk.shift_reduce_plain(to_channel_major_plain(d, 1).view(27, 4, n, n, n))
    return from_channel_major_plain(acc.view(4, n ** 3), n ** 3, 1).view(n, n, n, 4)


def _shift_lead3(a: torch.Tensor, d) -> torch.Tensor:
    """result[j, ...] = a[j - d, ...] over the first three axes, zero-padded
    (``transfer_kernels._shift3`` on the leading axes)."""
    out = torch.zeros_like(a)
    src, dst = [], []
    for s, n_ax in zip(d, a.shape[:3]):
        s = int(s)
        src.append(slice(max(-s, 0), n_ax - max(s, 0)))
        dst.append(slice(max(s, 0), n_ax - max(-s, 0)))
    out[tuple(dst)] = a[tuple(src)]
    return out


def p2g_shift_reduce_rows_plain(d: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch K10a on the rows, with no transpose: 27 zero-padded
    shifted adds of the column blocks ``4o .. 4o + 3`` of the (n, n, n, 108)
    view, in offset order from zero — the kernel's order.
    (n^3, 108) -> (n, n, n, 4)."""
    _check_rows("p2g_shift_reduce", d, (n ** 3, 108))
    rows = d.view(n, n, n, 108)
    acc = torch.zeros((n, n, n, 4), dtype=d.dtype, device=d.device)
    for o in range(27):
        acc = acc + _shift_lead3(rows[..., 4 * o:4 * o + 4], _OFFSETS[o])
    return acc


def p2g_shift_reduce(d: torch.Tensor, n: int) -> torch.Tensor:
    """K10a: ``acc[cell, g] = sum_o d[cell - off_o, 4o + g]`` over the 27
    offsets in order, sources outside the box adding 0; ``d`` is (n^3, 108).
    (n, n, n, 4) f32.  CUDA tensors launch ``fs_shift_reduce_rows``
    (``csrc/stencil.cu``), bitwise equal to ``p2g_shift_reduce_rows_plain``
    and ``p2g_shift_reduce_plain``; CPU tensors take
    ``p2g_shift_reduce_plain``."""
    if d.device.type == "cpu":
        return p2g_shift_reduce_plain(d, n)
    native.require_cuda(d, "p2g_shift_reduce")
    native.check_tensor("d", d, torch.float32, (n ** 3, 108), d.device)
    out = torch.empty((n, n, n, 4), dtype=torch.float32, device=d.device)
    lib = native.library()
    with torch.cuda.device(d.device):
        rc = lib.fs_shift_reduce_rows(d.data_ptr(), out.data_ptr(), n,
                                      native.stream_ptr(d.device))
    native.check_launch("p2g_shift_reduce", rc)
    p2g_shift_reduce.launches += 1
    return out


p2g_shift_reduce.launches = 0


def g2p_table_expand_plain(fm: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch K10b: ``g2p_table_expand`` through the plain versions
    of the transposes and K7b.  (n, n, n, 4) -> (n^3, 108)."""
    _check_rows("g2p_table_expand", fm, (n, n, n, 4))
    fm_cm = to_channel_major_plain(fm.reshape(n ** 3, 4), 1).view(4, n, n, n)
    return from_channel_major_plain(tk.shift_expand_plain(fm_cm).view(108, n ** 3),
                                    n ** 3, 1)


def g2p_table_expand_rows_plain(fm: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch K10b on the rows, with no transpose: 27 zero-padded
    shifted copies of ``fm`` into the column blocks ``4o .. 4o + 3`` of the
    (n, n, n, 108) view, in offset order — the kernel's function.
    (n, n, n, 4) -> (n^3, 108)."""
    _check_rows("g2p_table_expand", fm, (n, n, n, 4))
    rows = torch.empty((n, n, n, 108), dtype=fm.dtype, device=fm.device)
    for o in range(27):
        rows[..., 4 * o:4 * o + 4] = _shift_lead3(fm, -_OFFSETS[o])
    return rows.view(n ** 3, 108)


def g2p_table_expand(fm: torch.Tensor, n: int) -> torch.Tensor:
    """K10b: ``table[cell, 4o + g] = fm[cell + off_o, g]``, 0 where that
    neighbour is outside the box; ``fm`` is (n, n, n, 4).  (n^3, 108) f32.
    CUDA tensors launch ``fs_shift_expand_rows`` (``csrc/stencil.cu``),
    bitwise equal to ``g2p_table_expand_rows_plain`` and
    ``g2p_table_expand_plain``; CPU tensors take
    ``g2p_table_expand_plain``."""
    if fm.device.type == "cpu":
        return g2p_table_expand_plain(fm, n)
    native.require_cuda(fm, "g2p_table_expand")
    native.check_tensor("fm", fm, torch.float32, (n, n, n, 4), fm.device)
    out = torch.empty((n ** 3, 108), dtype=torch.float32, device=fm.device)
    lib = native.library()
    with torch.cuda.device(fm.device):
        rc = lib.fs_shift_expand_rows(fm.data_ptr(), out.data_ptr(), n,
                                      native.stream_ptr(fm.device))
    native.check_launch("g2p_table_expand", rc)
    g2p_table_expand.launches += 1
    return out


g2p_table_expand.launches = 0
