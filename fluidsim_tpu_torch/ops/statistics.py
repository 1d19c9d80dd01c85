"""Grid statistics and histograms — the counterpart of
``fluidsim_tpu/ops/statistics.py`` (``openvdb/math/Stats.h`` +
``openvdb/tools/Statistics.h``): population statistics (``math::Stats``,
``Stats.h:208``) and fixed-range histograms (``math::Histogram``,
``Stats.h:305``) as masked reductions on the tensors' device, with no
read of the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Stats", "stats", "histogram", "extrema", "op_stats"]


class Stats(NamedTuple):
    """Population statistics of the sampled values (``math::Stats``),
    0-d float32 tensors and an int32 ``count``."""
    min: torch.Tensor
    max: torch.Tensor
    mean: torch.Tensor
    variance: torch.Tensor  # population variance, like Stats::variance()
    std: torch.Tensor
    count: torch.Tensor


def stats(values, mask=None) -> Stats:
    """One-pass moment statistics over (optionally masked) grid values.

    ``mask=None`` reduces over every cell.  Empty selections return zeros
    (min/max of an empty OpenVDB iterator are undefined; pinned to 0).
    """
    v = torch.as_tensor(values)
    f32 = torch.float32
    if mask is None:
        n = torch.tensor(float(v.numel()), dtype=f32, device=v.device)
        s = torch.sum(v, dtype=f32)
        s2 = torch.sum((v * v).to(f32))
        vmin, vmax = torch.amin(v), torch.amax(v)
    else:
        m = mask.to(torch.bool)
        n = torch.sum(m, dtype=f32)
        s = torch.sum(torch.where(m, v, 0), dtype=f32)
        s2 = torch.sum(torch.where(m, v * v, 0).to(f32))
        big = torch.finfo(torch.float32).max
        vmin = torch.amin(torch.where(m, v, big))
        vmax = torch.amax(torch.where(m, v, -big))
    safe_n = torch.clamp(n, min=1.0)
    mean = s / safe_n
    var = torch.clamp(s2 / safe_n - mean * mean, min=0.0)
    empty = n == 0
    z = torch.zeros((), dtype=f32, device=v.device)
    return Stats(
        min=torch.where(empty, z, vmin.to(f32)),
        max=torch.where(empty, z, vmax.to(f32)),
        mean=torch.where(empty, z, mean),
        variance=torch.where(empty, z, var),
        std=torch.where(empty, z, torch.sqrt(var)),
        count=n.to(torch.int32),
    )


def extrema(values, mask=None):
    """(min, max) only — ``math::Extrema`` / ``tools::extrema``."""
    s = stats(values, mask)
    return s.min, s.max


def histogram(values, bins: int, vmin: float, vmax: float, mask=None):
    """Fixed-range histogram (``math::Histogram``, ``Stats.h:305``).

    Values outside ``[vmin, vmax]`` are dropped, like Histogram::add.
    Returns int32 counts of shape ``(bins,)``: an integer scatter-add,
    the same on every run.
    """
    v = torch.as_tensor(values).reshape(-1).to(torch.float32)
    keep = (v >= vmin) & (v <= vmax)
    if mask is not None:
        keep = keep & mask.to(torch.bool).reshape(-1)
    width = (vmax - vmin) / bins
    idx = torch.clamp(((v - vmin) / width).to(torch.int32), 0, bins - 1)
    out = torch.zeros((bins,), dtype=torch.int32, device=v.device)
    return out.index_add_(0, idx, keep.to(torch.int32))


def op_stats(values, op, mask=None, **op_kwargs) -> Stats:
    """Statistics of an operator applied to a grid (``tools::opStatistics``,
    e.g. gradient-magnitude stats); ``op`` is any function of
    :mod:`fluidsim_tpu_torch.ops.gridops`."""
    return stats(op(values, **op_kwargs), mask)
