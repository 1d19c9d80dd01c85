"""Quadratic-support B-spline transfer kernels and C-style rounding — the
PyTorch counterpart of ``fluidsim_tpu/core/splines.py``.

The FLIP kernel is ``1.5 * B(|x|)`` and the MPM kernel ``B(|x - 0.5|)``,
where ``B`` is the cubic B-spline compressed to support ``|x| < 1``.  The
f32 operations and their order match the JAX functions, so values agree
bit for bit on the same inputs.
"""

from __future__ import annotations

import torch


def bspline_base(a: torch.Tensor) -> torch.Tensor:
    """Base kernel piece for ``a = |arg| >= 0`` (support ``a < 1``):
    ``a < 0.5 -> 4a^3 - 4a^2 + 2/3``; ``a < 1 -> -(4/3)a^3 + 4a^2 - 4a + 4/3``."""
    a2 = a * a
    a3 = a2 * a
    inner = 4.0 * a3 - 4.0 * a2 + 2.0 / 3.0
    outer = -4.0 / 3.0 * a3 + 4.0 * a2 - 4.0 * a + 4.0 / 3.0
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.where(a < 0.5, inner, torch.where(a < 1.0, outer, zero))


def spline_flip(x: torch.Tensor) -> torch.Tensor:
    """FLIP transfer weight: ``1.5 * bspline_base(|x|)``."""
    return 1.5 * bspline_base(torch.abs(x))


def spline_mpm(x: torch.Tensor) -> torch.Tensor:
    """MPM transfer weight: ``bspline_base(|x - 0.5|)``."""
    return bspline_base(torch.abs(x - 0.5))


def cround(x: torch.Tensor) -> torch.Tensor:
    """C ``round()``: half away from zero.  ``torch.round`` rounds half to
    even and would move base cells at .5 coordinates."""
    return torch.where(x >= 0, torch.floor(x + 0.5), -torch.floor(-x + 0.5))


def cround_out(x: torch.Tensor) -> torch.Tensor:
    """MPM advection rounding: ceil for positive values, floor otherwise."""
    return torch.where(x > 0, torch.ceil(x), torch.floor(x))
