"""Quadratic-support B-spline transfer kernels and C-style rounding — the
PyTorch counterpart of ``fluidsim_tpu/core/splines.py``.

The FLIP kernel is ``1.5 * B(|x|)`` and the MPM kernel ``B(|x - 0.5|)``,
where ``B`` is the cubic B-spline compressed to support ``|x| < 1``;
``spline2`` is ``B(|x|)`` itself and ``dspline2`` its signed derivative,
from which ``grad_w_mpm`` builds the MPM weight gradients.  The f32
operations and their order match the JAX functions, so values agree bit
for bit on the same inputs.
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


def spline2(x: torch.Tensor) -> torch.Tensor:
    """Unshifted, unscaled base kernel ``bspline_base(|x|)``."""
    return bspline_base(torch.abs(x))


def dspline2(x: torch.Tensor) -> torch.Tensor:
    """Signed derivative of ``spline2``: ``sign(x)`` times ``12a^2 - 8a``
    for ``a = |x| < 0.5``, ``-4a^2 + 8a - 4`` for ``a <= 1``, else 0
    (``torch.sign(0) == 0``, as ``jnp.sign``)."""
    a = torch.abs(x)
    a2 = a * a
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    mag = torch.where(a < 0.5, 12.0 * a2 - 8.0 * a,
                      torch.where(a <= 1.0, -4.0 * a2 + 8.0 * a - 4.0, zero))
    return torch.sign(x) * mag


def grad_w_mpm(delta: torch.Tensor):
    """MPM weight and its gradient with respect to the grid node, from
    ``delta = p - c`` (..., 3): per axis ``spline2(delta_d - 0.5)`` and
    ``-dspline2(delta_d - 0.5)``.  Returns ``(w (...,), grad (..., 3))``."""
    s = delta - 0.5
    wd = spline2(s)
    gd = -dspline2(s)
    w = wd[..., 0] * wd[..., 1] * wd[..., 2]
    gx = gd[..., 0] * wd[..., 1] * wd[..., 2]
    gy = wd[..., 0] * gd[..., 1] * wd[..., 2]
    gz = wd[..., 0] * wd[..., 1] * gd[..., 2]
    return w, torch.stack([gx, gy, gz], dim=-1)


def cround(x: torch.Tensor) -> torch.Tensor:
    """C ``round()``: half away from zero.  ``torch.round`` rounds half to
    even and would move base cells at .5 coordinates."""
    return torch.where(x >= 0, torch.floor(x + 0.5), -torch.floor(-x + 0.5))


def cround_out(x: torch.Tensor) -> torch.Tensor:
    """MPM advection rounding: ceil for positive values, floor otherwise."""
    return torch.where(x > 0, torch.ceil(x), torch.floor(x))
