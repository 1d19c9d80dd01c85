"""Batched 3x3 products, determinant and cofactor matrix — the counterpart
of ``mm3``, ``mv3``, ``det3`` and ``cofactor3`` in
``fluidsim_tpu/ops/svd3.py``.

Each is unrolled into f32 elementwise operations in the reference's order,
with no ``@`` and no ``torch.linalg``: a matmul on the card could run in
TF32, and the elementwise form rounds the same on every device.  The SVD,
polar decomposition and stress of the reference module come with MPM.
"""

from __future__ import annotations

import torch


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 matmul of (..., 3, 3) tensors."""
    return torch.stack(
        [torch.stack([a[..., i, 0] * b[..., 0, j]
                      + a[..., i, 1] * b[..., 1, j]
                      + a[..., i, 2] * b[..., 2, j]
                      for j in range(3)], dim=-1)
         for i in range(3)], dim=-2)


def mv3(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3)."""
    return torch.stack([a[..., i, 0] * x[..., 0] + a[..., i, 1] * x[..., 1]
                        + a[..., i, 2] * x[..., 2] for i in range(3)], dim=-1)


def det3(f: torch.Tensor) -> torch.Tensor:
    """Batched determinant of (..., 3, 3)."""
    return (f[..., 0, 0] * (f[..., 1, 1] * f[..., 2, 2] - f[..., 1, 2] * f[..., 2, 1])
            - f[..., 0, 1] * (f[..., 1, 0] * f[..., 2, 2] - f[..., 1, 2] * f[..., 2, 0])
            + f[..., 0, 2] * (f[..., 1, 0] * f[..., 2, 1] - f[..., 1, 1] * f[..., 2, 0]))


def cofactor3(f: torch.Tensor) -> torch.Tensor:
    """The cofactor matrix of (..., 3, 3), ``det(F) F^{-T}``."""
    return torch.stack([
        torch.stack([f[..., 1, 1] * f[..., 2, 2] - f[..., 1, 2] * f[..., 2, 1],
                     f[..., 1, 2] * f[..., 2, 0] - f[..., 1, 0] * f[..., 2, 2],
                     f[..., 1, 0] * f[..., 2, 1] - f[..., 1, 1] * f[..., 2, 0]], dim=-1),
        torch.stack([f[..., 0, 2] * f[..., 2, 1] - f[..., 0, 1] * f[..., 2, 2],
                     f[..., 0, 0] * f[..., 2, 2] - f[..., 0, 2] * f[..., 2, 0],
                     f[..., 0, 1] * f[..., 2, 0] - f[..., 0, 0] * f[..., 2, 1]], dim=-1),
        torch.stack([f[..., 0, 1] * f[..., 1, 2] - f[..., 0, 2] * f[..., 1, 1],
                     f[..., 0, 2] * f[..., 1, 0] - f[..., 0, 0] * f[..., 1, 2],
                     f[..., 0, 0] * f[..., 1, 1] - f[..., 0, 1] * f[..., 1, 0]], dim=-1),
    ], dim=-2)
