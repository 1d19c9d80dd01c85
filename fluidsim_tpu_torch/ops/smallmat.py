"""Unrolled per-particle small-matrix contractions — the counterpart of
``apply_mat27`` and ``outer_sum27`` in ``fluidsim_tpu/ops/smallmat.py``.
The 3-sized dimensions are unrolled into elementwise products, so no
batched matmul (and no TF32) is involved.  Only the plain versions of the
MPM force scatter and gradW gather use them."""

from __future__ import annotations

import torch


def apply_mat27(c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(P,3,3) x (P,27,3) -> (P,27,3): per-(particle, offset) ``C @ d``,
    each row summed over j = 0, 1, 2 in order."""
    return torch.stack(
        [sum(c[:, None, i, j] * d[..., j] for j in range(3)) for i in range(3)],
        dim=-1)


def outer_sum27(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P,27,3) x (P,27,3) -> (P,3,3): ``sum_k a[:,k,i] b[:,k,j]``."""
    return torch.stack(
        [torch.stack([torch.sum(a[..., i] * b[..., j], dim=1)
                      for j in range(3)], dim=-1) for i in range(3)], dim=-2)
