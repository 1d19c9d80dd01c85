"""Transfer constants and the grid-velocity normalisation — the counterpart
of ``fluidsim_tpu/ops/transfer.py`` (``_OFFSETS``, ``_KERNELS``,
``normalize_velocity_cm``).  The sorted transfers themselves are in
``ops.transfer_kernels``."""

from __future__ import annotations

import numpy as np
import torch

from fluidsim_tpu_torch.core.splines import spline_flip, spline_mpm

# 27 stencil offsets, x-major: offset o is (o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1).
_OFFSETS = np.array([(i, j, k)
                     for i in (-1, 0, 1)
                     for j in (-1, 0, 1)
                     for k in (-1, 0, 1)], dtype=np.int32)

_KERNELS = {"flip": spline_flip, "mpm": spline_mpm}


def normalize_velocity_cm(weights: torch.Tensor,
                          mom_cm: torch.Tensor) -> torch.Tensor:
    """Weight-normalise channel-major (3,N,N,N) momentum where the weight is
    positive; leave it as it is elsewhere."""
    w = weights[None]
    pos_w = w > 0
    return torch.where(pos_w, mom_cm / torch.where(pos_w, w, 1.0), mom_cm)
