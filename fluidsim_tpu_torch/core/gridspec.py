"""Dense grid geometry — the PyTorch counterpart of ``fluidsim_tpu/core/gridspec.py``.

The simulation box is the coordinate range ``[-B, B]^3`` held as dense
``(N, N, N)`` tensors with index ``i = c + B`` per axis, ``N = 2B + 1``.
Grid velocity is MAC and channel-major, ``(3, N, N, N)``: component ``d``
of cell ``c`` lives on the lower ``d``-face, and the cell-centred value is
``0.5 * (v[d, c] + v[d, c + e_d])``.

``GridSpec`` is host-side numpy (scene geometry); the shift helpers work on
tensors of any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static geometry of the simulation box.

    Attributes:
      bound: B — grid coordinates span ``[-B, B]`` per axis.
      wall: cells with ``|c| > wall`` are solid boundary walls (``B - 2``).
      dx: voxel size.
    """

    bound: int
    wall: int
    dx: float = 1.0

    @property
    def n(self) -> int:
        return 2 * self.bound + 1

    @property
    def shape(self):
        return (self.n, self.n, self.n)

    def coords(self) -> np.ndarray:
        """(N,) integer coordinates ``-B..B``."""
        return np.arange(-self.bound, self.bound + 1)

    def wall_mask(self) -> np.ndarray:
        """Boolean (N,N,N): True where ``|c| > wall`` on any axis."""
        over = np.abs(self.coords()) > self.wall
        return over[:, None, None] | over[None, :, None] | over[None, None, :]

    def within_mask(self, m: int) -> np.ndarray:
        """Boolean (N,N,N): True where ``|c| <= m`` on all axes."""
        ok = np.abs(self.coords()) <= m
        return ok[:, None, None] & ok[None, :, None] & ok[None, None, :]

    def wall_normals(self) -> np.ndarray:
        """(N,N,N,3) inward normals on wall cells: +-1 per axis whose
        coordinate exceeds the wall threshold (unused by the dynamics)."""
        c = self.coords()
        n = self.n
        normals = np.zeros((n, n, n, 3), dtype=np.float32)
        over = np.abs(c) > self.wall
        sgn = np.where(c < 0, 1.0, -1.0)
        for d in range(3):
            shape = [1, 1, 1]
            shape[d] = n
            normals[..., d] = np.where(over.reshape(shape),
                                       sgn.reshape(shape), 0.0)
        return normals


def flat_index(cells, n: int):
    """Flatten (..., 3) array-index cells (already offset by +B) to ids."""
    return (cells[..., 0] * n + cells[..., 1]) * n + cells[..., 2]


def shift_to_plus(a: torch.Tensor, d: int) -> torch.Tensor:
    """result[c] = a[c + e_d] along grid axis ``d`` of an (N,N,N) tensor,
    zero beyond the edge: read the plus-side neighbour."""
    out = torch.zeros_like(a)
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    src[d] = slice(1, None)
    dst[d] = slice(0, -1)
    out[tuple(dst)] = a[tuple(src)]
    return out


def shift_to_minus(a: torch.Tensor, d: int) -> torch.Tensor:
    """result[c] = a[c - e_d] (zero beyond the edge): the minus-side
    neighbour."""
    out = torch.zeros_like(a)
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    src[d] = slice(0, -1)
    dst[d] = slice(1, None)
    out[tuple(dst)] = a[tuple(src)]
    return out


def cell_center_velocity_cm(vel_cm: torch.Tensor) -> torch.Tensor:
    """Channel-major (3,N,N,N) MAC face velocity -> cell-centred velocity,
    ``0.5 * (v[d, c] + v[d, c + e_d])`` with zero beyond the array edge."""
    return torch.stack([0.5 * (vel_cm[d] + shift_to_plus(vel_cm[d], d))
                        for d in range(3)], dim=0)
