"""APIC transfers — the counterpart of the JAX package's Pallas APIC path:
``transfer_pallas.p2g_pallas(aff=...)`` and ``g2p_apic_pallas``.

P2G scatters ``w_o * (v + C (x_o - x_p))``: the per-particle part of
``x_o - x_p = (base - pos) + off_o`` folds into an effective velocity here,
and the offset part is added inside the K1 aff kernel (or, on the bucket
path's window-grouped order, inside K6a).  G2P gathers the 22
offset moments (K2 moments, or K7b then K7a from the materialised table)
and fits ``C = B D^{-1}`` from them with the
reference's centred fit, a ``1e-3 I`` ridge and the adjugate inverse, in
(P, 3, 3) elementwise arithmetic.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch.core.splines import cround
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.svd3 import cofactor3, det3, mm3, mv3


def p2g_apic(w27t: torch.Tensor, pos_s: torch.Tensor, vel_s: torch.Tensor,
             aff_s: torch.Tensor, flat_s: torch.Tensor, solid: torch.Tensor,
             bound: int, fused_scatter: bool = True):
    """APIC P2G of sorted particles with (P, 3, 3) affine matrices
    ``aff_s``: on ``veff = v + C (base - pos)``, K1 aff over the cell ranges
    of a full sort, or (``fused_scatter=False``, a window-grouped order) K6a
    with the APIC term and K6b; then the masks of
    ``transfer_kernels.p2g``.  Returns (weights, mom (3,N,N,N), occ)."""
    n = 2 * bound + 1
    e = cround(pos_s) - pos_s
    veff = vel_s + mv3(aff_s, e)
    aff9 = aff_s.reshape(-1, 9)
    if fused_scatter:
        accn = tk.p2g_scatter_affine(w27t, veff, aff9,
                                     tk.cell_starts(flat_s, n), n)
    else:
        accn = tk.shift_reduce(tk.p2g_scatter_base(
            w27t, veff, flat_s, tk.window_starts(flat_s, n), n, aff_s=aff9))
    return tk.p2g_masks(accn, solid, bound)


def g2p_apic(w27t: torch.Tensor, flat_s: torch.Tensor, pos_s: torch.Tensor,
             vc: torch.Tensor, bound: int, wall: int, fused_table: bool = True):
    """APIC G2P: (velocity (P, 3), C (P, 3, 3)) per sorted particle from
    channel-major cell-centred ``vc`` (3,N,N,N), over the cells within
    ``|c| <= wall``.  Both are 0 for a particle with no weight there.
    ``fused_table=False``: the moments from K7b's neighbourhood table and
    K7a (the counterpart of ``g2p_apic_pallas(fused_table=False)``), equal
    to K2 moments' to the bit."""
    fm = tk.gather_fields(vc, bound, wall)
    if fused_table:
        mo = tk.g2p_moments(fm, w27t, flat_s)
    else:
        mo = tk.g2p_moments_table(tk.shift_expand(fm), w27t, flat_s)
    return affine_fit(mo, pos_s)


def affine_fit(mo: torch.Tensor, pos_s: torch.Tensor):
    """(velocity, C) from the (22, P) offset moments of K2 moments: the
    centred B/D fit of ``transfer_pallas.g2p_apic_pallas`` in the same
    elementwise operations."""
    p = pos_s.shape[0]
    den = mo[0]
    vnum = mo[1:4].T                                  # sum w f
    mbar_n = mo[4:7].T                                # sum w mask off
    f_n = mo[7:16].T.reshape(p, 3, 3)                 # sum w f_c off_k
    msym = mo[16:22].T                                # sum w mask off off^T
    mmat = torch.stack(
        [torch.stack([msym[:, 0], msym[:, 1], msym[:, 2]], -1),
         torch.stack([msym[:, 1], msym[:, 3], msym[:, 4]], -1),
         torch.stack([msym[:, 2], msym[:, 4], msym[:, 5]], -1)], -2)

    e = cround(pos_s) - pos_s                         # base - pos
    nz = den != 0
    safe = torch.where(nz, den, 1.0)
    vel = torch.where(nz[:, None], vnum / safe[:, None], 0.0)

    # d_o = e + off_o:  sum w f d^T = vnum e^T + F;
    # sum w mask d d^T = den e e^T + e mbar^T + mbar e^T + M
    dbar = e + mbar_n / safe[:, None]
    b = ((vnum[:, :, None] * e[:, None, :] + f_n) / safe[:, None, None]
         - vel[:, :, None] * dbar[:, None, :])
    dmat = ((den[:, None, None] * e[:, :, None] * e[:, None, :]
             + e[:, :, None] * mbar_n[:, None, :]
             + mbar_n[:, :, None] * e[:, None, :] + mmat)
            / safe[:, None, None]
            - dbar[:, :, None] * dbar[:, None, :])
    dreg = dmat + 1e-3 * torch.eye(3, dtype=pos_s.dtype, device=pos_s.device)
    inv = cofactor3(dreg).transpose(-1, -2) / det3(dreg)[:, None, None]
    c = torch.where(nz[:, None, None], mm3(b, inv), 0.0)
    return vel, c
