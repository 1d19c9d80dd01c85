"""The MPM frame's particle <-> grid transfers and force functions on the
kernels of ``ops.transfer_kernels`` — the counterpart of
``fluidsim_tpu/ops/mpm_pallas.py`` on the port's dense layout.

Particles are sorted by the plain flat id of their clipped base cell (as
the FLIP frame), and the frame's stencil is computed once: the MPM weights
``w27t`` (27, P) and the weight gradients ``gradw`` (81, P).  The TPU
pipeline's haloed ids, packed 128-row columns, window-local ids and chunked
pack were workarounds for its memory system and have no counterpart here.

  mass and momentum P2G         K1 (``p2g_scatter``) on ``w27t``
  frame-0 density               K2 (``g2p_gather``) of the mass
  velocity gradient, Hessian    K2 gw (``g2p_gather_gw``) on ``gradw``
  grid force                    K1 fg (``p2g_scatter_force``) on ``gradw``
  FLIP delta                    ``transfer_kernels.g2p`` on ``w27t``

Grid fields are channel-major, (3, N, N, N).
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch.core.splines import cround, dspline2, spline2
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.svd3 import mm3, piola_linearized


def sort_mpm(pos, vel, FE, FP, volume, bound: int):
    """Stable sort of the whole MPM particle state by base cell: FE, FP and
    the volume ride along as one 19-column payload.  The order is that of
    the JAX package's ``sort_mpm_h``.  Returns ``(pos, vel, FE, FP,
    volume, flat_s)``."""
    p = pos.shape[0]
    extra = torch.cat([FE.reshape(p, 9), FP.reshape(p, 9), volume[:, None]],
                      dim=-1)
    pos_s, vel_s, flat_s, rest = tk.sort_by_cell(pos, vel, bound, extra=extra)
    return (pos_s, vel_s, rest[:, 0:9].reshape(p, 3, 3),
            rest[:, 9:18].reshape(p, 3, 3), rest[:, 18].contiguous(), flat_s)


def mpm_stencil(pos_s: torch.Tensor, bound: int):
    """The frame's stencil: ``w27t`` (27, P), the MPM weights zero for
    particles whose base cell lies outside the box
    (``masked_weights_cm(pos_s, bound, "mpm")``), and ``gradw`` (81, P),
    row ``3o + k`` the k-component of the weight gradient at offset o,
    ``-dspline2(s_k) spline2(s_j) spline2(s_l)`` with ``s = pos - (base +
    off) - 0.5``.  These are the rows 0-26 and 40-120 of the JAX package's
    ``pack_mpm_rows``, in the same f32 operation order.  That function
    packs them in blocks of particles to bound the TPU's temporaries; here
    they are plain tensors (gradw is 324 B per particle)."""
    base = cround(pos_s)
    wd, gd = [], []
    for a in range(3):
        s = [(pos_s[:, a] - (base[:, a] + (q - 1))) - 0.5 for q in range(3)]
        wd.append([spline2(x) for x in s])
        gd.append([-dspline2(x) for x in s])
    rows = []
    for o in range(27):
        ox, oy, oz = o // 9, (o // 3) % 3, o % 3
        rows += [gd[0][ox] * wd[1][oy] * wd[2][oz],
                 wd[0][ox] * gd[1][oy] * wd[2][oz],
                 wd[0][ox] * wd[1][oy] * gd[2][oz]]
    return tk.masked_weights_cm(pos_s, bound, "mpm"), torch.stack(rows, dim=0)


def _masked(fields: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Channel-major ``fields`` zeroed where ``mask`` (N,N,N) is False."""
    return torch.where(mask[None], fields, 0.0)


def p2g_mpm(w27t, vel_s, cell_start, solid, bound: int, plan=None):
    """Mass (N,N,N) and channel-major momentum (3,N,N,N) by K1, both masked
    to non-solid target cells (not the FLIP frame's ``bound - 2`` window).
    ``plan``: the frame's ``transfer_kernels.chunk_plan`` of
    ``cell_start`` (the card's K1 builds one when None)."""
    accn = _masked(tk.p2g_scatter(w27t, vel_s, cell_start, 2 * bound + 1,
                                  plan), ~solid)
    return accn[0], accn[1:4]


def density(mass, w27t, flat_s, solid):
    """Per-particle density ``sum_o w_o mass(base + off_o)`` over
    non-solid cells: channel 0 of K2 on the masked mass (channels 1-2 zero,
    channel 3 the mask, as the TPU gather's input)."""
    ns = ~solid
    zero = torch.zeros_like(mass)
    fm = torch.stack([torch.where(ns, mass, 0.0), zero, zero, ns.to(mass.dtype)])
    return tk.g2p_gather(fm, w27t, flat_s)[0]


def _gather_gw(fields, mask, gradw, flat_s):
    """(P, 3, 3) ``g[p, c, k] = sum_o gradW_k(p, o) f_c(base + off_o)`` of
    channel-major ``fields`` masked to ``mask``, by K2 gw."""
    out = tk.g2p_gather_gw(_masked(fields, mask), gradw, flat_s)
    return out.reshape(3, 3, -1).permute(2, 0, 1)


def gradv_gather(velg, gradw, flat_s, solid):
    """Velocity gradient ``gradV_p[c, k] = sum_i v_c(i) gradW_k(i)`` over
    the non-solid stencil cells.  (P, 3, 3)."""
    return _gather_gw(velg, ~solid, gradw, flat_s)


def flip_delta(w27t, flat_s, dvc, bound: int, wall: int):
    """FLIP velocity delta: the FLIP gather of the cell-centred velocity
    change ``dvc`` (3,N,N,N) with the MPM weights, normalised over the
    cells within ``|c| <= wall``.  (P, 3)."""
    return tk.g2p(w27t, flat_s, dvc, bound, wall)


def make_force_fns(pos_s, FE, volume, mu, lam, gradw, cell_start, flat_s,
                   active, solid, bound: int, hessian: str = "full",
                   plan=None):
    """``(f0, dforce)``: the explicit grid force and its exact
    linearisation, channel-major (3,N,N,N).

    ``f0()`` scatters ``M = scale sigma`` with ``sigma = P0 FE^T`` through
    K1 fg, masked to non-solid cells; ``scale`` is ``-volume`` for
    particles whose base cell lies in the box and 0 otherwise.
    ``dforce(u)`` is the same scatter of ``dP(g FE) FE^T``, where ``g`` is
    the K2 gw gather of ``u`` over the active cells: an explicit linear
    chain, so no automatic differentiation is involved.  ``hessian`` is
    "full" (the exact corotated differential), "spd" (its Gauss-Newton
    part) or "hybrid", which returns ``(f0, dforce_full, dforce_spd)``.
    The polar decomposition runs once for all of them.  ``plan`` is the
    frame's ``transfer_kernels.chunk_plan`` of ``cell_start``, shared by
    every force scatter (with None each launch on the card builds its own;
    the CPU's plain scatter needs none).
    """
    n = 2 * bound + 1
    p = pos_s.shape[0]
    fe_t = FE.transpose(-1, -2)
    p0, dp_full, dp_spd = piola_linearized(FE, mu, lam)
    valid = torch.all(torch.abs(cround(pos_s)) <= bound, dim=-1)
    scale = torch.where(valid, -volume, 0.0)

    def scatter_sigma(sigma):
        m9 = (scale[:, None] * sigma.reshape(p, 9)).contiguous()
        return _masked(tk.p2g_scatter_force(gradw, m9, cell_start, n, plan),
                       ~solid)

    def f0():
        return scatter_sigma(mm3(p0, fe_t))

    def dforce_with(dp):
        def dforce(u):
            g = _gather_gw(u, active, gradw, flat_s)
            return scatter_sigma(mm3(dp(mm3(g, FE)), fe_t))
        return dforce

    if hessian == "hybrid":
        return f0, dforce_with(dp_full), dforce_with(dp_spd)
    return f0, dforce_with(dp_spd if hessian == "spd" else dp_full)
