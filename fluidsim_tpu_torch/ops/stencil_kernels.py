"""Pressure-solve stencil kernels — the counterpart of
``fluidsim_tpu/ops/pallas_stencil.py``: the masked 7-point Laplacian (K3,
``apply_laplacian_padded``) and the Chebyshev preconditioner (K4,
``cheb_step_padded`` chained by ``chebyshev_precond_fused``), whose steps run
up to ``S_MAX`` at a time in one launch (``cheb_steps``).

The CG state stays in the dense (N,N,N) layout.  On a shard of
``parallel/`` the CG vectors are the (nl, N, N) slab, and each kernel takes
beside its operands their neighbours' edge rows (``ghost``), the rows that
the ranks on either side own next to this slab, and reads them where they
lie: no operand with ghost rows is built and no output is cut.  A plane
that is None reads 0 (a domain end, or both ends of the one slab at world
size 1).  The TPU path's padded (Npx, L) layout and its block and lane-halo
choices fit VMEM and are not needed here.  A cell is fluid exactly where
``adiag > 0``; neighbours outside the array read 0.

``apply_laplacian`` and ``cheb_steps`` launch the CUDA kernels of
``csrc/stencil.cu`` for CUDA tensors and use their plain PyTorch versions
only for CPU tensors; anything else raises.  Each counts its kernel launches
in ``.launches``; ``cheb_step``, one step from a given (z, d) as the TPU
kernel takes it, is ``cheb_steps`` with one step.  Both versions round every
operation the same way (the kernels are built without FMA contraction), so
they agree bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from fluidsim_tpu_torch import native
from fluidsim_tpu_torch.core.gridspec import shift_to_minus, shift_to_plus

# the most Chebyshev steps of one K4 launch (kMaxChebSteps in stencil.cu):
# chebyshev_precond_fused is one launch up to degree 4; a launch of 4 steps
# cost more than two of 2 on the H100 (PERF.md section 6)
S_MAX = 3

_GHOST_FIELDS = ("z", "d", "r", "adiag")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _masked_laplacian(q: torch.Tensor, adiag: torch.Tensor, scale: float,
                      q_lo=None, q_hi=None):
    """``adiag*q - scale*(x- + x+ + y- + y+ + z- + z+)`` of an already
    masked ``q``, summed in that order (the TPU kernel's order); ``q_lo`` and
    ``q_hi``, masked (N, N) planes or None (0), are the x- neighbours of the
    first row and the x+ neighbours of the last."""
    xm = shift_to_minus(q, 0)
    if q_lo is not None:
        xm[0] = q_lo
    xp = shift_to_plus(q, 0)
    if q_hi is not None:
        xp[-1] = q_hi
    s = xm + xp
    s = s + shift_to_minus(q, 1)
    s = s + shift_to_plus(q, 1)
    s = s + shift_to_minus(q, 2)
    s = s + shift_to_plus(q, 2)
    return adiag * q - scale * s


# ---- K3: masked Laplacian -------------------------------------------------

def _masked_plane(p, a):
    return None if p is None or a is None else torch.where(a > 0, p, 0.0)


def apply_laplacian_plain(p: torch.Tensor, adiag: torch.Tensor, scale: float,
                          ghost=None) -> torch.Tensor:
    """Plain PyTorch K3 (``ghost`` as in ``apply_laplacian``)."""
    fluid = adiag > 0
    q = torch.where(fluid, p, 0.0)
    q_lo = q_hi = None
    if ghost is not None:
        p_lo, p_hi, a_lo, a_hi = ghost
        q_lo, q_hi = _masked_plane(p_lo, a_lo), _masked_plane(p_hi, a_hi)
    return torch.where(fluid, _masked_laplacian(q, adiag, scale, q_lo, q_hi),
                       0.0)


def apply_laplacian(p: torch.Tensor, adiag: torch.Tensor, scale: float,
                    ghost=None) -> torch.Tensor:
    """K3: ``A @ p`` on (N,N,N) or (nx,N,N) f32 — ``adiag*p - scale * (sum
    of the fluid neighbours of p)`` on fluid cells, 0 elsewhere.  ``ghost``:
    None, or the neighbours' (N, N) edge planes ``(p_lo, p_hi, a_lo, a_hi)``
    of ``p`` and ``adiag`` before row 0 and after row nx - 1, each None for
    zeros.  CUDA tensors launch ``fs_apply_laplacian``; CPU tensors take
    ``apply_laplacian_plain``."""
    if p.device.type == "cpu":
        return apply_laplacian_plain(p, adiag, scale, ghost)
    native.require_cuda(p, "apply_laplacian")
    dev = p.device
    nx, n = p.shape[0], p.shape[-1]
    for name, t in (("p", p), ("adiag", adiag)):
        native.check_tensor(name, t, torch.float32, (nx, n, n), dev)
    planes = (None,) * 4 if ghost is None else tuple(ghost)
    for name, t in zip(("p_lo", "p_hi", "a_lo", "a_hi"), planes, strict=True):
        if t is not None:
            native.check_tensor(name, t, torch.float32, (n, n), dev)
    out = torch.empty_like(p)
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_apply_laplacian(p.data_ptr(), adiag.data_ptr(),
                                    *map(_ptr, planes), out.data_ptr(),
                                    float(scale), nx, n,
                                    native.stream_ptr(dev))
    native.check_launch("apply_laplacian", rc)
    apply_laplacian.launches += 1
    return out


apply_laplacian.launches = 0


# ---- K4: Chebyshev steps --------------------------------------------------

def cheb_step_plain(z: torch.Tensor, adiag: torch.Tensor, r: torch.Tensor,
                    d: torch.Tensor, scale: float, c1: float, c2: float):
    """One plain PyTorch K4 step; returns (d_new, z_new)."""
    fluid = adiag > 0
    q = torch.where(fluid, z, 0.0)
    az = torch.where(fluid, _masked_laplacian(q, adiag, scale), 0.0)
    resid = r - az
    safe = torch.where(fluid, adiag, 1.0)
    pd = torch.where(fluid, resid / safe, 0.0)
    dn = c1 * d + c2 * pd
    return dn, q + dn


def _jacobi_start(adiag, r, theta: float):
    """The polynomial's first term, ``D^-1 r / theta`` on fluid cells."""
    fluid = adiag > 0
    safe = torch.where(fluid, adiag, 1.0)
    return torch.where(fluid, r / safe, 0.0) * (1.0 / theta)


def _near(block, depth: int, lo: bool):
    """The ``depth`` rows of an edge block next to the slab: the last of a
    ``lo`` block, the first of a ``hi`` one."""
    return block[block.shape[0] - depth:] if lo else block[:depth]


def _no_planes(ghost) -> bool:
    return ghost is None or all(t is None for pair in ghost.values()
                                for t in pair)


def cheb_steps_plain(adiag, r, scale: float, coefs, theta=None, z=None,
                     d=None, ghost=None, want_d: bool = False):
    """Plain PyTorch ``cheb_steps``: the steps composed, each on the slab
    with ``S = len(coefs)`` edge rows of every field on either side
    (zeros where ``ghost`` has none), cut back to the slab at the end."""
    s, nx = len(coefs), r.shape[0]
    ghost = None if _no_planes(ghost) else ghost

    def ext(t, name):
        if ghost is None:
            return t
        lo, hi = ghost.get(name, (None, None))
        zero = t.new_zeros((s,) + tuple(t.shape[1:]))
        return torch.cat([zero if lo is None else _near(lo, s, True), t,
                          zero if hi is None else _near(hi, s, False)])

    a, rr = ext(adiag, "adiag"), ext(r, "r")
    if theta is not None:
        dd = zz = _jacobi_start(a, rr, theta)
    else:
        zz, dd = ext(z, "z"), ext(d, "d")
    for c1, c2 in coefs:
        dd, zz = cheb_step_plain(zz, a, rr, dd, scale, c1, c2)
    if ghost is not None:
        zz, dd = zz[s:s + nx], dd[s:s + nx]
    return (zz, dd) if want_d else zz


def cheb_steps(adiag, r, scale: float, coefs, theta=None, z=None, d=None,
               ghost=None, want_d: bool = False):
    """K4: ``S = len(coefs)`` (1..``S_MAX``) Chebyshev steps in one
    launch on (N,N,N) or (nx,N,N) f32; step j is ``resid = r - A z; d' =
    c1_j*d + c2_j*resid/adiag (fluid only); z' = z + d'`` with ``coefs[j] =
    (c1_j, c2_j)``.  They start from the given ``(z, d)``, or with ``theta``
    from the Jacobi term ``d = z = D^-1 r / theta`` (no ``z`` or ``d``).
    Returns z after the steps, and ``(z, d)`` with ``want_d``.

    ``ghost``: None, or a dict from "z", "d", "r", "adiag" to ``(lo, hi)``,
    the neighbours' edge rows of that field before row 0 and after row
    nx - 1, each a (>= S, N, N) block (the S rows next to the slab are read)
    or None for zeros; a field missing reads zeros.  CUDA tensors launch
    ``fs_cheb_steps``; CPU tensors take ``cheb_steps_plain``."""
    s = len(coefs)
    if not 1 <= s <= S_MAX:
        raise ValueError(f"cheb_steps: {s} steps, the kernel takes 1 to "
                         f"{S_MAX}")
    if (theta is None) != (z is not None) or (z is None) != (d is None):
        raise ValueError("cheb_steps: give either theta or both z and d")
    if r.device.type == "cpu":
        return cheb_steps_plain(adiag, r, scale, coefs, theta, z, d, ghost,
                                want_d)
    native.require_cuda(r, "cheb_steps")
    dev = r.device
    nx, n = r.shape[0], r.shape[-1]
    mids = dict(z=z, d=d, r=r, adiag=adiag)
    ghost = ghost or {}
    fields = []
    for name in _GHOST_FIELDS:
        t = mids[name]
        if t is not None:
            native.check_tensor(name, t, torch.float32, (nx, n, n), dev)
        lo, hi = ghost.get(name, (None, None)) if t is not None else (None,
                                                                       None)
        lo = None if lo is None else _near(lo, s, True)
        hi = None if hi is None else _near(hi, s, False)
        for side, plane in (("lo", lo), ("hi", hi)):
            if plane is not None:
                native.check_tensor(f"{name}_{side}", plane, torch.float32,
                                    (s, n, n), dev)
        fields += [t, lo, hi]
    zn = torch.empty_like(r)
    dn = torch.empty_like(r) if want_d else None
    ptrs = (ctypes.c_void_p * 12)(*map(_ptr, fields))
    cs = (ctypes.c_float * (2 * s))(*(float(c) for pair in coefs
                                      for c in pair))
    lib = native.library()
    with torch.cuda.device(dev):
        rc = lib.fs_cheb_steps(ptrs, zn.data_ptr(), _ptr(dn), cs, s,
                               float(scale),
                               0.0 if theta is None else 1.0 / theta, nx, n,
                               native.stream_ptr(dev))
    native.check_launch("cheb_steps", rc)
    cheb_steps.launches += 1
    return (zn, dn) if want_d else zn


cheb_steps.launches = 0


def cheb_step(z: torch.Tensor, adiag: torch.Tensor, r: torch.Tensor,
              d: torch.Tensor, scale: float, c1: float, c2: float):
    """K4 as the TPU kernel computes it: one step ``resid = r - A z; d' =
    c1*d + c2*resid/adiag (fluid only); z' = z + d'`` from a given (z, d);
    returns (d', z').  ``cheb_steps`` with one step (one launch of
    ``fs_cheb_steps`` on CUDA tensors, ``cheb_step_plain`` on CPU ones)."""
    zn, dn = cheb_steps(adiag, r, scale, [(c1, c2)], z=z, d=d, want_d=True)
    return dn, zn


def cheb_coefs(degree: int, lam_max: float = 2.0, ratio: float = 30.0):
    """``(theta, [(c1, c2)] * (degree - 1))`` of the Chebyshev-Jacobi
    polynomial of ``ops.pcg.chebyshev_preconditioner`` on [lam_max/ratio,
    lam_max]: the rho recurrence in Python floats, so every step's pair is a
    constant of the call."""
    a, b = lam_max / ratio, lam_max
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    coefs = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        coefs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, coefs


def chebyshev_precond_fused(adiag: torch.Tensor, scale: float,
                            degree: int = 3, lam_max: float = 2.0,
                            ratio: float = 30.0, edges=None):
    """Chebyshev-Jacobi preconditioner on K4: the polynomial of
    ``ops.pcg.chebyshev_preconditioner``, its ``degree - 1`` steps run up
    to ``S_MAX`` at a time by ``cheb_steps``, the first launch from the
    Jacobi term.  So an application is one launch up to degree ``S_MAX +
    1`` and ``ceil((degree - 1) / S_MAX)`` above it (the steps shared out
    evenly, the first launches taking one more); degree 1 is the Jacobi
    term alone, with no launch.

    On a slab of ``parallel/`` (``adiag``, ``r`` and the result (nl, N,
    N)), ``edges(tensors, width)`` returns each tensor's neighbours' edge
    rows ``(lo, hi)`` (``halo.edge_rows``).  A launch then takes ``S <=
    min(S_MAX, nl)`` steps, so that its edge rows come from the
    neighbouring slab alone.  Building the preconditioner exchanges
    ``adiag``'s edge rows that deep, once; an application exchanges ``r``'s
    once, and ``z``'s and ``d``'s before each launch after the first.
    Every rank's slab has the same ``nl``, so the ranks make the same
    exchanges."""
    theta, coefs = cheb_coefs(degree, lam_max, ratio)
    if not coefs:
        return lambda r: _jacobi_start(adiag, r, theta)
    per = S_MAX if edges is None else min(S_MAX, adiag.shape[0])
    launches = math.ceil(len(coefs) / per)
    q, rem = divmod(len(coefs), launches)
    split = [q + 1] * rem + [q] * (launches - rem)
    if edges is not None:
        (adiag_edges,) = edges([adiag], max(split))

    def precond(r):
        ghost = None
        if edges is not None:
            (r_edges,) = edges([r], split[0])
            ghost = {"adiag": adiag_edges, "r": r_edges}
        z = d = None
        done = 0
        for j, s in enumerate(split):
            last = j == len(split) - 1
            if j and edges is not None:
                ghost["z"], ghost["d"] = edges([z, d], s)
            out = cheb_steps(adiag, r, scale, coefs[done:done + s],
                             theta=None if j else theta, z=z, d=d,
                             ghost=ghost, want_d=not last)
            done += s
            if last:
                return out
            z, d = out

    return precond
