"""Batched 3x3 linear algebra of the MPM frame — the counterpart of
``fluidsim_tpu/ops/svd3.py``: products, determinant, cofactor matrix, the
closed-form SVD (unrolled cyclic Jacobi on F^T F), the polar decomposition
and its differential, the corotated Piola stress with its linearisation,
hardening and the singular-value clamp.

Each is unrolled into f32 elementwise operations in the reference's order,
with no ``@``, no ``torch.linalg`` and no data-dependent loop: a matmul on
the card could run in TF32, and the elementwise form rounds the same on
every device.  The reference's ``custom_jvp`` polar rotation and its
``jax.jvp`` of the cofactor matrix become the explicit differentials
``polar_delta`` and ``dcofactor3``.

On the card the MPM frame's chain runs as four CUDA kernels of
``csrc/mat3.cu``, a thread per particle with every matrix in registers,
each equal to its plain version bit for bit: ``piola_linearized`` (the
polar stress and the factors an apply reads), ``StressDifferential.apply``
(an implicit apply's ``dP(g FE) FE^T``), ``clamp_singular`` and ``mm3``.
Each takes its plain version (``piola_linearized_plain``,
``StressDifferential.apply_plain``, ``clamp_singular_plain``,
``mm3_plain``) for CPU tensors only, raises on any other device or on an
operand its kernel does not take, and counts its launches in
``.launches`` (the apply's by variant).  The plain functions run on any
device.
"""

from __future__ import annotations

import torch

from fluidsim_tpu_torch import native


def mm3_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 matmul of (..., 3, 3) tensors, on any device."""
    return torch.stack(
        [torch.stack([a[..., i, 0] * b[..., 0, j]
                      + a[..., i, 1] * b[..., 1, j]
                      + a[..., i, 2] * b[..., 2, j]
                      for j in range(3)], dim=-1)
         for i in range(3)], dim=-2)


def _mat_strides(name: str, t: torch.Tensor, p: int, device):
    """The element strides of ``t``, a (P, 3, 3) f32 operand on ``device``
    in any layout (a transposed view, a slice of the sort's payload, a view
    of (9, P) rows); raise on anything else."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != (p, 3, 3):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{(p, 3, 3)}")
    return t.stride()


def _launch(name: str, device, launch):
    """Run ``launch(lib, stream)`` on ``device``; raise on a launch
    error."""
    lib = native.library()
    with torch.cuda.device(device):
        rc = launch(lib, native.stream_ptr(device))
    native.check_launch(name, rc)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 matmul.  CPU tensors take ``mm3_plain`` ((..., 3, 3),
    broadcast); CUDA operands, (P, 3, 3) f32 each in any layout, launch
    ``fs_mm3`` (``csrc/mat3.cu``), equal to it bit for bit, into a new
    (P, 3, 3) tensor."""
    if a.device.type == "cpu":
        return mm3_plain(a, b)
    native.require_cuda(a, "mm3")
    dev, p = a.device, a.shape[0]
    sa, sb = _mat_strides("a", a, p, dev), _mat_strides("b", b, p, dev)
    out = torch.empty((p, 3, 3), dtype=torch.float32, device=dev)
    _launch("mm3", dev, lambda lib, stream: lib.fs_mm3(
        a.data_ptr(), *sa, b.data_ptr(), *sb, out.data_ptr(), p, stream))
    mm3.launches += 1
    return out


mm3.launches = 0


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


def _mat(rows) -> torch.Tensor:
    """(..., 3, 3) from three rows of three (...,) tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _rot_apply(a: torch.Tensor, v: torch.Tensor, p: int, q: int,
               c: torch.Tensor, s: torch.Tensor):
    """Apply the Givens rotation J(p,q; c,s) as A <- J^T A J, V <- V J (A
    symmetric (..., 3, 3))."""
    r = 3 - p - q
    app, aqq, apq = a[..., p, p], a[..., q, q], a[..., p, q]
    arp, arq = a[..., r, p], a[..., r, q]
    app_n = c * c * app - 2.0 * s * c * apq + s * s * aqq
    aqq_n = s * s * app + 2.0 * s * c * apq + c * c * aqq
    arp_n = c * arp - s * arq
    arq_n = s * arp + c * arq
    zero = torch.zeros_like(app)
    ent = {(p, p): app_n, (q, q): aqq_n, (r, r): a[..., r, r],
           (p, q): zero, (q, p): zero,
           (r, p): arp_n, (p, r): arp_n, (r, q): arq_n, (q, r): arq_n}
    a_n = _mat([[ent[(i, j)] for j in range(3)] for i in range(3)])
    vp, vq = v[..., :, p], v[..., :, q]
    cn, sn = c[..., None], s[..., None]
    cols = [v[..., :, 0], v[..., :, 1], v[..., :, 2]]
    cols[p], cols[q] = cn * vp - sn * vq, sn * vp + cn * vq
    return a_n, torch.stack(cols, dim=-1)


def _jacobi_eigh3(a: torch.Tensor, sweeps: int = 5):
    """Symmetric 3x3 eigendecomposition by ``sweeps`` unrolled cyclic
    Jacobi sweeps.  Returns (w, V) with A ~= V diag(w) V^T."""
    v = torch.eye(3, dtype=a.dtype, device=a.device).expand(a.shape)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = a[..., p, q]
            diff = a[..., q, q] - a[..., p, p]
            nz = torch.abs(apq) > 0
            tau = diff / (2.0 * torch.where(nz, apq, one))
            # tau == 0 (equal diagonal) takes the full 45-degree rotation
            sgn = torch.where(tau >= 0, one, -one)
            t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(nz, t, 0.0)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            a, v = _rot_apply(a, v, p, q, c, t * c)
    return torch.stack([a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]], dim=-1), v


def _sort_desc3(w: torch.Tensor, v: torch.Tensor):
    """Descending 3-element sort network on the eigenvalues, permuting V's
    columns along."""
    cols = [v[..., :, 0], v[..., :, 1], v[..., :, 2]]
    ws = [w[..., 0], w[..., 1], w[..., 2]]
    for i, j in ((0, 1), (0, 2), (1, 2)):
        sw = ws[i] < ws[j]
        ws[i], ws[j] = (torch.where(sw, ws[j], ws[i]),
                        torch.where(sw, ws[i], ws[j]))
        cols[i], cols[j] = (torch.where(sw[..., None], cols[j], cols[i]),
                            torch.where(sw[..., None], cols[i], cols[j]))
    return torch.stack(ws, dim=-1), torch.stack(cols, dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) . (..., 3) -> (..., 1), summed in index order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])[..., None]


def _unit(x: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(_dot3(x, x))
    ok = n > 1e-20
    return torch.where(ok, x / torch.where(ok, n, 1.0), fallback)


def svd3(f: torch.Tensor):
    """Closed-form SVD of (..., 3, 3): eigendecomposition of F^T F by
    unrolled Jacobi, U from F V with Gram-Schmidt and an orthonormal
    completion for (near-)singular values.  s >= 0 descending, U and V
    orthogonal with ``det(U V^T) = sign(det F)``.  Returns (U, s, V^T)."""
    w, v = _jacobi_eigh3(mm3_plain(f.transpose(-1, -2), f))
    w, v = _sort_desc3(w, v)
    s = torch.sqrt(torch.clamp(w, min=0.0))

    # proper V (det +1): flip the last column where the sort left det -1
    flip = torch.where(det3(v) < 0, -1.0, 1.0)
    v = torch.stack([v[..., :, 0], v[..., :, 1], v[..., :, 2] * flip[..., None]],
                    dim=-1)

    fv = mm3_plain(f, v)
    eye = torch.eye(3, dtype=f.dtype, device=f.device).expand(f.shape)
    u0 = _unit(fv[..., :, 0], eye[..., :, 0])
    f1 = fv[..., :, 1]
    g1 = f1 - _dot3(u0, f1) * u0
    # rank-1 fallback: cross u0 with the axis least aligned with it
    k = torch.argmin(torch.abs(u0), dim=-1)
    ek = torch.nn.functional.one_hot(k, 3).to(f.dtype)
    u1_fb = _unit(_cross(u0, ek), eye[..., :, 1])
    n1 = torch.sqrt(_dot3(g1, g1))
    ok1 = n1 > 1e-12 * torch.clamp(s[..., 0:1], min=1e-30)
    u1 = torch.where(ok1, g1 / torch.where(ok1, n1, 1.0), u1_fb)
    sgn = torch.where(det3(f) < 0, -1.0, 1.0)[..., None]
    u2 = sgn * _unit(_cross(u0, u1), eye[..., :, 2])
    return torch.stack([u0, u1, u2], dim=-1), s, v.transpose(-1, -2)


def polar_rs(f: torch.Tensor):
    """(R, S) of the polar decomposition F = R S, from one SVD."""
    u, s, vt = svd3(f)
    return mm3_plain(u, vt), mm3_plain(vt.transpose(-1, -2),
                                       s[..., :, None] * vt)


def polar_delta(r: torch.Tensor, s: torch.Tensor, df: torch.Tensor):
    """Rotation differential dR for a perturbation dF of F = R S: solve the
    3x3 skew system built from S (closed-form adjugate inverse) for the
    entries of ``R^T dR``, then ``dR = R skew(x)``.  Linear in ``dF``."""
    rhs = (mm3_plain(r.transpose(-1, -2), df)
           - mm3_plain(df.transpose(-1, -2), r))
    v = torch.stack([rhs[..., 0, 1], rhs[..., 0, 2], rhs[..., 1, 2]], dim=-1)
    m = _mat([[s[..., 0, 0] + s[..., 1, 1], s[..., 1, 2], -s[..., 0, 2]],
              [s[..., 1, 2], s[..., 0, 0] + s[..., 2, 2], s[..., 0, 1]],
              [-s[..., 0, 2], s[..., 0, 1], s[..., 1, 1] + s[..., 2, 2]]])
    det = det3(m)
    minv = cofactor3(m).transpose(-1, -2) / torch.where(
        det != 0, det, 1.0)[..., None, None]
    x = mv3(minv, v)
    zero = torch.zeros_like(x[..., 0])
    k = _mat([[zero, x[..., 0], x[..., 1]],
              [-x[..., 0], zero, x[..., 2]],
              [-x[..., 1], -x[..., 2], zero]])
    return mm3_plain(r, k)


def dcofactor3(f: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Differential of ``cofactor3`` at F along dF: each entry ``a*b - c*d``
    becomes ``(da*b + a*db) - (dc*d + c*dd)``, the order of ``jax.jvp``."""
    def e(i, j, k, l, m, n, o, q):
        return ((df[..., i, j] * f[..., k, l] + f[..., i, j] * df[..., k, l])
                - (df[..., m, n] * f[..., o, q] + f[..., m, n] * df[..., o, q]))
    return _mat([
        [e(1, 1, 2, 2, 1, 2, 2, 1), e(1, 2, 2, 0, 1, 0, 2, 2),
         e(1, 0, 2, 1, 1, 1, 2, 0)],
        [e(0, 2, 2, 1, 0, 1, 2, 2), e(0, 0, 2, 2, 0, 2, 2, 0),
         e(0, 1, 2, 0, 0, 0, 2, 1)],
        [e(0, 1, 1, 2, 0, 2, 1, 1), e(0, 2, 1, 0, 0, 0, 1, 2),
         e(0, 0, 1, 1, 0, 1, 1, 0)]])


def _ddot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Frobenius product of (..., 3, 3) tensors: the 9-term elementwise
    sum in row-major order (the JAX package's HIGHEST-precision einsum)."""
    out = a[..., 0, 0] * b[..., 0, 0]
    for i, j in ((0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2)):
        out = out + a[..., i, j] * b[..., i, j]
    return out


# the rows of ``fs_polar_stress``'s factors ``fac``, (25, P): what an apply
# reads of R, S, cof and J, each matrix row-major
FACTOR_ROWS = {"R": range(0, 9), "S": range(9, 15), "cof": range(15, 24),
               "J": range(24, 25)}
S_ENTRIES = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))  # polar_delta's


def factor_rows(r: torch.Tensor, s: torch.Tensor, cof: torch.Tensor,
                j: torch.Tensor) -> torch.Tensor:
    """The (25, P) factor rows that ``fs_polar_stress`` writes, from the
    plain factors: R's nine entries, the six of S that ``polar_delta``
    reads, cof's nine, J."""
    p = j.shape[0]
    return torch.cat([r.reshape(p, 9).T, torch.stack(
        [s[:, i, k] for i, k in S_ENTRIES]), cof.reshape(p, 9).T, j[None]])


class StressDifferential:
    """The linear differential ``dP(dF)`` of the corotated Piola stress at
    FE, from the factors of one polar decomposition (R, S, ``cof(FE)``,
    J = det FE):

      "full": dP(dF) = 2 mu (dF - dR) + lam ((cof:dF) cof + (J - 1) dcof)
      "spd":  dP(dF) = 2 mu dF + lam (cof:dF) cof

    the exact corotated Hessian and its positive-semidefinite Gauss-Newton
    part.  ``factors`` is (R, S, cof, J) from the plain chain, or the
    (25, P) rows ``fac`` that ``piola_linearized``'s kernel wrote.

    ``dp.apply(g9, scale)`` is an implicit apply's whole 3x3 chain,
    ``scale (dP(g FE) FE^T)`` as (P, 9) row-major rows (K1 fg's input),
    with ``g[p, c, k] = g9[3c + k, p]`` (K2 gw's (9, P) output):
    ``apply_plain`` for CPU tensors, the kernel ``fs_stress_apply`` on the
    ``fac`` rows for CUDA tensors, counted in
    ``StressDifferential.launches[variant]``.  ``dp(dF)``, the plain
    chain on any device, takes the plain factors."""

    launches = {"full": 0, "spd": 0}

    def __init__(self, spd: bool, fe, mu, lam, factors):
        self.spd, self.variant = spd, "spd" if spd else "full"
        self.fe, self.mu, self.lam = fe, mu, lam
        self.factors = factors

    def __call__(self, df: torch.Tensor) -> torch.Tensor:
        if isinstance(self.factors, torch.Tensor):
            raise TypeError("StressDifferential: the kernel's factor rows "
                            "serve apply only (the plain chain needs "
                            "piola_linearized_plain's factors)")
        r, s, cof, j = self.factors
        mu_, lam_ = self.mu[..., None, None], self.lam[..., None, None]
        if self.spd:
            return (2.0 * mu_ * df
                    + lam_ * _ddot(cof, df)[..., None, None] * cof)
        dr = polar_delta(r, s, df)
        dcof = dcofactor3(self.fe, df)
        return (2.0 * mu_ * (df - dr)
                + lam_ * (_ddot(cof, df)[..., None, None] * cof
                          + (j - 1.0)[..., None, None] * dcof))

    def apply_plain(self, g9: torch.Tensor, scale: torch.Tensor):
        """``scale (dP(g FE) FE^T)`` (P, 9) by the plain chain, on any
        device."""
        p = g9.shape[1]
        g = g9.reshape(3, 3, p).permute(2, 0, 1)
        sigma = mm3_plain(self(mm3_plain(g, self.fe)),
                          self.fe.transpose(-1, -2))
        return (scale[:, None] * sigma.reshape(p, 9)).contiguous()

    def apply(self, g9: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """``scale (dP(g FE) FE^T)`` (P, 9): ``apply_plain`` for CPU
        tensors, else one launch of ``fs_stress_apply`` (``csrc/mat3.cu``),
        equal to it bit for bit, into a new (P, 9) tensor.  ``g9`` (9, P)
        and ``scale`` (P,) f32 contiguous, on the device of the factor
        rows."""
        if g9.device.type == "cpu":
            return self.apply_plain(g9, scale)
        native.require_cuda(g9, "StressDifferential.apply")
        fac, fe = self.factors, self.fe
        if not isinstance(fac, torch.Tensor):
            raise ValueError("StressDifferential.apply: no kernel factor "
                             "rows (built by piola_linearized_plain)")
        dev, p = g9.device, fe.shape[0]
        native.check_tensor("g9", g9, torch.float32, (9, p), dev)
        fs = _mat_strides("fe", fe, p, dev)
        native.check_tensor("fac", fac, torch.float32, (25, p), dev)
        for name, t in (("mu", self.mu), ("lam", self.lam),
                        ("scale", scale)):
            native.check_tensor(name, t, torch.float32, (p,), dev)
        m9 = torch.empty((p, 9), dtype=torch.float32, device=dev)
        _launch("StressDifferential.apply", dev,
                lambda lib, stream: lib.fs_stress_apply(
                    g9.data_ptr(), fe.data_ptr(), *fs, fac.data_ptr(),
                    self.mu.data_ptr(), self.lam.data_ptr(),
                    scale.data_ptr(), m9.data_ptr(), int(self.spd), p,
                    stream))
        StressDifferential.launches[self.variant] += 1
        return m9


def piola_linearized_plain(fe: torch.Tensor, mu: torch.Tensor,
                           lam: torch.Tensor):
    """``piola_linearized`` by the plain chain, on any device."""
    r, s = polar_rs(fe)
    j = det3(fe)
    cof = cofactor3(fe)
    p0 = 2.0 * mu[..., None, None] * (fe - r) + (
        lam * (j - 1.0))[..., None, None] * cof
    factors = (r, s, cof, j)
    return (p0, StressDifferential(False, fe, mu, lam, factors),
            StressDifferential(True, fe, mu, lam, factors))


def piola_linearized(fe: torch.Tensor, mu: torch.Tensor, lam: torch.Tensor):
    """The corotated first Piola stress at FE,
    ``P0 = 2 mu (FE - R) + lam (J - 1) cof(FE)``, and its two linear
    differentials from one polar decomposition.  Returns (P0, dP_full,
    dP_spd), the differentials ``StressDifferential``s.

    CPU tensors take ``piola_linearized_plain``.  CUDA tensors launch
    ``fs_polar_stress`` (``csrc/mat3.cu``), equal to it bit for bit: ``fe``
    (P, 3, 3) f32 in any layout, ``mu`` and ``lam`` (P,) f32 contiguous;
    P0 is a new (P, 3, 3) tensor, and the differentials hold the kernel's
    (25, P) factor rows (``FACTOR_ROWS``)."""
    if fe.device.type == "cpu":
        return piola_linearized_plain(fe, mu, lam)
    native.require_cuda(fe, "piola_linearized")
    dev, p = fe.device, fe.shape[0]
    fs = _mat_strides("fe", fe, p, dev)
    native.check_tensor("mu", mu, torch.float32, (p,), dev)
    native.check_tensor("lam", lam, torch.float32, (p,), dev)
    p0 = torch.empty((p, 3, 3), dtype=torch.float32, device=dev)
    fac = torch.empty((25, p), dtype=torch.float32, device=dev)
    _launch("piola_linearized", dev, lambda lib, stream: lib.fs_polar_stress(
        fe.data_ptr(), *fs, mu.data_ptr(), lam.data_ptr(), p0.data_ptr(),
        fac.data_ptr(), p, stream))
    piola_linearized.launches += 1
    return (p0, StressDifferential(False, fe, mu, lam, fac),
            StressDifferential(True, fe, mu, lam, fac))


piola_linearized.launches = 0


def hardening(mu0: float, lam0: float, eps: float, jp: torch.Tensor,
              exponent_cap: float | None = None):
    """Exponential hardening ``mu = mu0 exp(eps (1 - Jp))``, likewise
    lambda, with the exponent clamped to ``[-cap, cap]`` when a cap is
    given."""
    e = eps * (1.0 - jp)
    if exponent_cap is not None:
        e = torch.clamp(e, -exponent_cap, exponent_cap)
    h = torch.exp(e)
    return mu0 * h, lam0 * h


def clamp_singular_plain(f: torch.Tensor, minv: float, maxv: float):
    """``clamp_singular`` by the plain chain, on any device."""
    u, s, vt = svd3(f)
    sc = torch.clamp(s, minv, maxv)
    fe = mm3_plain(u, sc[..., :, None] * vt)
    return fe, mm3_plain(vt.transpose(-1, -2),
                         u.transpose(-1, -2) / sc[..., :, None])


def clamp_singular(f: torch.Tensor, minv: float, maxv: float):
    """Clamp F's singular values to ``[minv, maxv]``: returns
    ``(U clamp(s) V^T, V clamp(s)^-1 U^T)``.  CPU tensors take
    ``clamp_singular_plain``; a CUDA ``f``, (P, 3, 3) f32 in any layout,
    launches ``fs_clamp_singular`` (``csrc/mat3.cu``), equal to it bit for
    bit, into two new (P, 3, 3) tensors."""
    if f.device.type == "cpu":
        return clamp_singular_plain(f, minv, maxv)
    native.require_cuda(f, "clamp_singular")
    dev, p = f.device, f.shape[0]
    fs = _mat_strides("f", f, p, dev)
    fe = torch.empty((p, 3, 3), dtype=torch.float32, device=dev)
    inv = torch.empty_like(fe)
    _launch("clamp_singular", dev, lambda lib, stream: lib.fs_clamp_singular(
        f.data_ptr(), *fs, minv, maxv, fe.data_ptr(), inv.data_ptr(), p,
        stream))
    clamp_singular.launches += 1
    return fe, inv


clamp_singular.launches = 0
