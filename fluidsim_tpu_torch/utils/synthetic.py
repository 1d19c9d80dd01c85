"""Synthetic kernel inputs that a frame's state may not reach, made from a
seed with numpy: the run tables of the bucket move (K5) and skewed sorted
states for the K1 modes (K1, K1 aff, K1 fg).  ``chip_smoke.py`` holds the CUDA
kernels to their plain versions on them, and the CPU tests hold the plain
versions and the plans to numpy on the same inputs."""

from __future__ import annotations

import numpy as np
import torch

from fluidsim_tpu_torch.ops.bucket_sort import DEAD_DST
from fluidsim_tpu_torch.ops.transfer_kernels import CHUNK


def bucket_tables(seed: int, p: int, nc: int, to: int = 1024, emax: int = 64,
                  t: int = 512, device="cpu"):
    """K5 inputs over ``tc = ceil_t(p)`` chunk-sorted rows: a run of 2.5
    ``to`` rows across three output blocks, a block met by exactly ``emax``
    runs, then runs of 1 to 600 rows (some of one row) to the end, so
    ``p`` need not be a multiple of ``to``; the runs' source ranges are a
    random permutation of ``[0, tc)``.  Returns ``(key_s, pay_s, tbl,
    runs)``: random int32 keys (tc,), f32 payload (nc, tc), the table
    (nout, 3, emax) laid out as ``bucket_plan`` lays it out (each block's
    entries from the run holding its first row, in ``dst`` order, dead
    entries last), and ``runs`` (R, 3) int64 numpy, every run's (dst, src,
    cnt)."""
    rng = np.random.default_rng(seed)
    tc = -(-p // t) * t
    nout = -(-tc // to)
    head = [2 * to + to // 2, to // 2] + [to // emax] * (emax - 1)
    head.append(to - (to // emax) * (emax - 1))
    if sum(head) >= tc:
        raise ValueError(f"bucket_tables: {p} rows hold no runs past the "
                         f"first {sum(head)}")
    tail = np.where(rng.random(tc) < 0.2, 1, rng.integers(2, 601, tc))
    tail = tail[:np.searchsorted(np.cumsum(tail), tc - sum(head)) + 1]
    cnt = np.concatenate([head, tail]).astype(np.int64)
    cnt[-1] -= cnt.sum() - tc
    dst = np.cumsum(cnt) - cnt
    order = rng.permutation(len(cnt))
    src = np.empty_like(cnt)
    src[order] = np.cumsum(cnt[order]) - cnt[order]
    edges = np.arange(nout, dtype=np.int64) * to
    lo = np.searchsorted(dst, edges, side="right") - 1
    met = np.searchsorted(dst, edges + to, side="left") - lo
    if met.max() > emax or met[3] != emax:
        raise ValueError(f"bucket_tables: blocks met by {met.tolist()} runs")
    pad = np.full(emax, DEAD_DST, np.int64)
    cols = [np.concatenate([a, fill]) for a, fill in
            ((dst, pad), (src, 0 * pad), (cnt, 0 * pad))]
    sl = lo[:, None] + np.arange(emax)[None, :]
    tbl = np.stack([c[sl] for c in cols], axis=1).astype(np.int32)
    key_s = rng.integers(-2 ** 31, 2 ** 31 - 1, tc, dtype=np.int64)
    pay_s = rng.standard_normal((nc, tc)).astype(np.float32)
    return (torch.as_tensor(key_s.astype(np.int32), device=device),
            torch.as_tensor(pay_s, device=device),
            torch.as_tensor(tbl, device=device),
            np.stack([dst, src, cnt], axis=1))


def _skewed_counts(rng, n: int, big: int, band: float) -> np.ndarray:
    """The int64 particles per cell, (n^3,), of the skewed states."""
    counts = np.zeros((n, n, n), np.int64)
    h = max(1, int(band * n) // 2)
    c = n // 2
    sub = counts[c - h:c + h + 1, c - h:c + h + 1, c - h:c + h + 1]
    sub[...] = np.where(rng.random(sub.shape) < 1 / 3,
                        rng.integers(1, 301, sub.shape), 0)
    faces = [(0, slice(None), slice(None)), (n - 1, slice(None), slice(None)),
             (slice(None), 0, slice(None)), (slice(None), n - 1, slice(None)),
             (slice(None), slice(None), 0), (slice(None), slice(None), n - 1)]
    for f in faces:
        face = counts[f]
        face[...] = np.where(rng.random(face.shape) < 0.01,
                             rng.integers(1, 301, face.shape), 0)
    counts[0, 0, 0] = counts[n - 1, n - 1, n - 1] = 7
    counts[c, c, c] = big
    counts[c + 1, c, c], counts[c, c + 1, c] = CHUNK, CHUNK + 1
    counts[c, c, c + 1] = 2 * CHUNK
    counts[c - 1, c - 1, c] = 2 * CHUNK + 1
    return counts.reshape(-1)


def skewed_force_state(seed: int, n: int, big: int, band: float = 0.3,
                       device="cpu"):
    """A sorted K1 fg state on an n^3 grid: ``big`` particles in the centre
    cell; cells of exactly C, C + 1, 2 C and 2 C + 1 particles beside it
    (C = ``CHUNK``, the most particles in one chunk of a K1 plan); 1-300
    particles in a third of the cells of a band of ``band * n`` cells
    around the centre and in 1% of the cells of each of the six faces; 7 in
    two corners; the rest of the grid empty, so most target cells have an
    empty neighbourhood.  Returns ``(gradw, m9, cell_start, counts)``:
    random f32 gradW (81, P) and M (P, 9), the int32 cell ranges (n^3 +
    1,), and the int64 numpy particles per cell."""
    rng = np.random.default_rng(seed)
    counts = _skewed_counts(rng, n, big, band)
    p = int(counts.sum())
    cell_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    gradw = rng.standard_normal((81, p)).astype(np.float32)
    m9 = rng.standard_normal((p, 9)).astype(np.float32)
    return (torch.as_tensor(gradw, device=device),
            torch.as_tensor(m9, device=device),
            torch.as_tensor(cell_start, device=device), counts)


def skewed_wv_state(seed: int, n: int, big: int, band: float = 0.3,
                    device="cpu"):
    """The K1 and K1 aff inputs on ``skewed_force_state``'s cells (the same
    counts for the same arguments): random weights in [0, 1) (27, P),
    velocities (P, 3) and affine matrices (P, 9, scale 0.5), f32.  Returns
    ``(w27t, vel, aff, cell_start, counts)``."""
    rng = np.random.default_rng(seed)
    counts = _skewed_counts(rng, n, big, band)
    p = int(counts.sum())
    cell_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    w27t = rng.random((27, p)).astype(np.float32)
    vel = rng.normal(scale=3.0, size=(p, 3)).astype(np.float32)
    aff = rng.normal(scale=0.5, size=(p, 9)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (w27t, vel, aff, cell_start)) + (counts,)
