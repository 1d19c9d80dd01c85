"""Synthetic kernel inputs that a frame's state may not reach, made from a
seed with numpy: the run tables of the bucket move (K5), skewed sorted
states for the K1 modes (K1, K1 aff, K1 fg), a skewed window-grouped
state for the base-cell scatter (K6a), a skewed sorted row state for
the row scatter-add (K8b), the edge cases of the G2P gather's tiles
(K2) and 3x3 matrices for the MPM chain's kernels (``mat3_cases``).
``chip_smoke.py`` holds the CUDA
kernels to their plain versions on them, and the CPU tests hold the plain
versions and the plans to numpy on the same inputs."""

from __future__ import annotations

import numpy as np
import torch

from fluidsim_tpu_torch.ops.bucket_sort import DEAD_DST
from fluidsim_tpu_torch.ops.transfer_kernels import CHUNK, WINDOW


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


def skewed_window_state(seed: int, n: int, big: int, fill: float = 0.05,
                        device="cpu"):
    """A K6a state on an n^3 grid (n^3 not a multiple of ``WINDOW``), its
    particles grouped by ``WINDOW``-cell window of their cell id and
    shuffled inside each window: 1-40 particles in a fraction ``fill`` of
    the cells of the lower half of the ids (the upper half's windows stay
    empty); 5 in every cell of window 1 (a span of 2,560 ids); ``big`` in
    the centre cell; 1-3 in every cell of the ragged last window.  Returns
    ``(w27t, vel, aff, flat_s, counts)``: random weights in [0, 1) (27, P),
    velocities (P, 3), affine matrices (P, 9, scale 0.5), f32, the int32
    cell ids (P,), and the int64 numpy particles per cell (n^3,)."""
    n3 = n ** 3
    last = n3 // WINDOW * WINDOW
    centre = (n // 2 * n + n // 2) * n + n // 2
    if last == n3 or last < 3 * WINDOW or centre // WINDOW in (1, last // WINDOW):
        raise ValueError(f"skewed_window_state: n = {n} gives no ragged last "
                         "window, or one that is window 1 or the centre's")
    rng = np.random.default_rng(seed)
    counts = np.zeros(n3, np.int64)
    half = counts[:n3 // 2]
    half[...] = np.where(rng.random(half.shape) < fill,
                         rng.integers(1, 41, half.shape), 0)
    counts[WINDOW:2 * WINDOW] = 5
    counts[last:] = rng.integers(1, 4, n3 - last)
    counts[centre] = big
    flat = np.repeat(np.arange(n3), counts)
    flat = flat[np.lexsort((rng.random(flat.size), flat // WINDOW))]
    p = flat.size
    w27t = rng.random((27, p)).astype(np.float32)
    vel = rng.normal(scale=3.0, size=(p, 3)).astype(np.float32)
    aff = rng.normal(scale=0.5, size=(p, 9)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (w27t, vel, aff, flat.astype(np.int32))) + (counts,)


def skewed_row_state(seed: int, n: int, big: int, device="cpu"):
    """A K8b state on an n^3 grid, sorted by cell: 1-40 rows in 5% of the
    cells of the lower half of the ids (the upper half stays empty), ``big`` rows in the centre cell and 1-3 in each of the
    last 200 cells (a ragged last tile where n^3 is not a multiple of
    ``rows.SCATTER_CELLS``).  Returns ``(u_rows, flat_s, counts)``: random
    f32 rows (P + 8, 128) (8 rows past P), the int32 cell ids (P,), and the
    int64 numpy rows per cell (n^3,)."""
    n3 = n ** 3
    centre = (n // 2 * n + n // 2) * n + n // 2
    rng = np.random.default_rng(seed)
    counts = np.zeros(n3, np.int64)
    half = counts[:n3 // 2]
    half[...] = np.where(rng.random(half.shape) < 0.05,
                         rng.integers(1, 41, half.shape), 0)
    counts[n3 - 200:] = rng.integers(1, 4, 200)
    counts[centre] = big
    flat = np.repeat(np.arange(n3, dtype=np.int32), counts)
    rows = rng.standard_normal((flat.size + 8, 128), dtype=np.float32)
    return (torch.as_tensor(rows, device=device),
            torch.as_tensor(flat, device=device), counts)


def gather_edge_cases(p: int, n: int, seed: int = 0, device="cpu"):
    """K2 inputs that reach each path of its tiles of 128 sorted rows
    (``kGatherTile`` in ``csrc/transfer.cu``; K2 moments' tiles take the
    cases without a count), each ``(name, fm, w27t, flat, count)`` with
    ``p`` rows (any ``p``: one not a multiple of 4, one
    on either side of a tile's end), random positive
    weights and random fields that are not zero on the box faces:

    - ``rows``: about 24 particles a cell along a z run from the end of an
      (x, y) row into the next and on across an x plane;
    - ``faces``: particles on random cells of the box's faces, edges and
      corners;
    - ``dense``: every particle in 3 cells of the box's corner (staged
      tiles reading zeros outside the grid);
    - ``wide``: ids spread over the whole grid (tiles reading the fields
      directly);
    - ``grouped``: the ``rows`` ids shuffled inside each 512-cell window,
      as the bucket path orders them (a tile's first and last ids need not
      bound the rest);
    - ``count_split``, ``count_zero``, ``count_all``: the ``rows`` ids
      with a live count inside a tile, 0 and ``p``, the slots past it
      dead (id ``n^3``);
    - ``slab``: an x slab of 5 rows of the grid holding the ``faces``
      particles that fall in it, the rest dead, with their count.
    """
    rng = np.random.default_rng(seed)
    ncell = n ** 3
    fm = torch.as_tensor(rng.normal(size=(4, n, n, n)).astype(np.float32),
                         device=device)
    w27t = torch.as_tensor(rng.random((27, p), dtype=np.float32),
                           device=device)
    f0 = (1 * n + n - 1) * n + n - 3
    rows = np.minimum(f0 + np.arange(p) // 24, ncell - 1)
    face = rng.integers(0, n, size=(p, 3))
    side = rng.integers(0, 3, size=p)
    face[np.arange(p), side] = rng.integers(0, 2, size=p) * (n - 1)
    faces = np.sort((face[:, 0] * n + face[:, 1]) * n + face[:, 2])
    dense = np.sort(rng.choice(np.array([0, 1, n]), size=p))
    wide = np.sort(rng.integers(0, ncell, size=p))

    def ids(a):
        return torch.as_tensor(a.astype(np.int32), device=device)

    def counted(a, live, dead):
        a = a.copy()
        a[live:] = dead
        return ids(a), torch.tensor([live], dtype=torch.int32, device=device)

    grouped = rows[np.lexsort((rng.random(p), rows // 512))]
    cases = [("rows", fm, w27t, ids(rows), None),
             ("faces", fm, w27t, ids(faces), None),
             ("dense", fm, w27t, ids(dense), None),
             ("wide", fm, w27t, ids(wide), None),
             ("grouped", fm, w27t, ids(grouped), None)]
    for name, live in (("count_split", p // 2 + 3), ("count_zero", 0),
                       ("count_all", p)):
        cases.append((name, fm, w27t, *counted(rows, min(live, p), ncell)))
    nx = 5
    cut = int(np.searchsorted(faces, nx * n * n))
    cases.append(("slab", fm[:, :nx].contiguous(), w27t,
                  *counted(faces, cut, nx * n * n)))
    return cases


# the kinds of ``mat3_cases``: tests/test_torch_mpm_kernels.py's four, the F
# update's neighbourhood of the identity, then the edge cases of svd3's
# branches
MAT3_KINDS = ("random", "near_singular", "rotation", "inverted",
              "near_identity", "zero", "rank1", "rank2", "negative_det",
              "equal_singular", "zero_offdiag")


def mat3_cases(kind: str, count: int = 2000, seed: int = 0) -> np.ndarray:
    """(count, 3, 3) f32 matrices of one of ``MAT3_KINDS``:

    - ``random``, ``near_singular`` (a smallest singular value below 1e-4,
      half with the two largest equal), ``rotation`` and ``inverted``
      (``I + 0.3 N`` with a column negated), as the CPU tests draw them;
    - ``near_identity``: ``I + 0.05 N``, deformation gradients;
    - ``zero``; ``rank1`` (``a b^T``) and ``rank2`` (a zero singular
      value): U's Gram-Schmidt and rank-1 fallbacks;
    - ``negative_det``: random with det < 0 (the sign carried by U);
    - ``equal_singular``: scaled rotations, scaled identities and
      ``[[a, b, 0], [b, a, 0], [0, 0, c]]``, whose ``F^T F`` has equal
      diagonal entries (tau = 0) with exact zeros or not off it;
    - ``zero_offdiag``: random with one off-diagonal entry a row exactly
      0, a quarter of them diagonal.
    """
    base = {"random": 0, "near_singular": 1, "rotation": 2, "inverted": 3}
    rng = np.random.default_rng(seed * 16 + base.get(
        kind, 4 + MAT3_KINDS.index(kind)))
    f = rng.normal(size=(count, 3, 3))
    if kind == "near_singular":
        u, s, vt = np.linalg.svd(f)
        s[:, 2] = rng.uniform(0, 1e-4, size=count)
        s[: count // 2, 1] = s[: count // 2, 0]
        f = u @ (s[:, :, None] * vt)
    elif kind == "rotation":
        q, _ = np.linalg.qr(f)
        f = q * np.sign(np.linalg.det(q))[:, None, None]
    elif kind == "inverted":
        f = np.eye(3) + 0.3 * f
        f[:, :, 0] *= -1.0
    elif kind == "near_identity":
        f = np.eye(3) + 0.05 * f
    elif kind == "zero":
        f = np.zeros_like(f)
    elif kind == "rank1":
        f = f[:, :, :1] * rng.normal(size=(count, 1, 3))
    elif kind == "rank2":
        u, s, vt = np.linalg.svd(f)
        s[:, 2] = 0.0
        f = u @ (s[:, :, None] * vt)
    elif kind == "negative_det":
        f[:, :, 0] *= -np.sign(np.linalg.det(f))[:, None]
    elif kind == "equal_singular":
        q, _ = np.linalg.qr(f)
        scale = rng.choice([0.5, 1.0, 2.0, 3.0], size=(count, 1, 1))
        f = q * scale
        third = count // 3
        f[:third] = np.eye(3) * scale[:third]
        rest = count - 2 * third
        g = np.zeros((rest, 3, 3))
        g[:, 0, 0] = g[:, 1, 1] = rng.choice([1.0, 1.5, 2.0], size=rest)
        g[:, 0, 1] = g[:, 1, 0] = rng.choice([0.25, 0.5], size=rest)
        g[:, 2, 2] = rng.choice([0.5, 1.0, 2.0], size=rest)
        f[2 * third:] = g
    elif kind == "zero_offdiag":
        for i in range(3):
            j = (i + 1 + rng.integers(0, 2, size=count)) % 3
            f[np.arange(count), i, j] = 0.0
        f[: count // 4] *= np.eye(3)
    elif kind != "random":
        raise ValueError(f"mat3_cases: unknown kind {kind!r}")
    return f.astype(np.float32)
