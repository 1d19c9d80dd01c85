"""Bit-exact reproduction of the reference's random streams — the
counterpart of ``fluidsim_tpu/compat/mt19937.py``.

The reference seeds ``std::mt19937`` (``fluid.cc:1348``, ``mpm.cc:1279``) and
draws through two libstdc++ distributions:

* ``std::uniform_int_distribution<Index64>`` over ``[0, voxelCount-1]``
  (``openvdb/math/Math.h:171-213`` RandInt used by
  ``UniformPointScatter``, ``PointScatter.h:158-160``),
* ``std::uniform_real_distribution<double>`` over ``[0,1)``
  (``Math.h:135-163`` Rand01, used for the in-voxel jitter,
  ``PointScatter.h:416-429``).

numpy's legacy ``RandomState`` initialises MT19937 with the same
``init_genrand`` recurrence as ``std::mt19937`` and produces the identical
raw 32-bit stream, so we pull raw words from it in bulk and replay the exact
libstdc++ distribution algorithms on top (vectorised where possible).
"""

from __future__ import annotations

import numpy as np


class Mt19937:
    """A std::mt19937-compatible raw-word stream."""

    def __init__(self, seed: int):
        self._bg = np.random.RandomState(seed)._bit_generator
        self._buf = np.empty(0, np.uint64)
        self._i = 0

    def raw(self, n: int) -> np.ndarray:
        """Next n uint32 words (as uint64 for arithmetic headroom)."""
        while self._i + n > len(self._buf):
            fresh = self._bg.random_raw(max(n, 1 << 16)).astype(np.uint64)
            self._buf = np.concatenate([self._buf[self._i:], fresh])
            self._i = 0
        out = self._buf[self._i:self._i + n]
        self._i += n
        return out

    def uniform_int(self, n: int, upper: int) -> np.ndarray:
        """n draws of libstdc++ (GCC >= 11) uniform_int_distribution over
        [0, upper] with a 32-bit engine.

        Uses Lemire's multiplicative method (``bits/uniform_int_dist.h``
        ``_S_nd``, citing Lemire TOMACS 2019): ``product = u64(g()) * range``;
        reject while ``u32(product) < (2^32 - range) % range``; result is
        ``product >> 32``.  One raw word consumed per draw (incl. rejected).
        """
        uerange = np.uint64(upper + 1)
        if upper + 1 > (1 << 32):
            raise NotImplementedError("range wider than 32-bit engine")
        threshold = np.uint64(((1 << 32) - int(uerange)) % int(uerange))
        out = np.empty(n, np.int64)
        filled = 0
        while filled < n:
            need = n - filled
            draws = self.raw(need + 16)
            product = draws * uerange
            low = product & np.uint64(0xFFFFFFFF)
            ok = low >= threshold
            good = (product[ok] >> np.uint64(32)).astype(np.int64)
            take = min(len(good), need)
            out[filled:filled + take] = good[:take]
            filled += take
            if take < len(good) or filled == n:
                accept_idx = np.flatnonzero(ok)
                last_used = accept_idx[take - 1] if take > 0 else -1
                self._i -= len(draws) - (last_used + 1)
                break
        return out

    def uniform_real(self, n: int) -> np.ndarray:
        """n draws of libstdc++ uniform_real_distribution<double> over [0,1).

        generate_canonical with a 32-bit engine uses 2 raw words per double,
        least-significant first: (w0 + w1 * 2^32) / 2^64.
        """
        w = self.raw(2 * n).reshape(n, 2)
        val = (w[:, 0] + np.float64(2.0 ** 32) * w[:, 1]) / np.float64(2.0 ** 64)
        # generate_canonical clamps values that round to 1.0
        return np.minimum(val, np.nextafter(1.0, 0.0))
