"""The port's particle partition (``fluidsim_tpu_torch/ops/partition.py``)
against the JAX package's on the same seeded positions: one case for each
case of ``tests/test_partition.py``.  Cells, counts, offsets and
neighbour counts agree bit for bit.  The port sorts stably, so its order
is numpy's stable argsort bit for bit; the JAX sort is not asked to be
stable, so against it each cell's ids are compared as sets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.ops import partition as jpt
from fluidsim_tpu_torch.ops import partition as pt

B = 6
N = 2 * B + 1


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_particles(p=500, seed=0, spread=B - 0.51):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, size=(p, 3)).astype(np.float32)
    pos[:20] = np.round(pos[:20]) + np.float32(0.5)   # half-even ties
    return pos


def _both(pos):
    part = pt.partition_by_cell(torch.as_tensor(pos), B)
    jpart = jpt.partition_by_cell(jnp.asarray(pos), B)
    return part, jpart


@pytest.mark.parametrize("spread", [B - 0.51, B + 3.0])
def test_counts_match_numpy(spread):
    pos = _random_particles(spread=spread)
    part, jpart = _both(pos)
    for name in ("counts", "offsets", "cell_of"):
        got = getattr(part, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jpart, name)))
    flat = pt.cells_of(torch.as_tensor(pos), B).numpy()
    np.testing.assert_array_equal(flat, np.asarray(
        jpt.cells_of(jnp.asarray(pos), B)))
    assert np.array_equal(part.counts.numpy(), np.bincount(flat,
                                                           minlength=N ** 3))
    assert int(part.offsets[-1]) == len(pos)


def test_order_groups_particles_by_cell():
    pos = _random_particles(300, seed=1)
    part, jpart = _both(pos)
    flat = pt.cells_of(torch.as_tensor(pos), B).numpy()
    order = part.order.numpy()
    assert part.order.dtype == torch.int32
    np.testing.assert_array_equal(order, np.argsort(flat, kind="stable"))
    jorder = np.asarray(jpart.order)
    off = part.offsets.numpy()
    for c in np.flatnonzero(part.counts.numpy()):
        assert (set(order[off[c]:off[c + 1]])
                == set(jorder[off[c]:off[c + 1]]))


def test_points_in_cell_query():
    pos = _random_particles(400, seed=2)
    part, jpart = _both(pos)
    counts = part.counts.numpy()
    for target, cap in ((int(np.argmax(counts)), int(counts.max()) + 3),
                        (int(np.argmin(counts)), 4), (0, 2)):
        ids, count = pt.points_in_cell(part, target, capacity=cap)
        jids, jcount = jpt.points_in_cell(jpart, target, capacity=cap)
        assert int(count) == int(jcount)
        ids, jids = ids.numpy(), np.asarray(jids)
        np.testing.assert_array_equal(ids < 0, jids < 0)
        assert set(ids[ids >= 0]) == set(jids[jids >= 0])
        assert (ids[int(count):] == -1).all()


@pytest.mark.parametrize("radius", [1, 2])
def test_neighbor_counts_against_numpy(radius):
    pos = _random_particles(250, seed=3)
    part, jpart = _both(pos)
    nc = pt.neighbor_counts(part, B, radius=radius).numpy()
    np.testing.assert_array_equal(
        nc, np.asarray(jpt.neighbor_counts(jpart, B, radius=radius)))
    c = part.counts.numpy().reshape(N, N, N)
    pad = np.pad(c, radius)
    expect = np.zeros_like(c)
    w = 2 * radius + 1
    for dx in range(w):
        for dy in range(w):
            for dz in range(w):
                expect += pad[dx:dx + N, dy:dy + N, dz:dz + N]
    assert np.array_equal(nc, expect)
