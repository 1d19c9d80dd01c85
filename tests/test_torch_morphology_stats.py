"""The port's morphology and statistics (``fluidsim_tpu_torch/ops/
morphology.py``, ``ops/statistics.py``) against the JAX package's on the
same seeded inputs: one case for each case of
``tests/test_morphology_stats.py``.  Masks, extrema and histogram counts
agree bit for bit; the moments within a tolerance scaled by the values'
rms (f32 sums in another order; see ``_same_stats``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsim_tpu.ops import gridops as jg
from fluidsim_tpu.ops import morphology as jm
from fluidsim_tpu.ops import statistics as jst
from fluidsim_tpu_torch.ops import gridops as g
from fluidsim_tpu_torch.ops import morphology as m
from fluidsim_tpu_torch.ops import statistics as st

N = 17
C = N // 2
PATTERNS = [m.NN_FACE, m.NN_FACE_EDGE, m.NN_FACE_EDGE_VERTEX]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _single():
    a = np.zeros((N, N, N), bool)
    a[C, C, C] = True
    return a


def _random_mask(seed, p=0.6):
    return np.random.default_rng(seed).random((N, N, N)) < p


def _same_mask(fn, jfn, mask, *args):
    got = fn(torch.as_tensor(mask), *args).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(mask),
                                                      *args)))
    return got


@pytest.mark.parametrize("pattern", PATTERNS)
def test_dilate_neighborhood_counts(pattern):
    assert _same_mask(m.dilate, jm.dilate, _single(), 1,
                      pattern).sum() == 1 + pattern
    _same_mask(m.dilate, jm.dilate, _random_mask(0, 0.05), 2, pattern)


def test_dilate_face_two_steps_is_l1_ball():
    got = _same_mask(m.dilate, jm.dilate, _single(), 2, m.NN_FACE)
    x = np.abs(np.arange(N) - C)
    l1 = x[:, None, None] + x[None, :, None] + x[None, None, :]
    assert np.array_equal(got, l1 <= 2)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_erode_inverts_dilate_on_ball(pattern):
    ball = m.dilate(torch.as_tensor(_single()), 3, m.NN_FACE).numpy()
    e = _same_mask(m.erode, jm.erode, ball, 1, pattern)
    if pattern == m.NN_FACE:
        assert np.array_equal(
            e, m.dilate(torch.as_tensor(_single()), 2, m.NN_FACE).numpy())
    assert _same_mask(m.erode, jm.erode, _single(), 1, pattern).sum() == 0
    _same_mask(m.erode, jm.erode, _random_mask(1, 0.9), 2, pattern)
    with pytest.raises(ValueError):
        m.erode(torch.as_tensor(ball), 1, 12)


def test_erode_at_box_edge():
    e = _same_mask(m.erode, jm.erode, np.ones((N, N, N), bool), 1, m.NN_FACE)
    assert e[1:-1, 1:-1, 1:-1].all()
    assert not e[0].any() and not e[-1].any() and not e[:, :, -1].any()


@pytest.mark.parametrize("pattern", PATTERNS)
def test_opening_removes_speckle_closing_fills_hole(pattern):
    blob = m.dilate(torch.as_tensor(_single()), 3,
                    m.NN_FACE_EDGE_VERTEX).numpy()
    speckled = blob.copy()
    speckled[1, 1, 1] = True
    o = _same_mask(m.opening, jm.opening, speckled, 1, pattern)
    assert not o[1, 1, 1] and o[C, C, C]
    holed = blob.copy()
    holed[C, C, C] = False
    assert _same_mask(m.closing, jm.closing, holed, 1, pattern)[C, C, C]
    _same_mask(m.opening, jm.opening, _random_mask(2), 1, pattern)
    _same_mask(m.closing, jm.closing, _random_mask(3), 1, pattern)


def _same_stats(got, want):
    """The moments' f32 noise scales with the values' rms, ``E[v²]^½``,
    not with the result (the sums cancel): min and max within 1e-6 of
    the rms, the mean within 1e-4 of it, the variance ``E[v²] - mean²``
    within 1e-5 of ``E[v²]``, the std within the square root of that."""
    ev2 = float(want.variance) + float(want.mean) ** 2
    for name, tol in (("min", 1e-6), ("max", 1e-6), ("mean", 1e-4)):
        diff = abs(float(getattr(got, name)) - float(getattr(want, name)))
        assert diff <= tol * ev2 ** 0.5, name
    assert abs(float(got.variance) - float(want.variance)) <= 1e-5 * ev2
    assert abs(float(got.std) - float(want.std)) <= (1e-5 * ev2) ** 0.5
    assert int(got.count) == int(want.count)
    assert got.count.dtype == torch.int32 and got.mean.dtype == torch.float32


def test_stats_against_numpy():
    rng = np.random.default_rng(3)
    v = rng.normal(2.0, 1.5, size=(N, N, N)).astype(np.float32)
    s = st.stats(torch.as_tensor(v))
    _same_stats(s, jst.stats(jnp.asarray(v)))
    assert float(s.min) == v.min() and float(s.max) == v.max()
    assert np.isclose(float(s.variance), v.var(), rtol=1e-3)
    mask = rng.random(v.shape) < 0.3
    _same_stats(st.stats(torch.as_tensor(v), torch.as_tensor(mask)),
                jst.stats(jnp.asarray(v), jnp.asarray(mask)))


def test_stats_masked_and_empty():
    v = np.arange(8.0, dtype=np.float32).reshape(2, 2, 2)
    mask = v >= 4
    s = st.stats(torch.as_tensor(v), mask=torch.as_tensor(mask))
    _same_stats(s, jst.stats(jnp.asarray(v), mask=jnp.asarray(mask)))
    assert float(s.min) == 4 and float(s.max) == 7 and int(s.count) == 4
    empty = np.zeros_like(mask)
    s0 = st.stats(torch.as_tensor(v), mask=torch.as_tensor(empty))
    _same_stats(s0, jst.stats(jnp.asarray(v), mask=jnp.asarray(empty)))
    assert int(s0.count) == 0 and float(s0.mean) == 0.0


@pytest.mark.parametrize("bins,lo,hi", [(10, 0.0, 100.0), (5, 0.0, 50.0),
                                        (7, -1.3, 2.9)])
def test_extrema_and_histogram(bins, lo, hi):
    v = np.arange(100, dtype=np.float32)
    h = st.histogram(torch.as_tensor(v), bins=bins, vmin=lo, vmax=hi)
    assert h.dtype == torch.int32
    np.testing.assert_array_equal(
        h.numpy(), np.asarray(jst.histogram(jnp.asarray(v), bins, lo, hi)))
    if bins == 10:
        assert (h.numpy() == 10).all()
    rng = np.random.default_rng(bins)
    r = rng.normal(1.0, 1.5, size=(N, N, N)).astype(np.float32)
    mask = rng.random(r.shape) < 0.5
    np.testing.assert_array_equal(
        st.histogram(torch.as_tensor(r), bins, lo, hi,
                     mask=torch.as_tensor(mask)).numpy(),
        np.asarray(jst.histogram(jnp.asarray(r), bins, lo, hi,
                                 mask=jnp.asarray(mask))))
    low, high = st.extrema(torch.as_tensor(r))
    jlow, jhigh = jst.extrema(jnp.asarray(r))
    assert float(low) == float(jlow) and float(high) == float(jhigh)


def test_op_stats_gradient_magnitude():
    c = np.arange(-C, C + 1, dtype=np.float32)
    f = np.broadcast_to(c[:, None, None], (N, N, N)).copy()
    f += np.random.default_rng(4).normal(0, 0.01, f.shape).astype(np.float32)
    interior = np.zeros((N, N, N), bool)
    interior[2:-2, 2:-2, 2:-2] = True
    s = st.op_stats(torch.as_tensor(f), lambda x: g.magnitude(g.gradient(x)),
                    mask=torch.as_tensor(interior))
    _same_stats(s, jst.op_stats(jnp.asarray(f),
                                lambda x: jg.magnitude(jg.gradient(x)),
                                mask=jnp.asarray(interior)))
    assert np.isclose(float(s.mean), 1.0, atol=1e-2)
    s2 = st.op_stats(torch.as_tensor(f), g.laplacian, dx=0.5)
    _same_stats(s2, jst.op_stats(jnp.asarray(f), jg.laplacian, dx=0.5))
