"""The CPU side of the port's span kernels (K9a ``p2g_scatter_spans``, K9b
``g2p_gather_spans``): K9a's tile plan (``span_tile_starts_plain``) and the
order check both kernels run on the device (``span_order_flag_plain``),
each against numpy, and the wrappers refusing ids outside the box.

The kernels themselves run only on the card, where ``chip_smoke.py`` (phase
20) holds the kernels' plan and flag to these plain versions bit for bit;
``tests/test_torch_table.py`` compares the wrappers with the JAX span
kernels in interpret mode.  Everything here is integer arithmetic or a
bitwise comparison: no tolerance.
"""

import numpy as np
import pytest
import torch

from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.utils import synthetic


def _ids(kind: str, n: int) -> np.ndarray:
    """int32 cell ids at n^3: sorted (3 particles a cell on average, the
    upper quarter of the ids empty), one particle, none, or the sorted ids
    shuffled."""
    rng = np.random.default_rng(n)
    n3 = n ** 3
    if kind == "empty":
        return np.zeros(0, np.int32)
    if kind == "one":
        return np.array([n3 // 2], np.int32)
    flat = np.sort(rng.integers(0, 3 * n3 // 4, 3 * n3)).astype(np.int32)
    return rng.permutation(flat) if kind == "unsorted" else flat


def _halving_search(flat: np.ndarray, key: int) -> int:
    """The first p with flat[p] >= key by halving [0, P), as the kernel
    searches: on an unsorted order too its answer lies in [0, P]."""
    lo, hi = 0, flat.size
    while lo < hi:
        mid = (lo + hi) >> 1
        if flat[mid] < key:
            lo = mid + 1
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("n", [25, 45])       # n^3 not a multiple of 128
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "empty", "one"])
def test_span_tile_plan_against_numpy(kind, n):
    flat = _ids(kind, n)
    n3 = n ** 3
    ts = tk.span_tile_starts_plain(torch.as_tensor(flat), n3).numpy()
    ntiles = -(-n3 // tk.SPAN_CELLS)
    edges = np.minimum(np.arange(ntiles + 1) * tk.SPAN_CELLS, n3)
    assert ts.dtype == np.int32 and ts.shape == (ntiles + 1,)
    np.testing.assert_array_equal(
        ts, [_halving_search(flat, int(e)) for e in edges])
    # every tile's range [lo, hi) lies in [0, P] with lo <= hi
    assert ts.min() >= 0 and ts.max() <= flat.size
    assert (np.diff(ts) >= 0).all()
    if kind != "unsorted":
        np.testing.assert_array_equal(ts, np.searchsorted(flat, edges))
        assert ts[0] == 0 and ts[-1] == flat.size
        # every particle lies in its tile's range
        tile = flat // tk.SPAN_CELLS
        assert (ts[tile] <= np.arange(flat.size)).all()
        assert (np.arange(flat.size) < ts[tile + 1]).all()


def _flag(flat: np.ndarray, n3: int) -> int:
    out = tk.span_order_flag_plain(torch.as_tensor(flat), n3)
    assert out.dtype == torch.int32 and out.shape == ()
    return int(out)


@pytest.mark.parametrize("kind", ["sorted", "empty", "one"])
def test_span_order_flag_is_0_on_sorted_ids(kind):
    n = 25
    assert _flag(_ids(kind, n), n ** 3) == 0


@pytest.mark.parametrize("where", ["start", "middle", "end"])
def test_span_order_flag_sets_on_one_inverted_pair(where):
    n = 25
    flat = np.unique(_ids("sorted", n))       # strictly increasing
    i = {"start": 0, "middle": flat.size // 2, "end": flat.size - 2}[where]
    flat[[i, i + 1]] = flat[[i + 1, i]]
    assert _flag(flat, n ** 3) == 1


@pytest.mark.parametrize("bad", ["-1 first", "n^3 last"])
def test_span_order_flag_sets_on_an_id_outside_the_box(bad):
    n = 25
    flat = _ids("sorted", n)
    if bad == "-1 first":
        flat[0] = -1
    else:
        flat[-1] = n ** 3
    assert np.all(np.diff(flat) >= 0)         # still sorted
    assert _flag(flat, n ** 3) == 1


def _small_state(n: int = 5, p: int = 40):
    rng = np.random.default_rng(n)
    flat = np.sort(rng.integers(0, n ** 3, p)).astype(np.int32)
    fm = rng.normal(size=(4, n, n, n)).astype(np.float32)
    return (torch.as_tensor(flat),
            torch.as_tensor(rng.random((27, p)).astype(np.float32)),
            torch.as_tensor(rng.normal(size=(p, 3)).astype(np.float32)),
            tk.shift_expand_plain(torch.as_tensor(fm)))


@pytest.mark.parametrize("which", ["p2g_scatter_spans", "g2p_gather_spans",
                                   "g2p_gather_spans moments"])
@pytest.mark.parametrize("bad", ["-1 first", "n^3 last"])
def test_k9_wrappers_raise_on_cpu_for_an_id_outside_the_box(which, bad):
    n = 5
    flat, w27t, vel, table = _small_state(n)
    flat = flat.clone()
    if bad == "-1 first":
        flat[0] = -1
    else:
        flat[-1] = n ** 3
    before = (tk.p2g_scatter_spans.launches, tk.g2p_gather_spans.launches)
    with pytest.raises(ValueError, match="must be sorted by cell id"):
        if which == "p2g_scatter_spans":
            tk.p2g_scatter_spans(w27t, vel, flat, n)
        else:
            tk.g2p_gather_spans(table, w27t, flat,
                                moments=which.endswith("moments"))
    assert (tk.p2g_scatter_spans.launches,
            tk.g2p_gather_spans.launches) == before


@pytest.mark.parametrize("mode", ["flip", "apic"])
def test_k9a_on_a_skewed_sorted_state_sums_in_array_order(mode):
    """The skewed window state sorted by cell (one cell of 600 particles,
    a ragged last tile): the CPU K9a equals ``p2g_scatter_base_ordered``,
    the kernel's summation order, bit for bit."""
    n = 17
    w27t, vel, aff, flat, counts = synthetic.skewed_window_state(3, n, 600)
    flat, perm = torch.sort(flat, stable=True)
    w27t, vel, aff = w27t[:, perm], vel[perm], aff[perm]
    aff = aff if mode == "apic" else None
    assert counts.max() == 600 and n ** 3 % tk.SPAN_CELLS
    out = tk.p2g_scatter_spans(w27t, vel, flat, n, aff)
    np.testing.assert_array_equal(
        out.numpy(), tk.p2g_scatter_base_ordered(w27t, vel, flat, n,
                                                 aff).numpy())
