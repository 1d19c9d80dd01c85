"""The port's sorted transfers (``ops/transfer_kernels.py``) against the JAX
Pallas transfer pipeline (``ops/transfer_pallas.py``) run in interpret mode.

On CPU tensors the K1/K2 wrappers run their plain PyTorch versions; the CUDA
kernels themselves are compared with those on the card by ``chip_smoke.py``.

Tolerances: the sort order, the flat ids and the stencil weights are
selections and identical f32 expressions, so they must agree exactly.  P2G
and G2P are f32 sums over up to 27 x (particles per cell) terms taken in
another order than the TPU kernels' one-hot matmuls, hence atol 1e-5 /
rtol 1e-5 for P2G and atol 1e-5 / rtol 1e-4 for the normalised G2P (the
bounds ``tests/test_transfer_pallas.py`` holds the Pallas path to).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fluidsim_tpu.core.gridspec import cell_center_velocity_cm as j_centre
from fluidsim_tpu.ops import transfer as jtr
from fluidsim_tpu.ops import transfer_pallas as tp
from fluidsim_tpu.scenes import get_scene
from fluidsim_tpu.seeding import seed_particles
from fluidsim_tpu_torch.core.gridspec import cell_center_velocity_cm
from fluidsim_tpu_torch.ops import transfer as ttr
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.utils import synthetic

BOUND = 8
N = 2 * BOUND + 1


@pytest.fixture(scope="module")
def particles():
    """Seeded cube particles plus particles spread over the whole interior
    (some on exact .5 coordinates, where rounding decides the base cell),
    with random velocities."""
    scene = get_scene("water_cube_drop", bound=BOUND, density=3.0)
    pos, _ = seed_particles(scene, seed=0)
    rng = np.random.default_rng(5)
    spread = rng.uniform(-(BOUND - 1.5), BOUND - 1.5, size=(300, 3))
    halves = rng.integers(-(BOUND - 3), BOUND - 3, size=(40, 3)) + 0.5
    pos = np.concatenate([pos, spread, halves]).astype(np.float32)
    vel = rng.normal(scale=3.0, size=pos.shape).astype(np.float32)
    return scene, pos, vel


@pytest.fixture(scope="module")
def sorted_both(particles):
    scene, pos, vel = particles
    lay = tp.HaloLayout(N)
    jp, jv, jflat = tp.sort_by_cell_h(jnp.asarray(pos), jnp.asarray(vel),
                                      BOUND, lay)
    tpos, tvel, tflat = tk.sort_by_cell(torch.as_tensor(pos),
                                        torch.as_tensor(vel), BOUND)
    return scene, lay, (jp, jv, jflat), (tpos, tvel, tflat)


def test_sort_order_is_the_stable_cell_order(sorted_both):
    _, lay, (jp, jv, jflat), (tpos, tvel, tflat) = sorted_both
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tvel.numpy(), np.asarray(jv))
    # the haloed id and the plain flat id name the same cell
    from fluidsim_tpu.ops import pallas_shift as ps
    jh = np.asarray(jflat).astype(np.int64)
    x = jh // lay.lwr - ps._XH
    yz = jh % lay.lwr - lay.lh
    np.testing.assert_array_equal(tflat.numpy(), x * N * N + yz)


def test_cell_starts_bound_each_cells_range(sorted_both):
    *_, (_, _, tflat) = sorted_both
    cs = tk.cell_starts(tflat, N).numpy()
    assert cs.dtype == np.int32 and cs.shape == (N ** 3 + 1,)
    counts = np.bincount(tflat.numpy(), minlength=N ** 3)
    np.testing.assert_array_equal(np.diff(cs), counts)
    assert cs[0] == 0 and cs[-1] == tflat.shape[0]


def test_masked_weights_cm_exact(sorted_both):
    _, _, (jp, *_), (tpos, *_) = sorted_both
    np.testing.assert_array_equal(
        tk.masked_weights_cm(tpos, BOUND, "flip").numpy(),
        np.asarray(tp.masked_weights_cm(jp, BOUND, "flip")))


@pytest.fixture(scope="module")
def p2g_both(sorted_both):
    scene, lay, (jp, jv, jflat), (tpos, tvel, tflat) = sorted_both
    jsolid = jnp.asarray(scene.solid)
    jw, jmom, jocc, wv = tp.p2g_pallas(jp, jv, jflat, jsolid, BOUND, lay,
                                       "flip", interpret=True,
                                       channel_major=True)
    w27t = tk.masked_weights_cm(tpos, BOUND, "flip")
    tw, tmom, tocc = tk.p2g(w27t, tvel, tflat, torch.as_tensor(scene.solid),
                            BOUND)
    return (jw, jmom, jocc, wv), (tw, tmom, tocc, w27t)


def test_p2g_matches_pallas(p2g_both):
    (jw, jmom, jocc, _), (tw, tmom, tocc, _) = p2g_both
    assert tmom.shape == (3, N, N, N)
    for name, a, b in (("weights", tw, jw), ("momentum", tmom, jmom),
                       ("occupancy", tocc, jocc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert float(tw.sum()) > 0


def test_g2p_matches_pallas(sorted_both, p2g_both):
    scene, lay, (jp, _, jflat), (_, _, tflat) = sorted_both
    (jw, jmom, _, wv), (_, _, _, w27t) = p2g_both
    # the fields a frame gathers: cell-centred, normalised grid velocity
    jvc = j_centre(jtr.normalize_velocity_cm(jw, jmom))
    vc = cell_center_velocity_cm(ttr.normalize_velocity_cm(
        torch.as_tensor(np.array(jw)), torch.as_tensor(np.array(jmom))))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(jvc))
    wall = scene.spec.wall
    ref = tp.g2p_pallas(jp, jflat, jvc, BOUND, wall, lay, "flip",
                        wv_rows=wv, interpret=True, channel_major=True)
    out = tk.g2p(w27t, tflat, vc, BOUND, wall)
    assert out.shape == (jp.shape[0], 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)
    # two channels take the same normalisation
    ref2 = tp.g2p_pallas(jp, jflat, jvc[:2], BOUND, wall, lay, "flip",
                         wv_rows=wv, interpret=True, channel_major=True)
    np.testing.assert_allclose(tk.g2p(w27t, tflat, vc[:2], BOUND, wall).numpy(),
                               np.asarray(ref2), atol=1e-5, rtol=1e-4)


def test_wrappers_take_the_plain_version_on_cpu_only(sorted_both):
    *_, (tpos, tvel, tflat) = sorted_both
    w27t = tk.masked_weights_cm(tpos, BOUND, "flip")
    cs = tk.cell_starts(tflat, N)
    before = tk.p2g_scatter.launches
    np.testing.assert_array_equal(tk.p2g_scatter(w27t, tvel, cs, N).numpy(),
                                  tk.p2g_scatter_plain(w27t, tvel, cs, N).numpy())
    fm = torch.as_tensor(
        np.random.default_rng(0).random((4, N, N, N)).astype(np.float32))
    np.testing.assert_array_equal(tk.g2p_gather(fm, w27t, tflat).numpy(),
                                  tk.g2p_gather_plain(fm, w27t, tflat).numpy())
    assert tk.p2g_scatter.launches == before       # counts kernel launches only
    # a device with no kernel and no plain route raises instead of falling back
    with pytest.raises(ValueError):
        tk.p2g_scatter(w27t.to("meta"), tvel.to("meta"), cs.to("meta"), N)
    with pytest.raises(ValueError):
        tk.g2p_gather(fm.to("meta"), w27t.to("meta"), tflat.to("meta"))


@pytest.mark.parametrize("case", ["flip", "skewed"])
def test_p2g_scatter_chunked_matches_plain(sorted_both, case):
    """``p2g_scatter_chunked``, the order of K1's CUDA kernels (chunk sums,
    records, pull) in PyTorch, against the plain K1 on the JAX-compared FLIP
    state and on ``utils/synthetic.skewed_wv_state`` (2,000 particles in one
    cell, cells of exactly one and two chunks): within 1e-5 of
    ``max|plain|``, the bound of f32 sums of up to 27 x 2,000 terms taken in
    another order."""
    if case == "flip":
        *_, (tpos, tvel, tflat) = sorted_both
        w27t, vel, n = tk.masked_weights_cm(tpos, BOUND, "flip"), tvel, N
        cs = tk.cell_starts(tflat, n)
    else:
        w27t, vel, _, cs, counts = synthetic.skewed_wv_state(0, 24, 2000)
        n = 24
        assert counts.max() > 10 * tk.CHUNK
    plan = tk.chunk_plan(cs, vel.shape[0])
    ref = tk.p2g_scatter_plain(w27t, vel, cs, n)
    out = tk.p2g_scatter_chunked(w27t, vel, plan, n)
    scale = float(ref.abs().max())
    assert out.shape == (4, n, n, n) and scale > 1.0
    assert float((out - ref).abs().max()) <= 1e-5 * scale
