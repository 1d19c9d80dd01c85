"""The port's ``sort_method="bucket"`` path against the JAX package: the
window-grouped bucket sort (``ops/bucket_sort.py``, K5), the unfused P2G's
base-cell scatter (K6a, ``scatter_wv_cm``) and shift-reduce (K6b,
``reduce_haloed``) in Pallas interpret mode, and the bucket FLIP frame.

On CPU tensors the kernel wrappers run their plain PyTorch versions; the
CUDA kernels are compared with those on the card by ``chip_smoke.py``.

Tolerances: the bucket sort is a selection (stable sorts and the same run
placement on both sides), so its output must be bitwise equal.  K6a and K6b
are f32 sums over a cell's particles and over 27 offsets taken in another
order than the TPU kernels' one-hot matmuls: atol/rtol 1e-5.  The frame:
kinetic energy rtol 1e-4 and equal iteration counts, as
``tests/test_torch_flip.py``, and equal fluid cells except where the
occupancy is a lone ~1e-9 weight whose sign the jitted JAX frame rounds
otherwise (the same at bound 16 on the full-sort path); the two packages group by different ids
(haloed against plain), so their particle orders differ and positions are
compared order-free (each column sorted, atol 1e-3).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fluidsim_tpu.models import flip as jflip
from fluidsim_tpu.ops import bucket_sort as jbs
from fluidsim_tpu.ops import pallas_shift as ps
from fluidsim_tpu.ops import pallas_transfer as pt
from fluidsim_tpu.ops import transfer_pallas as tp
from fluidsim_tpu.scenes import get_scene as jget_scene
from fluidsim_tpu_torch import FlipParams, FlipSim, interop
from fluidsim_tpu_torch.ops import apic
from fluidsim_tpu_torch.ops import bucket_sort as bs
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.scenes import get_scene
from fluidsim_tpu_torch.utils import synthetic

KBOUND = 12                  # K6a / K6b / unfused P2G
KN = 2 * KBOUND + 1
FBOUND, FDENSITY, FRAMES = 16, 8.0, 3   # 10,648 particles: many 512-row chunks


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's CPU frames, as in
    ``tests/test_torch_mpm.py``: with the other test processes on the same
    cores, spreading small grid operations over every core costs more than
    it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _coherent_keys(rng, p, ncells=4000):
    """Sorted keys with a +-40 jitter: a few windows per 512-key chunk (the
    keys of ``tests/test_bucket_sort.py``)."""
    base = np.sort(rng.integers(0, ncells, p))
    jitter = rng.integers(-40, 40, p)
    return np.clip(base + jitter, 0, ncells + 63).astype(np.int32)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("p,nc,ints", [(5000, 6, False), (8192, 6, False),
                                       (4096, 15, False), (3000, 1, True)])
def test_bucket_by_window_bitwise(p, nc, ints):
    """Coherent keys at the FLIP (6) and APIC (15) payload widths, and an
    int32 column bitcast to f32: flat_out, cols_out and ok bit for bit."""
    rng = np.random.default_rng(p)
    keys = _coherent_keys(rng, p)
    if ints:
        cols = rng.integers(-(2 ** 31), 2 ** 31 - 1, (nc, p),
                            dtype=np.int64).astype(np.int32).view(np.float32)
    else:
        cols = rng.standard_normal((nc, p)).astype(np.float32)
    jf, jc, jok = jbs.bucket_by_window(jnp.asarray(keys), jnp.asarray(cols),
                                       interpret=True)
    tf, tc, tok = bs.bucket_by_window(torch.as_tensor(keys),
                                      torch.as_tensor(cols))
    assert bool(jok) and tok is True
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(_bits(tc.numpy()), _bits(jc))
    assert (np.diff(tf.numpy() // 512) >= 0).all()
    # each key's rows in the order the full stable sort gives them
    order = np.argsort(keys, kind="stable")
    for k in np.unique(keys)[::97]:
        np.testing.assert_array_equal(_bits(tc.numpy()[:, tf.numpy() == k]),
                                      _bits(cols[:, order][:, keys[order] == k]))


def test_bucket_or_sort_falls_back_on_random_keys():
    rng = np.random.default_rng(1)
    p = 5000
    keys = rng.integers(0, 1 << 22, p).astype(np.int32)
    cols = rng.standard_normal((6, p)).astype(np.float32)
    _, _, jok = jbs.bucket_by_window(jnp.asarray(keys), jnp.asarray(cols),
                                     interpret=True)
    moves = bs.bucket_move.launches
    _, _, tok = bs.bucket_by_window(torch.as_tensor(keys), torch.as_tensor(cols))
    assert not bool(jok) and tok is False
    before = bs.bucket_or_sort.fallbacks
    tf, tc = bs.bucket_or_sort(torch.as_tensor(keys), torch.as_tensor(cols))
    assert bs.bucket_or_sort.fallbacks == before + 1
    assert bs.bucket_move.launches == moves      # no move on a fallback
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(tf.numpy(), keys[order])
    np.testing.assert_array_equal(_bits(tc.numpy()), _bits(cols[:, order]))


def test_window_past_the_placement_classes_raises():
    """The JAX sort merges windows >= 2^16 into the padding class; the port
    refuses them."""
    keys = np.arange(1000, dtype=np.int32) + 512 * (1 << 16) - 500
    with pytest.raises(ValueError, match="window"):
        bs.bucket_by_window(torch.as_tensor(keys), torch.zeros((6, 1000)))


def test_bucket_move_plain_on_the_plan():
    """K5's plain version moves the plan's rows exactly as a permutation of
    the chunk-sorted rows, and the CPU wrapper counts no launch."""
    rng = np.random.default_rng(7)
    keys = torch.as_tensor(_coherent_keys(rng, 3000))
    cols = torch.as_tensor(rng.standard_normal((6, 3000)).astype(np.float32))
    key_s, pay_s, tbl, stats = bs.bucket_plan(keys, cols)
    assert bs.caps_hold(stats.tolist())
    assert tbl.shape == (3, 3, 8) and key_s.shape == (3072,)
    before = bs.bucket_move.launches
    kf, kc = bs.bucket_move(key_s, pay_s, tbl, 3000, 1024)
    assert bs.bucket_move.launches == before
    rows = lambda k, c: sorted(zip(k.tolist(), map(tuple, c.T.tolist())))
    assert rows(kf, kc) == rows(keys, cols)
    with pytest.raises(ValueError):
        bs.bucket_move(key_s.to("meta"), pay_s.to("meta"), tbl.to("meta"),
                       3000, 1024)


def _move_loop(key_s, pay_s, runs, p):
    """``out[dst + i] = in[src + i]`` for ``i < cnt``, one row at a time."""
    key, pay = key_s.numpy(), pay_s.numpy()
    kout = np.zeros(p, np.int32)
    cout = np.zeros((pay.shape[0], p), np.float32)
    for dst, src, cnt in runs.tolist():
        for i in range(min(cnt, p - dst)):
            kout[dst + i] = key[src + i]
            cout[:, dst + i] = pay[:, src + i]
    return kout, cout


@pytest.mark.parametrize("seed,p,nc,to,emax", [(0, 20000, 6, 1024, 64),
                                               (1, 9000, 15, 1024, 64),
                                               (2, 6000, 1, 512, 32)])
def test_bucket_move_on_adversarial_tables(seed, p, nc, to, emax):
    """K5's plain version on ``utils/synthetic.bucket_tables`` (a run of 2.5
    blocks, a block met by exactly ``emax`` runs, runs of one row, dead
    entries, ``p`` not a multiple of ``to``) against a numpy loop over the
    runs, bit for bit; the tables keep ``bucket_plan``'s layout, which the
    CUDA kernel's search relies on."""
    key_s, pay_s, tbl, runs = synthetic.bucket_tables(seed, p, nc, to, emax)
    assert p % to and runs[:, 2].max() > 2 * to and (runs[:, 2] == 1).any()
    dst = tbl[:, 0].numpy().astype(np.int64)
    assert (np.diff(dst, axis=1) >= 0).all()
    live = (dst != bs.DEAD_DST).sum(axis=1)
    assert live.max() == emax and live.min() < emax
    edges = np.arange(tbl.shape[0])[:, None] * to
    meet = (dst < edges + to) & (dst + tbl[:, 2].numpy() > edges)
    assert meet.sum(axis=1).max() == emax
    kf, kc = bs.bucket_move(key_s, pay_s, tbl, p, to)
    kn, cn = _move_loop(key_s, pay_s, runs, p)
    np.testing.assert_array_equal(kf.numpy(), kn)
    np.testing.assert_array_equal(_bits(kc.numpy()), _bits(cn))


def test_bucket_by_window_matches_jax_with_a_run_past_an_output_block():
    """A 2048-row chunk of one window (t = 2048 > to = 1024) makes a run
    that covers two output blocks; 7000 rows are no multiple of ``to``."""
    rng = np.random.default_rng(11)
    keys = np.concatenate([np.sort(rng.integers(0, 512, 3000)),
                           _coherent_keys(rng, 4000) + 512]).astype(np.int32)
    cols = rng.standard_normal((6, keys.shape[0])).astype(np.float32)
    kw = dict(t=2048, emax=16)
    _, _, tbl, stats = bs.bucket_plan(torch.as_tensor(keys),
                                      torch.as_tensor(cols), **kw)
    assert int(tbl[:, 2].max()) > 1024 and bs.caps_hold(stats.tolist(), 8, 16)
    jf, jc, jok = jbs.bucket_by_window(jnp.asarray(keys), jnp.asarray(cols),
                                       interpret=True, **kw)
    tf, tc, tok = bs.bucket_by_window(torch.as_tensor(keys),
                                      torch.as_tensor(cols), **kw)
    assert bool(jok) and tok is True
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(_bits(tc.numpy()), _bits(jc))


def test_bucket_by_window_matches_jax_with_a_block_at_emax():
    """Keys spread over ~10 windows per 512-row chunk (``rmax`` 16), with
    ``emax`` the most runs that meet one output block: that block meets
    exactly ``emax``, the others fewer, and the dead slots fill the rest."""
    rng = np.random.default_rng(12)
    keys = np.clip(np.sort(rng.integers(0, 60000, 6000))
                   + rng.integers(-40, 40, 6000), 0, None).astype(np.int32)
    cols = rng.standard_normal((6, keys.shape[0])).astype(np.float32)
    _, _, tbl, stats = bs.bucket_plan(torch.as_tensor(keys),
                                      torch.as_tensor(cols), rmax=16, emax=64)
    stats = stats.tolist()
    emax = stats[1]
    assert stats[0] <= 16 and emax > 8
    kw = dict(rmax=16, emax=emax)
    _, _, tbl, _ = bs.bucket_plan(torch.as_tensor(keys),
                                  torch.as_tensor(cols), **kw)
    assert (tbl[:, 0] == bs.DEAD_DST).any()
    jf, jc, jok = jbs.bucket_by_window(jnp.asarray(keys), jnp.asarray(cols),
                                       interpret=True, **kw)
    tf, tc, tok = bs.bucket_by_window(torch.as_tensor(keys),
                                      torch.as_tensor(cols), **kw)
    assert bool(jok) and tok is True
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(_bits(tc.numpy()), _bits(jc))


# ---- K6a, K6b and the unfused P2G at bound 12 ------------------------------

@pytest.fixture(scope="module")
def grouped():
    """Particles over the interior, in the JAX package's full sort order and
    in the port's order grouped by 512-cell window with the particles of
    each window shuffled (a bucket order, not a cell order)."""
    rng = np.random.default_rng(12)
    p = 4000
    pos = rng.uniform(-(KBOUND - 1.5), KBOUND - 1.5, (p, 3)).astype(np.float32)
    vel = rng.normal(scale=3.0, size=(p, 3)).astype(np.float32)
    aff = rng.normal(scale=0.5, size=(p, 9)).astype(np.float32)
    lay = tp.HaloLayout(KN)
    jp, jv, jflat, jaff = tp.sort_by_cell_h(jnp.asarray(pos), jnp.asarray(vel),
                                            KBOUND, lay, extra=jnp.asarray(aff))
    tpos, tvel, tflat, taff = tk.sort_by_cell(
        torch.as_tensor(pos), torch.as_tensor(vel), KBOUND,
        extra=torch.as_tensor(aff))
    win = tflat.numpy() // tk.WINDOW
    shuffle = np.lexsort((rng.random(p), win))
    assert not (np.diff(tflat.numpy()[shuffle]) >= 0).all()
    t = tuple(x[torch.as_tensor(shuffle)].contiguous()
              for x in (tpos, tvel, tflat, taff))
    return lay, (jp, jv, jflat, jaff), t


def _unhalo(d_cm, lay):
    """(128, XR * LWR) haloed channel-major -> (108, n, n, n): cell (x, y, z)
    at id (x + XH) * lwr + lh + y * n + z."""
    d = np.asarray(d_cm).reshape(128, lay.xr, lay.lwr)
    d = d[:108, ps._XH:ps._XH + KN, lay.lh:lay.lh + KN * KN]
    return d.reshape(108, KN, KN, KN)


@pytest.fixture(scope="module")
def k6a_both(grouped):
    lay, (jp, jv, jflat, jaff), (tpos, tvel, tflat, taff) = grouped
    out = {}
    for mode in ("flip", "apic"):
        jaff_m = jaff.reshape(-1, 3, 3) if mode == "apic" else None
        wv, _ = pt.pack_wv_rows(jflat, tp.masked_weights(jp, KBOUND), jv,
                                lay.t, aff=jaff_m, w=lay.w)
        d_cm = pt.scatter_wv_cm(wv, jflat, lay.ncells, w=lay.w, t=lay.t,
                                interpret=True)
        port = tk.p2g_scatter_base(
            tk.masked_weights_cm(tpos, KBOUND), tvel, tflat,
            tk.window_starts(tflat, KN), KN,
            aff_s=taff if mode == "apic" else None)
        out[mode] = (d_cm, port)
    return out


@pytest.mark.parametrize("mode", ["flip", "apic"])
def test_k6a_scatter_base_matches_scatter_wv_cm(mode, grouped, k6a_both):
    lay = grouped[0]
    d_cm, port = k6a_both[mode]
    assert port.shape == (27, 4, KN, KN, KN)
    ref = _unhalo(d_cm, lay)
    np.testing.assert_allclose(port.numpy().reshape(108, KN, KN, KN), ref,
                               atol=1e-5, rtol=1e-5)
    assert np.abs(ref).max() > 1 and not np.asarray(d_cm)[108:].any()


@pytest.mark.parametrize("mode", ["flip", "apic"])
def test_k6a_order_function_matches_scatter_wv_cm(mode, grouped, k6a_both):
    """``p2g_scatter_base_ordered``, K6a's order on the card, against the
    TPU kernel at the tolerance of its plain version."""
    lay, _, (tpos, tvel, tflat, taff) = grouped
    d_cm, _ = k6a_both[mode]
    out = tk.p2g_scatter_base_ordered(
        tk.masked_weights_cm(tpos, KBOUND), tvel, tflat, KN,
        aff_s=taff if mode == "apic" else None)
    np.testing.assert_allclose(out.numpy().reshape(108, KN, KN, KN),
                               _unhalo(d_cm, lay), atol=1e-5, rtol=1e-5)


def _k6a_state(kind, grouped):
    """(w27t, vel, aff, flat_s) of one K6a state: the window-grouped one of
    ``grouped``, the same particles fully sorted by cell, or
    ``synthetic.skewed_window_state`` (3,000 particles in one cell, a span
    past 2,048 ids, the ragged last window occupied)."""
    if kind == "skewed":
        return synthetic.skewed_window_state(3, 17, 3000)[:4]
    *_, (tpos, tvel, tflat, taff) = grouped
    w27t = tk.masked_weights_cm(tpos, KBOUND)
    if kind == "sorted":
        perm = torch.sort(tflat, stable=True)[1]
        return w27t[:, perm].contiguous(), tvel[perm], taff[perm], tflat[perm]
    return w27t, tvel, taff, tflat


@pytest.mark.parametrize("mode", ["flip", "apic"])
@pytest.mark.parametrize("kind", ["grouped", "sorted", "skewed"])
def test_k6a_order_function_equals_the_plain_version_bitwise(kind, mode,
                                                             grouped):
    """The CPU plain version (``index_add_``) sums each cell in array order,
    as the kernel does: the order function equals it to the bit."""
    w27t, vel, aff, flat = _k6a_state(kind, grouped)
    n = 17 if kind == "skewed" else KN
    aff = aff if mode == "apic" else None
    ordered = tk.p2g_scatter_base_ordered(w27t, vel, flat, n, aff)
    plain = tk.p2g_scatter_base_plain(w27t, vel, flat, n, aff)
    assert ordered.shape == (27, 4, n, n, n)
    np.testing.assert_array_equal(_bits(ordered.numpy()), _bits(plain.numpy()))
    assert float(ordered.abs().max()) > 1


def test_k6a_plain_version_sums_in_array_order():
    """Both against an explicit numpy loop over the particles in array
    order, each add rounded to f32, on the skewed window state."""
    w27t, vel, aff, flat, _ = synthetic.skewed_window_state(4, 17, 500)
    n3 = 17 ** 3
    u = tk._wv_values(w27t, vel, aff).reshape(-1, 108).numpy()
    ref = np.zeros((n3, 108), np.float32)
    for i, f in enumerate(flat.numpy()):
        ref[f] = ref[f] + u[i]
    ref = ref.T.reshape(27, 4, 17, 17, 17)
    for fn in (tk.p2g_scatter_base_plain, tk.p2g_scatter_base_ordered):
        np.testing.assert_array_equal(
            _bits(fn(w27t, vel, flat, 17, aff).numpy()), _bits(ref))


def test_skewed_window_state_has_what_it_claims():
    w27t, vel, aff, flat, counts = synthetic.skewed_window_state(5, 17, 3000)
    f = flat.numpy().astype(np.int64)
    n3, p = 17 ** 3, f.size
    assert w27t.shape == (27, p) and vel.shape == (p, 3) and aff.shape == (p, 9)
    np.testing.assert_array_equal(np.bincount(f, minlength=n3), counts)
    win = f // tk.WINDOW
    assert (np.diff(win) >= 0).all() and not (np.diff(f) >= 0).all()
    spans = np.bincount(win)
    assert counts.max() == 3000 and spans.max() > 2048
    assert n3 % tk.WINDOW and spans[-1] > 0 and (spans == 0).any()
    ws = tk.window_starts(flat, 17).numpy()
    np.testing.assert_array_equal(np.diff(ws), spans)


def test_k6b_shift_reduce_matches_reduce_haloed(grouped, k6a_both):
    """On the APIC base-cell sums (K6b is linear and blind to the mode)."""
    lay = grouped[0]
    d_cm, _ = k6a_both["apic"]
    acc = ps.reduce_haloed(jnp.asarray(d_cm).reshape(128, lay.xr, lay.lwr),
                           KN, bx=lay.bx, lblk=lay.lblk, interpret=True,
                           lh=lay.lh)
    ref = np.asarray(acc)[:, :KN, :KN * KN].reshape(4, KN, KN, KN)
    port = tk.shift_reduce(torch.from_numpy(
        _unhalo(d_cm, lay).reshape(27, 4, KN, KN, KN).copy())).numpy()
    # the TPU kernel's lane rolls wrap only into the y and z wall cells
    inner = (slice(None), slice(None), slice(1, KN - 1), slice(1, KN - 1))
    np.testing.assert_allclose(port[inner], ref[inner], atol=1e-5, rtol=1e-5)


def test_k6_wrappers_take_the_plain_version_on_cpu_only(grouped):
    *_, (tpos, tvel, tflat, _) = grouped
    w27t = tk.masked_weights_cm(tpos, KBOUND)
    ws = tk.window_starts(tflat, KN)
    before = (tk.p2g_scatter_base.launches, tk.shift_reduce.launches)
    d = tk.p2g_scatter_base(w27t, tvel, tflat, ws, KN)
    np.testing.assert_array_equal(
        d.numpy(), tk.p2g_scatter_base_plain(w27t, tvel, tflat, KN).numpy())
    np.testing.assert_array_equal(tk.shift_reduce(d).numpy(),
                                  tk.shift_reduce_plain(d).numpy())
    assert (tk.p2g_scatter_base.launches, tk.shift_reduce.launches) == before
    with pytest.raises(ValueError):
        tk.p2g_scatter_base(w27t.to("meta"), tvel.to("meta"),
                            tflat.to("meta"), ws.to("meta"), KN)
    with pytest.raises(ValueError):
        tk.shift_reduce(d.to("meta"))


@pytest.mark.parametrize("mode", ["flip", "apic"])
def test_unfused_p2g_matches_p2g_pallas_and_k1(mode, grouped):
    lay, (jp, jv, jflat, jaff), (tpos, tvel, tflat, taff) = grouped
    scene = jget_scene("water_cube_drop", bound=KBOUND)
    solid = torch.as_tensor(scene.solid)
    apic_mode = mode == "apic"
    jw, jmom, jocc, _ = tp.p2g_pallas(
        jp, jv, jflat, jnp.asarray(scene.solid), KBOUND, lay, "flip",
        aff=jaff.reshape(-1, 3, 3) if apic_mode else None, interpret=True,
        channel_major=True, fused_scatter=False)
    w27t = tk.masked_weights_cm(tpos, KBOUND)
    if apic_mode:
        port = apic.p2g_apic(w27t, tpos, tvel, taff.reshape(-1, 3, 3), tflat,
                             solid, KBOUND, fused_scatter=False)
    else:
        port = tk.p2g(w27t, tvel, tflat, solid, KBOUND, fused_scatter=False)
    for name, a, b in zip(("weights", "momentum", "occupancy"), port,
                          (jw, jmom, jocc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert float(port[0].sum()) > 0
    # the port's K1 on the same particles, fully sorted
    srt = tk.sort_by_cell(tpos, tvel, KBOUND, extra=taff)
    ws27 = tk.masked_weights_cm(srt[0], KBOUND)
    if apic_mode:
        fused = apic.p2g_apic(ws27, srt[0], srt[1], srt[3].reshape(-1, 3, 3),
                              srt[2], solid, KBOUND)
    else:
        fused = tk.p2g(ws27, srt[1], srt[2], solid, KBOUND)
    for a, b in zip(port, fused):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


# ---- the bucket frame ------------------------------------------------------

def _params(scene, mode="flip", sort_method="bucket"):
    return FlipParams(bound=scene.spec.bound, wall=scene.spec.wall,
                      dx=scene.spec.dx, gravity=tuple(scene.gravity),
                      mode=mode, sort_method=sort_method)


def _order_free(pos) -> np.ndarray:
    return np.sort(np.asarray(pos), axis=0)


def _cell_counts(pos, bound) -> np.ndarray:
    n = 2 * bound + 1
    c = np.clip(np.floor(np.abs(pos) + 0.5) * np.sign(pos) + bound, 0, n - 1)
    return np.bincount(((c[:, 0] * n + c[:, 1]) * n + c[:, 2]).astype(np.int64),
                       minlength=n ** 3)


@pytest.fixture(scope="module")
def bucket_frames():
    jscene = jget_scene("water_cube_drop", bound=FBOUND, density=FDENSITY)
    jparams = jflip.FlipParams(bound=FBOUND, wall=jscene.spec.wall,
                               dx=jscene.spec.dx,
                               gravity=tuple(jscene.gravity),
                               pallas_transfer=True, sort_method="bucket")
    jsim = jflip.FlipSim(jscene, params=jparams, seed=0)
    tscene = get_scene("water_cube_drop", bound=FBOUND, density=FDENSITY)
    tsim = FlipSim(tscene, params=_params(tscene), device="cpu")
    assert tsim.params.walls_only_solid and tsim.num_particles == 10648
    moves = bs.bucket_move.launches
    jm, tm, fallbacks = [], [], []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(FRAMES):
            f0 = bs.bucket_or_sort.fallbacks
            jm.append(jsim.step())
            tm.append(tsim.step())
            fallbacks.append(bs.bucket_or_sort.fallbacks - f0)
    assert bs.bucket_move.launches == moves     # the CPU runs K5's plain version
    return jsim, tsim, jm, tm, fallbacks


def test_bucket_frames_match_the_jax_bucket_frames(bucket_frames):
    jsim, tsim, jm, tm, fallbacks = bucket_frames
    assert set(tm[0]) == set(jm[0])
    for f, (j, t) in enumerate(zip(jm, tm)):
        np.testing.assert_allclose(float(t["kinetic_energy"]),
                                   float(j["kinetic_energy"]), rtol=1e-4,
                                   err_msg=f"frame {f}")
        assert t["outer_iters"] == int(j["outer_iters"]), f
        assert t["cg_iters"] == int(j["cg_iters"]), f
        # the fluid cells agree but where the occupancy is a lone weight of
        # ~1e-9 whose sign the jitted JAX frame and the port round apart
        # (the spline's cubic cancels near |x| = 1.5; the JAX functions run
        # eagerly give the port's sign)
        jocc, tocc = np.asarray(j["occupancy"]), t["occupancy"].numpy()
        apart = (jocc > 0) != (tocc > 0)
        assert np.abs(jocc[apart]).max(initial=0) < 1e-7, f
        assert np.abs(tocc[apart]).max(initial=0) < 1e-7, f
        assert abs(int(t["num_fluid_cells"]) - int(j["num_fluid_cells"])) \
            == int(apart.sum()), f
    assert tm[1]["cg_iters"] > 0
    tpos, jpos = tsim.state.pos.numpy(), np.asarray(jsim.state.pos)
    np.testing.assert_allclose(_order_free(tpos), _order_free(jpos), atol=1e-3)
    np.testing.assert_array_equal(_cell_counts(tpos, FBOUND),
                                  _cell_counts(jpos, FBOUND))
    assert np.isfinite(tpos).all() and np.abs(tpos).max() < FBOUND
    # the seeding order trips the caps; later frames keep the bucket order,
    # which is then not a cell order
    assert fallbacks[0] == 1 and 0 in fallbacks[1:]
    flat = tk.sort_by_cell(tsim.state.pos, tsim.state.vel, FBOUND,
                           method="bucket")[2].numpy()
    assert (np.diff(flat // tk.WINDOW) >= 0).all()
    assert not (np.diff(flat) >= 0).all()


def test_a_jax_bucket_state_steps_on_the_port(bucket_frames):
    """The state order is free, so a state the JAX bucket path left steps on
    the port like any other (``interop`` carries nothing new)."""
    jsim = bucket_frames[0]
    d = {k: np.asarray(getattr(jsim.state, k))
         for k in ("pos", "vel", "dt", "t", "frame", "pressure")}
    scene = bucket_frames[1].scene
    full = FlipSim.from_state(scene, interop.state_from_numpy(d, device="cpu"),
                              params=_params(scene, sort_method="full"),
                              device="cpu")
    bucket = FlipSim.from_state(scene,
                                interop.state_from_numpy(d, device="cpu"),
                                params=_params(scene), device="cpu")
    mf, mb = full.step(), bucket.step()
    np.testing.assert_allclose(float(mb["kinetic_energy"]),
                               float(mf["kinetic_energy"]), rtol=1e-5)
    assert mb["cg_iters"] == mf["cg_iters"]


@pytest.mark.parametrize("mode", ["pic", "apic"])
def test_pic_and_apic_bucket_frames_match_the_full_sort(mode):
    scene = get_scene("water_cube_drop", bound=FBOUND, density=FDENSITY)
    sims = {s: FlipSim(scene, params=_params(scene, mode, s), device="cpu")
            for s in ("full", "bucket")}
    f0 = bs.bucket_or_sort.fallbacks
    for f in range(FRAMES):
        mf, mb = sims["full"].step(), sims["bucket"].step()
        np.testing.assert_allclose(float(mb["kinetic_energy"]),
                                   float(mf["kinetic_energy"]), rtol=1e-4,
                                   err_msg=f"frame {f}")
        assert mb["outer_iters"] == mf["outer_iters"]
        assert mb["cg_iters"] == mf["cg_iters"]
    assert bs.bucket_or_sort.fallbacks - f0 < FRAMES
    pf, pb = (sims[s].state.pos.numpy() for s in ("full", "bucket"))
    np.testing.assert_allclose(_order_free(pb), _order_free(pf), atol=1e-3)
    if mode == "apic":
        np.testing.assert_allclose(
            np.sort(sims["bucket"].state.aff.numpy().reshape(-1, 9), axis=0),
            np.sort(sims["full"].state.aff.numpy().reshape(-1, 9), axis=0),
            atol=1e-3)


def test_flip_params_refuse_another_sort_method():
    with pytest.raises(ValueError, match="sort_method"):
        FlipParams(sort_method="radix")
    with pytest.raises(ValueError, match="sort method"):
        tk.sort_by_cell(torch.zeros((4, 3)), torch.zeros((4, 3)), 4,
                        method="radix")
