"""The sharded port's building blocks (``fluidsim_tpu_torch/parallel/``):

* the halo primitives at 2 and 4 gloo ranks, bit for bit against the JAX
  functions under ``shard_map`` on as many virtual CPU devices, on the same
  numpy inputs (pure moves and adds);
* the slab plain versions of K1 (``wv``, fg, and their chunk order), K2
  (4 rows, gw), K3 and K4 on an (nx, n, n) slab, bit for bit against the
  cube versions on the slab embedded in a cube whose cells outside it are
  0; dead slots past the alive prefix reach neither K1 nor K2;
* ``pcg(reduce_fn=...)``: the stacked reduction keeps the local sums;
* the sharded solve's stencils (K3, the Chebyshev preconditioner on K4)
  reading the neighbours' edge rows in place, on slabs of 2-5 rows run as
  threads of this process that exchange through shared memory: bit for
  bit the cube's, and the operand path the solve took before (each
  operand built with its ghost rows, the outputs cut back).

Spawned ranks run ``fluidsim_tpu_torch.parallel.dryrun``'s functions, one
thread each, under a time limit of their own (``run_ranks``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fluidsim_tpu.parallel import halo as jhalo
from fluidsim_tpu_torch.ops import stencil_kernels as sk
from fluidsim_tpu_torch.ops import transfer_kernels as tk
from fluidsim_tpu_torch.ops.pcg import pcg
from fluidsim_tpu_torch.parallel import dryrun

SPAWN_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_halo(ndev, d):
    """The JAX halo primitives on the same blocks, per device."""
    mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("x",))
    w, cap = int(d["width"]), int(d["capacity"])

    def body(slab, ext, pay, sl, sr):
        f = cap
        inc_b, val_b = jhalo.migrate_edge_bands(pay[:f], sl[:f], pay[-f:],
                                                sr[-f:], "x")
        inc_n, val_n, dropped = jhalo.migrate_neighbors(pay, sl, sr, cap, "x")
        return (jhalo.exchange_halo(slab, w, "x"),
                jhalo.halo_reduce(ext, w, "x"), inc_b, val_b, inc_n, val_n,
                dropped.reshape(1))

    spec = P("x")
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 5,
                           out_specs=(spec,) * 7))
    args = [jax.device_put(jnp.asarray(d[k]), NamedSharding(mesh, spec))
            for k in ("slab", "ext", "payload", "send_left", "send_right")]
    return [np.split(np.asarray(o), ndev) for o in fn(*args)]


@pytest.mark.parametrize("world", [2, 4])
def test_halo_primitives_match_jax(world, tmp_path):
    rng = np.random.default_rng(world)
    nl, w, p, cap = 4, 2, 40, 6
    u = rng.random(world * p)
    send_left = u < 0.3
    send_right = (~send_left) & (rng.random(world * p) < 0.4)
    d = {"slab": rng.normal(size=(world * nl, 3, 5)).astype(np.float32),
         "ext": rng.normal(size=(world * (nl + 2 * w), 3, 5)).astype(np.float32),
         "payload": rng.normal(size=(world * p, 6)).astype(np.float32),
         "send_left": send_left, "send_right": send_right,
         "width": w, "capacity": cap}
    path = str(tmp_path / "halo.npz")
    np.savez(path, **d)
    dryrun.run_ranks(dryrun.halo_rank, world, "cpu", (path,),
                     timeout_s=SPAWN_TIMEOUT_S)
    jout = _jax_halo(world, d)
    names = ("exchange", "reduce", "bands", "bands_valid", "neighbours",
             "neighbours_valid", "dropped")
    for r in range(world):
        got = np.load(f"{path}.rank{r}.npz")
        for name, blocks in zip(names, jout):
            np.testing.assert_array_equal(np.asarray(got[name]).reshape(-1),
                                          blocks[r].reshape(-1),
                                          err_msg=f"rank {r} {name}")
        # edge_rows: exchange_halo's ghost rows, None at a domain end
        for key, rows, end in (("edge_lo", slice(0, w), r == 0),
                               ("edge_hi", slice(-w, None), r == world - 1)):
            if end:
                assert got[key].size == 0, f"rank {r} {key}"
            else:
                np.testing.assert_array_equal(got[key], jout[0][r][rows],
                                              err_msg=f"rank {r} {key}")
    # rank 0's left link and the last rank's right link are domain ends
    first = np.load(f"{path}.rank0.npz")
    assert (first["exchange"][:w] == 0).all()
    assert not first["bands_valid"][:cap].any()


def test_halo_is_local_at_world_one():
    from fluidsim_tpu_torch.parallel import halo

    x = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    ext = halo.exchange_halo(x, 1, dim=1)
    assert ext.shape == (2, 6, 3)
    assert torch.equal(ext[:, 1:5], x) and not ext[:, 0].any()
    assert torch.equal(halo.halo_reduce(ext, 1, dim=1), x)
    assert halo.world() == (0, 1)


# ---- the slab plain versions against the cube's ----------------------------

N, NX, A = 9, 5, 2        # a (5, 9, 9) slab at rows [2, 7) of a 9^3 cube


def _slab_particles(rng, p, n_dead=0):
    """Sorted particles with base cells in the slab rows: (pos of cube
    coordinates, cube ids, slab ids); ``n_dead`` dead slots appended with
    the slab's dead id."""
    b = N // 2
    base = np.stack([rng.integers(A, A + NX, p), rng.integers(0, N, p),
                     rng.integers(0, N, p)], -1)
    pos = (base - b + rng.uniform(-0.49, 0.49, (p, 3))).astype(np.float32)
    cube = ((base[:, 0] * N + base[:, 1]) * N + base[:, 2]).astype(np.int32)
    order = np.argsort(cube, kind="stable")
    pos, cube = pos[order], cube[order]
    slab = cube - A * N * N
    if n_dead:
        pos = np.concatenate([pos, np.full((n_dead, 3), 1e6, np.float32)])
        slab = np.concatenate([slab, np.full(n_dead, NX * N * N, np.int32)])
    return torch.as_tensor(pos), torch.as_tensor(cube), torch.as_tensor(slab)


def _equal(a, b):
    assert a.shape == b.shape
    assert torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("dead", [0, 7])
def test_k1_slab_plain_and_order_match_cube(dead):
    rng = np.random.default_rng(1)
    p = 300
    pos, cube_ids, slab_ids = _slab_particles(rng, p, dead)
    b = N // 2
    w27t = tk.masked_weights_cm(pos, b)
    vel = torch.as_tensor(rng.normal(size=(p + dead, 3)).astype(np.float32))
    m9 = torch.as_tensor(rng.normal(size=(p + dead, 9)).astype(np.float32))
    gradw = torch.as_tensor(rng.normal(size=(81, p + dead)).astype(np.float32))
    cs_cube = tk.cell_starts(cube_ids, N)
    cs_slab = tk.cell_starts(slab_ids, N, NX)
    assert int(cs_slab[-1]) == p and tk.slab_rows(cs_slab, N) == NX
    rows = slice(A, A + NX)
    live = slice(0, p)
    cube = tk.p2g_scatter_plain(w27t[:, live], vel[live], cs_cube, N)
    slab = tk.p2g_scatter_plain(w27t, vel, cs_slab, N)
    _equal(slab, cube[:, rows])
    plan = tk.chunk_plan(cs_slab, p + dead)
    cube_plan = tk.chunk_plan(cs_cube, p)
    assert torch.equal(plan.chunk_first, cube_plan.chunk_first)
    _equal(tk.p2g_scatter_chunked(w27t, vel, plan, N),
           tk.p2g_scatter_chunked(w27t[:, live], vel[live], cube_plan,
                                  N)[:, rows])
    fg_cube = tk.p2g_scatter_force_plain(gradw[:, live], m9[live], cs_cube, N)
    _equal(tk.p2g_scatter_force_plain(gradw, m9, cs_slab, N), fg_cube[:, rows])
    _equal(tk.p2g_scatter_force_chunked(gradw, m9, plan, N),
           tk.p2g_scatter_force_chunked(gradw[:, live], m9[live], cube_plan,
                                        N)[:, rows])
    # every wrapper takes its plain version on CPU tensors
    _equal(tk.p2g_scatter(w27t, vel, cs_slab, N), slab)


@pytest.mark.parametrize("dead", [0, 5])
def test_k2_slab_plain_matches_cube(dead):
    rng = np.random.default_rng(2)
    p = 200
    pos, cube_ids, slab_ids = _slab_particles(rng, p, dead)
    w27t = tk.masked_weights_cm(pos, N // 2)
    fm = torch.as_tensor(rng.normal(size=(4, N, N, N)).astype(np.float32))
    fm[:, :A] = 0.0
    fm[:, A + NX:] = 0.0                   # the cube reads 0 off the slab
    fm_slab = fm[:, A:A + NX].contiguous()
    count = torch.tensor([p], dtype=torch.int32)
    out = tk.g2p_gather(fm_slab, w27t, slab_ids, count)
    _equal(out[:, :p], tk.g2p_gather_plain(fm, w27t[:, :p], cube_ids))
    assert not out[:, p:].any()
    gradw = torch.as_tensor(rng.normal(size=(81, p + dead)).astype(np.float32))
    gw = tk.g2p_gather_gw(fm_slab[:3].contiguous(), gradw, slab_ids, count)
    _equal(gw[:, :p], tk.g2p_gather_gw_plain(fm[:3], gradw[:, :p], cube_ids))
    assert not gw[:, p:].any()
    # the kernel's order (sequential over the offsets) against the plain sum
    ordered = tk.g2p_gather_gw_ordered(fm_slab[:3].contiguous(), gradw,
                                       slab_ids, count)
    np.testing.assert_allclose(ordered.numpy(), gw.numpy(), rtol=0,
                               atol=1e-5 * float(gw.abs().max()))
    assert not ordered[:, p:].any()


def test_k2_count_reads_no_dead_row():
    """A dead slot's id decodes to row nx, whose -1 neighbour is a real
    cell: the count keeps it from reading there."""
    rng = np.random.default_rng(3)
    fm = torch.as_tensor(rng.normal(size=(4, NX, N, N)).astype(np.float32))
    flat = torch.tensor([0, NX * N * N], dtype=torch.int32)
    w27t = torch.ones((27, 2))
    without = tk.g2p_gather(fm, w27t, flat)
    assert without[:, 1].abs().sum() > 0
    with_count = tk.g2p_gather(fm, w27t, flat, torch.tensor([1],
                                                            dtype=torch.int32))
    assert not with_count[:, 1].any()
    _equal(with_count[:, 0], without[:, 0])


def test_k3_k4_slab_plain_match_cube():
    rng = np.random.default_rng(4)
    p = torch.as_tensor(rng.normal(size=(N, N, N)).astype(np.float32))
    ad = torch.as_tensor(rng.uniform(0.5, 6.0, (N, N, N)).astype(np.float32))
    ad[rng.random((N, N, N)) < 0.3] = 0.0
    ad[:A] = 0.0
    ad[A + NX:] = 0.0
    r, d = (torch.as_tensor(rng.normal(size=(N, N, N)).astype(np.float32))
            for _ in range(2))
    s = slice(A, A + NX)
    _equal(sk.apply_laplacian(p[s].contiguous(), ad[s].contiguous(), 0.37),
           sk.apply_laplacian_plain(p, ad, 0.37)[s])
    dn, zn = sk.cheb_step(p[s].contiguous(), ad[s].contiguous(),
                          r[s].contiguous(), d[s].contiguous(), 0.37, 0.6, 1.1)
    dc, zc = sk.cheb_step_plain(p, ad, r, d, 0.37, 0.6, 1.1)
    # off the slab the cube's cells are not fluid: only d' differs there
    _equal(dn, dc[s])
    _equal(zn, zc[s])


def test_chunk_fill_plain_skips_dead_slots():
    rng = np.random.default_rng(5)
    _, _, slab_ids = _slab_particles(rng, 500, 9)
    cs = tk.cell_starts(slab_ids, N, NX)
    counts = cs[1:] - cs[:-1]
    chunk_start = torch.zeros_like(cs)
    chunk_start[1:] = torch.cumsum((counts + tk.CHUNK - 1) // tk.CHUNK, 0)
    nch = int(chunk_start[-1])
    first, cell = tk.chunk_fill_plain(cs, chunk_start, 509)
    live_first, live_cell = tk.chunk_fill_plain(cs, chunk_start, 500)
    assert torch.equal(first[:nch + 1], live_first[:nch + 1])
    assert torch.equal(cell[:nch + 1], live_cell[:nch + 1])
    assert int(first[nch]) == 500 and int(cell[nch]) == NX * N * N


# ---- the slab solve's stencils on threaded ranks ---------------------------

class _ThreadRanks:
    """``size`` ranks as threads of this process: ``edges(rank)`` is a
    ``halo.edge_rows`` for that rank, its rows handed over in shared
    memory between two barriers."""

    def __init__(self, size):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=SPAWN_TIMEOUT_S)
        self.posted = [None] * size

    def edges(self, rank):
        def exchange(tensors, width):
            self.posted[rank] = [(t[:width].clone(),
                                  t[t.shape[0] - width:].clone())
                                 for t in tensors]
            self.barrier.wait()
            out = [(self.posted[rank - 1][k][1] if rank > 0 else None,
                    self.posted[rank + 1][k][0] if rank < self.size - 1
                    else None) for k in range(len(tensors))]
            self.barrier.wait()
            return out
        return exchange

    def run(self, fn):
        """``fn(rank, edges)`` on every rank at once; their results."""
        out, errors = [None] * self.size, []

        def body(rank):
            try:
                out[rank] = fn(rank, self.edges(rank))
            except BaseException as e:   # re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SPAWN_TIMEOUT_S)
        if errors:
            raise errors[0]
        assert not any(t.is_alive() for t in threads), "a rank did not finish"
        return out


def _operand_precond(adiag, scale, degree, ghost):
    """The sharded Chebyshev preconditioner as the solve ran it before:
    ``r`` padded with zero rows, and every step on (nl + 2)-row operands,
    ``z`` with its neighbours' rows refreshed before each step (``ghost``),
    the result cut back."""
    theta, coefs = sk.cheb_coefs(degree)
    fluid = adiag > 0
    safe = torch.where(fluid, adiag, 1.0)

    def precond(r):
        r = torch.nn.functional.pad(r, (0, 0, 0, 0, 1, 1))
        d = torch.where(fluid, r / safe, 0.0) * (1.0 / theta)
        z = d
        for c1, c2 in coefs:
            d, z = sk.cheb_step_plain(ghost(z[1:-1]), adiag, r, d, scale, c1,
                                      c2)
        return z[1:-1]

    return precond


@pytest.mark.parametrize("degree", [3, 4, 8])
@pytest.mark.parametrize("nl", [2, 3, 4, 5])
def test_slab_stencils_on_threaded_ranks_match_cube(nl, degree):
    """A 9^3 cube cut into slabs of ``nl`` rows (the last one running past
    the box, as ``Slab`` cuts it), one thread per rank: K3 with one edge
    row of p and adiag, and the preconditioner exchanging ``adiag`` once
    and ``r`` (and ``z``, ``d`` between launches: a launch takes at most
    ``min(S_MAX, nl)`` steps, so degree 4 splits at nl = 2 and degree 8
    everywhere), bit for bit the cube's and the operand path's."""
    n, scale = 9, 0.37
    size = -(-n // nl)
    rng = np.random.default_rng(100 * nl + degree)
    rows = size * nl
    ad = rng.uniform(0.5, 6.0, (rows, n, n)).astype(np.float32)
    ad[rng.random(ad.shape) < 0.3] = 0.0
    ad[n:] = 0.0
    p, r = (np.where(ad > 0, rng.normal(size=ad.shape), 0.0)
            .astype(np.float32) for _ in range(2))
    ad, p, r = map(torch.as_tensor, (ad, p, r))
    cube_ap = sk.apply_laplacian(p[:n].contiguous(), ad[:n].contiguous(),
                                 scale)
    cube_z = sk.chebyshev_precond_fused(ad[:n].contiguous(), scale,
                                        degree=degree)(r[:n].contiguous())
    ranks = _ThreadRanks(size)

    def rank_fn(rank, edges):
        s = slice(rank * nl, (rank + 1) * nl)
        a_s, p_s, r_s = (t[s].contiguous() for t in (ad, p, r))
        (a_lo, a_hi), = edges([a_s], 1)
        (p_lo, p_hi), = edges([p_s], 1)
        row0 = lambda t: None if t is None else t[0]
        ap = sk.apply_laplacian(p_s, a_s, scale,
                                ghost=(row0(p_lo), row0(p_hi), row0(a_lo),
                                       row0(a_hi)))
        z = sk.chebyshev_precond_fused(a_s, scale, degree=degree,
                                       edges=edges)(r_s)

        def ghost(q):
            (lo, hi), = edges([q], 1)
            zero = q.new_zeros((1,) + tuple(q.shape[1:]))
            return torch.cat([zero if lo is None else lo, q,
                              zero if hi is None else hi])

        z_old = _operand_precond(ghost(a_s), scale, degree, ghost)(r_s)
        return ap, z, z_old

    out = ranks.run(rank_fn)
    ap, z, z_old = (torch.cat([o[k] for o in out]) for k in range(3))
    _equal(ap[:n], cube_ap)
    _equal(z[:n], cube_z)
    _equal(z, z_old)


def test_pcg_reduce_fn_keeps_the_local_sums():
    rng = np.random.default_rng(6)
    a = torch.as_tensor(rng.uniform(2.0, 6.0, (7, 7, 7)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(7, 7, 7)).astype(np.float32))
    apply_a = lambda q: sk.apply_laplacian(q, a, 0.3)
    plain = pcg(apply_a, b, rtol=1e-6, maxiter=50)
    calls = []

    def reduce(s):
        calls.append(s.shape)
        return s.clone()

    reduced = pcg(apply_a, b, rtol=1e-6, maxiter=50, reduce_fn=reduce)
    assert reduced.iters == plain.iters > 0
    _equal(reduced.x, plain.x)
    _equal(reduced.residual, plain.residual)
    # bnorm2, then per iteration one scalar and one stacked pair
    assert calls.count(torch.Size([2])) == plain.iters + 1
    assert calls.count(torch.Size([])) == plain.iters + 1


def test_run_ranks_defaults_to_the_card():
    """``dryrun.run_ranks`` runs on the card unless the caller asks for the
    CPU, as the port's other entry points do."""
    import inspect

    from fluidsim_tpu_torch.parallel import dryrun

    assert inspect.signature(dryrun.run_ranks).parameters[
        "device"].default == "cuda"
