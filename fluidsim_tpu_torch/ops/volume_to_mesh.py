"""Iso-surface mesh extraction — the counterpart of
``fluidsim_tpu/ops/volume_to_mesh.py`` (``openvdb/tools/VolumeToMesh.h``
analog: dual contouring, adaptivity 0, as naive Surface Nets).

The dense pass runs on the field's device: every (N−1)³ dual cell
computes its vertex as the mean of its cube-edge iso-crossings, and every
grid edge with a sign change emits the quad of its four surrounding dual
cells, all fixed-shape masked tensors.  The compaction to packed ``(V,3)``
vertices and ``(Q,4)`` quads (one ``cumsum`` remap) runs on the host, as
in the JAX package.

Round-trip partner of ``ops/mesh.py:mesh_to_sdf`` (MeshToVolume analog).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["volume_to_mesh_arrays", "volume_to_mesh", "quads_to_triangles",
           "mesh_area"]

# The 8 cube corners of a dual cell, in offset coordinates.
_CORNERS = [(ci, cj, ck) for ci in (0, 1) for cj in (0, 1) for ck in (0, 1)]
# The 12 cube edges as corner-index pairs.
_EDGES = [
    (a, b)
    for ia, a in enumerate(_CORNERS)
    for b in _CORNERS[ia + 1:]
    if sum(abs(x - y) for x, y in zip(a, b)) == 1
]


def _corner(phi, off):
    """(N-1)³ view of the sample at cube-corner offset ``off``."""
    n = phi.shape[0]
    return phi[tuple(slice(o, n - 1 + o) for o in off)]


def volume_to_mesh_arrays(phi, iso: float = 0.0):
    """Dense dual-contouring pass over an ``(N,N,N)`` scalar field.

    Returns a dict of fixed-shape tensors:
      ``vertex``: (N-1,N-1,N-1,3) per-dual-cell vertex in sample-index
        space (mean of the cell's edge iso-crossings; 0 where inactive);
      ``cell_active``: (N-1,)³ bool — cell straddles the iso-contour;
      ``quads[d]``: (N-1,N-1,N-1,4) int32 flat dual-cell ids of the quad
        dual to the grid edge leaving sample (i,j,k) along axis ``d``,
        wound so the face normal points toward increasing φ;
      ``quad_active[d]``: matching bool mask (edge sign change, and all
        four neighboring dual cells in range).
    """
    n = phi.shape[0]
    m = n - 1
    f = phi - iso
    dt, dev = f.dtype, f.device
    corners = {off: _corner(f, off) for off in _CORNERS}

    # --- per-cell vertex: mean of edge iso-crossings --------------------
    acc = torch.zeros((m, m, m, 3), dtype=dt, device=dev)
    cnt = torch.zeros((m, m, m), dtype=dt, device=dev)
    for a, b in _EDGES:
        va, vb = corners[a], corners[b]
        crossing = (va > 0) != (vb > 0)
        t = torch.clamp(va / torch.where(va - vb == 0, 1.0, va - vb), 0.0, 1.0)
        pa = torch.tensor(a, dtype=dt, device=dev)
        pb = torch.tensor(b, dtype=dt, device=dev)
        point = pa + t[..., None] * (pb - pa)
        acc = acc + torch.where(crossing[..., None], point, 0.0)
        cnt = cnt + crossing.to(dt)

    cell_active = cnt > 0
    vertex = acc / torch.clamp(cnt, min=1.0)[..., None]
    # offset of the cell origin (sample index of corner (0,0,0))
    r = torch.arange(m, dtype=dt, device=dev)
    base = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1)
    vertex = torch.where(cell_active[..., None], vertex + base, 0.0)

    # --- quads dual to sign-changing grid edges -------------------------
    # The edge leaving sample s along axis d is shared by the four dual
    # cells s - {0,1} along each axis other than d.
    quads = []
    quad_active = []
    ids = torch.arange(m * m * m, dtype=torch.int32, device=dev).reshape(m, m, m)
    coord = torch.arange(n, device=dev)
    inner = (coord >= 1) & (coord <= n - 2)
    sub = tuple(slice(0, m) for _ in range(3))
    for d in range(3):
        # cyclic transverse order so (o1, o2, d) is right-handed and the
        # base winding's geometric normal is +e_d for every axis
        o1, o2 = (d + 1) % 3, (d + 2) % 3
        sign_change = (f > 0) != (torch.roll(f, -1, dims=d) > 0)
        # the far face along d has no +d neighbor; the 4 dual cells exist
        # only for samples with 1 <= s <= N-2 along the transverse axes
        ok = [inner, inner, inner]
        ok[d] = coord <= n - 2
        inside = (ok[0][:, None, None] & ok[1][None, :, None]
                  & ok[2][None, None, :])
        active = (sign_change & inside)[sub]

        def cell_id(du1, du2):
            # cell index = sample index - shift  (shift in {0,1})
            rolled = ids
            for ax, s in ((o1, du1), (o2, du2)):
                if s:
                    rolled = torch.roll(rolled, 1, dims=ax)
            return rolled

        # counter-clockwise loop around the edge: (0,0) -> (1,0) -> (1,1)
        # -> (0,1) in (o1,o2) cell-offset space
        q = torch.stack([cell_id(0, 0), cell_id(1, 0),
                         cell_id(1, 1), cell_id(0, 1)], dim=-1)
        # wind toward increasing phi: reverse where phi decreases along +d
        flip = (f > 0)[sub]
        q = torch.where(flip[..., None], q.flip(-1), q)
        quads.append(q)
        quad_active.append(active)

    return {
        "vertex": vertex,
        "cell_active": cell_active,
        "quads": quads,
        "quad_active": quad_active,
    }


def volume_to_mesh(phi, iso: float = 0.0, bound: int | None = None):
    """Extract a packed quad mesh from an iso-surface — the
    ``tools::volumeToMesh(grid, points, quads)`` entry point.

    Returns ``(verts, quads)`` numpy arrays of shape (V,3) and (Q,4).
    ``bound`` recenters vertices to centered voxel coordinates (positions
    in [-bound, bound]); ``None`` leaves them in sample-index space.
    """
    out = volume_to_mesh_arrays(phi, iso=iso)
    vertex = out["vertex"].cpu().numpy().reshape(-1, 3)
    active = out["cell_active"].cpu().numpy().reshape(-1)
    # dense cell id -> packed vertex id
    remap = np.cumsum(active) - 1
    verts = vertex[active]
    quad_list = []
    for q, qa in zip(out["quads"], out["quad_active"]):
        q = q.cpu().numpy().reshape(-1, 4)
        qa = qa.cpu().numpy().reshape(-1)
        quad_list.append(remap[q[qa]])
    quads = (np.concatenate(quad_list, axis=0)
             if quad_list else np.zeros((0, 4), np.int64))
    if bound is not None:
        verts = verts - float(bound)
    return verts, quads


def quads_to_triangles(quads):
    """Fan each quad into two triangles (the reference tool's optional
    triangle output)."""
    quads = np.asarray(quads)
    return np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], axis=0)


def mesh_area(verts, faces):
    """Total surface area of a triangle or quad mesh (host-side helper)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces)
    if faces.shape[1] == 4:
        faces = quads_to_triangles(faces)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1).sum()
