"""Platonic-solid level sets — a copy of ``fluidsim_tpu/ops/platonic.py``
(``openvdb/tools/LevelSetPlatonic.h`` analog), voxelized by the port's
``mesh_to_sdf`` on ``device``.

The reference builds each solid as a triangle mesh and runs it through
``meshToVolume`` (``createLevelSetPlatonic(faces, scale, center, ...)``
with faces ∈ {4, 6, 8, 12, 20}).  Same design here: exact vertex tables,
faces recovered by supporting-plane detection (numpy, at import time —
these are 4..20-vertex convex solids), then the ``mesh_to_sdf`` reduction
(``ops/mesh.py``) voxelizes.  Meshes are also useful on their own (demo /
test fodder for VolumeToMesh round trips).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fluidsim_tpu_torch.ops.mesh import mesh_to_sdf

__all__ = ["platonic_mesh", "platonic_sdf", "PLATONIC_FACES"]

_PHI = (1.0 + math.sqrt(5.0)) / 2.0


def _vertices(faces: int) -> np.ndarray:
    if faces == 4:  # tetrahedron
        v = [(1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1)]
    elif faces == 6:  # cube
        v = [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
    elif faces == 8:  # octahedron
        v = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
             (0, 0, 1), (0, 0, -1)]
    elif faces == 12:  # dodecahedron
        p, q = _PHI, 1.0 / _PHI
        v = [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
        v += [(0, s1 * q, s2 * p) for s1 in (-1, 1) for s2 in (-1, 1)]
        v += [(s1 * q, s2 * p, 0) for s1 in (-1, 1) for s2 in (-1, 1)]
        v += [(s1 * p, 0, s2 * q) for s1 in (-1, 1) for s2 in (-1, 1)]
    elif faces == 20:  # icosahedron
        p = _PHI
        v = [(0, s1, s2 * p) for s1 in (-1, 1) for s2 in (-1, 1)]
        v += [(s1, s2 * p, 0) for s1 in (-1, 1) for s2 in (-1, 1)]
        v += [(s1 * p, 0, s2) for s1 in (-1, 1) for s2 in (-1, 1)]
    else:
        raise ValueError("faces must be one of 4, 6, 8, 12, 20")
    verts = np.asarray(v, np.float64)
    return verts / np.linalg.norm(verts, axis=1).max()  # circumradius 1


def _hull_faces(verts: np.ndarray):
    """Facets of a convex polytope: every supporting plane containing ≥3
    vertices with all others strictly inside, each polygon triangulated as
    an outward-wound fan around its centroid-sorted boundary."""
    n = len(verts)
    seen = set()
    tris = []
    for i in range(n):
        for j in range(i + 1, n):
            for k in range(j + 1, n):
                nrm = np.cross(verts[j] - verts[i], verts[k] - verts[i])
                ln = np.linalg.norm(nrm)
                if ln < 1e-12:
                    continue
                nrm = nrm / ln
                d = verts @ nrm - verts[i] @ nrm
                if d.max() > 1e-9 and d.min() < -1e-9:
                    continue  # not a supporting plane
                if d.max() > 1e-9:  # flip so remaining verts are inside
                    nrm = -nrm
                    d = -d
                members = tuple(np.flatnonzero(np.abs(d) < 1e-9))
                if members in seen:
                    continue
                seen.add(members)
                # polar-sort the face polygon around its centroid
                pts = verts[list(members)]
                c = pts.mean(axis=0)
                ref = pts[0] - c
                ref = ref / np.linalg.norm(ref)
                up = np.cross(nrm, ref)
                ang = np.arctan2((pts - c) @ up, (pts - c) @ ref)
                order = [members[t] for t in np.argsort(ang)]
                for t in range(1, len(order) - 1):
                    tris.append((order[0], order[t], order[t + 1]))
    return np.asarray(tris, np.int32)


def platonic_mesh(faces: int, scale: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Triangle mesh of a platonic solid with circumradius ``scale``,
    outward-wound.  Returns ``(verts (V,3), tris (T,3))``."""
    verts = _vertices(faces)
    tris = _hull_faces(verts)
    return verts * scale + np.asarray(center, np.float64), tris


PLATONIC_FACES = (4, 6, 8, 12, 20)


def platonic_sdf(faces: int, bound: int, scale: float, center=(0.0, 0.0, 0.0),
                 half_width: float | None = None, device="cuda"):
    """``tools::createLevelSetPlatonic``: signed distance grid of the
    solid on the centered ``[-bound, bound]³`` lattice, optionally clamped
    to a ``±half_width`` narrow band like the reference's banded SDFs."""
    verts, tris = platonic_mesh(faces, scale, center)
    sdf = mesh_to_sdf(verts, tris, bound, device=device)
    if half_width is not None:
        sdf = torch.clamp(sdf, -half_width, half_width)
    return sdf
