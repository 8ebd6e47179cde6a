"""Mesh decimation + subdivision (a copy of
`reconstruction_tpu/surface/simplify.py`; numpy on the host).

Equivalents of the reference's auxiliary meshlab scripts
(`Demo/meshlab/decimation.mlx`: quadric edge collapse to a target face
count; `Demo/meshlab/subdiv.mlx`: Loop subdivision x3).

Decimation uses quadric-guided vertex clustering: cell size adapts until
the face budget is met, and each cluster's representative minimizes the
summed face quadrics inside the cluster (pseudo-inverse with fallback to
the centroid) — the standard streaming approximation of full QEC, chosen
over greedy edge collapse for vectorizability.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _face_quadrics(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(F, 4, 4) plane quadrics weighted by face area."""
    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(a, b)
    area = np.linalg.norm(n, axis=1) / 2
    nn = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    d = -(nn * verts[faces[:, 0]]).sum(1)
    p = np.concatenate([nn, d[:, None]], axis=1)  # (F, 4)
    Q = p[:, :, None] * p[:, None, :]
    return Q * np.maximum(area, 1e-12)[:, None, None]


def decimate_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    target_faces: int = 100_000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reduce to <= target_faces (decimation.mlx: QEC to 100k faces)."""
    if len(faces) <= target_faces:
        return verts, faces
    lo_cells, hi_cells = 4, 4096
    best = None
    for _ in range(12):
        cells = int(np.sqrt(lo_cells * hi_cells))
        v2, f2 = _cluster_decimate(verts, faces, cells)
        if len(f2) > target_faces:
            hi_cells = cells - 1
        else:
            best = (v2, f2)
            lo_cells = cells + 1
        if lo_cells > hi_cells:
            break
    if best is None:
        best = _cluster_decimate(verts, faces, 4)
    return best


def _cluster_decimate(verts: np.ndarray, faces: np.ndarray,
                      cells: int) -> Tuple[np.ndarray, np.ndarray]:
    mn = verts.min(0)
    ext = np.maximum(verts.max(0) - mn, 1e-12)
    cell = ext.max() / cells
    key = np.floor((verts - mn) / cell).astype(np.int64)
    dims = key.max(0) + 1
    kid = (key[:, 0] * dims[1] + key[:, 1]) * dims[2] + key[:, 2]
    uniq, inv = np.unique(kid, return_inverse=True)
    nclusters = len(uniq)

    # accumulate per-cluster quadrics from adjacent faces
    FQ = _face_quadrics(verts, faces)
    Q = np.zeros((nclusters, 4, 4))
    for k in range(3):
        np.add.at(Q, inv[faces[:, k]], FQ)
    cnt = np.zeros(nclusters)
    cent = np.zeros((nclusters, 3))
    np.add.at(cent, inv, verts)
    np.add.at(cnt, inv, 1.0)
    cent /= np.maximum(cnt[:, None], 1)

    # optimal representative: solve Q[:3,:3] v = -Q[:3,3]
    A = Q[:, :3, :3]
    b = -Q[:, :3, 3]
    reps = cent.copy()
    det = np.linalg.det(A)
    solvable = np.abs(det) > 1e-10
    if solvable.any():
        sol = np.linalg.solve(A[solvable] + 1e-12 * np.eye(3),
                              b[solvable][..., None])[..., 0]
        # reject solutions far from the cluster (degenerate quadrics)
        ok = np.linalg.norm(sol - cent[solvable], axis=1) < 3 * cell
        idxs = np.nonzero(solvable)[0][ok]
        reps[idxs] = sol[ok]

    newf = inv[faces]
    keep = ((newf[:, 0] != newf[:, 1]) & (newf[:, 1] != newf[:, 2])
            & (newf[:, 0] != newf[:, 2]))
    newf = newf[keep]
    # drop duplicate faces
    skey = np.sort(newf, axis=1)
    _, first = np.unique(skey, axis=0, return_index=True)
    newf = newf[np.sort(first)]
    return reps, newf.astype(np.int32)


def loop_subdivide(verts: np.ndarray, faces: np.ndarray,
                   iterations: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Loop subdivision (subdiv.mlx applies 3 iterations)."""
    v, f = verts.astype(np.float64), faces.astype(np.int64)
    for _ in range(iterations):
        v, f = _loop_once(v, f)
    return v, f.astype(np.int32)


def _loop_once(verts: np.ndarray, faces: np.ndarray):
    nv = len(verts)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    ek = np.sort(e, axis=1)
    uniq, inv, cnt = np.unique(ek, axis=0, return_inverse=True,
                               return_counts=True)
    ne = len(uniq)
    # edge -> adjacent "wing" vertices (opposite corners)
    opp = np.concatenate([faces[:, 2], faces[:, 0], faces[:, 1]])
    wing_sum = np.zeros((ne, 3))
    wing_cnt = np.zeros(ne)
    np.add.at(wing_sum, inv, verts[opp])
    np.add.at(wing_cnt, inv, 1.0)

    # new edge points: interior 3/8(a+b) + 1/8(c+d); boundary midpoint
    a, b = verts[uniq[:, 0]], verts[uniq[:, 1]]
    interior = cnt == 2
    ep = np.where(interior[:, None],
                  0.375 * (a + b) + 0.125 * wing_sum,
                  0.5 * (a + b))

    # even (original) vertices: Loop weights; boundary: 1/8 6/8 1/8
    adj_sum = np.zeros((nv, 3))
    deg = np.zeros(nv)
    np.add.at(adj_sum, e[:, 0], verts[e[:, 1]])
    np.add.at(deg, e[:, 0], 1.0)
    # (each undirected edge appears twice in e, once per direction? e has
    # directed halves per face; for closed meshes each undirected edge
    # contributes both directions across its two faces)
    bnd_edges = uniq[cnt == 1]
    is_bnd = np.zeros(nv, bool)
    is_bnd[bnd_edges.ravel()] = True

    n = np.maximum(deg, 1)
    beta = np.where(n > 3, 3.0 / (8.0 * n), 3.0 / 16.0)
    even = (1 - n * beta)[:, None] * verts + beta[:, None] * adj_sum
    # boundary rule: average with boundary neighbors only
    bsum = np.zeros((nv, 3))
    bcnt = np.zeros(nv)
    np.add.at(bsum, bnd_edges[:, 0], verts[bnd_edges[:, 1]])
    np.add.at(bcnt, bnd_edges[:, 0], 1.0)
    np.add.at(bsum, bnd_edges[:, 1], verts[bnd_edges[:, 0]])
    np.add.at(bcnt, bnd_edges[:, 1], 1.0)
    with np.errstate(invalid="ignore"):
        bnd_pos = 0.75 * verts + 0.25 * (bsum / np.maximum(bcnt, 1)[:, None])
    even = np.where(is_bnd[:, None] & (bcnt >= 2)[:, None], bnd_pos, even)

    new_verts = np.vstack([even, ep])
    F = len(faces)
    e01 = nv + inv[:F]
    e12 = nv + inv[F:2 * F]
    e20 = nv + inv[2 * F:]
    v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]
    new_faces = np.concatenate([
        np.stack([v0, e01, e20], 1),
        np.stack([v1, e12, e01], 1),
        np.stack([v2, e20, e12], 1),
        np.stack([e01, e12, e20], 1),
    ])
    return new_verts, new_faces
