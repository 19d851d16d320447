"""Loop subdivision surfaces -> triangle meshes (counterpart of
src/shapes/loopsubdiv.cpp LoopSubdivide).

Vectorized numpy implementation: `nlevels` rounds of 1:4 triangle splits with
Loop's vertex/edge masks (boundary-aware), then projection to the limit
surface. Shading normals are area-weighted vertex normals (the reference
evaluates exact limit tangents; visually equivalent for the bench scenes)."""

from __future__ import annotations

import numpy as np


def _edge_key(a, b):
    return np.minimum(a, b).astype(np.int64) * (1 << 32) + np.maximum(a, b)


def loop_subdivide(P: np.ndarray, indices: np.ndarray, nlevels: int):
    """Returns (P', indices', N') after nlevels of Loop subdivision."""
    P = np.asarray(P, np.float64)
    F = np.asarray(indices, np.int64).reshape(-1, 3)

    for _ in range(max(0, nlevels)):
        P, F = _subdivide_once(P, F)
    P = _limit_surface(P, F)
    N = _vertex_normals(P, F)
    return P.astype(np.float32), F.astype(np.int32), N.astype(np.float32)


def _mesh_topology(P, F):
    nv = len(P)
    e0 = _edge_key(F[:, 0], F[:, 1])
    e1 = _edge_key(F[:, 1], F[:, 2])
    e2 = _edge_key(F[:, 2], F[:, 0])
    all_edges = np.concatenate([e0, e1, e2])
    uniq, inv, counts = np.unique(all_edges, return_inverse=True, return_counts=True)
    boundary_edge = counts[inv] == 1  # per face-edge slot
    return nv, (e0, e1, e2), uniq, inv, counts, boundary_edge


def _subdivide_once(P, F):
    nv = len(P)
    nf = len(F)
    ea = F[:, [0, 1, 2]]
    eb = F[:, [1, 2, 0]]
    keys = _edge_key(ea.ravel(order="F"), eb.ravel(order="F"))  # 3*nf, slots: e01|e12|e20
    uniq, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    ne = len(uniq)
    edge_is_boundary = counts == 1

    # endpoints of each unique edge
    end_a = np.zeros(ne, np.int64)
    end_b = np.zeros(ne, np.int64)
    end_a[inv] = ea.ravel(order="F")
    end_b[inv] = eb.ravel(order="F")
    # opposite vertex sum per unique edge (for interior 3/8-1/8 mask)
    opp = np.concatenate([F[:, 2], F[:, 0], F[:, 1]])
    opp_sum = np.zeros((ne, 3))
    np.add.at(opp_sum, inv, P[opp])

    pa, pb = P[np.minimum(end_a, end_b) * 0 + end_a], P[end_b]
    interior = ~edge_is_boundary
    new_edge_pts = np.where(
        interior[:, None],
        0.375 * (pa + pb) + 0.125 * opp_sum,
        0.5 * (pa + pb),
    )

    # --- even (original) vertex update ---
    # valence and neighbor sums over unique edges
    valence = np.zeros(nv, np.int64)
    np.add.at(valence, end_a, 1)
    np.add.at(valence, end_b, 1)
    nbr_sum = np.zeros((nv, 3))
    np.add.at(nbr_sum, end_a, P[end_b])
    np.add.at(nbr_sum, end_b, P[end_a])
    # boundary: vertex on any boundary edge -> crease rule over boundary nbrs
    bmask = np.zeros(nv, bool)
    np.logical_or.at(bmask, end_a[edge_is_boundary], True)
    np.logical_or.at(bmask, end_b[edge_is_boundary], True)
    bnbr_sum = np.zeros((nv, 3))
    bvalence = np.zeros(nv, np.int64)
    np.add.at(bnbr_sum, end_a[edge_is_boundary], P[end_b[edge_is_boundary]])
    np.add.at(bnbr_sum, end_b[edge_is_boundary], P[end_a[edge_is_boundary]])
    np.add.at(bvalence, end_a[edge_is_boundary], 1)
    np.add.at(bvalence, end_b[edge_is_boundary], 1)

    n = np.maximum(valence, 1)
    beta = np.where(n == 3, 3.0 / 16.0, 3.0 / (8.0 * n))  # Warren's simplification
    # pbrt uses beta(n) = (5/8 - (3/8 + 1/4 cos(2 pi/n))^2)/n; use that exactly:
    beta = (0.625 - (0.375 + 0.25 * np.cos(2.0 * np.pi / n)) ** 2) / n
    interior_new = (1.0 - n * beta)[:, None] * P + beta[:, None] * nbr_sum
    crease_new = 0.75 * P + 0.125 * bnbr_sum
    new_even = np.where(bmask[:, None], crease_new, interior_new)

    P_out = np.concatenate([new_even, new_edge_pts])

    # --- 1:4 face split: child faces reference edge midpoints at nv+edge_id ---
    m01 = nv + inv[0 * nf : 1 * nf]
    m12 = nv + inv[1 * nf : 2 * nf]
    m20 = nv + inv[2 * nf : 3 * nf]
    F_out = np.concatenate(
        [
            np.stack([F[:, 0], m01, m20], -1),
            np.stack([m01, F[:, 1], m12], -1),
            np.stack([m20, m12, F[:, 2]], -1),
            np.stack([m01, m12, m20], -1),
        ]
    )
    return P_out, F_out


def _limit_surface(P, F):
    """Push vertices to the Loop limit surface (loopsubdiv.cpp gamma/limit)."""
    nv = len(P)
    ea = F[:, [0, 1, 2]].ravel(order="F")
    eb = F[:, [1, 2, 0]].ravel(order="F")
    keys = _edge_key(ea, eb)
    uniq, first_idx = np.unique(keys, return_index=True)
    counts = np.unique(keys, return_counts=True)[1]
    end_a, end_b = ea[first_idx], eb[first_idx]
    edge_is_boundary = counts == 1

    valence = np.zeros(nv, np.int64)
    np.add.at(valence, end_a, 1)
    np.add.at(valence, end_b, 1)
    nbr_sum = np.zeros((nv, 3))
    np.add.at(nbr_sum, end_a, P[end_b])
    np.add.at(nbr_sum, end_b, P[end_a])
    bmask = np.zeros(nv, bool)
    np.logical_or.at(bmask, end_a[edge_is_boundary], True)
    np.logical_or.at(bmask, end_b[edge_is_boundary], True)
    bnbr_sum = np.zeros((nv, 3))
    np.add.at(bnbr_sum, end_a[edge_is_boundary], P[end_b[edge_is_boundary]])
    np.add.at(bnbr_sum, end_b[edge_is_boundary], P[end_a[edge_is_boundary]])

    n = np.maximum(valence, 1)
    beta = (0.625 - (0.375 + 0.25 * np.cos(2.0 * np.pi / n)) ** 2) / n
    gamma = 1.0 / (n + 3.0 / (8.0 * np.maximum(beta, 1e-9)))
    interior_limit = (1.0 - n * gamma)[:, None] * P + gamma[:, None] * nbr_sum
    boundary_limit = 0.2 * bnbr_sum + 0.6 * P  # 1/5 (v0 + v1) + 3/5 v
    return np.where(bmask[:, None], boundary_limit, interior_limit)


def _vertex_normals(P, F):
    fn = np.cross(P[F[:, 1]] - P[F[:, 0]], P[F[:, 2]] - P[F[:, 0]])
    N = np.zeros_like(P)
    np.add.at(N, F[:, 0], fn)
    np.add.at(N, F[:, 1], fn)
    np.add.at(N, F[:, 2], fn)
    norm = np.linalg.norm(N, axis=-1, keepdims=True)
    return N / np.where(norm > 0, norm, 1.0)
