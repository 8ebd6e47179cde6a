"""Feature matching and multi-view track building (counterpart of
`reconstruction_tpu/ba/tracks.py`).

Descriptors of a view pair are matched by one NCC matrix product with
mutual-best and threshold gating; tracks link matches transitively by a
union-find on the host (small data) and are padded to the (M, O)
observation layout of `BAProblem`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from reconstruction_tpu_torch.ba.bundle_adjust import BAProblem
from reconstruction_tpu_torch.ba.features import Features


def match_descriptors(dA: torch.Tensor, okA: torch.Tensor,
                      dB: torch.Tensor, okB: torch.Tensor,
                      threshold: float = 0.8) -> torch.Tensor:
    """Mutual-best NCC matches.  Returns (N,) int64 index into B or -1."""
    S = dA @ dB.T
    S = torch.where(okA[:, None] & okB[None, :], S,
                    torch.tensor(-2.0, dtype=S.dtype, device=S.device))
    best_ab = torch.argmax(S, dim=1)     # the first maximum, as jnp.argmax
    best_ba = torch.argmax(S, dim=0)
    score = torch.gather(S, 1, best_ab[:, None])[:, 0]
    mutual = best_ba[best_ab] == torch.arange(S.shape[0], device=S.device)
    good = mutual & (score >= threshold)
    return torch.where(good, best_ab, torch.full_like(best_ab, -1))


class _UF:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, a):
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


def build_tracks(
    feats: Sequence[Features],
    descs: Sequence[torch.Tensor],
    K: Sequence[np.ndarray],
    Rt: Sequence[np.ndarray],
    pairs: Sequence[Tuple[int, int]],
    threshold: float = 0.8,
    min_views: int = 2,
    max_obs: int = 8,
) -> BAProblem:
    """Match the given view pairs and link them into tracks, on the
    descriptors' device.  A track keeps at most one observation per view;
    its point starts at the midpoint triangulation of its first two."""
    dev = descs[0].device
    offsets = np.cumsum([0] + [f.xy.shape[0] for f in feats])
    uf = _UF(int(offsets[-1]))
    for (a, b) in pairs:
        m = match_descriptors(descs[a], feats[a].ok, descs[b], feats[b].ok,
                              threshold).cpu().numpy()
        for i, j in enumerate(m):
            if j >= 0:
                uf.union(offsets[a] + i, offsets[b] + int(j))

    groups = {}
    for v, f in enumerate(feats):
        okv = f.ok.cpu().numpy()
        xyv = f.xy.cpu().numpy()
        for i in range(xyv.shape[0]):
            if okv[i]:
                groups.setdefault(uf.find(offsets[v] + i), []).append((v, xyv[i]))

    tracks = [g for g in groups.values()
              if len({v for v, _ in g}) >= min_views
              and len(g) == len({v for v, _ in g})]
    M, O = len(tracks), max_obs
    obs_uv = np.zeros((M, O, 2), np.float32)
    obs_cam = np.zeros((M, O), np.int32)
    obs_ok = np.zeros((M, O), bool)
    pts0 = np.zeros((M, 3), np.float32)
    for mi, g in enumerate(tracks):
        for oi, (v, xy) in enumerate(g[:O]):
            obs_uv[mi, oi] = xy
            obs_cam[mi, oi] = v
            obs_ok[mi, oi] = True
        (va, xa), (vb, xb) = g[0], g[1]
        pts0[mi] = _triangulate_midpoint(K[va], Rt[va], xa, K[vb], Rt[vb], xb)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return BAProblem(K=t(np.stack(K), torch.float32),
                     Rt0=t(np.stack(Rt), torch.float32),
                     points0=t(pts0, torch.float32),
                     obs_uv=t(obs_uv, torch.float32),
                     obs_cam=t(obs_cam, torch.int32),
                     obs_ok=t(obs_ok, torch.bool))


def _triangulate_midpoint(Ka, Rta, xa, Kb, Rtb, xb) -> np.ndarray:
    """Midpoint of the two back-projected rays (float64)."""
    def ray(K, Rt, x):
        R, t = np.asarray(Rt)[:, :3], np.asarray(Rt)[:, 3]
        C = -R.T @ t
        d = R.T @ np.linalg.inv(K) @ np.array([x[0], x[1], 1.0])
        return C, d / np.linalg.norm(d)
    Ca, da = ray(Ka, Rta, xa)
    Cb, db = ray(Kb, Rtb, xb)
    w0 = Ca - Cb
    a = da @ da
    b = da @ db
    c = db @ db
    d = da @ w0
    e = db @ w0
    den = a * c - b * b
    if abs(den) < 1e-12:
        return (Ca + Cb) / 2
    s = (b * e - c * d) / den
    t = (a * e - b * d) / den
    return ((Ca + s * da) + (Cb + t * db)) / 2
