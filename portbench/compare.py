"""The numbers that decide `correct`: what the timed path produced against
what the plain reference (`portbench/reference`) works out from the same
inputs.  None of them needs the two sides to round alike or to list their
points in the same order: a float32 path that rounds otherwise moves its
values by a few units in the last place, and only a share of them past a
tolerance counts.

A pair (the finest level's view-0 disparity and its triangulated cloud),
each a share of the entries valid on either side, so that a pair at the
end of an arc, which sees little of the scene, weighs as much as any:
  disp_off_share    the disparity map's pixels whose validity differs, or
                    whose values lie more than DISP_TOL pixels apart
  cloud_off_share   the cloud's grid points whose validity differs, or
                    whose positions lie more than XYZ_TOL apart (scene
                    units)
A take adds, for its fused (MLS) cloud and its textured mesh:
  fused_count_rel   |points - reference's| / reference's
  fused_mean_dist   mean distance from each point to the other cloud's
                    nearest point, both ways, in Poisson grid cells
  mesh_count_rel    |vertices - reference's| / reference's
  mesh_mean_dist    the same for the mesh's vertices
  color_mean_abs    mean |colour difference| of each vertex against the
                    reference's nearest vertex, in 8-bit levels
Each number is compared with its limit in `limits/<cell>.json`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.config import NOMATCH

DISP_TOL = 0.01    # pixels of the finest level
XYZ_TOL = 1e-4     # scene units (the scene spans about 4)


def off_share(dist: torch.Tensor, valid: torch.Tensor, ref_valid: torch.Tensor,
              tol: float) -> float:
    """Share of the entries valid on either side whose validity differs,
    or that are valid on both and ``dist`` apart by more than ``tol``."""
    off = (valid != ref_valid) | (valid & ref_valid & (dist > tol))
    return float(off.sum()) / max(float((valid | ref_valid).sum()), 1.0)


def pair_numbers(disp: torch.Tensor, cloud, ref, disp_tol: float | None = None,
                 xyz_tol: float | None = None) -> Dict[str, float]:
    """``disp``, ``cloud``: the program's finest disparity and cloud (xyz,
    colors, valid); ``ref``: the reference's PairResult; the tolerances
    DISP_TOL and XYZ_TOL unless given."""
    disp_tol = DISP_TOL if disp_tol is None else disp_tol
    xyz_tol = XYZ_TOL if xyz_tol is None else xyz_tol
    rd = ref.disparity.to(disp.device)
    if disp.shape != rd.shape:
        return {"disp_off_share": 1.0, "cloud_off_share": 1.0}
    out = {"disp_off_share": off_share((disp - rd).abs(), disp != NOMATCH, rd != NOMATCH,
                                       disp_tol)}
    v, rv = cloud.valid.bool(), ref.cloud.valid.to(cloud.valid.device).bool()
    if v.shape != rv.shape:
        out["cloud_off_share"] = 1.0
        return out
    dist = torch.linalg.norm(cloud.xyz.float() - ref.cloud.xyz.to(cloud.xyz.device).float(),
                             dim=-1)
    out["cloud_off_share"] = off_share(torch.nan_to_num(dist, nan=float("inf")), v, rv,
                                       xyz_tol)
    return out


def worst(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for row in rows:
        for k, v in row.items():
            out[k] = max(out.get(k, 0.0), float(v))
    return out


def _nearest(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    from scipy.spatial import cKDTree
    return cKDTree(b).query(a)


def _mean_dist(a: np.ndarray, b: np.ndarray, unit: float):
    """(mean nearest distance both ways / ``unit``, for each point of ``a``
    its nearest in ``b``)."""
    d_ab, idx = _nearest(a, b)
    d_ba, _ = _nearest(b, a)
    return float((d_ab.sum() + d_ba.sum()) / (len(d_ab) + len(d_ba)) / unit), idx


def take_numbers(pairs: List[Tuple[torch.Tensor, object]], mesh: Dict[str, np.ndarray],
                 ref, **tols) -> Dict[str, float]:
    """``pairs``: the program's (disparity, cloud) of each pair of the
    take; ``mesh``: its vertices, colors and fused cloud; ``ref``: the
    reference's TakeResult."""
    if len(pairs) != len(ref.pairs):
        rows = [{"disp_off_share": 1.0, "cloud_off_share": 1.0}]
    else:
        rows = [pair_numbers(d, c, r, **tols) for (d, c), r in zip(pairs, ref.pairs)]
    out = worst(rows)
    xyz, rxyz = np.asarray(mesh["cloud_xyz"], np.float64), np.asarray(ref.cloud_xyz, np.float64)
    out["fused_count_rel"] = abs(len(xyz) - len(rxyz)) / max(len(rxyz), 1)
    if len(xyz) and len(rxyz):
        out["fused_mean_dist"] = _mean_dist(xyz, rxyz, ref.spacing)[0]
    else:
        out["fused_mean_dist"] = 0.0 if len(xyz) == len(rxyz) else 1e9
    v, rv = mesh["vertices"], ref.vertices
    out["mesh_count_rel"] = abs(len(v) - len(rv)) / max(len(rv), 1)
    if len(v) and len(rv):
        out["mesh_mean_dist"], idx = _mean_dist(v, rv, ref.spacing)
        out["color_mean_abs"] = float(np.abs(np.asarray(mesh["colors"], np.float64)
                                             - np.asarray(ref.colors, np.float64)[idx]).mean())
    else:
        out["mesh_mean_dist"] = 0.0 if len(v) == len(rv) else 1e9
        out["color_mean_abs"] = 0.0 if len(v) == len(rv) else 255.0
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float] | None) -> Tuple[bool, Dict]:
    """(every number within its limit, {name: {"value", "limit"}}).  A
    number without a limit, or no limits at all, is not correct."""
    if not numbers:
        return False, {}
    out, ok = {}, True
    for k, v in numbers.items():
        lim = None if limits is None else limits.get(k)
        out[k] = {"value": v, "limit": lim}
        if lim is None or not (v <= lim):
            ok = False
    return ok, out
