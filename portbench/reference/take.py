"""The whole take in plain PyTorch and NumPy: every pair through the plain
pair path, then the cloud and surface stages in the port's stage order
(a frozen copy of `pipeline/reconstruct.reconstruct` without its
checkpoints, artifacts, dedup and device mesh):

  per pair: match_pair -> SOR -> normals (flipped toward the pair's camera)
  global:   MLS -> Poisson -> marching -> trim, islands, cleanup,
            Laplacian, holes -> texture
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from portbench.reference.cloud.filters import sor_filter
from portbench.reference.cloud.mls import mls_smooth
from portbench.reference.cloud.normals import estimate_normals
from portbench.reference.config import ReconstructionConfig
from portbench.reference.stereo.pipeline import PairResult, match_pair
from portbench.reference.surface.marching import marching_tetrahedra
from portbench.reference.surface.mesh import (
    clean_mesh, close_holes, density_trim, laplacian_smooth,
    remove_small_components, vertex_density)
from portbench.reference.surface.poisson import poisson_reconstruct
from portbench.reference.surface.texture import texture_vertices


class TakeResult(NamedTuple):
    """Host arrays of the mesh and the fused (MLS) cloud, and the pairs."""

    vertices: np.ndarray
    faces: np.ndarray
    colors: np.ndarray
    cloud_xyz: np.ndarray
    cloud_normals: np.ndarray
    spacing: float
    pairs: List[PairResult]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def filter_pair(cfg: ReconstructionConfig, res: PairResult):
    """SOR and camera-facing normals of one pair's cloud; host arrays of
    the kept points."""
    cc = cfg.cloud
    cloud = res.cloud
    host_xyz, host_valid, host_colors = (_np(a) for a in (
        cloud.xyz, cloud.valid, cloud.colors))
    keep = sor_filter(cloud.xyz, cloud.valid, mean_k=cc.sor_mean_k,
                      std_thresh=cc.sor_std_thresh, host_points=host_xyz,
                      host_valid=host_valid)
    nrm = estimate_normals(cloud.xyz, keep, radius=cc.mls_radius,
                           viewpoint=np.asarray(res.rectification.T_final, np.float32),
                           host_points=host_xyz, host_valid=host_valid)
    keepn = _np(keep)
    return host_xyz[keepn], _np(nrm)[keepn], host_colors[keepn]


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    n = np.zeros_like(verts)
    if len(faces):
        a = verts[faces[:, 1]] - verts[faces[:, 0]]
        b = verts[faces[:, 2]] - verts[faces[:, 0]]
        fn = np.cross(a, b)
        for k in range(3):
            np.add.at(n, faces[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(ln, 1e-12)


def _f32(x):
    return x.float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def texture_cameras(pairs: Sequence[PairResult]):
    cams = []
    for res in pairs:
        rect = res.rectification
        cams.append((rect.P1_world, _f32(res.rect_images[0]),
                     _f32(res.rect_masks[0]), rect.T_final))
        cams.append((rect.P2_world, _f32(res.rect_images[1]),
                     _f32(res.rect_masks[1]), rect.C2_world))
    return cams


def reconstruct_take(cfg: ReconstructionConfig, pairs, device) -> TakeResult:
    """``pairs``: objects with image0, image1, mask0, mask1, K0, Rt0, K1,
    Rt1 (host arrays), in the take's pair order."""
    dev = torch.device(device)
    cc, sf = cfg.cloud, cfg.surface
    results, xyzs, nrms, cols = [], [], [], []
    for p in pairs:
        res = match_pair(cfg, p.image0, p.image1, p.mask0, p.mask1,
                         p.K0, p.Rt0, p.K1, p.Rt1, device=dev)
        xyz, nrm, col = filter_pair(cfg, res)
        results.append(res)
        xyzs.append(xyz)
        nrms.append(nrm)
        cols.append(col)
    xyz = np.concatenate(xyzs, axis=0)
    nrm = np.concatenate(nrms, axis=0)
    col = np.concatenate(cols, axis=0)
    valid = np.ones(len(xyz), bool)

    sm, nrm_s, ok = mls_smooth(_on(xyz, dev), _on(valid, dev), cc.mls_radius, nrm,
                               host_points=xyz, host_valid=valid)
    pos_d, nrm_d = sm[ok], nrm_s[ok]
    xyz_s, nrm_h = _np(pos_d), _np(nrm_d)
    del col

    pres = poisson_reconstruct(pos_d, nrm_d,
                               torch.ones(len(pos_d), dtype=torch.bool, device=dev),
                               resolution=sf.grid_resolution, cycles=sf.mg_cycles,
                               point_weight=sf.point_weight)
    chi_h = _np(pres.chi - pres.iso)
    dens_h = _np(pres.density)
    origin_h = _np(pres.origin)
    spacing_h = float(pres.spacing)
    del pres
    verts, faces = marching_tetrahedra(chi_h, 0.0, origin=origin_h, spacing=spacing_h)

    dens = vertex_density(dens_h, (verts - origin_h) / spacing_h)
    verts, faces = density_trim(verts, faces, dens, quantile=sf.trim_quantile,
                                smooth_iters=sf.trim_smooth_iters)
    verts, faces = remove_small_components(verts, faces, sf.min_component_diag_frac)
    verts, faces = clean_mesh(verts, faces)
    verts = laplacian_smooth(verts, faces, iterations=sf.laplacian_steps,
                             cotangent=sf.laplacian_cotangent)
    verts, faces = close_holes(verts, faces, sf.close_holes_max_edges)

    cams = texture_cameras(results)
    colors = texture_vertices(verts, vertex_normals(verts, faces), cams, device=dev)
    return TakeResult(vertices=verts, faces=faces, colors=colors, cloud_xyz=xyz_s,
                      cloud_normals=nrm_h, spacing=spacing_h, pairs=results)
