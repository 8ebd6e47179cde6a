"""Per-pair scan meshes (counterpart of `reconstruction_tpu/pipeline/scan_mesh.py`).

The reference meshes each pair's filtered cloud (`system("mesh.bat")`:
Poisson depth 9, SurfaceTrimmer, `CCloudOptimization.cpp:125-126`) and
recolors the trimmed mesh once per camera of the pair (`:127-143`),
giving the `color_<pair>_{0,1}.ply` scans.  Here: Poisson on the device,
marching tetrahedra, density trim and cleanup on the host, single-view
recolor, written as BGR binary PLYs.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from reconstruction_tpu_torch.config import ReconstructionConfig
from reconstruction_tpu_torch.io.ply import write_ply
from reconstruction_tpu_torch.surface.marching import marching_tetrahedra
from reconstruction_tpu_torch.surface.mesh import (
    clean_mesh, density_trim, remove_small_components, vertex_density)
from reconstruction_tpu_torch.surface.poisson import poisson_reconstruct
from reconstruction_tpu_torch.surface.texture import texture_single_view


def pair_scan_mesh(
    cfg: ReconstructionConfig,
    xyz: np.ndarray,
    normals: np.ndarray,
    pair_index: int,
    P0_world: np.ndarray,
    P1_world: np.ndarray,
    image0: np.ndarray,
    image1: np.ndarray,
    out_dir: Optional[str] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Mesh one pair's filtered cloud and recolor it from both cameras.

    Returns (verts, faces, colors0, colors1); writes `color_<pair>_{0,1}.ply`
    under out_dir when given (the reference's `tmp/` scans)."""
    dev = torch.device(device)
    pts = torch.from_numpy(np.array(xyz, np.float32)).to(dev)
    nrm = torch.from_numpy(np.array(normals, np.float32)).to(dev)
    pair_res = cfg.surface.pair_grid_resolution or cfg.surface.grid_resolution
    res = poisson_reconstruct(
        pts, nrm, torch.ones(len(pts), dtype=torch.bool, device=dev),
        resolution=pair_res, cycles=cfg.surface.mg_cycles,
        point_weight=cfg.surface.point_weight)
    origin = res.origin.cpu().numpy()
    spacing = float(res.spacing)
    verts, faces = marching_tetrahedra(res.chi.cpu().numpy(), float(res.iso),
                                       origin=origin, spacing=spacing)
    dens = vertex_density(res.density.cpu().numpy(), (verts - origin) / spacing)
    verts, faces = density_trim(verts, faces, dens,
                                quantile=cfg.surface.trim_quantile,
                                smooth_iters=cfg.surface.trim_smooth_iters)
    verts, faces = remove_small_components(verts, faces,
                                           cfg.surface.min_component_diag_frac)
    verts, faces = clean_mesh(verts, faces)

    colors0 = texture_single_view(verts, P0_world, image0)
    colors1 = texture_single_view(verts, P1_world, image1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        write_ply(os.path.join(out_dir, f"color_{pair_index}_0.ply"),
                  verts, colors=colors0, faces=faces, color_order="bgr")
        write_ply(os.path.join(out_dir, f"color_{pair_index}_1.ply"),
                  verts, colors=colors1, faces=faces, color_order="bgr")
    return verts, faces, colors0, colors1
