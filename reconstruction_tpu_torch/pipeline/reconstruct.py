"""End-to-end reconstruction (counterpart of
`reconstruction_tpu/pipeline/reconstruct.py`), the functional equivalent of
the reference's `main.cpp` + `CStereoMatching::MatchAllLayer` +
`CCloudOptimization::{filter,run}`:

  per pair: rectify -> pyramid match -> triangulate -> SOR -> normals ->
            camera-facing flip -> accumulate   (`CCloudOptimization.cpp:64-147`)
  global:   [dedup] -> MLS -> Poisson -> trim -> island removal ->
            cleanup -> Laplacian -> close holes -> texture -> PLY
            (`CCloudOptimization.cpp:149-398`)

Everything image- or cloud-sized runs on ``device`` (the card unless the
caller asks for the CPU); marching tetrahedra and the mesh cleanup run on
the host.  The pairs run one after the other, or split over the ranks of
a device mesh (``mesh``); each pair's cloud comes to the host once, for
the grid geometry, the stats and the fused cloud.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from reconstruction_tpu_torch.cloud.backend import resolve_backend
from reconstruction_tpu_torch.cloud.dedup import build_dedup_inputs, cross_view_dedup
from reconstruction_tpu_torch.cloud.filters import (
    radius_outlier_filter, radius_outlier_filter_np, sor_filter)
from reconstruction_tpu_torch.cloud.mls import mls_smooth
from reconstruction_tpu_torch.cloud.normals import estimate_normals
from reconstruction_tpu_torch.config import ReconstructionConfig, preset
from reconstruction_tpu_torch.core.camera import calibration_matrices
from reconstruction_tpu_torch.core.rectify import RectifyResult
from reconstruction_tpu_torch.io.images import check_writable, imread, imwrite
from reconstruction_tpu_torch.io.opencv_yaml import load_opencv_yaml
from reconstruction_tpu_torch.io.ply import write_ply
from reconstruction_tpu_torch.pipeline.checkpoint import StageStore
from reconstruction_tpu_torch.pipeline.scan_mesh import pair_scan_mesh
from reconstruction_tpu_torch.stereo.pipeline import PairResult, match_pair
from reconstruction_tpu_torch.surface.marching import marching_tetrahedra
from reconstruction_tpu_torch.surface.mesh import (
    clean_mesh, close_holes, density_trim, laplacian_smooth,
    remove_small_components, vertex_density)
from reconstruction_tpu_torch.surface.poisson import poisson_reconstruct
from reconstruction_tpu_torch.surface.texture import texture_vertices
from reconstruction_tpu_torch.utils.logging import StageStats, get_logger
from reconstruction_tpu_torch.utils.timing import Timer, span

log = get_logger(__name__)


@dataclass
class PairInput:
    """Host-side inputs for one stereo pair."""

    image0: np.ndarray
    image1: np.ndarray
    mask0: np.ndarray
    mask1: np.ndarray
    K0: np.ndarray
    Rt0: np.ndarray
    K1: np.ndarray
    Rt1: np.ndarray


@dataclass
class Reconstruction:
    """Full pipeline output (host arrays)."""

    vertices: np.ndarray
    faces: np.ndarray
    colors: np.ndarray
    cloud_xyz: np.ndarray
    cloud_normals: np.ndarray
    pair_results: List[PairResult] = field(default_factory=list)
    stats: StageStats = field(default_factory=StageStats)
    timer: Timer = field(default_factory=Timer)


def load_pairs(cfg: ReconstructionConfig) -> List[PairInput]:
    """The calibration, images and masks of every pair of ``cfg.cam_pairs``,
    read from ``cfg.filepath`` (`CManageData::Init`, `CManageData.cpp:45-79`)."""
    calib = load_opencv_yaml(os.path.join(cfg.filepath, cfg.camera_calib_name))

    def load_cam(cid):
        return (*calibration_matrices(calib, cid),
                imread(os.path.join(cfg.filepath, cfg.imagelist[cid])),
                imread(os.path.join(cfg.filepath, cfg.masklist[cid]), grayscale=True))

    pairs = []
    for a, b in cfg.cam_pairs:
        K0, Rt0, i0, m0 = load_cam(a)
        K1, Rt1, i1, m1 = load_cam(b)
        pairs.append(PairInput(image0=i0, image1=i1, mask0=m0, mask1=m1,
                               K0=K0, Rt0=Rt0, K1=K1, Rt1=Rt1))
    return pairs


def load_run_config(config_path: str) -> Tuple[ReconstructionConfig, List[PairInput]]:
    """Load a reference-format run config, its calibration and its images
    (`CManageData::Init`, `CManageData.cpp:24-79`): the "myself" preset
    with the file's run keys."""
    raw = load_opencv_yaml(config_path)
    cam_id = np.asarray(raw["camID"], np.int64)
    cfg = preset("myself").replace(
        filepath=raw.get("filepath", ""),
        outfilename=raw.get("outfilename", "out.ply"),
        isoutput=bool(raw.get("isoutput", 0)),
        camera_calib_name=raw.get("camera_calib_name", "calib_camera.yml"),
        pyramid_levels=int(raw.get("PyrmNum", 4)),
        lowest_level_size=(int(raw.get("LowestLevelWidth", 160)),
                           int(raw.get("LowestLevelHeight", 240))),
        imagelist=tuple(raw.get("imagelist", ())),
        masklist=tuple(raw.get("masklist", ())),
        cam_pairs=tuple(tuple(int(v) for v in row) for row in cam_id),
    )
    return cfg, load_pairs(cfg)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def reconstruct(
    cfg: ReconstructionConfig,
    pairs: Sequence[PairInput],
    output_path: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    artifact_dir: Optional[str] = None,
    mesh=None,
    *,
    device="cuda",
) -> Reconstruction:
    """Run the full pipeline on host-resident pair inputs.

    With cfg.isoutput, per-pair artifacts are written under artifact_dir
    (default "tmp", like the reference): cloud<i>.ply (the pair's
    filtered colored cloud, `CStereoMatching.cpp:723-757`), the rectified
    views <i>_<camID>.jpg and the color_<i>_{0,1}.ply scan meshes
    (`CCloudOptimization.cpp:127-143`).  checkpoint_dir: per-pair clouds
    and projection context are stored there and restored by a later run.

    mesh: optional `parallel/mesh.make_mesh` mesh with a `pair` axis, on
    every rank of its world.  The pairs without a checkpoint then run
    split over the pair axis (`parallel/production.match_pairs_sharded`,
    the "stereo_sharded" span), every rank gets all their results, and
    the rest of the pipeline runs unchanged on every rank, so every rank
    returns the same Reconstruction; only rank 0 writes files.  ``device``
    must be of the mesh's device type (this rank's card for "cuda")."""
    dev = torch.device(device)
    writer = True
    if mesh is not None:
        if mesh.device_type != dev.type:
            raise ValueError(f"reconstruct: the mesh is on {mesh.device_type!r} but "
                             f"device is {device!r}")
        writer = dist.get_rank() == 0
    if not writer:
        output_path = artifact_dir = None
    if cfg.isoutput and artifact_dir is None and writer:
        artifact_dir = "tmp"
    if cfg.isoutput and artifact_dir:
        # Fail before the first pair, not after all their stereo: the
        # rectified views are .jpg files, which need Pillow.
        os.makedirs(artifact_dir, exist_ok=True)
        check_writable(os.path.join(artifact_dir, "0_0.jpg"))
    timer = Timer(dev)
    stats = StageStats()
    store = StageStore(checkpoint_dir) if checkpoint_dir else None
    backend = resolve_backend(cfg.cloud.backend)
    cc = cfg.cloud

    def filter_pair(res: PairResult) -> Dict:
        """SOR + normals for one pair (`CCloudOptimization::filter`,
        `CCloudOptimization.cpp:64-121`)."""
        cloud = res.cloud
        with span("sor"):
            host_xyz, host_valid, host_colors = (_np(a) for a in (
                cloud.xyz, cloud.valid, cloud.colors))
            keep = sor_filter(cloud.xyz, cloud.valid, mean_k=cc.sor_mean_k,
                              std_thresh=cc.sor_std_thresh, host_points=host_xyz,
                              host_valid=host_valid, backend=cc.backend)
        # Optional radius outlier removal (commented out in the reference,
        # `CCloudOptimization.cpp:90-96`), in the same SOR -> outrem order.
        if cc.use_radius_outlier_removal:
            with span("outrem"):
                if backend == "native":
                    keep = radius_outlier_filter_np(host_xyz, keep, radius=cc.outrem_radius,
                                                    min_neighbors=cc.outrem_neighbors)
                else:
                    keep = radius_outlier_filter(cloud.xyz, keep, radius=cc.outrem_radius,
                                                 min_neighbors=cc.outrem_neighbors,
                                                 host_points=host_xyz, host_valid=host_valid)
        # Normals, flipped toward the pair's camera (`:101-121`).
        with span("normals"):
            nrm = estimate_normals(cloud.xyz, keep, radius=cc.mls_radius,
                                   viewpoint=np.asarray(res.rectification.T_final, np.float32),
                                   host_points=host_xyz, host_valid=host_valid,
                                   backend=cc.backend)
            keepn = _np(keep)
            return dict(xyz=host_xyz[keepn], nrm=_np(nrm)[keepn], col=host_colors[keepn],
                        raw_points=int(host_valid.sum()))

    all_xyz: List[np.ndarray] = []
    all_nrm: List[np.ndarray] = []
    all_col: List[np.ndarray] = []
    pair_results: List[Optional[PairResult]] = []
    sharded: Dict[int, PairResult] = {}
    if mesh is not None and pairs:
        from reconstruction_tpu_torch.parallel.mesh import broadcast_objects
        from reconstruction_tpu_torch.parallel.production import match_pairs_sharded
        todo = [pi for pi in range(len(pairs))
                if not (store and store.has("pair_cloud", pi))]
        todo = broadcast_objects([todo])[0]      # rank 0's checkpoints decide
        if todo:
            split = Timer(dev)
            with timer.span("stereo_sharded"):
                rs = match_pairs_sharded(cfg, [pairs[pi] for pi in todo], mesh, timer=split)
                sharded = dict(zip(todo, rs))
            stats.add("stereo_sharded", pairs=len(todo),
                      **{f"{k}_s": round(v, 4) for k, v in split.spans.items()})
    for pi, pin in enumerate(pairs):
        log.info("pair %d/%d: stereo matching", pi + 1, len(pairs))
        cached = store.load("pair_cloud", pi) if store and pi not in sharded else None
        if cached is not None:
            all_xyz.append(cached["xyz"])
            all_nrm.append(cached["nrm"])
            all_col.append(cached["col"])
            restored = _restore_pair_result(cached)
            if restored is None:
                log.warning("pair %d: checkpoint lacks projection context; the "
                            "restored pair cannot feed texture or dedup", pi)
            pair_results.append(restored)
            continue
        if pi in sharded:
            res = sharded.pop(pi)
        else:
            with timer.span(f"pair{pi}/stereo"):
                res = match_pair(cfg, pin.image0, pin.image1, pin.mask0, pin.mask1,
                                 pin.K0, pin.Rt0, pin.K1, pin.Rt1, device=dev)
        with timer.span(f"pair{pi}/filter"):
            out = filter_pair(res)
        xyz, nrm, col = out["xyz"], out["nrm"], out["col"]
        drift_p99 = float(res.refine_drift.max())
        stats.add(f"pair{pi}", raw_points=out["raw_points"], kept_points=len(xyz),
                  refine_drift_p99=round(drift_p99, 2))
        # Past ~12 slots of drift the refine reads neutral costs outside its
        # window: surface it instead of diverging in silence.
        if drift_p99 > 12.0:
            log.warning("pair %d: refine drift p99 %.1f slots exceeds the "
                        "refine window budget (~12)", pi, drift_p99)
        rect = res.rectification
        img0, img1 = (_np(im).astype(np.float32) for im in res.rect_images)
        if cfg.isoutput and artifact_dir:
            write_ply(os.path.join(artifact_dir, f"cloud{pi}.ply"), xyz,
                      colors=col, color_order="bgr")
            # Rectified views, `<pair>_<camID>.jpg` (`CStereoMatching.cpp:159-166`).
            for side, img in ((0, img0), (1, img1)):
                imwrite(os.path.join(artifact_dir, f"{pi}_{cfg.cam_pairs[pi][side]}.jpg"),
                        img)
            # Per-pair Poisson, trim and per-camera recolor scans
            # (`CCloudOptimization.cpp:125-143`).
            pair_scan_mesh(cfg, xyz, nrm, pi, rect.P1_world, rect.P2_world,
                           img0, img1, out_dir=artifact_dir, device=dev)
        if store and writer:
            # The projection context texture and dedup read, so that a
            # resumed run textures and dedups like a fresh one.
            store.save("pair_cloud", pi, xyz=xyz, nrm=nrm, col=col,
                       P1_world=rect.P1_world, P2_world=rect.P2_world,
                       T_final=rect.T_final, C2_world=rect.C2_world,
                       rect_img0=_np(res.rect_images[0]),
                       rect_img1=_np(res.rect_images[1]),
                       rect_mask0=_np(res.rect_masks[0]),
                       rect_mask1=_np(res.rect_masks[1]),
                       rect_em0=_np(res.rect_masks_eroded[0]),
                       rect_em1=_np(res.rect_masks_eroded[1]))
        all_xyz.append(xyz)
        all_nrm.append(nrm)
        all_col.append(col)
        pair_results.append(res)

    xyz = np.concatenate(all_xyz, axis=0)
    nrm = np.concatenate(all_nrm, axis=0)
    col = np.concatenate(all_col, axis=0)
    valid = np.ones(len(xyz), bool)
    log.info("fused cloud: %d points", len(xyz))
    live = [r for r in pair_results if r is not None]

    # Optional cross-view dedup (`CCloudOptimization.cpp:152-346`), gated
    # by the eroded rectified cam0 masks (`:186-193,217`).
    if cc.dedup and live and any(r.rect_masks_eroded is None
                                 or r.rect_masks_eroded[0] is None for r in live):
        log.warning("dedup skipped: restored pair(s) carry no eroded rectified masks")
    elif cc.dedup and live:
        with timer.span("dedup"):
            ctx = build_dedup_inputs(live, [r.rect_masks_eroded[0] for r in live], dev)
            valid = _np(cross_view_dedup(_on(xyz, dev), _on(nrm, dev),
                                         _on(valid, dev), ctx))
            stats.add("dedup", kept=int(valid.sum()))

    # MLS (`CCloudOptimization.cpp:350-364`) and re-orientation.
    with timer.span("mls"):
        pts_d = _on(xyz, dev)
        sm, nrm_s, ok = mls_smooth(pts_d, _on(valid, dev), cc.mls_radius, nrm,
                                   host_points=xyz, host_valid=valid, backend=cc.backend)
        if isinstance(sm, torch.Tensor):
            pos_d, nrm_d = sm[ok], nrm_s[ok]
        else:
            pos_d, nrm_d = _on(sm[ok], dev), _on(nrm_s[ok], dev)
        okn = _np(ok)
        xyz_s, nrm_h, col_s = _np(pos_d), _np(nrm_d), col[okn]
    stats.add("mls", points=len(xyz_s))

    # Global Poisson -> mesh (`meshlab.bat` equivalents).  The host
    # marches chi - iso at 0 and trims with the full-resolution density.
    with timer.span("poisson"):
        pres = poisson_reconstruct(pos_d, nrm_d,
                                   torch.ones(len(pos_d), dtype=torch.bool, device=dev),
                                   resolution=cfg.surface.grid_resolution,
                                   cycles=cfg.surface.mg_cycles,
                                   point_weight=cfg.surface.point_weight)
        chi_h = _np(pres.chi - pres.iso)
        dens_h = _np(pres.density)
        origin_h = _np(pres.origin)
        spacing_h = float(pres.spacing)
        del pres
    with timer.span("marching"):
        verts, faces = marching_tetrahedra(chi_h, 0.0, origin=origin_h, spacing=spacing_h)
    stats.add("poisson", verts=len(verts), faces=len(faces))

    sf = cfg.surface
    with timer.span("mesh_cleanup"):
        with span("density"):
            dens = vertex_density(dens_h, (verts - origin_h) / spacing_h)
        with span("density_trim"):
            verts, faces = density_trim(verts, faces, dens, quantile=sf.trim_quantile,
                                        smooth_iters=sf.trim_smooth_iters)
        with span("small_components"):
            verts, faces = remove_small_components(verts, faces, sf.min_component_diag_frac)
        with span("clean"):
            verts, faces = clean_mesh(verts, faces)
        with span("laplacian"):
            verts = laplacian_smooth(verts, faces, iterations=sf.laplacian_steps,
                                     cotangent=sf.laplacian_cotangent)
        with span("close_holes"):
            verts, faces = close_holes(verts, faces, sf.close_holes_max_edges)
    stats.add("cleanup", verts=len(verts), faces=len(faces))

    # Texture (the TextureStitcher equivalent).
    with timer.span("texture"):
        vnorm = _vertex_normals(verts, faces)
        cams = texture_cameras(pair_results)
        colors = (texture_vertices(verts, vnorm, cams, backend=cc.backend, device=dev)
                  if cams else np.full((len(verts), 3), 127.0))
    if output_path:
        write_ply(output_path, verts, colors=colors, faces=faces, color_order="bgr")
        log.info("wrote %s", output_path)

    return Reconstruction(vertices=verts, faces=faces, colors=colors,
                          cloud_xyz=xyz_s, cloud_normals=nrm_h,
                          pair_results=live, stats=stats, timer=timer)


def _restore_pair_result(payload: Dict[str, np.ndarray]) -> Optional[PairResult]:
    """The texture- and dedup-facing part of a PairResult, from a
    checkpoint payload (None for payloads without projection context)."""
    if "P1_world" not in payload:
        return None
    rect = RectifyResult(
        R1=None, R2=None, P1=None, P2=None, Q=None, R_final=None,
        T_final=payload["T_final"], P1_scaled=None, P2_scaled=None,
        P1_world=payload["P1_world"], P2_world=payload["P2_world"],
        C2_world=payload["C2_world"], baseline_axis=0)
    em = ((payload["rect_em0"], payload["rect_em1"])
          if "rect_em0" in payload else (None, None))
    return PairResult(
        disparity=None, cloud=None, rectification=rect, margins0=None, margins1=None,
        rect_images=(payload["rect_img0"], payload["rect_img1"]),
        rect_masks=(payload["rect_mask0"], payload["rect_mask1"]),
        refine_drift=None, rect_masks_eroded=em)


def _f32(x):
    return x.float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def texture_cameras(pair_results: Sequence[Optional[PairResult]]):
    """Texture views: both cameras of every live pair, as the reference's
    two scans a pair feed TextureStitcher (`Demo/scans.txt:1-20`,
    `CCloudOptimization.cpp:396`), sampling the working-resolution
    rectified images through the world -> scaled-pixel projections
    (`CStereoMatching.cpp:145`).  Images and masks stay where the pair
    left them (on its device, or on the host for a restored pair)."""
    cams = []
    for res in pair_results:
        if res is None:
            continue
        rect = res.rectification
        cams.append((rect.P1_world, _f32(res.rect_images[0]),
                     _f32(res.rect_masks[0]), rect.T_final))
        cams.append((rect.P2_world, _f32(res.rect_images[1]),
                     _f32(res.rect_masks[1]), rect.C2_world))
    return cams


def _vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    n = np.zeros_like(verts)
    if len(faces):
        a = verts[faces[:, 1]] - verts[faces[:, 0]]
        b = verts[faces[:, 2]] - verts[faces[:, 0]]
        fn = np.cross(a, b)
        for k in range(3):
            np.add.at(n, faces[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(ln, 1e-12)
