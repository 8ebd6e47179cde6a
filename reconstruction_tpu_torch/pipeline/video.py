"""Per-frame video reconstruction with a temporal pose graph (counterpart of
`reconstruction_tpu/pipeline/video.py`).

Per frame, the rig reconstruction runs (`reconstruct` by default); the
anchor camera's features are tracked frame to frame to estimate the
relative rig motion; the chain of frame poses, with optional loop
closures measured between frames directly, is optimized by the pose
graph.  Features, matching and the pose graph run on the device; the
rigid fit of the matched points stays in float64 numpy, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from reconstruction_tpu_torch.ba.features import describe, harris_corners
from reconstruction_tpu_torch.ba.pose_graph import pose_graph_optimize
from reconstruction_tpu_torch.ba.tracks import match_descriptors
from reconstruction_tpu_torch.config import ReconstructionConfig
from reconstruction_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class FrameResult:
    index: int
    mesh_vertices: np.ndarray
    mesh_faces: np.ndarray
    rig_pose: np.ndarray  # 4x4 frame -> world


def _estimate_relative_pose(
    prev_gray: np.ndarray,
    cur_gray: np.ndarray,
    K: np.ndarray,
    Rt: np.ndarray,
    depth_hint: float,
    *,
    device="cuda",
) -> np.ndarray:
    """Coarse frame-to-frame rig motion from anchor-camera feature flow.

    Approximates small inter-frame motion as a rigid transform fitted to
    back-projected matched features at the scene depth."""
    dev = torch.device(device)
    pg = torch.as_tensor(np.ascontiguousarray(prev_gray), device=dev)
    cg = torch.as_tensor(np.ascontiguousarray(cur_gray), device=dev)
    ones = torch.ones(pg.shape, dtype=torch.bool, device=dev)
    f0 = harris_corners(pg, ones, max_features=256)
    f1 = harris_corners(cg, ones, max_features=256)
    d0 = describe(pg, f0, radius=4)
    d1 = describe(cg, f1, radius=4)
    m = match_descriptors(d0, f0.ok, d1, f1.ok, 0.8).cpu().numpy()
    xy0 = f0.xy.cpu().numpy()
    xy1 = f1.xy.cpu().numpy()
    src, dst = [], []
    R, t = np.asarray(Rt)[:, :3], np.asarray(Rt)[:, 3]
    Kinv = np.linalg.inv(np.asarray(K))
    C = -R.T @ t
    for i, j in enumerate(m):
        if j < 0:
            continue
        for xy, acc in ((xy0[i], src), (xy1[int(j)], dst)):
            ray = R.T @ Kinv @ np.array([xy[0], xy[1], 1.0])
            acc.append(C + ray / np.linalg.norm(ray) * depth_hint)
    if len(src) < 4:
        return np.eye(4)
    src = np.asarray(src)
    dst = np.asarray(dst)
    # Umeyama (rotation + translation, no scale)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1, 1, np.sign(np.linalg.det(Vt.T @ U.T))])
    Rrel = Vt.T @ S @ U.T
    trel = mu_d - Rrel @ mu_s
    T = np.eye(4)
    T[:3, :3] = Rrel
    T[:3, 3] = trel
    return T


def reconstruct_video(
    cfg: ReconstructionConfig,
    frame_loader: Callable[[int], Sequence],
    num_frames: int,
    reconstruct_frame: Optional[Callable] = None,
    anchor_cam: int = 0,
    depth_hint: float = 10.0,
    loop_closure_stride: int = 0,
    *,
    device="cuda",
) -> List[FrameResult]:
    """Sequence driver.

    frame_loader(i) returns the PairInput list of frame i;
    reconstruct_frame(cfg, pairs) defaults to the port's `reconstruct` on
    ``device``.
    """
    if reconstruct_frame is None:
        from reconstruction_tpu_torch.pipeline.reconstruct import reconstruct as _r
        reconstruct_frame = lambda c, p: _r(c, p, device=device)  # noqa: E731

    results: List[FrameResult] = []
    rel: List[np.ndarray] = []
    anchors: List[np.ndarray] = []
    meshes = []
    K = Rt = None
    for fi in range(num_frames):
        pairs = frame_loader(fi)
        anchor_img = pairs[0].image0.mean(-1)
        K = pairs[0].K0
        Rt = pairs[0].Rt0
        if anchors:
            rel.append(_estimate_relative_pose(
                anchors[-1], anchor_img, K, Rt, depth_hint, device=device))
        anchors.append(anchor_img)
        log.info("video frame %d/%d", fi + 1, num_frames)
        r = reconstruct_frame(cfg, pairs)
        meshes.append((r.vertices, r.faces))

    # Pose-graph over the frame chain (+ optional loop closures).
    N = num_frames
    T_init = [np.eye(4)]
    for Trel in rel:
        T_init.append(Trel @ T_init[-1])
    edges, Z = [], []
    for i in range(N - 1):
        edges.append([i, i + 1])
        Z.append(np.linalg.inv(T_init[i]) @ T_init[i + 1])
    if loop_closure_stride:
        # Loop closures are independent measurements: features re-matched
        # between the two anchor frames directly (a closure derived from
        # the integrated chain would carry no new information).  M is the
        # measured i->j rig motion (T_j ~ M @ T_i), in the convention of
        # the consecutive edges.
        for i in range(0, N - loop_closure_stride, loop_closure_stride):
            j = i + loop_closure_stride
            M = _estimate_relative_pose(anchors[i], anchors[j], K, Rt,
                                        depth_hint, device=device)
            edges.append([i, j])
            Z.append(np.linalg.inv(T_init[i]) @ M @ T_init[i])
    if len(edges) >= 1 and N >= 2:
        dev = torch.device(device)
        T_opt, _ = pose_graph_optimize(
            torch.as_tensor(np.asarray(edges, np.int32), device=dev),
            torch.as_tensor(np.stack(Z).astype(np.float32), device=dev),
            torch.as_tensor(np.stack(T_init).astype(np.float32), device=dev), N,
            iterations=10)
        T_opt = T_opt.cpu().numpy()
    else:
        T_opt = np.stack(T_init)

    for fi, (v, f) in enumerate(meshes):
        results.append(FrameResult(index=fi, mesh_vertices=v, mesh_faces=f,
                                   rig_pose=T_opt[fi]))
    return results
