"""Kinect depth-map -> point-cloud converter (counterpart of
`reconstruction_tpu/pipeline/kinect.py`).

Replaces `Kinect2Cloud/CKinect2Cloud.cpp:13-82`: per-device intrinsics
(fx, fy, cx, cy), background-depth gating (skip when bg - depth <= 500 or
bg < 100, `:62`), pinhole back-projection (`:64-69`) on the device, then,
on the host as the reference does them, the rigid transform by the
precomputed `R1t_times_R` (`:73`) and the binary PLY (`:74-81`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from reconstruction_tpu_torch.io.images import imread
from reconstruction_tpu_torch.io.opencv_yaml import load_opencv_yaml
from reconstruction_tpu_torch.io.ply import write_ply


def depth_to_points(
    depth: torch.Tensor,
    background: torch.Tensor,
    intrinsics: torch.Tensor,
    bbox: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Back-project a depth map on its device.  Returns ((H*W, 4)
    homogeneous points, (H*W,) validity): fixed shape, masked."""
    H, W = depth.shape
    dev = depth.device
    fx, fy, cx, cy = (intrinsics[k].float() for k in range(4))
    bbox = bbox.float()
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    d = depth.float()
    bg = background.float()
    ok = ((d != 0) & (bg - d > 500) & (bg >= 100)
          & (x >= bbox[0]) & (x < bbox[1])
          & (y >= bbox[2]) & (y < bbox[3]))
    Z = d
    X = (x - cx) * Z / fx
    Y = (y - cy) * Z / fy
    pts = torch.stack([X, Y, Z, torch.ones_like(Z)], dim=-1).reshape(-1, 4)
    return pts, ok.reshape(-1)


def kinect_to_cloud(filelist_yml: str, *, device="cuda") -> None:
    """Full converter driver (`CKinect2Cloud::run`, `:13-46`)."""
    dev = torch.device(device)
    cfg = load_opencv_yaml(filelist_yml)
    calib = load_opencv_yaml(cfg["kinect_info"])
    bbox = torch.as_tensor(np.asarray(cfg["boundingbox"], np.float32), device=dev)
    for sn in cfg["kinect_sn"]:
        params = torch.as_tensor(np.asarray(
            calib[f"DepthCameraIntrinsic-{sn}"], np.float32).ravel(), device=dev)
        R1tR = np.asarray(calib[f"R1t_times_R-{sn}"], np.float64)
        files = cfg[f"imagelist-{sn}"]
        bks = cfg[f"masklist-{sn}"]
        outs = cfg[f"outlist-{sn}"]
        for fdepth, fbk, fout in zip(files, bks, outs):
            depth = torch.from_numpy(imread(fdepth, grayscale=True)).to(dev)
            bk = torch.from_numpy(imread(fbk, grayscale=True)).to(dev)
            pts, ok = depth_to_points(depth, bk, params, bbox)
            cloud = pts[ok].cpu().numpy() @ R1tR  # (N, 4) x (4, ...) -> 3
            write_ply(fout, cloud[:, :3].astype(np.float32))
