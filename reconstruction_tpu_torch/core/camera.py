"""Pinhole camera model (counterpart of `reconstruction_tpu/core/camera.py`).

Cameras are tiny per-pair matrices used on the host (rectification, scene
rendering), so they stay numpy arrays here; only image-sized work moves to
torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Camera:
    """One calibrated pinhole camera.

    Attributes:
      K: (3, 3) intrinsics.
      Rt: (3, 4) extrinsics, world -> camera: x_cam = R @ x_world + t.
    """

    K: np.ndarray
    Rt: np.ndarray

    @property
    def R(self) -> np.ndarray:
        return self.Rt[..., :, :3]

    @property
    def t(self) -> np.ndarray:
        return self.Rt[..., :, 3]


@dataclass(frozen=True)
class CameraPair:
    """A stereo pair with file pointers, mirroring
    `CManageData::cam[pair][0..1]` (`CManageData.cpp:50-64`)."""

    left: Camera
    right: Camera
    left_id: int
    right_id: int
    left_image: str = ""
    right_image: str = ""
    left_mask: str = ""
    right_mask: str = ""


def make_camera(K, Rt) -> Camera:
    """float32 storage, like the reference's `make_camera`."""
    return Camera(K=np.asarray(K, np.float32), Rt=np.asarray(Rt, np.float32))


def calibration_matrices(calib: Dict[str, np.ndarray], cid: int) -> Tuple[np.ndarray, np.ndarray]:
    """float64 K (3, 3) and Rt (3, 4) of camera ``cid`` from a parsed
    calibration dict with keys ``intrinsic-<id>`` and ``extrinsic-<id>``
    (`CManageData.cpp:59-60`)."""
    return (np.asarray(calib[f"intrinsic-{cid}"], np.float64).reshape(3, 3),
            np.asarray(calib[f"extrinsic-{cid}"], np.float64).reshape(3, 4))


def load_calibration(calib: Dict[str, np.ndarray], cam_ids: Sequence[int]) -> Dict[int, Camera]:
    """Cameras ``cam_ids`` of a parsed calibration dict, parsed as float64
    (`calibration_matrices`), stored as float32."""
    return {cid: make_camera(*calibration_matrices(calib, cid)) for cid in cam_ids}


def relative_pose(cam0: Camera, cam1: Camera) -> Tuple[np.ndarray, np.ndarray]:
    """Pose of cam1 relative to cam0: x1 = R x0 + T
    (`CStereoMatching.cpp:125-126`), float32."""
    R = cam1.R @ cam0.R.T
    T = -R @ cam0.t + cam1.t
    return R, T


def synthetic_rig(
    num_cameras: int = 2,
    radius: float = 10.0,
    span_deg: float = 20.0,
    focal: float = 800.0,
    image_size: Tuple[int, int] = (640, 480),
    look_at: Sequence[float] = (0.0, 0.0, 0.0),
) -> list:
    """A synthetic inward-facing camera arc for tests and benchmarks."""
    w, h = image_size
    K = np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]], np.float64)
    cams = []
    center = np.asarray(look_at, np.float64)
    angles = np.linspace(-span_deg / 2, span_deg / 2, num_cameras) * np.pi / 180.0
    for a in angles:
        cpos = center + radius * np.array([np.sin(a), 0.0, -np.cos(a)])
        fwd = center - cpos
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd])  # rows: camera axes in world coords
        t = -R @ cpos
        cams.append(make_camera(K, np.concatenate([R, t[:, None]], axis=1)))
    return cams
