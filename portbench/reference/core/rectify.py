"""Stereo rectification (Bouguet's algorithm), re-derived from scratch.

Replaces the reference's use of `cv::stereoRectify` with zero distortion,
``flags=0`` and ``alpha=-1`` (`reconstruction/CStereoMatching.cpp:128-131`)
and the surrounding convention plumbing:

  * relative pose R = R1 R0^T, T = -R t0 + t1 (`CStereoMatching.cpp:125-126`)
  * rectified-cam-0 -> world transform R_final/T_final
    (`CStereoMatching.cpp:132-137`)
  * the Q(3,2) sign flip (`CStereoMatching.cpp:138`) that adapts OpenCV's
    disparity convention (d = x_l - x_r) to the reference's d = x_r - x_l
  * projection row scaling for the working resolution
    (`CStereoMatching.cpp:140-145`)

Rectification parameters are tiny per-pair matrices; they are computed
host-side in float64 once per pair.  Only the remap itself (see
`core/remap.py`) runs on device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def rodrigues_vec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (SO(3) log map)."""
    R = np.asarray(R, np.float64)
    c = (np.trace(R) - 1.0) / 2.0
    c = np.clip(c, -1.0, 1.0)
    theta = np.arccos(c)
    if theta < 1e-12:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # Near pi: extract axis from R + I.
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # Fix signs from off-diagonals.
        i = int(np.argmax(axis))
        axis = A[i] / max(axis[i], 1e-12)
        axis /= np.linalg.norm(axis)
        return axis * theta
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (theta / (2.0 * np.sin(theta)))


def rodrigues_mat(w: np.ndarray) -> np.ndarray:
    """Axis-angle vector -> rotation matrix (SO(3) exp map)."""
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


@dataclass(frozen=True)
class RectifyResult:
    """Everything downstream stages need from rectification.

    Attributes mirror the reference state after `CStereoMatching::Rectify`:
      R1, R2: rectifying rotations (original cam -> rectified cam).
      P1, P2: 3x4 rectified projections at the ORIGINAL image size.
      Q: 4x4 reprojection matrix with the reference's sign flip applied
         (`CStereoMatching.cpp:138`), valid for d = x_r - x_l.
      R_final, T_final: rectified-cam-0 -> world (`CStereoMatching.cpp:132-133`).
      P1_scaled, P2_scaled: projections with rows 0..1 scaled to the working
         (finest-pyramid) resolution (`CStereoMatching.cpp:140-143`).
      P1_world, P2_world: world -> scaled rectified pixels, i.e. the
         reference's `cam[j].P` after `P = P*Extrinsic_final`
         (`CStereoMatching.cpp:145`), used for texture projection.
      C2_world: camera 1's world center -R1^T t1 (`CManageData.cpp:63`
         computes it per camera) — needed so the SECOND scan of each pair
         can weight into the final texture like `Demo/scans.txt`'s
         2-per-pair contract.
      baseline_axis: 0 for horizontal epipolar lines, 1 for vertical.
    """

    R1: np.ndarray
    R2: np.ndarray
    P1: np.ndarray
    P2: np.ndarray
    Q: np.ndarray
    R_final: np.ndarray
    T_final: np.ndarray
    P1_scaled: np.ndarray
    P2_scaled: np.ndarray
    P1_world: np.ndarray
    P2_world: np.ndarray
    C2_world: np.ndarray
    baseline_axis: int


def stereo_rectify(
    K1: np.ndarray,
    K2: np.ndarray,
    image_size: Tuple[int, int],
    R: np.ndarray,
    T: np.ndarray,
    new_image_size: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Bouguet stereo rectification, zero distortion, alpha=-1, flags=0.

    Args:
      K1, K2: 3x3 intrinsics.
      image_size: (width, height) of the calibration images.
      R, T: pose of camera 2 relative to camera 1 (x2 = R x1 + T).
      new_image_size: optional output size (defaults to image_size).

    Returns:
      (R1, R2, P1, P2, Q, baseline_axis) with OpenCV-compatible semantics:
      Q follows OpenCV's convention (disparity d = x_left - x_right);
      callers wanting the reference convention use `apply_reference_q_flip`.
    """
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    nx, ny = float(image_size[0]), float(image_size[1])
    if new_image_size is None:
        new_image_size = image_size

    # Split the relative rotation evenly between the two cameras.
    om = rodrigues_vec(R)
    r_r = rodrigues_mat(-0.5 * om)
    t = r_r @ T

    # Baseline axis: x if |tx| > |ty| else y.
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c, nt = t[idx], np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0

    # Rotation bringing the baseline onto the chosen image axis.
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0.0:
        ww *= np.arccos(min(abs(c) / nt, 1.0)) / nw
    wR = rodrigues_mat(ww)

    # R2 rotates camera 2; camera 1 must land in the SAME rectified frame:
    # R1 = R2 @ R.  (Using the raw input R — not rodrigues(om/2) — keeps
    # this exact even when R is only approximately orthogonal, e.g. after
    # float32 calibration storage; OpenCV behaves the same way.)
    R2 = wR @ r_r
    R1 = R2 @ R
    t = R2 @ T

    # New common focal length: mean of the two focals along the non-baseline
    # axis, scaled by the output/input ratio along that axis.
    ratio_x = new_image_size[0] / nx / 2.0
    ratio_y = new_image_size[1] / ny / 2.0
    ratio = ratio_x if idx == 1 else ratio_y
    fc_new = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * ratio

    # New principal points: center the projected original-image corners
    # (corners at (nx-1, ny-1); normalized corners round-trip through
    # float32 like OpenCV's CvPoint2D32f buffers).
    cc_new = np.zeros((2, 2))
    for k, (K, Rk) in enumerate(((K1, R1), (K2, R2))):
        corners = np.array(
            [[0, 0, 1], [nx - 1, 0, 1], [0, ny - 1, 1], [nx - 1, ny - 1, 1]],
            np.float64).T
        xn = np.linalg.inv(K) @ corners  # normalized coords
        xn = (xn[:2] / xn[2]).astype(np.float32).astype(np.float64)
        pr = Rk @ np.vstack([xn, np.ones(4)])
        pr = pr[:2] / pr[2]
        avg = pr.mean(axis=1) * fc_new
        cc_new[k, 0] = (nx - 1) / 2.0 - avg[0]
        cc_new[k, 1] = (ny - 1) / 2.0 - avg[1]

    # flags=0 (no CALIB_ZERO_DISPARITY): only the non-baseline principal
    # coordinate is shared between the two views.
    if idx == 0:
        cc_new[:, 1] = cc_new[:, 1].mean()
    else:
        cc_new[:, 0] = cc_new[:, 0].mean()

    # Rescale principal points to the output size (identity when equal).
    sx = new_image_size[0] / nx
    sy = new_image_size[1] / ny
    cc_out = cc_new * np.array([sx, sy])

    P1 = np.zeros((3, 4))
    P1[0, 0] = P1[1, 1] = fc_new
    P1[2, 2] = 1.0
    P1[0, 2], P1[1, 2] = cc_out[0]
    P2 = P1.copy()
    P2[0, 2], P2[1, 2] = cc_out[1]
    P2[idx, 3] = t[idx] * fc_new  # baseline * focal

    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3] = -cc_out[0, 0]
    Q[1, 3] = -cc_out[0, 1]
    Q[2, 3] = fc_new
    Q[3, 2] = -1.0 / t[idx]
    Q[3, 3] = (cc_out[0, 0] - cc_out[1, 0]) / t[idx] if idx == 0 else (
        cc_out[0, 1] - cc_out[1, 1]) / t[idx]
    return R1, R2, P1, P2, Q, idx


def rectify_pair(
    K0: np.ndarray,
    Rt0: np.ndarray,
    K1: np.ndarray,
    Rt1: np.ndarray,
    origin_size: Tuple[int, int],
    working_size: Tuple[int, int],
) -> RectifyResult:
    """Full per-pair rectification, reproducing `CStereoMatching::Rectify`
    (`CStereoMatching.cpp:117-168`) end to end.

    Args:
      K0/Rt0, K1/Rt1: intrinsics + 3x4 world->camera extrinsics.
      origin_size: (width, height) of the source images.
      working_size: (width, height) of the finest pyramid level
        (LowestLevelSize * 2^(PyrmNum-1), `CStereoMatching.cpp:120`).
    """
    Rt0 = np.asarray(Rt0, np.float64)
    Rt1 = np.asarray(Rt1, np.float64)
    R0, t0 = Rt0[:, :3], Rt0[:, 3]
    R1w, t1 = Rt1[:, :3], Rt1[:, 3]

    # Relative pose (`CStereoMatching.cpp:125-126`).
    R_rel = R1w @ R0.T
    T_rel = -R_rel @ t0 + t1

    R1, R2, P1, P2, Q, idx = stereo_rectify(
        K0, K1, origin_size, R_rel, T_rel, new_image_size=origin_size
    )

    # Rectified-cam-0 -> world (`CStereoMatching.cpp:132-133`).
    R_final = R0.T @ R1.T
    T_final = -R0.T @ t0

    # Reference disparity convention: d = x_r - x_l -> flip Q(3,2)
    # (`CStereoMatching.cpp:138`).
    Q = Q.copy()
    Q[3, 2] = -Q[3, 2]

    # Scale projections to the working resolution
    # (`CStereoMatching.cpp:140-143`): rows 0..1 multiplied by
    # working_width / origin_width (uniform pyramid scale).
    scale = working_size[0] / origin_size[0]
    P1_scaled = P1.copy()
    P1_scaled[:2] *= scale
    P2_scaled = P2.copy()
    P2_scaled[:2] *= scale

    # World -> scaled rectified pixels (`CStereoMatching.cpp:134-137,145`):
    # Extrinsic_final = [[R_final^T, -R_final^T T_final], [0, 1]].
    E = np.zeros((4, 4))
    E[3, 3] = 1.0
    E[:3, :3] = R_final.T
    E[:3, 3] = -R_final.T @ T_final
    P1_world = P1_scaled @ E
    P2_world = P2_scaled @ E

    return RectifyResult(
        R1=R1, R2=R2, P1=P1, P2=P2, Q=Q,
        R_final=R_final, T_final=T_final,
        P1_scaled=P1_scaled, P2_scaled=P2_scaled,
        P1_world=P1_world, P2_world=P2_world,
        C2_world=-R1w.T @ t1,
        baseline_axis=idx,
    )
