"""Bundle adjustment with Schur-complement reduction (counterpart of
`reconstruction_tpu/ba/bundle_adjust.py`).

Cameras have fixed intrinsics K and a 6-DoF pose perturbation
(omega, tau) about base extrinsics [R|t]; points have 3 DoF; residuals
are Huber-weighted reprojection errors.  A Gauss-Newton step assembles
6x6 camera blocks, 3x3 point blocks and the 6x3 couplings W (kernel K4,
`ops/ba_coupling.py`), solves the reduced camera system

    S = H_cc - sum_j H_cp,j H_pp,j^-1 H_pc,j

(6C x 6C, dense) and back-substitutes the points in closed form.

Observations are grouped by point, padded to O per point.  The block
assembly keeps the reference's component ("structure of arrays") form:
per-observation quantities are (N,) tensors, N = M * O.  Camera-block
sums and the Schur products are float32 matrix products (one-hot rows
for the per-camera sums; TF32 off, PyTorch's default), never
scatter-adds, so a run on the card gives the same bits every time.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from reconstruction_tpu_torch.core.rectify import rodrigues_mat
from reconstruction_tpu_torch.ops.ba_coupling import ba_coupling


class BAProblem(NamedTuple):
    """Observations grouped by point (padded).

    K: (C, 3, 3) intrinsics.  Rt0: (C, 3, 4) base extrinsics.
    points0: (M, 3) initial points.
    obs_uv: (M, O, 2) observed pixels (O = max obs per point).
    obs_cam: (M, O) int32 camera index per observation, in [0, C).
    obs_ok: (M, O) bool validity.
    """

    K: torch.Tensor
    Rt0: torch.Tensor
    points0: torch.Tensor
    obs_uv: torch.Tensor
    obs_cam: torch.Tensor
    obs_ok: torch.Tensor


def _sinc_ab(w0, w1, w2):
    """th^2 and the smooth Rodrigues coefficients A = sin(th)/th and
    B = (1 - cos th)/th^2, with th = sqrt(th^2 + 1e-12): no division by
    ||w|| at w = 0, where poses start."""
    th2 = w0 * w0 + w1 * w1 + w2 * w2
    th = torch.sqrt(th2 + 1e-12)
    return th2, th, torch.sin(th) / th, (1.0 - torch.cos(th)) / (th2 + 1e-12)


def _cross(a0, a1, a2, b0, b1, b2):
    return (a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0)


def _base_point(Rt0, X):
    """y = R0 X + t0, componentwise over any leading batch dims."""
    X0, X1, X2 = X[..., 0], X[..., 1], X[..., 2]
    return tuple(Rt0[..., i, 0] * X0 + Rt0[..., i, 1] * X1
                 + Rt0[..., i, 2] * X2 + Rt0[..., i, 3] for i in range(3))


def _project(K, Rt0, pose6, X):
    """Pixel (u, v) of point X through a camera with pose perturbation
    pose6, elementwise over leading batch dims: (..., 2).  The rotation
    acts by Rodrigues on vectors, R(w) v = v + A (w x v) + B (w x (w x v))."""
    w0, w1, w2 = pose6[..., 0], pose6[..., 1], pose6[..., 2]
    y0, y1, y2 = _base_point(Rt0, X)
    _, _, A, B = _sinc_ab(w0, w1, w2)
    c0, c1, c2 = _cross(w0, w1, w2, y0, y1, y2)
    d0, d1, d2 = _cross(w0, w1, w2, c0, c1, c2)
    z = (y0 + A * c0 + B * d0 + pose6[..., 3],
         y1 + A * c1 + B * d1 + pose6[..., 4],
         y2 + A * c2 + B * d2 + pose6[..., 5])
    u, v, s = (K[..., i, 0] * z[0] + K[..., i, 1] * z[1] + K[..., i, 2] * z[2]
               for i in range(3))
    return torch.stack([u / s, v / s], dim=-1)


def _residual(K, Rt0, pose6, X, uv):
    return _project(K, Rt0, pose6, X) - uv


# Forward-mode autodiff of one observation's residual: the reference the
# closed-form Jacobians below are tested against.
_jac_pose = jacfwd(_residual, argnums=2)
_jac_point = jacfwd(_residual, argnums=3)


def _obs_jacobians(K, Rt0, pose6, X, uv):
    """Residual and closed-form Jacobians, elementwise over leading dims.

    Returns (r (..., 2), Jc (..., 2, 6) = dr/dpose6, Jp (..., 2, 3) = dr/dX)
    of the chain y = R0 X + t0; z = R(w) y + tau; p = K z;
    r = p[:2] / p[2] - uv, with
      dz/dtau = I;  dz/dX = R(w) R0;
      dz/dw_k = A'_k c + A (e_k x y) + B'_k d + B (e_k x c + w x (e_k x y)),
    A'_k = w_k (cos th - A)/th^2, B'_k = w_k (A - 2B)/th^2 (the smoothed
    coefficients of `_project`)."""
    w = (pose6[..., 0], pose6[..., 1], pose6[..., 2])
    y = _base_point(Rt0, X)
    th2, th, A, B = _sinc_ab(*w)
    dA = (torch.cos(th) - A) / (th2 + 1e-12)
    dB = (A - 2.0 * B) / (th2 + 1e-12)

    def rot(v0, v1, v2):
        c = _cross(*w, v0, v1, v2)
        d = _cross(*w, *c)
        return (v0 + A * c[0] + B * d[0], v1 + A * c[1] + B * d[1],
                v2 + A * c[2] + B * d[2])

    c = _cross(*w, *y)
    d = _cross(*w, *c)
    z = [y[j] + A * c[j] + B * d[j] + pose6[..., 3 + j] for j in range(3)]
    u, v, s = (K[..., i, 0] * z[0] + K[..., i, 1] * z[1] + K[..., i, 2] * z[2]
               for i in range(3))
    inv_s = 1.0 / s
    us = u * inv_s
    vs = v * inv_s
    r = torch.stack([us - uv[..., 0], vs - uv[..., 1]], dim=-1)

    Ju = [(K[..., 0, j] - us * K[..., 2, j]) * inv_s for j in range(3)]
    Jv = [(K[..., 1, j] - vs * K[..., 2, j]) * inv_s for j in range(3)]

    dz_w = []
    for k in range(3):
        e = [0.0, 0.0, 0.0]
        e[k] = 1.0
        ey = _cross(*e, *y)
        ec = _cross(*e, *c)
        wey = _cross(*w, *ey)
        dz_w.append(tuple(w[k] * dA * c[j] + A * ey[j] + w[k] * dB * d[j]
                          + B * (ec[j] + wey[j]) for j in range(3)))
    rx = [rot(Rt0[..., 0, j], Rt0[..., 1, j], Rt0[..., 2, j]) for j in range(3)]

    def proj_rows(cols):
        top = [Ju[0] * col[0] + Ju[1] * col[1] + Ju[2] * col[2] for col in cols]
        bot = [Jv[0] * col[0] + Jv[1] * col[1] + Jv[2] * col[2] for col in cols]
        return torch.stack([torch.stack(top, -1), torch.stack(bot, -1)], -2)

    # dz/dtau = I: the tau columns of dr/dz are dr/dz itself.
    Jtau = torch.stack([torch.stack(Ju, -1), torch.stack(Jv, -1)], -2)
    Jc = torch.cat([proj_rows(dz_w), Jtau], dim=-1)
    Jp = proj_rows(rx)
    return r, Jc, Jp


def _obs_jac_scalars(K, Rt0, pose6, X, uv):
    """`_obs_jacobians` flattened to 20 component tensors:
    (r0, r1, Jc (2x6) row-major, Jp (2x3) row-major)."""
    r, Jc, Jp = _obs_jacobians(K, Rt0, pose6, X, uv)
    out = [r[..., 0], r[..., 1]]
    out += [Jc[..., a, i] for a in range(2) for i in range(6)]
    out += [Jp[..., a, i] for a in range(2) for i in range(3)]
    return tuple(out)


def _m3_mul(A, B):
    """Component-wise 3x3 product of row-major 9-tuples of tensors."""
    return [A[3 * r] * B[c] + A[3 * r + 1] * B[3 + c] + A[3 * r + 2] * B[6 + c]
            for r in range(3) for c in range(3)]


def _sym3_inv_comps(h):
    """Inverse of symmetric 3x3 matrices given as (xx, xy, xz, yy, yz, zz)
    component tensors, as a row-major 9-tuple: adjugate / det, then two
    Newton refinements X <- X (2I - A X)."""
    a, b, c, e, f, i = h
    A11 = e * i - f * f
    A12 = c * f - b * i
    A13 = b * f - c * e
    A22 = a * i - c * c
    A23 = c * b - a * f
    A33 = a * e - b * b
    inv_det = 1.0 / (a * A11 + b * A12 + c * A13)
    X = [A11 * inv_det, A12 * inv_det, A13 * inv_det,
         A12 * inv_det, A22 * inv_det, A23 * inv_det,
         A13 * inv_det, A23 * inv_det, A33 * inv_det]
    A9 = [a, b, c, b, e, f, c, f, i]
    for _ in range(2):
        AX = _m3_mul(A9, X)
        Y = [2.0 - AX[0], -AX[1], -AX[2],
             -AX[3], 2.0 - AX[4], -AX[5],
             -AX[6], -AX[7], 2.0 - AX[8]]
        X = _m3_mul(X, Y)
    return tuple(X)


def _huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """min(1, delta / ||r||) over the last axis."""
    nrm = torch.linalg.vector_norm(r, dim=-1) + 1e-12
    return torch.clamp(delta / nrm, max=1.0)


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 inverse (..., 3, 3): adjugate / det, then two Newton
    refinements (the point blocks are regularized SPD, det > 0)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = torch.stack([torch.stack([A11, A12, A13], -1),
                       torch.stack([A21, A22, A23], -1),
                       torch.stack([A31, A32, A33], -1)], -2)
    X = adj / det[..., None, None]
    I2 = 2.0 * torch.eye(3, dtype=A.dtype, device=A.device)
    for _ in range(2):
        X = X @ (I2 - A @ X)
    return X


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve through `_inv3x3`: (..., 3, 3) x (..., 3)."""
    return torch.einsum("...ij,...j->...i", _inv3x3(A), b)


def _gather_obs_params(problem: BAProblem, poses: torch.Tensor,
                       cam_flat: torch.Tensor, C: int):
    """Per-observation camera parameters by index gather.

    Returns (oh (N, C) one-hot rows for the camera-block sums, K (N, 3, 3),
    Rt0 (N, 3, 4), pose (N, 6))."""
    idx = cam_flat.long()
    oh = (idx[:, None] == torch.arange(C, device=idx.device)).to(poses.dtype)
    return oh, problem.K[idx], problem.Rt0[idx], poses[idx]


def _flat_obs(problem: BAProblem, poses: torch.Tensor, points: torch.Tensor,
              C: int):
    """(oh, K, Rt0, pose, X, uv, ok) per observation, N = M * O rows."""
    M, O = problem.obs_cam.shape
    N = M * O
    cam = problem.obs_cam.reshape(N)
    ok = problem.obs_ok.reshape(N).to(poses.dtype)
    uv = problem.obs_uv.reshape(N, 2)
    oh, K_o, Rt_o, pose_o = _gather_obs_params(problem, poses, cam, C)
    X_o = points[:, None, :].expand(M, O, 3).reshape(N, 3)
    return oh, K_o, Rt_o, pose_o, X_o, uv, ok


def ba_blocks(
    problem: BAProblem,
    poses: torch.Tensor,
    points: torch.Tensor,
    num_cameras: int,
    huber_delta: float = 2.0,
):
    """Assemble the Gauss-Newton blocks.

    Returns (S (6C, 6C) reduced camera system, b (6C,),
             hpp (6-tuple of (M,) upper-triangle point-block components,
             Tikhonov regularized), b_p (3-tuple of (M,)),
             W_t (18, C, M) couplings, e = 3 * i_pose + j_point,
             cost (scalar))."""
    C = num_cameras
    M, O = problem.obs_cam.shape
    oh, K_o, Rt_o, pose_o, X_o, uv, ok = _flat_obs(problem, poses, points, C)

    vals = _obs_jac_scalars(K_o, Rt_o, pose_o, X_o, uv)
    r = [vals[0], vals[1]]
    Jc = [[vals[2 + a * 6 + i] for i in range(6)] for a in range(2)]
    Jp = [[vals[14 + a * 3 + j] for j in range(3)] for a in range(2)]
    nrm = torch.sqrt(r[0] * r[0] + r[1] * r[1]) + 1e-12
    w = torch.clamp(huber_delta / nrm, max=1.0) * ok
    r = [x * w for x in r]
    Jc = [[x * w for x in row] for row in Jc]
    Jp = [[x * w for x in row] for row in Jp]

    cost = 0.5 * (torch.sum(r[0] ** 2) + torch.sum(r[1] ** 2))

    # Point blocks: per-point sums over the O observations.
    def po(x):
        return x.reshape(M, O).sum(dim=1)

    lam = 1e-6
    hpp = []
    for (i, j) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        comp = po(Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j])
        hpp.append(comp + lam if i == j else comp)
    hpp = tuple(hpp)
    b_p = tuple(-po(Jp[0][j] * r[0] + Jp[1][j] * r[1]) for j in range(3))

    # Camera blocks: (36 | 6, N) row stacks summed per camera by one
    # matrix product with the one-hot rows.
    Gt = torch.stack([Jc[0][i] * Jc[0][j] + Jc[1][i] * Jc[1][j]
                      for i in range(6) for j in range(6)])
    Hcc = (Gt @ oh).reshape(6, 6, C).permute(2, 0, 1)
    gct = torch.stack([Jc[0][i] * r[0] + Jc[1][i] * r[1] for i in range(6)])
    b_c = -(gct @ oh).T                                        # (C, 6)

    # Couplings W_t[e, c, m] = sum_o He[e, o, m] [cam[m, o] == c] (K4).
    He = torch.stack([(Jc[0][i] * Jp[0][j] + Jc[1][i] * Jp[1][j])
                      .reshape(M, O).T for i in range(6) for j in range(3)])
    W_t = ba_coupling(He.contiguous(), problem.obs_cam.T.contiguous(), C)

    # Schur reduction: S = blockdiag(Hcc) - sum_k X_k Y_k^T with
    # (c, i)-major (6C, M) slabs.
    Hinv = _sym3_inv_comps(hpp)
    WH_rows = []
    for i in range(6):
        for k in range(3):
            acc = W_t[i * 3] * Hinv[k][None, :]
            for j in range(1, 3):
                acc = acc + W_t[i * 3 + j] * Hinv[3 * j + k][None, :]
            WH_rows.append(acc)
    WH_t = torch.stack(WH_rows)                                # (18, C, M)

    S_red = torch.zeros((C * 6, C * 6), dtype=W_t.dtype, device=W_t.device)
    b_red = torch.zeros((C * 6,), dtype=W_t.dtype, device=W_t.device)
    for k in range(3):
        sel = [i * 3 + k for i in range(6)]
        Xk = WH_t[sel].permute(1, 0, 2).reshape(C * 6, M)
        Yk = W_t[sel].permute(1, 0, 2).reshape(C * 6, M)
        S_red = S_red + Xk @ Yk.T
        b_red = b_red + Xk @ b_p[k]
    S = _blockdiag(Hcc) - S_red
    b = b_c.reshape(C * 6) - b_red
    return S, b, hpp, b_p, W_t, cost


def _blockdiag(blocks: torch.Tensor) -> torch.Tensor:
    """(C, 6, 6) -> (6C, 6C) block diagonal."""
    return torch.block_diag(*blocks)


def ba_step(
    problem: BAProblem,
    poses: torch.Tensor,
    points: torch.Tensor,
    num_cameras: int,
    damping: float = 1e-3,
    huber_delta: float = 2.0,
    fix_gauge: bool = True,
    fix_cameras: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Gauss-Newton / LM step.  Returns (poses', points', cost).

    fix_cameras freezes every pose (structure-only refinement).  fix_gauge
    pins camera 0; scale about camera 0's center stays free, so a solution
    is defined up to that similarity."""
    C = num_cameras
    S, b, hpp, b_p, W_t, cost = ba_blocks(problem, poses, points, C,
                                          huber_delta)
    if fix_cameras:
        hd = tuple(h + (damping if i in (0, 3, 5) else 0.0)
                   for i, h in enumerate(hpp))
        Hinv = _sym3_inv_comps(hd)
        dp = torch.stack([Hinv[3 * i] * b_p[0] + Hinv[3 * i + 1] * b_p[1]
                          + Hinv[3 * i + 2] * b_p[2] for i in range(3)], dim=1)
        return poses, points + dp, cost
    dc = camera_step(S, b, C, damping, fix_gauge)
    return poses + dc, points + point_step(W_t, hpp, b_p, dc), cost


def camera_step(S: torch.Tensor, b: torch.Tensor, num_cameras: int,
                damping: float, fix_gauge: bool) -> torch.Tensor:
    """The damped reduced camera solve, camera 0 pinned with fix_gauge:
    (C, 6) pose update."""
    C = num_cameras
    dev = S.device
    S = S + damping * torch.eye(C * 6, dtype=S.dtype, device=dev)
    if fix_gauge:
        mask = torch.arange(C * 6, device=dev) >= 6
        S = torch.where(mask[:, None] & mask[None, :], S, torch.zeros_like(S))
        S = S + torch.diag((~mask).to(S.dtype))
        b = torch.where(mask, b, torch.zeros_like(b))
    return torch.linalg.solve(S, b).reshape(C, 6)


def point_step(W_t: torch.Tensor, hpp, b_p, dc: torch.Tensor) -> torch.Tensor:
    """Back-substitute the points: Hpp dp = b_p - W^T dc (summed over
    cameras); (M, 3) point update."""
    rhs = []
    for k in range(3):
        Wk = W_t[[i * 3 + k for i in range(6)]]                 # (6, C, M)
        rhs.append(b_p[k] - (Wk * dc.T[:, :, None]).sum((0, 1)))
    Hinv = _sym3_inv_comps(hpp)
    return torch.stack([Hinv[3 * i] * rhs[0] + Hinv[3 * i + 1] * rhs[1]
                        + Hinv[3 * i + 2] * rhs[2] for i in range(3)], dim=1)


def ba_cost(problem: BAProblem, poses: torch.Tensor, points: torch.Tensor,
            num_cameras: int, huber_delta: float = 2.0) -> torch.Tensor:
    """0.5 * sum of squared Huber-weighted residuals (scalar tensor)."""
    _, K_o, Rt_o, pose_o, X_o, uv, ok = _flat_obs(problem, poses, points,
                                                  num_cameras)
    r = _residual(K_o, Rt_o, pose_o, X_o, uv)
    w = _huber_weight(r, huber_delta) * ok
    return 0.5 * torch.sum((r * w[:, None]) ** 2)


def bundle_adjust(
    problem: BAProblem,
    iterations: int = 10,
    damping: float = 1e-3,
    huber_delta: float = 2.0,
    fix_cameras: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt loop: adaptive damping with accept/reject, on
    the problem's device.

    Returns (poses (C, 6), points (M, 3), accepted costs (float32, one
    per iteration plus the initial one)).  Raises ValueError when a camera
    id lies outside [0, C): the reference's one-hot gave such an id zero
    parameters (a NaN cost), an index gather would wrap it to another
    camera.  The check reads back once a call, not once a step."""
    C = problem.K.shape[0]
    cam = problem.obs_cam
    if bool(((cam < 0) | (cam >= C)).any()):
        lo, hi = int(cam.min()), int(cam.max())
        raise ValueError(f"obs_cam holds camera ids in [{lo}, {hi}]; "
                         f"they must lie in [0, {C})")
    poses = torch.zeros((C, 6), dtype=problem.points0.dtype,
                        device=problem.points0.device)
    points = problem.points0
    lam = damping
    cost = float(ba_cost(problem, poses, points, C, huber_delta))
    costs = [cost]
    for _ in range(iterations):
        accepted = False
        for _try in range(6):
            p2, x2, _ = ba_step(problem, poses, points, C, lam, huber_delta,
                                fix_cameras=fix_cameras)
            c2 = float(ba_cost(problem, p2, x2, C, huber_delta))
            if np.isfinite(c2) and c2 < cost:
                poses, points, cost = p2, x2, c2
                lam = max(lam * 0.5, 1e-8)
                accepted = True
                break
            lam *= 10.0
        costs.append(cost)
        if not accepted and lam > 1e8:
            break
    return poses, points, torch.tensor(costs, dtype=torch.float32)


def apply_pose(Rt0, pose6) -> np.ndarray:
    """Compose an optimized perturbation with base extrinsics (float64
    numpy; tensors are fetched to the host)."""
    Rt0, pose6 = (np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor)
                             else a, np.float64) for a in (Rt0, pose6))
    R = rodrigues_mat(pose6[:3])
    out = np.zeros((3, 4))
    out[:, :3] = R @ Rt0[:, :3]
    out[:, 3] = R @ Rt0[:, 3] + pose6[3:]
    return out
