"""The benchmark's scenes: a calibrated camera arc around an analytic height
field, ray-cast on the device (a frozen copy of the port's
`utils/synthetic.make_stereo_scene`, `render_view` and
`core/camera.synthetic_rig`, made to take a seed).

The seed draws the texture's phases, the height field's phases and a small
jitter of each camera (its angle on the arc, its distance, its aim).  It
never changes the image size, the camera count, the arc or the field's
amplitudes, so every seed asks the same amount of work of the pipeline.
Views are stored as the port's callers store captured images: 8-bit BGR
values and 0/255 masks, as float32 host arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class SceneParams:
    """What the seed draws for one take."""

    surface_phase: Tuple[float, float, float, float]
    texture_phase: Tuple[float, ...]       # 6 phases, two a channel
    cam_angle_deg: Tuple[float, ...]       # jitter of each camera's angle
    cam_radius: Tuple[float, ...]          # jitter of each camera's distance
    cam_aim: Tuple[Tuple[float, float, float], ...]   # jitter of its look-at point


def draw_params(rng: np.random.Generator, num_cameras: int) -> SceneParams:
    return SceneParams(
        surface_phase=tuple(float(v) for v in rng.uniform(-0.5, 0.5, 4)),
        texture_phase=tuple(float(v) for v in rng.uniform(0.0, 2 * np.pi, 6)),
        cam_angle_deg=tuple(float(v) for v in rng.uniform(-0.1, 0.1, num_cameras)),
        cam_radius=tuple(float(v) for v in rng.uniform(-0.02, 0.02, num_cameras)),
        cam_aim=tuple(tuple(float(v) for v in row)
                      for row in rng.uniform(-0.01, 0.01, (num_cameras, 3))))


def surface_fn(x, y, ph):
    """Height field z(x, y), |z| <= 0.35."""
    return (0.25 * torch.sin(1.3 * x + ph[0]) * torch.cos(1.1 * y + ph[1])
            + 0.1 * torch.sin(3.1 * x + 0.7 + ph[2]) * torch.sin(2.3 * y + 1.1 + ph[3]))


def texture_fn(x, y, ph):
    """Aperiodic chirped BGR texture, values 0..255."""
    r = 127 + 60 * torch.sin(7.1 * x + 2.3 * x * x + ph[0]) * torch.cos(6.3 * y + 1.7 * y * y + ph[1])
    g = 127 + 60 * torch.sin(5.3 * x + 1.0 + 3.1 * x * y + ph[2]) * torch.sin(8.1 * y + 0.5 + ph[3])
    b = 127 + 60 * torch.cos(9.7 * x + 2.0 + 2.9 * y * y + ph[4]) * torch.cos(4.3 * y + 1.3 * x * x + ph[5])
    return torch.stack([b, g, r], -1)


def rig(num_cameras: int, radius: float, span_deg: float, focal: float,
        image_size: Tuple[int, int], params: SceneParams) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(K (3, 3), Rt (3, 4)) float64 of each camera of the inward-facing arc,
    jittered by ``params``."""
    w, h = image_size
    K = np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]], np.float64)
    angles = np.linspace(-span_deg / 2, span_deg / 2, num_cameras)
    cams = []
    for i, a in enumerate(angles):
        a = (a + params.cam_angle_deg[i]) * np.pi / 180.0
        center = np.asarray(params.cam_aim[i], np.float64)
        r = radius + params.cam_radius[i]
        cpos = center + r * np.array([np.sin(a), 0.0, -np.cos(a)])
        fwd = center - cpos
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd])
        t = -R @ cpos
        # float32 storage, as the port's cameras are stored
        K32 = K.astype(np.float32).astype(np.float64)
        Rt32 = np.concatenate([R, t[:, None]], axis=1).astype(np.float32).astype(np.float64)
        cams.append((K32, Rt32))
    return cams


def render_view(K: np.ndarray, Rt: np.ndarray, image_size: Tuple[int, int],
                params: SceneParams, device, extent: float = 2.0, steps: int = 64):
    """Ray-cast the height field into one view (march to the first sign
    change of z - f(x, y), then bisect 40 times), in float64 on ``device``.
    Returns (image (H, W, 3) float32 of 8-bit values, mask (H, W) float32
    0/255), host arrays."""
    w, h = image_size
    f64 = torch.float64
    sph = torch.tensor(params.surface_phase, dtype=f64, device=device)
    tph = torch.tensor(params.texture_phase, dtype=f64, device=device)
    R = torch.as_tensor(Rt[:, :3], device=device)
    t = torch.as_tensor(Rt[:, 3], device=device)
    C = -R.T @ t
    v, u = torch.meshgrid(torch.arange(h, dtype=f64, device=device),
                          torch.arange(w, dtype=f64, device=device), indexing="ij")
    rays = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                        torch.ones_like(u)], dim=-1)
    dirs = rays @ R
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    d2s = float(torch.linalg.norm(C))
    t0, t1 = d2s - 1.5, d2s + 1.5

    def F(tv):
        p = C + tv[..., None] * dirs
        return p[..., 2] - surface_fn(p[..., 0], p[..., 1], sph)

    ts = np.linspace(t0, t1, steps)
    full = lambda val: torch.full((h, w), float(val), dtype=f64, device=device)  # noqa: E731
    prev_t, prev_F = full(t0), F(full(t0))
    lo, hi = full(float("nan")), full(float("nan"))
    for k in range(1, steps):
        cur_t = full(ts[k])
        cur_F = F(cur_t)
        new = torch.isnan(lo) & (torch.sign(cur_F) != torch.sign(prev_F))
        lo = torch.where(new, prev_t, lo)
        hi = torch.where(new, cur_t, hi)
        prev_t, prev_F = cur_t, cur_F
    hit = torch.isfinite(lo)
    lo = torch.where(hit, lo, full(t0))
    hi = torch.where(hit, hi, full(t1))
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        same = torch.sign(F(mid)) == torch.sign(F(lo))
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
    p = C + (0.5 * (lo + hi))[..., None] * dirs
    inside = hit & (p[..., 0].abs() < extent) & (p[..., 1].abs() < extent)
    img = torch.where(inside[..., None], texture_fn(p[..., 0], p[..., 1], tph),
                      torch.zeros((), dtype=f64, device=device))
    img8 = img.clamp(0, 255).to(torch.uint8)
    mask = (inside.to(torch.uint8) * 255)
    return (img8.cpu().numpy().astype(np.float32), mask.cpu().numpy().astype(np.float32))


@dataclass
class PairViews:
    """One pair's raw inputs, as handed to the port and to the reference."""

    image0: np.ndarray
    image1: np.ndarray
    mask0: np.ndarray
    mask1: np.ndarray
    K0: np.ndarray
    Rt0: np.ndarray
    K1: np.ndarray
    Rt1: np.ndarray


def make_take(rig_cfg: dict, image_size: Tuple[int, int],
              cam_pairs: Sequence[Sequence[int]], params: SceneParams,
              device) -> List[PairViews]:
    """The pairs of one take: only the cameras that ``cam_pairs`` name are
    rendered."""
    cams = rig(rig_cfg["num_cameras"], rig_cfg["radius"], rig_cfg["span_deg"],
               rig_cfg["focal_per_width"] * image_size[0], image_size, params)
    views = {}
    for cid in sorted({c for pair in cam_pairs for c in pair}):
        views[cid] = render_view(*cams[cid], image_size, params, device)
    return [PairViews(image0=views[a][0], image1=views[b][0],
                      mask0=views[a][1], mask1=views[b][1],
                      K0=cams[a][0], Rt0=cams[a][1], K1=cams[b][0], Rt1=cams[b][1])
            for a, b in cam_pairs]
