"""A synthetic video through `pipeline/video.reconstruct_video` with
frame-to-frame pose estimation and loop closures (BASELINE configs[4]:
16 frames x 2 pairs = 64 views): the port's counterpart of the JAX
package's `tools/demo_video.py`, with its flags, its rig, its JSON keys
and its gates, plus the card.  It runs on the card (the JAX tool pins
JAX to the CPU).

    python -m reconstruction_tpu_torch.tools.demo_video [--frames 16]
        [--width 320] [--json out]

The 4-camera rig (a 24-degree arc, radius 8) orbits the scene's z axis
by 1.5 degrees a frame and re-renders each frame, so the anchor camera's
features see real motion; `preset("tiny")` at 3 levels from W/4 x H/4
(H = 3W/4) reconstructs pairs (0, 1) and (2, 3) of each frame, and the
pose graph closes a loop every 8 frames.

It exits non-zero unless every frame's mesh has finite vertices and the
median point-to-surface RMSE is below 0.1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from reconstruction_tpu_torch.config import ReconstructionConfig, preset
from reconstruction_tpu_torch.utils.profiling import card_line

STEP_DEG = 1.5
RMSE_LIMIT = 0.1


def video_config(width: int = 320) -> ReconstructionConfig:
    """The JAX tool's configuration (`tools/demo_video.py:45-48`)."""
    H = 3 * width // 4
    return preset("tiny").replace(pyramid_levels=3,
                                  lowest_level_size=(width // 4, H // 4),
                                  cam_pairs=((0, 1), (2, 3)))


def orbit_rig(frame: int, size=(320, 240), num_cameras: int = 4,
              span_deg: float = 24.0):
    """The cameras of frame ``frame`` (this tool's: 4 on a 24-degree arc,
    radius 8, focal 1.6 x width): the rig turned by frame * STEP_DEG about
    the scene's z axis."""
    from reconstruction_tpu_torch.core.camera import synthetic_rig
    a = np.radians(frame * STEP_DEG)
    Rw = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                   [0.0, 0.0, 1.0]])
    cams = []
    for c in synthetic_rig(num_cameras=num_cameras, radius=8.0, span_deg=span_deg,
                           focal=size[0] * 1.6, image_size=size):
        Rt = np.asarray(c.Rt)
        cams.append(type(c)(K=c.K, Rt=np.concatenate([Rt[:, :3] @ Rw.T, Rt[:, 3:]], 1)))
    return cams


def pose_error_deg(T: np.ndarray, frame: int) -> float:
    """Degrees between a frame's optimized rig rotation about z and the
    orbit's: the scene is fixed and the rig turns +STEP_DEG a frame, so the
    anchor's flow sees -frame * STEP_DEG."""
    e = abs(np.degrees(np.arctan2(T[1, 0], T[0, 0])) + frame * STEP_DEG) % 360
    return float(min(e, 360 - e))


def run_video(frames: int = 16, width: int = 320, device="cuda"):
    """Render the frames, run `reconstruct_video`; returns (summary dict,
    results)."""
    from reconstruction_tpu_torch.pipeline.reconstruct import PairInput
    from reconstruction_tpu_torch.pipeline.video import reconstruct_video
    from reconstruction_tpu_torch.utils.synthetic import point_to_surface_rmse, render_view

    cfg = video_config(width)
    size = (width, 3 * width // 4)
    t0 = time.perf_counter()
    rendered = []
    for f in range(frames):
        cams = orbit_rig(f, size)
        views = [render_view(c, size, device=device) for c in cams]
        rendered.append((cams, views))
    print(f"[video] rendered {frames} frames x 4 views "
          f"({time.perf_counter() - t0:.1f}s)", file=sys.stderr, flush=True)

    def loader(i):
        cams, views = rendered[i]
        return [PairInput(image0=views[a][0], image1=views[b][0], mask0=views[a][1],
                          mask1=views[b][1], K0=np.asarray(cams[a].K),
                          Rt0=np.asarray(cams[a].Rt), K1=np.asarray(cams[b].K),
                          Rt1=np.asarray(cams[b].Rt)) for a, b in cfg.cam_pairs]

    t0 = time.perf_counter()
    results = reconstruct_video(cfg, loader, frames, depth_hint=8.0,
                                loop_closure_stride=8, device=device)
    wall = time.perf_counter() - t0
    errs = [pose_error_deg(r.rig_pose, f) for f, r in enumerate(results)]
    rmses = [point_to_surface_rmse(r.mesh_vertices) for r in results]
    out = {"frames": frames, "views": 4 * frames, "size": list(size),
           "wall_s": round(wall, 1),
           "per_frame_s": round(wall / frames, 2),
           "pose_err_deg_final": round(errs[-1], 3),
           "pose_err_deg_max": round(max(errs), 3),
           "mesh_rmse_median": round(float(np.median(rmses)), 4),
           "verts_median": int(np.median([len(r.mesh_vertices) for r in results])),
           "card": card_line(device)}
    return out, results


def passes(out: dict, results) -> bool:
    """The JAX tool's gates: finite vertices in every frame, median RMSE
    below RMSE_LIMIT."""
    return bool(all(np.isfinite(r.mesh_vertices).all() for r in results)
                and out["mesh_rmse_median"] < RMSE_LIMIT)


def main(argv=None, *, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    out, results = run_video(args.frames, args.width, device)
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    if not passes(out, results):
        print(f"[video] the meshes fail the gates: finite vertices, median RMSE "
              f"< {RMSE_LIMIT}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
