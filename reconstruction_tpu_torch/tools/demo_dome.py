"""The synthetic 32-camera dome (`preset("dome32")`, BASELINE.json
configs[3]: 16 adjacent pairs, 5 levels, 240x135 up to 3840x2160) through
the production sharded entry point `reconstruct(mesh=...)`: the port's
counterpart of the JAX package's `tools/demo_dome.py`, with its flags, its
configuration arithmetic, its scene (32 cameras on a 200-degree arc) and
its JSON keys, plus the peak device memory and the card.

    python -m reconstruction_tpu_torch.tools.demo_dome [--pairs 16]
        [--width 1920] [--levels 5] [--refine 6] [--devices 1] [--json out]

The flags cut the preset as the JAX tool does for a CPU host: the finest
width (the base height rounded to even: --width 3840 gives 3840x2176),
the refine budget (--refine + --refine per level), mls_radius 0.08, SOR
k 30, a 128^3 Poisson grid with 4 cycles.  `--devices 1` runs one rank in
this process (NCCL on the card, gloo on the CPU); N > 1 starts N ranks on
this host (`parallel/launch.run_local`, rank r on cuda:r), each rendering
the scene itself.  `python3 chip_smoke.py dome` runs the preset itself
through this tool's `dome_pairs`, `reconstruct_sharded` and `summary`.

It exits non-zero unless the mesh passes the JAX tool's gates: finite
vertices, more than 10,000 of them, point-to-surface RMSE < 0.2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import sys
import time

import numpy as np
import torch

from reconstruction_tpu_torch.config import ReconstructionConfig, preset
from reconstruction_tpu_torch.utils.profiling import card_line

SPAN_DEG = 200.0
MIN_VERTS = 10_000
RMSE_LIMIT = 0.2


def dome_config(pairs: int = 16, width: int = 1920, levels: int = 5,
                refine: int = 6) -> ReconstructionConfig:
    """The JAX tool's configuration for these flags (`tools/demo_dome.py:64-75`)."""
    base_w = width >> (levels - 1)
    base_h = max(2 * round(base_w * 9 / 32), 2)
    cfg = preset("dome32").replace(
        pyramid_levels=levels, lowest_level_size=(base_w, base_h),
        cam_pairs=tuple((2 * i, 2 * i + 1) for i in range(pairs)))
    return cfg.replace(
        stereo=dataclasses.replace(cfg.stereo, refine_iters_base=refine,
                                   refine_iters_per_level=refine),
        cloud=dataclasses.replace(cfg.cloud, mls_radius=0.08, sor_mean_k=30),
        surface=dataclasses.replace(cfg.surface, grid_resolution=128, mg_cycles=4))


def dome_pairs(cfg: ReconstructionConfig, device="cuda"):
    """The dome's cameras and `PairInput`s: 2 x pairs cameras on a
    200-degree arc, rendered at the finest size on ``device``."""
    from reconstruction_tpu_torch.pipeline.reconstruct import PairInput
    from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene
    cams, imgs, masks = make_stereo_scene(
        image_size=cfg.finest_size, span_deg=SPAN_DEG,
        num_cameras=2 * cfg.num_pairs, device=device)
    return cams, [PairInput(image0=imgs[a], image1=imgs[b], mask0=masks[a],
                            mask1=masks[b], K0=np.asarray(cams[a].K),
                            Rt0=np.asarray(cams[a].Rt), K1=np.asarray(cams[b].K),
                            Rt1=np.asarray(cams[b].Rt))
                  for a, b in cfg.cam_pairs]


def reconstruct_sharded(cfg: ReconstructionConfig, pairs, device="cuda"):
    """`reconstruct(mesh=...)` over every rank of the world (a world of one
    in this process when none was joined, left again after).  Returns
    (Reconstruction, seconds)."""
    import torch.distributed as dist
    from reconstruction_tpu_torch.parallel.mesh import make_mesh
    from reconstruction_tpu_torch.parallel.multihost import initialize_distributed
    from reconstruction_tpu_torch.pipeline.reconstruct import reconstruct
    joined = dist.is_initialized()
    dev = initialize_distributed(device=device)
    try:
        mesh = make_mesh(frame=1, tile=1, device=device)
        _sync(dev)
        t0 = time.perf_counter()
        rec = reconstruct(cfg, pairs, mesh=mesh, device=dev)
        _sync(dev)
        return rec, time.perf_counter() - t0
    finally:
        if not joined:
            dist.destroy_process_group()


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def summary(cfg: ReconstructionConfig, rec, wall: float, devices: int,
            device="cuda") -> dict:
    """The JAX tool's JSON keys, the peak device memory (None off the
    card) and the card."""
    from reconstruction_tpu_torch.utils.synthetic import point_to_surface_rmse
    cuda = torch.device(device).type == "cuda"
    return {"cameras": 2 * cfg.num_pairs, "pairs": cfg.num_pairs,
            "finest": list(cfg.finest_size), "levels": cfg.pyramid_levels,
            "devices": devices, "wall_s": round(wall, 1),
            "peak_rss_mb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024),
            "peak_device_mb": (round(torch.cuda.max_memory_allocated() / 2**20)
                               if cuda else None),
            "card": card_line(device),
            "verts": int(len(rec.vertices)), "faces": int(len(rec.faces)),
            "cloud_points": int(len(rec.cloud_xyz)),
            "surface_rmse": round(point_to_surface_rmse(rec.vertices), 5),
            "stages_s": {k: round(v, 2) for k, v in rec.timer.spans.items()
                         if "/" not in k or k.endswith("_sharded")}}


def passes(rec) -> bool:
    """The JAX tool's gates on the mesh."""
    from reconstruction_tpu_torch.utils.synthetic import point_to_surface_rmse
    return bool(np.isfinite(rec.vertices).all() and len(rec.vertices) > MIN_VERTS
                and point_to_surface_rmse(rec.vertices) < RMSE_LIMIT)


def _rank(cfg: ReconstructionConfig, device: str, devices: int) -> dict:
    """One rank's run (in this process, or a `run_local` child): render,
    reconstruct, summarize."""
    _, pairs = dome_pairs(cfg, device)
    rec, wall = reconstruct_sharded(cfg, pairs, device)
    return dict(summary(cfg, rec, wall, devices, device), ok=passes(rec))


def run_dome(cfg: ReconstructionConfig, devices: int = 1, device="cuda") -> dict:
    """The summary of rank 0 of a world of ``devices`` ranks, with "ok":
    whether the mesh passes the gates."""
    if devices == 1:
        return _rank(cfg, device, 1)
    from reconstruction_tpu_torch.parallel.launch import run_local
    return run_local(_rank, devices, device, cfg, device, devices, timeout=3600)[0]


def main(argv=None, *, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--refine", type=int, default=6)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    cfg = dome_config(args.pairs, args.width, args.levels, args.refine)
    Wf, Hf = cfg.finest_size
    print(f"[dome] {2 * args.pairs} cameras, {args.pairs} pairs, finest {Wf}x{Hf}, "
          f"{args.levels} levels, refine {args.refine}+{args.refine}/level, "
          f"{args.devices} device(s)", flush=True)
    out = run_dome(cfg, args.devices, device)
    ok = out.pop("ok")
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    if not ok:
        print(f"[dome] the mesh fails the gates: finite vertices, more than "
              f"{MIN_VERTS}, RMSE < {RMSE_LIMIT}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
