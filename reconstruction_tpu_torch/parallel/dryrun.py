"""One step of every sharded function on tiny shapes, over the initialized
world (counterpart of `__graft_entry__.dryrun_multichip`): pair-sharded
stereo matching, the tile-sharded refine, a distributed BA step, cloud
gather and splat, `reconstruct(mesh=...)` end to end, and the z-sharded
Poisson multigrid.

    torchrun --nproc_per_node=N -m reconstruction_tpu_torch.parallel.dryrun [cpu]

Each rank prints one summary line; `parallel/launch.run_local(dryrun, n,
device)` runs it on a local world.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from reconstruction_tpu_torch.config import NOMATCH


def dryrun(device="cuda") -> dict:
    """Run the step on every rank of the world (n ranks: a pair x tile
    mesh with tile 2 for even n, and a z mesh of n tiles); returns this
    rank's summary."""
    from reconstruction_tpu_torch.ba.bundle_adjust import BAProblem
    from reconstruction_tpu_torch.config import preset
    from reconstruction_tpu_torch.parallel.distributed_ba import ba_step_sharded
    from reconstruction_tpu_torch.parallel.fusion import all_gather_clouds, distributed_splat
    from reconstruction_tpu_torch.parallel.mesh import (
        axis_rank, axis_size, make_mesh, mesh_device)
    from reconstruction_tpu_torch.parallel.poisson_sharded import poisson_vcycle_sharded
    from reconstruction_tpu_torch.parallel.sharded import (
        match_level_pairs_sharded, refine_tiled)
    from reconstruction_tpu_torch.pipeline.reconstruct import PairInput, reconstruct
    from reconstruction_tpu_torch.stereo.margins import find_margin
    from reconstruction_tpu_torch.stereo.triangulate import PointCloud
    from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene

    n = dist.get_world_size()
    tile = 2 if n % 2 == 0 else 1
    pair = n // tile
    mesh = make_mesh(frame=1, pair=pair, tile=tile, device=device)
    dev = mesh_device(mesh)
    rng = np.random.default_rng(0)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    H, W = 32, 48

    # pair-sharded stereo level
    imgs0 = on(rng.integers(0, 256, (pair, H, W, 3)).astype(np.float32))
    imgs1 = on(rng.integers(0, 256, (pair, H, W, 3)).astype(np.float32))
    masks = np.zeros((pair, H, W), np.float32)
    masks[:, 4:-4, 4:-4] = 255.0
    masks = on(masks)
    state = match_level_pairs_sharded(mesh, imgs0, imgs1, masks, masks, None, 0,
                                      refine_iters=2)

    # tile-sharded refine with halo exchange
    Ht = 16 * tile
    imgL = on(rng.integers(0, 256, (Ht, W, 3)).astype(np.float32))
    imgR = on(rng.integers(0, 256, (Ht, W, 3)).astype(np.float32))
    disp = rng.integers(-2, 3, (Ht, W)).astype(np.float32)
    valid = np.zeros((Ht, W), bool)
    valid[2:-2, 2:-2] = True
    disp[~valid] = NOMATCH
    m = find_margin(on(valid), 2)
    out = refine_tiled(mesh, on(disp), imgL, imgR, m, iterations=3, s_cap=16, band=8)

    # distributed BA step (points over 'pair', Schur complement all-reduced)
    C, M, O = 4, 8 * pair, 4
    K = np.tile(np.array([[100.0, 0, 24], [0, 100, 16], [0, 0, 1]], np.float32), (C, 1, 1))
    Rt0 = np.tile(np.hstack([np.eye(3), [[0], [0], [5.0]]]).astype(np.float32), (C, 1, 1))
    prob = BAProblem(
        K=on(K), Rt0=on(Rt0),
        points0=on(rng.normal(size=(M, 3)).astype(np.float32)),
        obs_uv=on(rng.uniform(0, 40, (M, O, 2)).astype(np.float32)),
        obs_cam=on(rng.integers(0, C, (M, O)).astype(np.int32)),
        obs_ok=on(np.ones((M, O), bool)))
    _, _, cost = ba_step_sharded(mesh, prob, torch.zeros((C, 6), device=dev),
                                 prob.points0, C)

    # cloud fusion: this rank's pair's cloud gathered, and splatted
    Np = 64
    pts = rng.normal(size=(pair, Np, 3)).astype(np.float32)
    nrm = rng.normal(size=(pair, Np, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    col = rng.uniform(0, 255, (pair, Np, 3)).astype(np.float32)
    mine = slice(axis_rank(mesh, "pair"), axis_rank(mesh, "pair") + 1)
    fused = all_gather_clouds(mesh, PointCloud(on(pts[mine]), on(col[mine]),
                                               on(np.ones((1, Np), bool))))
    _, D = distributed_splat(mesh, on(pts[mine]), on(nrm[mine]), on(np.ones((1, Np), bool)),
                             on(np.full(3, -4.0, np.float32)), torch.tensor(0.25, device=dev),
                             32)

    # reconstruct(mesh=...) end to end on a tiny synthetic scene
    cfg = preset("tiny").replace(pyramid_levels=2, lowest_level_size=(64, 48),
                                 cam_pairs=((0, 1), (2, 3)))
    cfg = cfg.replace(surface=cfg.surface.__class__(grid_resolution=32, mg_cycles=2))
    cams, views, msks = make_stereo_scene(image_size=(128, 96), span_deg=24.0,
                                          num_cameras=4, device=dev)
    pins = [PairInput(image0=views[a], image1=views[b], mask0=msks[a], mask1=msks[b],
                      K0=np.asarray(cams[a].K), Rt0=np.asarray(cams[a].Rt),
                      K1=np.asarray(cams[b].K), Rt1=np.asarray(cams[b].Rt))
            for a, b in cfg.cam_pairs]
    recon = reconstruct(cfg, pins, mesh=mesh, device=dev.type)
    if "stereo_sharded" not in recon.timer.spans or len(recon.vertices) == 0:
        raise AssertionError("dryrun: reconstruct(mesh=...) made no sharded mesh")

    # z-plane-sharded Poisson multigrid
    zmesh = make_mesh(frame=1, pair=1, tile=n, device=device)
    Rg = 16 * n
    f = torch.zeros((Rg, Rg, Rg), device=dev)
    f[Rg // 2, Rg // 2, Rg // 2] = 1.0
    chi = poisson_vcycle_sharded(zmesh, f, torch.zeros_like(f), levels=2, cycles=1)

    summary = dict(mesh=dict(pair=axis_size(mesh, "pair"), tile=axis_size(mesh, "tile")),
                   stereo=tuple(state.disp0.shape), refine=tuple(out.shape),
                   ba_cost=float(cost), fused=tuple(fused.xyz.shape),
                   splat_mass=float(D.sum()), production_verts=len(recon.vertices),
                   chi=tuple(chi.shape), chi_finite=bool(torch.isfinite(chi).all()))
    print(f"dryrun rank {dist.get_rank()}/{n}: {summary}", flush=True)
    return summary


if __name__ == "__main__":
    from reconstruction_tpu_torch.parallel.multihost import initialize_distributed
    device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    initialize_distributed(device=device)
    try:
        dryrun(device)
    finally:
        dist.destroy_process_group()
