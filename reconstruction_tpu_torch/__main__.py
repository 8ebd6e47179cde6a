"""CLI entry point of the port (counterpart of `reconstruction_tpu/__main__.py`).

Usage mirrors the reference (`reconstruction/main.cpp:10-13`):

    python -m reconstruction_tpu_torch config.yml
    python -m reconstruction_tpu_torch batch path.txt        # BatchProcess
    python -m reconstruction_tpu_torch kinect filelist.yml   # Kinect2Cloud
    python -m reconstruction_tpu_torch masks <indir> <outdir>  # segmentation

Every mode runs on the card; ``main(argv, device="cpu")`` runs it on the
CPU instead.  ``config.yml --sharded`` splits the pairs' stereo over the
ranks of the process group (`parallel/`): a plain run is a world of one,
and on a host with N cards

    torchrun --nproc_per_node=N -m reconstruction_tpu_torch config.yml --sharded

runs N ranks, one a card, over NCCL.
"""

from __future__ import annotations

import sys
import time


def main(argv, *, device="cuda"):
    if len(argv) < 2:
        print("USAGE: python -m reconstruction_tpu_torch your_config_file.yml\n"
              "       python -m reconstruction_tpu_torch batch path.txt\n"
              "       python -m reconstruction_tpu_torch kinect filelist.yml\n"
              "       python -m reconstruction_tpu_torch masks <indir> <outdir>")
        return -1
    start = time.time()
    if argv[1] == "batch":
        from reconstruction_tpu_torch.pipeline.batch import run_batch
        run_batch(argv[2] if len(argv) > 2 else "path.txt", device=device)
    elif argv[1] == "kinect":
        from reconstruction_tpu_torch.pipeline.kinect import kinect_to_cloud
        kinect_to_cloud(argv[2], device=device)
    elif argv[1] == "masks":
        from reconstruction_tpu_torch.pipeline.segmentation import cut_image_dir
        cut_image_dir(argv[2], argv[3] if len(argv) > 3 else None, device=device)
    else:
        from reconstruction_tpu_torch.pipeline.reconstruct import (
            load_run_config, reconstruct)
        try:
            cfg, pairs = load_run_config(argv[1])
        except FileNotFoundError as e:
            # clean failure like the reference (`CReconstruction.cpp:8-14`)
            print(f"Can't open file: {e.filename}")
            return -1
        mesh = None
        if "--sharded" in argv[2:]:
            # Pair-sharded stereo over every rank of the world (replaces
            # the reference's sequential pair loop, `CStereoMatching.cpp:17`).
            import torch.distributed as dist
            from reconstruction_tpu_torch.parallel.mesh import make_mesh
            from reconstruction_tpu_torch.parallel.multihost import initialize_distributed
            joined = dist.is_initialized()
            initialize_distributed(device=device)
            mesh = make_mesh(frame=1, tile=1, device=device)
        try:
            res = reconstruct(cfg, pairs, output_path=cfg.outfilename, mesh=mesh,
                              device=device)
        finally:
            if mesh is not None and not joined:
                dist.destroy_process_group()
        print(res.timer.report())
    print(f"total time: {time.time() - start:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
