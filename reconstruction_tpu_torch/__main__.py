"""CLI entry point of the port (counterpart of `reconstruction_tpu/__main__.py`).

Usage mirrors the reference (`reconstruction/main.cpp:10-13`):

    python -m reconstruction_tpu_torch config.yml
    python -m reconstruction_tpu_torch batch path.txt        # BatchProcess
    python -m reconstruction_tpu_torch kinect filelist.yml   # Kinect2Cloud
    python -m reconstruction_tpu_torch masks <indir> <outdir>  # segmentation

Every mode runs on the card; ``main(argv, device="cpu")`` runs it on the
CPU instead.
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
    if "--sharded" in argv[1:]:
        raise NotImplementedError(
            "--sharded (the pair-sharded front end over several devices) "
            "belongs to the port's multi-device slice, which is not ported yet")
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
        res = reconstruct(cfg, pairs, output_path=cfg.outfilename, device=device)
        print(res.timer.report())
    print(f"total time: {time.time() - start:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
