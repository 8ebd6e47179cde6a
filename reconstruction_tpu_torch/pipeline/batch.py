"""Multi-take batch driver (counterpart of `reconstruction_tpu/pipeline/batch.py`).

Replaces `BatchProcess/main.cpp:18-79`: reads a `path.txt` of
(input_dir, output_dir) lines, generates a run config per expression
(pair table {0,1},{2,3},{4,5},{7,6}, PyrmNum 4, 160x240 base,
`BatchProcess/main.cpp:30-35,47-73`), writes it beside the output as
`config_<expr>.yml`, and runs the pipeline in process on ``device`` (the
reference spawns `reconstruction.exe` per take).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from reconstruction_tpu_torch.config import ReconstructionConfig, preset
from reconstruction_tpu_torch.io.opencv_yaml import save_opencv_yaml
from reconstruction_tpu_torch.pipeline import reconstruct as _recon
from reconstruction_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

EXPRESSION_NUM = 2
CAMERA_NUM = 10


def generate_take_config(input_path: str, output_path: str,
                         expression: int) -> ReconstructionConfig:
    """One take's config (mirrors `BatchProcess/main.cpp:47-73`)."""
    imagelist = tuple(f"{expression + 1:04d}_Cam{j}.jpg"
                      for j in range(CAMERA_NUM))
    masklist = tuple(os.path.join("mask", im) for im in imagelist)
    return preset("myself").replace(
        filepath=input_path,
        outfilename=os.path.join(output_path, f"{expression + 1}.ply"),
        isoutput=False,
        camera_calib_name="calib_camera.yml",
        pyramid_levels=4,
        lowest_level_size=(160, 240),
        imagelist=imagelist,
        masklist=masklist,
        cam_pairs=((0, 1), (2, 3), (4, 5), (7, 6)),
    )


def read_path_file(path_file: str) -> List[Tuple[str, str]]:
    out = []
    with open(path_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.append((parts[0], parts[1]))
    return out


def run_batch(path_file: str, checkpoint_root: Optional[str] = None, *,
              device="cuda") -> None:
    for input_path, output_path in read_path_file(path_file):
        os.makedirs(output_path, exist_ok=True)
        for expr in range(EXPRESSION_NUM):
            cfg = generate_take_config(input_path, output_path, expr)
            # The generated run config, as the reference writes one per take.
            save_opencv_yaml(os.path.join(output_path, f"config_{expr + 1}.yml"), {
                "filepath": cfg.filepath,
                "outfilename": cfg.outfilename,
                "isoutput": int(cfg.isoutput),
                "camera_calib_name": cfg.camera_calib_name,
                "PyrmNum": cfg.pyramid_levels,
                "LowestLevelWidth": cfg.lowest_level_size[0],
                "LowestLevelHeight": cfg.lowest_level_size[1],
                "imagelist": list(cfg.imagelist),
                "masklist": list(cfg.masklist),
                "camID": np.asarray(cfg.cam_pairs, np.uint8),
            })
            pairs = _recon.load_pairs(cfg)
            ckpt = (os.path.join(checkpoint_root, f"take{expr}")
                    if checkpoint_root else None)
            log.info("take %s expr %d -> %s", input_path, expr, cfg.outfilename)
            _recon.reconstruct(cfg, pairs, output_path=cfg.outfilename,
                               checkpoint_dir=ckpt, device=device)
