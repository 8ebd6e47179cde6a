"""The port's video demo (`reconstruction_tpu_torch/tools/demo_video.py`)
against the JAX package's (`tools/demo_video.py`), on the CPU: its
configuration, its orbiting rig and its pose error as the JAX tool builds
them, and a 2-frame run at 160x120 (16 frames at 320x240 run on the card,
`chip_smoke.py bench`): the JAX tool's JSON keys plus the card, and its
gates.  Below 160 columns the tiny preset's meshes leave the surface
(median RMSE 2.3 at 128x96), so the width stays 160."""

import json

import numpy as np
import pytest

import torch_parity  # noqa: F401 (two intra-op threads a test worker)
from synthetic import synthetic_rig
from reconstruction_tpu.config import preset as jpreset
from reconstruction_tpu_torch.tools import demo_video
from test_torch_dome import assert_same_config

# The JAX tool's JSON keys (tools/demo_video.py:108-115).
JAX_KEYS = {"frames", "views", "size", "wall_s", "per_frame_s", "pose_err_deg_final",
            "pose_err_deg_max", "mesh_rmse_median", "verts_median"}


@pytest.mark.parametrize("width", [320, 160])
def test_video_config_is_the_jax_tools(width):
    """tools/demo_video.py:42-48 on the reference's preset."""
    H = 3 * width // 4
    ref = jpreset("tiny").replace(pyramid_levels=3, lowest_level_size=(width // 4, H // 4),
                                  cam_pairs=((0, 1), (2, 3)))
    assert_same_config(demo_video.video_config(width), ref)


@pytest.mark.parametrize("frame", [0, 5, 15])
def test_orbit_rig_is_the_jax_tools(frame):
    """tools/demo_video.py:55-74: the 4-camera arc turned by 1.5 degrees a
    frame about z."""
    c, s = np.cos(np.radians(frame * 1.5)), np.sin(np.radians(frame * 1.5))
    Rw = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    ref = synthetic_rig(num_cameras=4, radius=8.0, span_deg=24.0, focal=320 * 1.6,
                        image_size=(320, 240))
    got = demo_video.orbit_rig(frame, (320, 240))
    for a, b in zip(got, ref):
        Rt = np.asarray(b.Rt)
        np.testing.assert_array_equal(np.asarray(a.K), np.asarray(b.K))
        np.testing.assert_array_equal(np.asarray(a.Rt)[:, :3], Rt[:, :3] @ Rw.T)
        np.testing.assert_array_equal(np.asarray(a.Rt)[:, 3], Rt[:, 3])


@pytest.mark.parametrize("deg, frame, err", [(-3.0, 2, 0.0), (-1.0, 2, 2.0),
                                             (179.0, 4, 175.0), (-179.0, 120, 1.0)])
def test_pose_error_is_the_jax_tools(deg, frame, err):
    """tools/demo_video.py:98-107: |angle + frame * 1.5| folded into
    [0, 180]."""
    a = np.radians(deg)
    T = np.eye(4)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    assert demo_video.pose_error_deg(T, frame) == pytest.approx(err, abs=1e-9)


def test_two_frames_on_the_cpu(tmp_path, capsys):
    out_path = tmp_path / "video.json"
    rc = demo_video.main(["--frames", "2", "--width", "160", "--json", str(out_path)],
                         device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert set(line) == JAX_KEYS | {"card"}
    assert line["card"] == "cpu"
    assert line["frames"] == 2 and line["views"] == 8 and line["size"] == [160, 120]
    assert line["mesh_rmse_median"] < demo_video.RMSE_LIMIT
    assert line["verts_median"] > 1000
    assert 0.0 <= line["pose_err_deg_final"] <= line["pose_err_deg_max"] < 5.0
    assert json.loads(out_path.read_text()) == line
