"""The port's dome tool (`reconstruction_tpu_torch/tools/demo_dome.py`)
against the JAX package's (`tools/demo_dome.py`), and the port's
configuration groups against the reference's.  The port leaves out the
reference's `ba` and `parallel` groups, which no stage of either package
reads.

The tool runs on the CPU at a small size: 16 pairs (the preset's 32
cameras on their 200-degree arc, 6.45 degrees apart) at 128x72 with 2
levels.  Fewer pairs spread fewer cameras over the same arc: 2 pairs put
4 cameras 66.7 degrees apart, where neither tool's stereo holds the
surface (RMSE 0.528 here, 0.520 in the JAX tool), so the pair count
stays the preset's and the width is cut instead.  Its mesh passes the JAX tool's gates unscaled:
finite vertices, more than 10,000, point-to-surface RMSE < 0.2."""

import dataclasses
import json

import numpy as np
import pytest

import torch_parity  # noqa: F401 (two intra-op threads a test worker)
from reconstruction_tpu import config as jconfig
from reconstruction_tpu_torch import config as tconfig
from reconstruction_tpu_torch.tools import demo_dome

# The reference's config groups that the port leaves out (read by no stage).
UNREAD_GROUPS = {"ba", "parallel"}

# The JAX tool's JSON keys (tools/demo_dome.py:101-108).
JAX_KEYS = {"cameras", "pairs", "finest", "levels", "devices", "wall_s",
            "peak_rss_mb", "verts", "faces", "cloud_points", "surface_rmse",
            "stages_s"}


def jax_tool_config(pairs, width, levels, refine):
    """tools/demo_dome.py:64-75, on the reference's preset."""
    base_w = width >> (levels - 1)
    base_h = max(2 * round(base_w * 9 / 32), 2)
    cfg = jconfig.preset("dome32").replace(
        pyramid_levels=levels, lowest_level_size=(base_w, base_h),
        cam_pairs=tuple((2 * i, 2 * i + 1) for i in range(pairs)))
    return cfg.replace(
        stereo=dataclasses.replace(cfg.stereo, refine_iters_base=refine,
                                   refine_iters_per_level=refine),
        cloud=dataclasses.replace(cfg.cloud, mls_radius=0.08, sor_mean_k=30),
        surface=dataclasses.replace(cfg.surface, grid_resolution=128, mg_cycles=4))


def assert_same_config(got, ref):
    """Every field of the port's config equal to the reference's (the
    parameter groups compared as dicts), and the reference's groups all
    present in the port's but the unread ones."""
    groups = lambda c: {f.name for f in dataclasses.fields(c)
                        if dataclasses.is_dataclass(getattr(c, f.name))}
    assert groups(got) == groups(ref) - UNREAD_GROUPS
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    assert got.finest_size == ref.finest_size
    for level in range(ref.pyramid_levels):
        assert got.refine_iterations(level) == ref.refine_iterations(level)


@pytest.mark.parametrize("flags", [(16, 1920, 5, 6), (2, 128, 2, 6),
                                   (16, 3840, 5, 30), (12, 960, 4, 12)])
def test_dome_config_matches_the_jax_tool(flags):
    assert_same_config(demo_dome.dome_config(*flags), jax_tool_config(*flags))


def test_dome_width_flag_rounds_the_base_height():
    """--width 3840 gives 3840x2176, not the preset's 3840x2160 (its base
    height 135 is odd): the card smoke builds the preset itself."""
    assert demo_dome.dome_config(16, 3840, 5, 30).finest_size == (3840, 2176)
    assert tconfig.preset("dome32").finest_size == (3840, 2160)


@pytest.mark.parametrize("name", ["myself", "ETH", "tiny", "dome32"])
def test_config_groups_match_reference(name):
    """Every group of the port's ReconstructionConfig with the reference's
    field names and defaults."""
    assert_same_config(tconfig.preset(name), jconfig.preset(name))


@pytest.mark.parametrize("group", ["StereoParams", "CloudParams", "SurfaceParams"])
def test_config_group_defaults_match_reference(group):
    got = dataclasses.asdict(getattr(tconfig, group)())
    ref = dataclasses.asdict(getattr(jconfig, group)())
    assert list(got) == list(ref)
    assert got == ref


def test_dome_tool_on_the_cpu(tmp_path):
    out = tmp_path / "dome.json"
    rc = demo_dome.main(["--pairs", "16", "--width", "128", "--levels", "2",
                         "--refine", "6", "--devices", "1", "--json", str(out)],
                        device="cpu")
    res = json.loads(out.read_text())
    assert JAX_KEYS <= set(res)
    assert res["peak_device_mb"] is None and res["card"] == "cpu"
    assert (res["cameras"], res["pairs"], res["finest"], res["levels"],
            res["devices"]) == (32, 16, [128, 72], 2, 1)
    assert "stereo_sharded" in res["stages_s"]
    assert np.isfinite(res["surface_rmse"]) and res["surface_rmse"] < 0.2
    assert res["verts"] > 10_000 and res["cloud_points"] > 10_000
    assert rc == 0
