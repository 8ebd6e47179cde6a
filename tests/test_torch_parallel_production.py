"""The port's production pair-sharded path on gloo ranks on the CPU:
`parallel/production.match_pairs_sharded` with 3 pairs on a pair axis of
2 (a padded lane) and `reconstruct(mesh=...)` on the tiny preset at
160x120 (tests/test_parallel.py:113-173), each held bit for bit to the
port's sequential path; and `parallel/dryrun.py` on a world of four.
The worlds start before the module's first test and run while the
pytest process computes the sequential references."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from reconstruction_tpu_torch.config import preset
from reconstruction_tpu_torch.parallel.dryrun import dryrun
from reconstruction_tpu_torch.parallel.launch import run_local
from reconstruction_tpu_torch.pipeline.reconstruct import PairInput, reconstruct
from reconstruction_tpu_torch.stereo.pipeline import match_pair
from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_work as work  # noqa: E402

CFG = preset("tiny").replace(pyramid_levels=2, lowest_level_size=(80, 60),
                             cam_pairs=((0, 1), (2, 3)))
CFG3 = CFG.replace(cam_pairs=((0, 1), (2, 3), (1, 2)))


def _pairs(cfg, cams, imgs, masks):
    return [PairInput(image0=imgs[a], image1=imgs[b], mask0=masks[a], mask1=masks[b],
                      K0=np.asarray(cams[a].K), Rt0=np.asarray(cams[a].Rt),
                      K1=np.asarray(cams[b].K), Rt1=np.asarray(cams[b].Rt))
            for a, b in cfg.cam_pairs]


@pytest.fixture(scope="module")
def scene():
    cams, imgs, masks = make_stereo_scene(image_size=(160, 120), span_deg=24.0,
                                          num_cameras=4, device="cpu")
    return _pairs(CFG3, cams, imgs, masks), _pairs(CFG, cams, imgs, masks)


@pytest.fixture(scope="module", autouse=True)
def jobs(scene):
    pairs3, pairs2 = scene
    with ThreadPoolExecutor(2) as pool:
        yield dict(
            production=pool.submit(run_local, work.production, 2, "cpu",
                                   CFG3, pairs3, CFG, pairs2, timeout=600),
            dryrun=pool.submit(run_local, dryrun, 4, "cpu", "cpu", timeout=600))


@pytest.fixture(scope="module")
def sequential(scene):
    """The port's sequential `reconstruct` of the two pairs, and the third
    pair's `match_pair`, with the ranks' thread count."""
    pairs3, pairs2 = scene
    torch.set_num_threads(work.THREADS)
    rec = reconstruct(CFG, pairs2, device="cpu")
    p = pairs3[2]
    third = match_pair(CFG3, p.image0, p.image1, p.mask0, p.mask1, p.K0, p.Rt0, p.K1, p.Rt1,
                       device="cpu")
    return rec, list(rec.pair_results) + [third]


@pytest.fixture(scope="module")
def production(jobs, sequential):
    return jobs["production"].result()


@pytest.mark.parametrize("rank", (0, 1))
@pytest.mark.parametrize("pi", (0, 1, 2))
def test_match_pairs_sharded_equals_match_pair(production, sequential, rank, pi):
    """Every rank holds every pair's result in input order, equal to the
    sequential `match_pair` (pair 2 ran on rank 1 beside its padded lane)."""
    got = production[rank]["pairs"]
    assert len(got) == 3
    ref = sequential[1][pi]
    g = got[pi]
    np.testing.assert_array_equal(g["disparity"], ref.disparity.numpy())
    np.testing.assert_array_equal(g["xyz"], ref.cloud.xyz.numpy())
    np.testing.assert_array_equal(g["colors"], ref.cloud.colors.numpy())
    np.testing.assert_array_equal(g["valid"], ref.cloud.valid.numpy())
    np.testing.assert_array_equal(g["rect0"], ref.rect_images[0].numpy())
    np.testing.assert_array_equal(g["rect1"], ref.rect_images[1].numpy())
    np.testing.assert_array_equal(g["mask0"], ref.rect_masks[0].numpy())
    np.testing.assert_array_equal(g["em0"], ref.rect_masks_eroded[0].numpy())
    np.testing.assert_array_equal(g["drift"], ref.refine_drift.numpy())
    assert g["margins0"] == [int(v) for v in ref.margins0]
    assert g["margins1"] == [int(v) for v in ref.margins1]


@pytest.mark.parametrize("rank", (0, 1))
def test_sharded_reconstruct_equals_sequential(production, sequential, rank):
    rec = sequential[0]
    got = production[rank]
    assert "stereo_sharded" in got["spans"]
    assert not any(s.endswith("/stereo") for s in got["spans"])
    assert len(rec.vertices) > 1000
    np.testing.assert_array_equal(got["vertices"], rec.vertices)
    np.testing.assert_array_equal(got["faces"], rec.faces)
    np.testing.assert_array_equal(got["colors"], rec.colors)
    split = next(r for r in got["stats"] if r["stage"] == "stereo_sharded")
    assert split["pairs"] == 2 and split["gather_s"] >= 0.0


def test_dryrun_world_of_four(jobs):
    out = jobs["dryrun"].result()
    for r in out:
        assert r == out[0]
    s = out[0]
    assert s["mesh"] == dict(pair=2, tile=2)
    assert s["stereo"] == (2, 32, 48) and s["refine"] == (32, 48)
    assert s["fused"] == (128, 3) and s["chi"] == (64, 64, 64) and s["chi_finite"]
    assert s["splat_mass"] == pytest.approx(128.0) and s["production_verts"] > 0
    assert np.isfinite(s["ba_cost"])
