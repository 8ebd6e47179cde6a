"""Port vs reference: `reconstruct` end to end, both on the CPU.

The scene of tests/test_full_pipeline.py (the tiny preset, 3 levels from
80x60, 4 cameras at 320x240 on a 24-degree arc, pairs (0, 1) and (2, 3))
goes through both packages.  The port meets that file's criteria, and
its output is held against the reference's; the measured margins are in
CHANGES.md."""

import dataclasses
import os

import numpy as np
import pytest
from scipy.spatial import cKDTree

import torch_parity  # noqa: F401  (few intra-op threads a worker)
from synthetic import make_stereo_scene, surface_fn

from reconstruction_tpu.config import preset as jpreset
from reconstruction_tpu.pipeline.reconstruct import PairInput as JPairInput
from reconstruction_tpu.pipeline.reconstruct import reconstruct as jreconstruct
from reconstruction_tpu_torch.config import preset
from reconstruction_tpu_torch.io.ply import read_ply
from reconstruction_tpu_torch.pipeline.reconstruct import (
    PairInput, _vertex_normals, reconstruct, texture_cameras)
from reconstruction_tpu_torch.surface.texture import texture_vertices

CAM_PAIRS = ((0, 1), (2, 3))


def _pairs(cls, image_size):
    cams, imgs, masks = make_stereo_scene(image_size=image_size, span_deg=24.0,
                                          num_cameras=4)
    return [cls(image0=imgs[a], image1=imgs[b], mask0=masks[a], mask1=masks[b],
                K0=np.asarray(cams[a].K), Rt0=np.asarray(cams[a].Rt),
                K1=np.asarray(cams[b].K), Rt1=np.asarray(cams[b].Rt))
            for a, b in CAM_PAIRS]


def _tiny(pkg_preset, levels, **kw):
    return pkg_preset("tiny").replace(pyramid_levels=levels, lowest_level_size=(80, 60),
                                      cam_pairs=CAM_PAIRS, **kw)


def _rmse(v):
    """tests/test_full_pipeline.py:44's interior height error."""
    sel = (np.abs(v[:, 0]) < 1.3) & (np.abs(v[:, 1]) < 1.3)
    assert sel.sum() > 1000
    dz = v[sel][:, 2] - surface_fn(v[sel][:, 0], v[sel][:, 1])
    return float(np.sqrt((dz ** 2).mean()))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cfg = _tiny(preset, 3, isoutput=True)
    out = str(tmp_path_factory.mktemp("out") / "mesh.ply")
    art = str(tmp_path_factory.mktemp("tmp_artifacts"))
    r = reconstruct(cfg, _pairs(PairInput, (320, 240)), output_path=out,
                    artifact_dir=art, device="cpu")
    r.output_path, r.artifact_dir, r.cfg = out, art, cfg
    return r


@pytest.fixture(scope="module")
def ref():
    return jreconstruct(_tiny(jpreset, 3), _pairs(JPairInput, (320, 240)))


# ------------------------------------ tests/test_full_pipeline.py's criteria


def test_mesh_nonempty(port):
    assert len(port.vertices) > 2000
    assert len(port.faces) > 4000
    assert np.isfinite(port.vertices).all()


def test_mesh_geometry(port):
    assert _rmse(port.vertices) < 0.06


def test_mesh_textured(port):
    assert port.colors.shape == (len(port.vertices), 3)
    assert port.colors.std() > 10.0


def test_output_ply_readable(port):
    data = read_ply(port.output_path)
    assert len(data.xyz) == len(port.vertices)
    assert data.faces is not None and len(data.faces) == len(port.faces)


def test_texture_uses_both_cameras(port):
    """Two views a live pair, with distinct projections and centers; the
    cam1 views alone color nearly what all views color."""
    cams = texture_cameras(port.pair_results)
    assert len(cams) == 2 * len(port.pair_results)
    for i in range(0, len(cams), 2):
        assert not np.allclose(cams[i][0], cams[i + 1][0])
        assert not np.allclose(cams[i][3], cams[i + 1][3])
    vnorm = _vertex_normals(port.vertices, port.faces)

    def coverage(cam_list):
        col = texture_vertices(port.vertices, vnorm, cam_list, device="cpu")
        return (np.abs(col - 127.0).max(axis=1) > 1.0).mean()

    cov_all = coverage(cams)
    cov_cam1 = coverage([(P, img, (m * 0 if i % 2 == 0 else m), c)
                         for i, (P, img, m, c) in enumerate(cams)])
    assert cov_all > 0.15, cov_all
    assert cov_cam1 > 0.8 * cov_all, (cov_cam1, cov_all)


def test_per_pair_artifacts(port):
    for pi, (a, b) in enumerate(CAM_PAIRS):
        cloud = read_ply(os.path.join(port.artifact_dir, f"cloud{pi}.ply"))
        assert len(cloud.xyz) > 500, (pi, len(cloud.xyz))
        assert cloud.colors is not None
        for side in (0, 1):
            scan = read_ply(os.path.join(port.artifact_dir, f"color_{pi}_{side}.ply"))
            assert len(scan.xyz) > 100, (pi, side, len(scan.xyz))
            assert scan.faces is not None and len(scan.faces) > 100
            assert scan.colors is not None and scan.colors.std() > 1.0
        for cam_id in (a, b):
            path = os.path.join(port.artifact_dir, f"{pi}_{cam_id}.jpg")
            assert os.path.exists(path) and os.path.getsize(path) > 1000, path


@pytest.fixture(scope="module")
def fresh_and_resumed(tmp_path_factory):
    """The dedup production path at 160x120, 2 levels, run fresh into a
    checkpoint directory and then restored from it."""
    cfg = _tiny(preset, 2)
    cfg = cfg.replace(cloud=dataclasses.replace(cfg.cloud, dedup=True))
    pairs = _pairs(PairInput, (160, 120))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    fresh = reconstruct(cfg, pairs, checkpoint_dir=ckpt, device="cpu")
    resumed = reconstruct(cfg, pairs, checkpoint_dir=ckpt, device="cpu")
    return fresh, resumed


def _records(r):
    return {rec["stage"]: rec for rec in r.stats.records}


def test_dedup_production_path(fresh_and_resumed):
    """The eroded rectified masks' gate rejects points, and the run still
    gives a mesh."""
    fresh, _ = fresh_and_resumed
    assert len(fresh.vertices) > 500
    recs = _records(fresh)
    total = sum(recs[f"pair{i}"]["kept_points"] for i in range(2))
    assert 0 < recs["dedup"]["kept"] < total, (recs["dedup"], total)


def test_resume_matches_fresh(fresh_and_resumed):
    """Restored pairs give the fresh run's mesh, texture and dedup."""
    fresh, resumed = fresh_and_resumed
    np.testing.assert_array_equal(fresh.vertices, resumed.vertices)
    np.testing.assert_array_equal(fresh.faces, resumed.faces)
    np.testing.assert_allclose(fresh.colors, resumed.colors, atol=1e-3)
    assert resumed.colors.std() > 10.0
    assert _records(resumed)["dedup"]["kept"] == _records(fresh)["dedup"]["kept"]


# ------------------------------------------------------ against the reference


def test_fused_cloud_count_vs_reference(port, ref):
    """The MLS'd fused clouds' point counts within 0.1%."""
    a, b = len(ref.cloud_xyz), len(port.cloud_xyz)
    assert abs(a - b) <= 1e-3 * a, (a, b)


def test_mesh_vertex_count_vs_reference(port, ref):
    a, b = len(ref.vertices), len(port.vertices)
    assert abs(a - b) <= 0.05 * a, (a, b)


def test_mesh_near_reference(port, ref):
    """Mean distance from each port vertex to the nearest reference vertex
    within a quarter of the Poisson grid's voxel."""
    pts = ref.cloud_xyz
    ext = float((pts.max(0) - pts.min(0)).max())
    spacing = ext * 1.2 / (port.cfg.surface.grid_resolution - 1)
    d, _ = cKDTree(ref.vertices).query(port.vertices)
    assert d.mean() <= 0.25 * spacing, (d.mean(), spacing)


def test_mesh_rmse_vs_reference(port, ref):
    a, b = _rmse(ref.vertices), _rmse(port.vertices)
    assert abs(a - b) <= 0.1 * a, (a, b)
