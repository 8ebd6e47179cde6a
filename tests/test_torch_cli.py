"""Port vs reference: the CLI (`python -m reconstruction_tpu_torch config.yml`)
on the reference's on-disk format, both on the CPU.

A 160x120 two-view scene (PyrmNum 2 from 80x60) is written as the
reference's users store it: an OpenCV-YAML run config and calibration and
PNG images and masks.  `load_run_config` gives both packages the same
config and bit-equal pairs; `main` through each package writes a mesh.
The fused clouds agree within 0.1% and the meshes' geometry within
`tests/test_torch_reconstruct.py`'s tolerances.  The vertex counts differ by more than those tolerances'
5% on this scene, and `test_vertex_gap_is_the_reference_int16_chi` shows
why: the reference marches an int16 copy of chi (its transfer format),
and the port's own chi, quantized so, gives the reference's count within
0.5%.
"""

import importlib
import os

import numpy as np
import pytest
from scipy.spatial import cKDTree

import torch_parity  # noqa: F401  (few intra-op threads a worker)
from synthetic import make_stereo_scene, surface_fn

import reconstruction_tpu_torch.pipeline.reconstruct as trecon
from reconstruction_tpu.__main__ import main as jmain
from reconstruction_tpu.io import images as jimages
from reconstruction_tpu.io import opencv_yaml as jyaml
from reconstruction_tpu_torch.__main__ import main as tmain
from reconstruction_tpu_torch.io import images as timages
from reconstruction_tpu_torch.io import opencv_yaml as tyaml
from reconstruction_tpu_torch.io.ply import read_ply

# The reference's pipeline package re-exports `reconstruct`, which shadows
# the module of that name.
jrecon = importlib.import_module("reconstruction_tpu.pipeline.reconstruct")

SIZE = (160, 120)


def write_scene(root, writer="reference", outfilename="out.ply"):
    """The reference's on-disk format: config.yml, calib_camera.yml, PNG
    images and 0/255 masks; written by either package."""
    yml, img = (jyaml, jimages) if writer == "reference" else (tyaml, timages)
    os.makedirs(root, exist_ok=True)
    cams, imgs, masks = make_stereo_scene(image_size=SIZE, span_deg=24.0, num_cameras=2)
    calib = {}
    for i, c in enumerate(cams):
        calib[f"intrinsic-{i}"] = np.asarray(c.K, np.float64)
        calib[f"extrinsic-{i}"] = np.asarray(c.Rt, np.float64)
        img.imwrite(os.path.join(root, f"view{i}.png"), imgs[i])
        img.imwrite(os.path.join(root, f"mask{i}.png"), masks[i])
    yml.save_opencv_yaml(os.path.join(root, "calib_camera.yml"), calib)
    return write_config(root, yml, outfilename)


def write_config(root, yml, outfilename):
    path = os.path.join(root, f"config_{os.path.splitext(outfilename)[0]}.yml")
    yml.save_opencv_yaml(path, {
        "filepath": root, "outfilename": os.path.join(root, outfilename), "isoutput": 0,
        "camera_calib_name": "calib_camera.yml", "PyrmNum": 2,
        "LowestLevelWidth": SIZE[0] // 2, "LowestLevelHeight": SIZE[1] // 2,
        "imagelist": ["view0.png", "view1.png"], "masklist": ["mask0.png", "mask1.png"],
        "camID": np.asarray([[0, 1]], np.int32)})
    return path


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_load_run_config_matches_reference(tmp_path, writer):
    path = write_scene(str(tmp_path), writer)
    jcfg, jpairs = jrecon.load_run_config(path)
    tcfg, tpairs = trecon.load_run_config(path)
    for key in ("filepath", "outfilename", "isoutput", "camera_calib_name",
                "pyramid_levels", "lowest_level_size", "imagelist", "masklist",
                "cam_pairs", "finest_size"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    for part in ("stereo", "cloud", "surface"):
        assert getattr(tcfg, part).__dict__ == getattr(jcfg, part).__dict__, part
    assert len(jpairs) == len(tpairs) == 1
    for field in ("image0", "image1", "mask0", "mask1", "K0", "Rt0", "K1", "Rt1"):
        a, b = getattr(jpairs[0], field), getattr(tpairs[0], field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """main through each package on one scene; each run's Reconstruction is
    kept by a wrapper around its package's `reconstruct`."""
    root = str(tmp_path_factory.mktemp("scene"))
    jpath = write_scene(root, "reference", "ref.ply")
    tpath = write_config(root, jyaml, "port.ply")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for key, mod in (("ref", jrecon), ("port", trecon)):
            real = mod.reconstruct

            def keep(*a, _real=real, _key=key, **kw):
                out[_key] = _real(*a, **kw)
                return out[_key]
            mp.setattr(mod, "reconstruct", keep)
        assert jmain(["prog", jpath]) == 0
        assert tmain(["prog", tpath], device="cpu") == 0
    out["ref_ply"] = read_ply(os.path.join(root, "ref.ply"))
    out["port_ply"] = read_ply(os.path.join(root, "port.ply"))
    out["root"] = root
    return out


def _rmse(v):
    sel = (np.abs(v[:, 0]) < 1.3) & (np.abs(v[:, 1]) < 1.3)
    assert sel.sum() > 1000
    dz = v[sel][:, 2] - surface_fn(v[sel][:, 0], v[sel][:, 1])
    return float(np.sqrt((dz ** 2).mean()))


def test_cli_writes_a_textured_mesh(runs):
    ply = runs["port_ply"]
    r = runs["port"]
    assert len(ply.xyz) == len(r.vertices) > 2000
    assert ply.faces is not None and len(ply.faces) == len(r.faces)
    assert np.isfinite(ply.xyz).all() and ply.colors.std() > 10.0
    assert "total" in r.timer.report() and "poisson" in r.timer.report()


def test_cli_fused_cloud_vs_reference(runs):
    a, b = len(runs["ref"].cloud_xyz), len(runs["port"].cloud_xyz)
    assert abs(a - b) <= 1e-3 * a, (a, b)


def test_cli_mesh_geometry_vs_reference(runs):
    """Interior RMSE within 10% and the mean distance from each port vertex
    to the nearest reference vertex within a quarter voxel."""
    ref, port = runs["ref_ply"].xyz, runs["port_ply"].xyz
    a, b = _rmse(ref), _rmse(port)
    assert abs(a - b) <= 0.1 * a, (a, b)
    pts = runs["ref"].cloud_xyz
    grid = trecon.preset("myself").surface.grid_resolution
    spacing = float((pts.max(0) - pts.min(0)).max()) * 1.2 / (grid - 1)
    d, _ = cKDTree(ref).query(port)
    assert d.mean() <= 0.25 * spacing, (d.mean(), spacing)


def test_cli_vertex_count_vs_reference(runs):
    """Within 12%: the reference's int16 chi removes far-field crossings
    that the port's float32 chi keeps (9.9% fewer vertices on this scene;
    see the next test)."""
    a, b = len(runs["ref_ply"].xyz), len(runs["port_ply"].xyz)
    assert abs(a - b) <= 0.12 * a, (a, b)


def test_vertex_gap_is_the_reference_int16_chi(runs, monkeypatch):
    """Marching the port's chi after the reference's int16 quantization
    (`reconstruction_tpu/pipeline/reconstruct.py:488-499`: clipped at 8
    times the steepest per-cell jump, 32000 steps) gives the reference's
    vertex count within 0.5%."""
    import torch
    real = trecon.marching_tetrahedra

    def march_int16(chi, iso, origin, spacing):
        c = torch.from_numpy(chi)
        jump = max(float((c[1:] - c[:-1]).abs().max()),
                   float((c[:, 1:] - c[:, :-1]).abs().max()),
                   float((c[:, :, 1:] - c[:, :, :-1]).abs().max()))
        A = max(8.0 * jump, 1e-12)
        q = torch.clamp(torch.round(c * (32000.0 / A)), -32000, 32000).to(torch.int16)
        return real(q.numpy().astype(np.float32) * np.float32(A / 32000.0), iso,
                    origin=origin, spacing=spacing)

    monkeypatch.setattr(trecon, "marching_tetrahedra", march_int16)
    cfg, pairs = trecon.load_run_config(os.path.join(runs["root"], "config_port.yml"))
    r = trecon.reconstruct(cfg, pairs, device="cpu")
    a = {s["stage"]: s for s in runs["ref"].stats.records}
    b = {s["stage"]: s for s in r.stats.records}
    for stage in ("poisson", "cleanup"):
        assert abs(a[stage]["verts"] - b[stage]["verts"]) <= 5e-3 * a[stage]["verts"], (
            stage, a[stage], b[stage])


def test_usage_text(capsys):
    assert tmain(["prog"]) == -1
    port = capsys.readouterr().out
    assert jmain(["prog"]) == -1
    ref = capsys.readouterr().out
    assert port == ref.replace("reconstruction_tpu ", "reconstruction_tpu_torch ")
    assert port.startswith("USAGE: python -m reconstruction_tpu_torch")


def test_missing_config(tmp_path, capsys):
    missing = str(tmp_path / "nope.yml")
    assert tmain(["prog", missing], device="cpu") == -1
    port = capsys.readouterr().out
    assert jmain(["prog", missing]) == -1
    assert port == capsys.readouterr().out == f"Can't open file: {missing}\n"


def test_sharded_raises(runs):
    """Named from when `--sharded` raised; it now checks that it does not:
    a world of one on this process (the pairs' stereo through
    `parallel/production.match_pairs_sharded`) writes the unsharded run's
    PLY byte for byte."""
    import torch.distributed as dist
    path = write_config(runs["root"], jyaml, "sharded.ply")
    assert tmain(["prog", path, "--sharded"], device="cpu") == 0
    assert not dist.is_initialized()
    with open(os.path.join(runs["root"], "sharded.ply"), "rb") as f:
        sharded = f.read()
    with open(os.path.join(runs["root"], "port.ply"), "rb") as f:
        assert sharded == f.read()


def _outcome(argv):
    try:
        return "returns", tmain(argv, device="cpu")
    except Exception as e:  # noqa: BLE001 - the outcome itself is compared
        return "raises", type(e)


@pytest.mark.parametrize("args", [
    ["nope.yml"], ["batch", "nope.txt"], ["kinect", "nope.yml"], ["masks", "nope", "out"]])
def test_sharded_raises_before_any_work(tmp_path, args):
    """Named from when `--sharded` raised before any work; it now checks
    that in every mode the flag changes nothing before a file is read (the
    inputs here do not exist): the run ends as it does without the flag,
    and no process group was started."""
    import torch.distributed as dist
    argv = ["prog"] + [str(tmp_path / a) if "nope" in a else a for a in args]
    assert _outcome(argv + ["--sharded"]) == _outcome(argv)
    assert not dist.is_initialized()
