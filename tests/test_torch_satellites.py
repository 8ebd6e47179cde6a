"""Port vs reference: the satellite modes and host utilities, on the CPU.

The cases of tests/test_pipeline_satellites.py (all but tools/tpu_run's),
each also held against the reference's output on the same inputs: the
batch driver's configs and the pairs it hands `reconstruct`, the Kinect
converter, the segmentation (score, flood fill, region growing, masks),
mesh decimation and subdivision, the watchdog, the geometry metrics and
the roofline table.
"""

import dataclasses
import importlib
import json
import os
import time

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (few intra-op threads a worker)
from torch_parity import T

import jax.numpy as jnp
from reconstruction_tpu.io import images as jimages
from reconstruction_tpu.io import opencv_yaml as jyaml
from reconstruction_tpu.pipeline import batch as jbatch
from reconstruction_tpu.pipeline import kinect as jkinect
from reconstruction_tpu.pipeline import segmentation as jseg
from reconstruction_tpu.surface import simplify as jsimplify
from reconstruction_tpu.utils import metrics as jmetrics
from reconstruction_tpu.utils import profiling as jprofiling
from reconstruction_tpu_torch.io import images as timages
from reconstruction_tpu_torch.io.ply import read_ply
from reconstruction_tpu_torch.pipeline import batch as tbatch
from reconstruction_tpu_torch.pipeline import kinect as tkinect
from reconstruction_tpu_torch.pipeline import segmentation as tseg
from reconstruction_tpu_torch.surface import simplify as tsimplify
from reconstruction_tpu_torch.utils import metrics as tmetrics
from reconstruction_tpu_torch.utils import profiling as tprofiling
from reconstruction_tpu_torch.utils.watchdog import (
    StageTimeout, check_finite, run_with_deadline)

jrecon = importlib.import_module("reconstruction_tpu.pipeline.reconstruct")
trecon = importlib.import_module("reconstruction_tpu_torch.pipeline.reconstruct")


# ------------------------------------------------------------------- batch


def assert_same_config(got, ref):
    """Every field of the port's config equal to the reference's (the
    parameter groups compared as dicts: they are the packages' own classes)."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name


@pytest.mark.parametrize("expression", [0, 1])
def test_batch_config_matches_reference(expression):
    ref = jbatch.generate_take_config("/in", "/out", expression)
    got = tbatch.generate_take_config("/in", "/out", expression)
    assert_same_config(got, ref)
    # tests/test_pipeline_satellites.py's checks
    assert got.pyramid_levels == 4 and got.lowest_level_size == (160, 240)
    assert got.cam_pairs == ((0, 1), (2, 3), (4, 5), (7, 6))
    assert got.imagelist[3] == f"000{expression + 1}_Cam3.jpg"
    assert got.masklist[3].endswith(f"000{expression + 1}_Cam3.jpg")


def _take_dir(root, rng):
    """A take in the reference's layout: 10 cameras x 2 expressions of
    JPEG images, masks in mask/, calib_camera.yml."""
    os.makedirs(os.path.join(root, "mask"), exist_ok=True)
    calib = {}
    for j in range(tbatch.CAMERA_NUM):
        calib[f"intrinsic-{j}"] = np.eye(3) * (100.0 + j)
        calib[f"extrinsic-{j}"] = rng.normal(size=(3, 4))
        for e in range(tbatch.EXPRESSION_NUM):
            name = f"{e + 1:04d}_Cam{j}.jpg"
            timages.imwrite(os.path.join(root, name),
                            rng.integers(0, 256, (12, 16, 3)).astype(np.float32))
            timages.imwrite(os.path.join(root, "mask", name),
                            (rng.uniform(size=(12, 16)) > 0.3).astype(np.float32) * 255)
    jyaml.save_opencv_yaml(os.path.join(root, "calib_camera.yml"), calib)


def test_run_batch_matches_reference(tmp_path, rng, monkeypatch):
    take, out = str(tmp_path / "take"), str(tmp_path / "out")
    _take_dir(take, rng)
    path_file = tmp_path / "path.txt"
    path_file.write_text(f"{take} {out}\n\nignored-single-column\n")
    calls = {"ref": [], "port": []}
    monkeypatch.setattr(jrecon, "reconstruct",
                        lambda cfg, pairs, **kw: calls["ref"].append((cfg, pairs, kw)))
    monkeypatch.setattr(trecon, "reconstruct",
                        lambda cfg, pairs, **kw: calls["port"].append((cfg, pairs, kw)))
    jbatch.run_batch(str(path_file))
    written = {e: open(os.path.join(out, f"config_{e}.yml"), "rb").read() for e in (1, 2)}
    tbatch.run_batch(str(path_file), device="cpu")
    for e in (1, 2):
        assert open(os.path.join(out, f"config_{e}.yml"), "rb").read() == written[e]
    assert len(calls["ref"]) == len(calls["port"]) == tbatch.EXPRESSION_NUM
    for (jc, jp, jkw), (tc, tp, tkw) in zip(calls["ref"], calls["port"]):
        assert_same_config(tc, jc)
        assert jkw == {"output_path": jc.outfilename, "checkpoint_dir": None}
        assert tkw == dict(jkw, device="cpu")
        assert len(jp) == len(tp) == 4
        for a, b in zip(jp, tp):
            for f in ("image0", "image1", "mask0", "mask1", "K0", "Rt0", "K1", "Rt1"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f


# ------------------------------------------------------------------ kinect


def test_kinect_depth_to_points():
    """tests/test_pipeline_satellites.py's case."""
    H, W = 24, 32
    depth = np.zeros((H, W), np.float32)
    bg = np.full((H, W), 2000.0, np.float32)
    depth[10, 10] = 1000.0   # kept: bg-d=1000>500
    depth[10, 11] = 1800.0   # dropped: bg-d=200
    depth[5, 5] = 1000.0
    bg[5, 5] = 50.0          # dropped: bg<100
    pts, ok = tkinect.depth_to_points(T(depth), T(bg), T(np.float32([100, 100, 16, 12])),
                                      T(np.float32([0, W, 0, H])))
    assert int(ok.sum()) == 1
    np.testing.assert_allclose(pts[ok][0].numpy(), [(10 - 16) * 10, (10 - 12) * 10, 1000, 1],
                               atol=1e-3)


def test_kinect_depth_to_points_matches_reference(rng):
    H, W = 53, 61
    depth = rng.integers(0, 4500, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.2] = 0
    bg = rng.integers(0, 5000, (H, W)).astype(np.float32)
    intr = np.float32([365.3, 365.1, 30.7, 25.2])
    bbox = np.float32([3, 55, 2, 48])
    jp, jo = jkinect.depth_to_points(jnp.asarray(depth), jnp.asarray(bg),
                                     jnp.asarray(intr), jnp.asarray(bbox))
    tp, to = tkinect.depth_to_points(T(depth), T(bg), T(intr), T(bbox))
    assert np.array_equal(np.asarray(jo), to.numpy()) and int(to.sum()) > 100
    assert np.array_equal(np.asarray(jp), tp.numpy())


def test_kinect_to_cloud_matches_reference(tmp_path, rng):
    """The converter end to end on one device's two frames.  Both packages
    read depth through imread(grayscale=True), 8-bit, as the reference
    does; the PLYs are byte-equal."""
    sn = "001122"
    calib = {f"DepthCameraIntrinsic-{sn}": np.float64([[365.3, 365.1, 30.7, 25.2]]),
             f"R1t_times_R-{sn}": rng.normal(size=(4, 3))}
    jyaml.save_opencv_yaml(str(tmp_path / "kinect.yml"), calib)
    files, bks = [], []
    for i in range(2):
        for lst, lo, hi in ((files, 0, 120), (bks, 100, 256)):
            p = str(tmp_path / f"{len(files) + len(bks)}.png")
            jimages.imwrite(p, rng.integers(lo, hi, (24, 32)).astype(np.float32))
            lst.append(p)
    for pkg, mod in (("ref", jkinect), ("port", tkinect)):
        outs = [str(tmp_path / f"{pkg}{i}.ply") for i in range(2)]
        jyaml.save_opencv_yaml(str(tmp_path / f"{pkg}.yml"), {
            "kinect_info": str(tmp_path / "kinect.yml"),
            "boundingbox": [0, 32, 0, 24], "kinect_sn": [sn],
            f"imagelist-{sn}": files, f"masklist-{sn}": bks, f"outlist-{sn}": outs})
        if pkg == "ref":
            mod.kinect_to_cloud(str(tmp_path / "ref.yml"))
        else:
            mod.kinect_to_cloud(str(tmp_path / "port.yml"), device="cpu")
    for i in range(2):
        ref = open(tmp_path / f"ref{i}.ply", "rb").read()
        assert open(tmp_path / f"port{i}.ply", "rb").read() == ref
        read_ply(str(tmp_path / f"port{i}.ply"))


# ------------------------------------------------------------ segmentation


def _frame(rng, H, W, integer=True):
    bg = rng.uniform(80, 120, (H, W, 3)).astype(np.float32)
    img = bg.copy()
    y0, y1, x0, x1 = H * 5 // 16, H * 11 // 16, W * 3 // 8, W * 27 // 40
    img[y0:y1, x0:x1] = rng.uniform(180, 250, (y1 - y0, x1 - x0, 3))
    if integer:
        img, bg = np.round(img), np.round(bg)
    return img.astype(np.float32), bg.astype(np.float32)


@pytest.mark.parametrize("channels", [3, 1])
def test_background_ncc_score_matches_reference(rng, channels):
    """Within 5e-6: the reference's jitted score rounds its fused window
    sums differently (measured up to 2.7e-6, where the cross term cancels
    against n * mean * mean); scores lie in [-1, 1]."""
    img, bg = _frame(rng, 48, 64, integer=False)
    if channels == 1:
        img, bg = img[..., 0], bg[..., 0]
    ref = np.asarray(jseg.background_ncc_score(jnp.asarray(img), jnp.asarray(bg), 2))
    got = tseg.background_ncc_score(T(img), T(bg), 2).numpy()
    assert np.abs(ref - got).max() <= 5e-6


@pytest.mark.parametrize("op", ["dilate", "erode", "open", "close"])
def test_binary_morph_matches_reference(rng, op):
    m = rng.uniform(size=(40, 52)) < 0.4
    for r in (2, 3):
        ref = np.asarray(jseg._binary_morph(jnp.asarray(m), op, r))
        assert np.array_equal(tseg._binary_morph(T(m), op, r).numpy(), ref)


@pytest.mark.parametrize("check_every", [1, 32])
def test_flood_fill_respects_barrier(monkeypatch, check_every):
    monkeypatch.setattr(tseg, "CHECK_EVERY", check_every)
    allowed = np.ones((16, 16), bool)
    allowed[:, 8] = False  # wall
    seed = np.zeros((16, 16), bool)
    seed[2, 2] = True
    out = tseg.flood_fill(T(seed), T(allowed)).numpy()
    assert out[:, :8].sum() == 16 * 8
    assert out[:, 9:].sum() == 0


@pytest.mark.parametrize("check_every", [1, 32])
@pytest.mark.parametrize("max_iters", [4096, 5, 37, 0])
def test_flood_fill_matches_reference(monkeypatch, rng, check_every, max_iters):
    """Equal to the reference's while loop, converged or cut at max_iters
    (mid-chunk for k = 32), with k steps between two checks."""
    monkeypatch.setattr(tseg, "CHECK_EVERY", check_every)
    allowed = rng.uniform(size=(45, 57)) < 0.7
    seed = np.zeros_like(allowed)
    seed[22, 28] = seed[3, 50] = True
    ref = np.asarray(jseg.flood_fill(jnp.asarray(seed), jnp.asarray(allowed),
                                     max_iters=max_iters))
    tseg.flood_fill.readbacks = 0
    got = tseg.flood_fill(T(seed), T(allowed), max_iters=max_iters).numpy()
    assert np.array_equal(got, ref)
    assert tseg.flood_fill.readbacks <= -(-max_iters // check_every)


@pytest.mark.parametrize("check_every", [1, 32])
def test_region_growing_matches_reference(monkeypatch, rng, check_every):
    monkeypatch.setattr(tseg, "CHECK_EVERY", check_every)
    yy, xx = np.mgrid[:50, :70]
    g = (100 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
         + rng.integers(-5, 6, (50, 70))).astype(np.float32)
    for seed, dif in (((1, 1), 30.0), ((35, 20), 51.0)):
        ref = np.asarray(jseg.region_growing(jnp.asarray(g), seed, dif, iters=70))
        got = tseg.region_growing(T(g), seed, dif, iters=70).numpy()
        assert np.array_equal(got, ref) and 0 < got.sum() < got.size


def test_segment_frame_finds_foreground(rng):
    """tests/test_pipeline_satellites.py's case."""
    H, W = 64, 80
    bg = rng.uniform(80, 120, (H, W, 3)).astype(np.float32)
    img = bg.copy()
    img[20:44, 30:54] = rng.uniform(180, 250, (24, 24, 3))
    mask = tseg.segment_frame(img, bg, threshold=0.4, device="cpu")
    assert (mask[26:38, 36:48] > 0).mean() > 0.8
    assert (mask[:, :20] > 0).mean() < 0.1


@pytest.mark.parametrize("size", [(64, 80), (240, 320)])
@pytest.mark.parametrize("integer", [True, False])
def test_segment_frame_matches_reference(monkeypatch, rng, size, integer):
    img, bg = _frame(rng, *size, integer=integer)
    ref = jseg.segment_frame(img, bg, 0.4)
    for k in (1, 32):
        monkeypatch.setattr(tseg, "CHECK_EVERY", k)
        got = tseg.segment_frame(img, bg, 0.4, device="cpu")
        assert got.dtype == ref.dtype and np.array_equal(got, ref), k
    assert 0.05 < (ref > 0).mean() < 0.5


def test_cut_image_dir_matches_reference(tmp_path, rng):
    indir = tmp_path / "in"
    indir.mkdir()
    for cam in (0, 3):
        for take in (1, 2):
            img, _ = _frame(rng, 48, 64)
            jimages.imwrite(str(indir / f"{take:04d}_Cam{cam}.jpg"), img)
    (indir / "notes.txt").write_text("not an image")
    jseg.cut_image_dir(str(indir), str(tmp_path / "ref"))
    tseg.cut_image_dir(str(indir), str(tmp_path / "port"), device="cpu")
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for name in names:
        ref = jimages.imread(str(tmp_path / "ref" / name), grayscale=True)
        got = timages.imread(str(tmp_path / "port" / name), grayscale=True)
        assert np.array_equal(got, ref), name


# -------------------------------------------------------- mesh simplification


def _sphere():
    from reconstruction_tpu_torch.surface.marching import marching_tetrahedra
    R = 32
    g = np.arange(R) - (R - 1) / 2
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    sdf = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 10.0
    return marching_tetrahedra(sdf, 0.0)


def test_decimate_mesh():
    v, f = _sphere()
    v2, f2 = tsimplify.decimate_mesh(v, f, target_faces=len(f) // 4)
    assert len(f2) <= len(f) // 4
    c = np.array([15.5] * 3)
    assert abs(np.median(np.linalg.norm(v2 - c, axis=1)) - 10.0) < 1.0
    r2, rf2 = jsimplify.decimate_mesh(v, f, target_faces=len(f) // 4)
    assert np.array_equal(v2, r2) and np.array_equal(f2, rf2)


def test_loop_subdivide():
    v, f = _sphere()
    v2, f2 = tsimplify.loop_subdivide(v, f, 1)
    assert len(f2) == 4 * len(f)
    r = np.linalg.norm(v2 - np.array([15.5] * 3), axis=1)
    assert r.std() < 0.5 and abs(np.median(r) - 10.0) < 0.5
    r2, rf2 = jsimplify.loop_subdivide(v, f, 1)
    assert np.array_equal(v2, r2) and np.array_equal(f2, rf2)


# --------------------------------------------------------------- watchdog


def test_watchdog_deadline():
    assert run_with_deadline(lambda: 42, 5.0) == 42
    with pytest.raises(StageTimeout):
        run_with_deadline(lambda: time.sleep(3), 0.3, "sleepy")
    with pytest.raises(ZeroDivisionError):
        run_with_deadline(lambda: 1 / 0, 5.0)


@pytest.mark.parametrize("wrap", [np.asarray, torch.as_tensor])
def test_check_finite(wrap):
    check_finite("stage", wrap(np.array([1.0, 2.0])), wrap(np.array([1, 2])))
    with pytest.raises(FloatingPointError, match="stage: output 1 has 2 non-finite"):
        check_finite("stage", wrap(np.array([1.0])), wrap(np.array([np.nan, np.inf, 0.0])))


# ---------------------------------------------------------------- metrics


def test_point_to_mesh_distance():
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    pts = np.array([[0.5, 0.5, 0.3], [0.5, 0.5, 0.0], [2.0, 0.5, 0.0],
                    [-1.0, -1.0, 0.0], [0.5, 0.5, -0.25]], np.float32)
    d = tmetrics.point_to_mesh_distance(pts, verts, faces, device="cpu")
    np.testing.assert_allclose(d, [0.3, 0.0, 1.0, np.sqrt(2), 0.25], atol=1e-5)
    assert tmetrics.point_to_mesh_rmse(pts, verts, faces, device="cpu") > 0
    a = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    assert tmetrics.chamfer_distance(a, a, device="cpu") < 1e-6


def test_metrics_match_reference(rng):
    """Every Ericson region (points around a random mesh, chunks smaller
    than the inputs) and the chamfer distance, within 1e-6."""
    v, f = _sphere()
    v = (v - 15.5) / 10.0
    f = f[rng.permutation(len(f))[:700]]
    pts = rng.normal(size=(300, 3)).astype(np.float32) * 0.8
    ref = jmetrics.point_to_mesh_distance(pts, v, f, point_chunk=128, tri_chunk=256)
    got = tmetrics.point_to_mesh_distance(pts, v, f, point_chunk=128, tri_chunk=256,
                                          device="cpu")
    assert np.abs(ref - got).max() <= 1e-6
    b = rng.normal(size=(150, 3)).astype(np.float32)
    assert abs(jmetrics.chamfer_distance(pts, b, chunk=64)
               - tmetrics.chamfer_distance(pts, b, chunk=64, device="cpu")) <= 1e-6


# -------------------------------------------------------------- profiling


def test_profiling_peaks_and_utilization():
    p = tprofiling.CHIP_PEAKS["h100"]
    assert p == {"hbm_gbps": 3.35e12, "flops_f32": 67e12, "int8_ops": 1979e12}
    c = tprofiling.KernelCost(flops=3.0e9, hbm_bytes=2.0e9)
    u = c.utilization(c.hbm_bytes / p["hbm_gbps"] * 2.0)
    assert u["hbm_util"] == pytest.approx(0.5) and u["bound"] == "hbm"
    assert u["flops_util"] == pytest.approx(c.flops / (c.hbm_bytes / p["hbm_gbps"] * 2.0)
                                            / p["flops_f32"])
    key, kind = tprofiling.resolve_chip("cpu")
    assert key == "h100" and "not a GPU" in kind


@pytest.mark.parametrize("flops, nbytes, seconds", [
    (1.0e9, 4.0e9, 2e-3),       # bytes set the bound
    (9.0e11, 1.0e8, 2e-2),      # operations set it
    (2.0e10, 1.0e9, 1e-3),      # the two within 1%
    (0.0, 1.0, 1e-6),           # no operations
])
def test_utilization_matches_reference(monkeypatch, flops, nbytes, seconds):
    """The reference's formula (its matmul-unit case) at this card's peaks."""
    monkeypatch.setitem(jprofiling.CHIP_PEAKS, "h100", tprofiling.CHIP_PEAKS["h100"])
    ref = jprofiling.KernelCost(flops, nbytes, "mxu").utilization(seconds, "h100")
    got = tprofiling.KernelCost(flops, nbytes).utilization(seconds)
    assert {k: v for k, v in got.items() if k != "bound"} == {
        k: v for k, v in ref.items() if k != "bound"}
    assert got["bound"] == {"hbm": "hbm", "mxu": "flops"}[ref["bound"]]


def test_trace_writes_a_chrome_trace(tmp_path):
    """The trace holds the program's spans on their own track, on the time
    base of the profiler's rows: a span holds the operator run inside it."""
    from reconstruction_tpu_torch.utils.timing import span
    path = str(tmp_path / "trace.json")
    with tprofiling.trace(path):
        with span("probe_span"):
            torch.ones(8).sum()
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mine, = [e for e in events if e.get("name") == "probe_span"]
    assert mine["pid"] == "program spans" and mine["ph"] == "X"
    ops = [e for e in events if e.get("name") == "aten::sum"]
    assert ops and all(mine["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= mine["ts"] + mine["dur"]
                       for e in ops)
