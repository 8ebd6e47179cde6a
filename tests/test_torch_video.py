"""Port vs reference: the video driver (`pipeline/video.py`), on the CPU.

The three cases of tests/test_video.py on the port; the frame-to-frame
pose estimate against the reference's on two rendered frames of an
orbiting rig; and a two-frame `reconstruct_video` at the tiny preset
through both packages (rig poses within 1e-4, meshes within
`tests/test_torch_reconstruct.py`'s tolerances).
"""

import importlib

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import torch_parity  # noqa: F401  (few intra-op threads a worker)
from synthetic import make_stereo_scene, render_view, surface_fn, synthetic_rig

from reconstruction_tpu.config import preset as jpreset
from reconstruction_tpu.pipeline.reconstruct import PairInput as JPairInput
from reconstruction_tpu_torch.ba.pose_graph import pose_graph_optimize
from reconstruction_tpu_torch.config import preset
from reconstruction_tpu_torch.pipeline import video as tvideo
from reconstruction_tpu_torch.pipeline.reconstruct import PairInput

jvideo = importlib.import_module("reconstruction_tpu.pipeline.video")

SIZE = (160, 120)


def test_video_driver_chains_frames():
    cfg = preset("tiny")
    cams, imgs, masks = make_stereo_scene(image_size=SIZE, span_deg=8.0, num_cameras=2)

    def loader(i):
        return [PairInput(image0=imgs[0], image1=imgs[1], mask0=masks[0], mask1=masks[1],
                          K0=np.asarray(cams[0].K), Rt0=np.asarray(cams[0].Rt),
                          K1=np.asarray(cams[1].K), Rt1=np.asarray(cams[1].Rt))]

    class FakeRecon:
        vertices = np.zeros((10, 3))
        faces = np.zeros((4, 3), np.int32)

    calls = []

    def fake_reconstruct(cfg, pairs):
        calls.append(len(pairs))
        return FakeRecon()

    results = tvideo.reconstruct_video(cfg, loader, 3, reconstruct_frame=fake_reconstruct,
                                       depth_hint=8.0, device="cpu")
    assert len(results) == 3
    assert calls == [1, 1, 1]
    # static scene => optimized rig poses stay near identity
    for r in results:
        np.testing.assert_allclose(r.rig_pose[:3, :3], np.eye(3), atol=0.05)
        assert np.linalg.norm(r.rig_pose[:3, 3]) < 0.5


def _tr(x, y, z):
    T = np.eye(4)
    T[:3, 3] = (x, y, z)
    return T


STEPS = [(1, 0), (1, 0), (0, 1), (0, 1), (-1, 0), (-1, 0), (0, -1), (0, -1)]


def test_pose_graph_loop_closure_snaps_back():
    """A square loop whose biased odometry drifts snaps back when the exact
    closure edge is added: end-pose error drops by well over 5x."""
    T_true = [np.eye(4)]
    for dx, dy in STEPS:
        T_true.append(T_true[-1] @ _tr(dx, dy, 0))
    N = len(T_true)
    edges, Z, T_init = [], [], [np.eye(4)]
    for i in range(N - 1):
        edges.append([i, i + 1])
        Zi = np.linalg.inv(T_true[i]) @ T_true[i + 1] @ _tr(0.05, 0, 0)
        Z.append(Zi)
        T_init.append(T_init[-1] @ Zi)

    def end_err(T_opt):
        return float(np.linalg.norm(T_opt[-1][:3, 3] - T_true[-1][:3, 3]))

    def run(edges, Z):
        T_opt, _ = pose_graph_optimize(
            torch.as_tensor(np.asarray(edges, np.int32)),
            torch.as_tensor(np.stack(Z).astype(np.float32)),
            torch.as_tensor(np.stack(T_init).astype(np.float32)), N, iterations=15)
        return T_opt.numpy()

    err_chain = end_err(np.stack(T_init))
    assert err_chain > 0.3
    err_no_closure = end_err(run(edges, Z))
    err_with = end_err(run(edges + [[0, N - 1]],
                           Z + [np.linalg.inv(T_true[0]) @ T_true[-1]]))
    assert err_no_closure > 0.9 * err_chain
    assert err_with * 5 < err_no_closure, (err_with, err_no_closure)


def test_video_loop_closure_corrects_drift(monkeypatch):
    """The driver's closure edges are measured between the two frames, not
    derived from the drifted chain: with a biased per-step estimator and an
    exact direct measurement, the end pose snaps back over 5x."""
    T_true = [np.eye(4)]
    for dx, dy in STEPS:
        T_true.append(_tr(dx, dy, 0) @ T_true[-1])
    N = len(T_true)

    def fake_estimate(prev_gray, cur_gray, K, Rt, depth_hint, device=None):
        i = int(round(float(prev_gray.flat[0])))
        j = int(round(float(cur_gray.flat[0])))
        M = T_true[j] @ np.linalg.inv(T_true[i])
        return _tr(0.05, 0, 0) @ M if abs(j - i) == 1 else M

    monkeypatch.setattr(tvideo, "_estimate_relative_pose", fake_estimate)
    K = np.eye(3)
    Rt = np.hstack([np.eye(3), np.zeros((3, 1))])

    def loader(i):
        img = np.full((4, 4, 3), float(i), np.float32)
        return [PairInput(image0=img, image1=img, mask0=img[..., 0], mask1=img[..., 0],
                          K0=K, Rt0=Rt, K1=K, Rt1=Rt)]

    class FakeRecon:
        vertices = np.zeros((3, 3))
        faces = np.zeros((1, 3), np.int32)

    def end_err(stride):
        res = tvideo.reconstruct_video(preset("tiny"), loader, N,
                                       reconstruct_frame=lambda c, p: FakeRecon(),
                                       loop_closure_stride=stride, device="cpu")
        return float(np.linalg.norm(res[-1].rig_pose[:3, 3] - T_true[-1][:3, 3]))

    e0, e1 = end_err(0), end_err(N - 1)
    assert e0 > 0.3, e0
    assert e1 * 5 < e0, (e1, e0)


def orbit_frames(num_frames, size=SIZE, step_deg=1.5, num_cameras=2):
    """tools/demo_video.py's rig: frame f rotates the rig by f * step_deg
    about the scene's z axis, every view rendered anew."""
    W, H = size
    rig0 = synthetic_rig(num_cameras=num_cameras, radius=8.0, span_deg=24.0,
                         focal=W * 1.6, image_size=(W, H))
    frames = []
    for f in range(num_frames):
        a = np.radians(f * step_deg)
        Rw = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                       [0.0, 0.0, 1.0]])
        cams = []
        for c in rig0:
            Rt = np.asarray(c.Rt)
            cams.append(type(c)(K=c.K, Rt=np.concatenate([Rt[:, :3] @ Rw.T, Rt[:, 3:]], 1)))
        views = [render_view(c, (W, H)) for c in cams]
        frames.append((cams, [v[0] for v in views], [v[1] for v in views]))
    return frames


@pytest.fixture(scope="module")
def frames():
    return orbit_frames(2)


def test_relative_pose_matches_reference(frames, monkeypatch):
    """Two rendered frames of the orbiting rig: the same mutual matches and
    the same rigid fit within 1e-4."""
    counts = {}
    for key, mod in (("ref", jvideo), ("port", tvideo)):
        real = mod.match_descriptors

        def count(*a, _real=real, _key=key):
            m = _real(*a)
            counts[_key] = int((np.asarray(m.cpu() if torch.is_tensor(m) else m) >= 0).sum())
            return m
        monkeypatch.setattr(mod, "match_descriptors", count)
    (cams0, imgs0, _), (_, imgs1, _) = frames
    K, Rt = np.asarray(cams0[0].K), np.asarray(cams0[0].Rt)
    a, b = imgs0[0].mean(-1), imgs1[0].mean(-1)
    ref = jvideo._estimate_relative_pose(a, b, K, Rt, 8.0)
    got = tvideo._estimate_relative_pose(a, b, K, Rt, 8.0, device="cpu")
    assert counts["port"] == counts["ref"] >= 20, counts
    assert np.abs(got - ref).max() <= 1e-4, np.abs(got - ref).max()
    assert not np.allclose(got, np.eye(4), atol=1e-3)    # the rig did move


def _rmse(v):
    sel = (np.abs(v[:, 0]) < 1.3) & (np.abs(v[:, 1]) < 1.3)
    assert sel.sum() > 300
    dz = v[sel][:, 2] - surface_fn(v[sel][:, 0], v[sel][:, 1])
    return float(np.sqrt((dz ** 2).mean()))


def test_reconstruct_video_matches_reference(frames):
    """Two frames, one pair each, at the tiny preset through both packages:
    rig poses within 1e-4; each frame's mesh within
    `tests/test_torch_reconstruct.py`'s tolerances (vertex count 5%, interior RMSE 10%, mean distance to the
    nearest reference vertex a quarter voxel)."""

    def loader(cls):
        return lambda i: [cls(image0=frames[i][1][0], image1=frames[i][1][1],
                              mask0=frames[i][2][0], mask1=frames[i][2][1],
                              K0=np.asarray(frames[i][0][0].K), Rt0=np.asarray(frames[i][0][0].Rt),
                              K1=np.asarray(frames[i][0][1].K), Rt1=np.asarray(frames[i][0][1].Rt))]

    ref = jvideo.reconstruct_video(jpreset("tiny"), loader(JPairInput), 2, depth_hint=8.0)
    cfg = preset("tiny")
    got = tvideo.reconstruct_video(cfg, loader(PairInput), 2, depth_hint=8.0, device="cpu")
    assert len(ref) == len(got) == 2
    for r, g in zip(ref, got):
        assert np.abs(r.rig_pose - g.rig_pose).max() <= 1e-4
        a, b = len(r.mesh_vertices), len(g.mesh_vertices)
        assert a > 1000 and abs(a - b) <= 0.05 * a, (a, b)
        ra, rb = _rmse(r.mesh_vertices), _rmse(g.mesh_vertices)
        assert abs(ra - rb) <= 0.1 * ra, (ra, rb)
        ext = float((r.mesh_vertices.max(0) - r.mesh_vertices.min(0)).max())
        spacing = ext * 1.2 / (cfg.surface.grid_resolution - 1)
        d, _ = cKDTree(r.mesh_vertices).query(g.mesh_vertices)
        assert d.mean() <= 0.25 * spacing, (d.mean(), spacing)
    assert not np.allclose(got[1].rig_pose, np.eye(4), atol=1e-3)
