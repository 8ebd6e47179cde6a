"""Port vs reference: the bundle adjustment slice (window descriptors, the
coupling contraction K4's plain version, Jacobians, block assembly, the LM
loop, Harris features, descriptors, tracks and the pose graph), on the
same seeded numpy inputs.  Each tolerance is stated where it is used."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from synthetic import make_stereo_scene, surface_fn
from test_ba import _make_ba_problem
from torch_parity import J, T, assert_equal, to_np

from reconstruction_tpu.ba import features as jf
from reconstruction_tpu.ba import pose_graph as jpg
from reconstruction_tpu.ba import tracks as jt
from reconstruction_tpu.ops.ba_coupling_pallas import ba_coupling_pallas
from reconstruction_tpu.stereo.ncc import window_descriptors as j_window_descriptors
from reconstruction_tpu_torch.ba import features as tf
from reconstruction_tpu_torch.ba import pose_graph as tpg
from reconstruction_tpu_torch.ba import tracks as tt
from reconstruction_tpu_torch.ops.ba_coupling import ba_coupling, ba_coupling_plain
from reconstruction_tpu_torch.stereo.ncc import row_score_matrix, window_descriptors
from reconstruction_tpu_torch.utils.convert import from_jax_state

# `ba/__init__` re-exports the function `bundle_adjust`, which shadows the
# submodule of the same name as a package attribute.
jb = importlib.import_module("reconstruction_tpu.ba.bundle_adjust")
tb = importlib.import_module("reconstruction_tpu_torch.ba.bundle_adjust")


def _port_problem(prob):
    return from_jax_state(prob)


def _rel(ref, got):
    ref, got = to_np(ref), to_np(got)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


# --------------------------------------------------------------------------
# window descriptors (the features' descriptor map)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,radius", [((20, 24, 3), 2), ((18, 22), 4)])
def test_window_descriptors_match(shape, radius):
    """Within 1e-6 absolute: XLA:CPU sums the mean and the norm in its own
    order, a last-bit difference on unit-norm descriptors."""
    img = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    img[:4, :4] = 7.0                 # flat windows: norm 0 -> 1
    dj, nj = j_window_descriptors(J(img), radius)
    dt, nt = window_descriptors(T(img), radius)
    assert dt.shape == dj.shape
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(nt), np.asarray(nj), rtol=1e-6, atol=1e-4)
    # the score matrix is the plain product of normalized descriptors
    S = row_score_matrix(dt, dt)
    np.testing.assert_allclose(to_np(S), np.einsum("hwk,hvk->hwv", to_np(dt),
                                                    to_np(dt)), atol=1e-5)


# --------------------------------------------------------------------------
# K4 plain version (the CPU path of the coupling contraction)
# --------------------------------------------------------------------------

def test_ba_coupling_plain_matches_pallas_and_reduce():
    """Bit-equal to the Pallas kernel in interpret mode (the same serial
    o-sum); within 1e-5 of the XLA reduce (f32 reassociation), as in
    tests/test_ops_pallas.py:216, with -1 padding and M not a tile multiple."""
    rng = np.random.default_rng(0)
    E, O, M, C = 18, 8, 700, 16
    He = rng.normal(size=(E, O, M)).astype(np.float32)
    cam = rng.integers(0, C, (O, M)).astype(np.int32)
    cam[:, -5:] = -1
    ref = np.asarray(ba_coupling_pallas(J(He), J(cam), C, interpret=True))
    n0 = ba_coupling.launches
    got = to_np(ba_coupling(T(He), T(cam), C))
    assert ba_coupling.launches == n0        # the CPU path launches nothing
    assert got.dtype == np.float32
    assert_equal(ref, got, "W_t vs Pallas (interpret)")
    oh = (cam[None] == np.arange(C)[:, None, None]).astype(np.float32)
    np.testing.assert_allclose(got, np.einsum("eom,com->ecm", He, oh),
                               rtol=1e-5, atol=1e-5)
    assert np.all(got[:, :, -5:] == 0.0)
    # float64 stays float64 on the CPU (the poses' dtype in ba_blocks)
    assert ba_coupling_plain(T(He).double(), T(cam), C).dtype == torch.float64


# --------------------------------------------------------------------------
# Jacobians and block assembly
# --------------------------------------------------------------------------

def test_analytic_jacobians_match_jacfwd_and_reference():
    """Closed-form Jacobians against torch.func.jacfwd of the same smoothed
    primal (2e-4 after scaling by the largest entry, as the reference's
    tests/test_ba.py:57) and against the reference's closed forms (1e-5
    scaled: both are the same float32 formula, summed in other orders)."""
    rng = np.random.default_rng(0)
    K = np.array([[800.0, 0, 320], [0, 820, 240], [0, 0, 1]], np.float32)
    for trial in range(10):
        Rt = np.hstack([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                        rng.normal(size=(3, 1))]).astype(np.float32)
        pose = (rng.normal(scale=0.3, size=6).astype(np.float32)
                if trial % 2 else np.zeros(6, np.float32))
        X = rng.normal(size=3).astype(np.float32)
        X[2] += 6.0
        uv = rng.uniform(0, 600, 2).astype(np.float32)
        a_np = (K, Rt, pose, X, uv)
        targs = [T(a) for a in a_np]
        r, Jc, Jp = tb._obs_jacobians(*targs)
        np.testing.assert_allclose(to_np(r), to_np(tb._residual(*targs)),
                                   rtol=1e-5, atol=1e-5)
        ref_c = to_np(tb._jac_pose(*targs))
        ref_p = to_np(tb._jac_point(*targs))
        sc = max(1.0, np.abs(ref_c).max())
        sp = max(1.0, np.abs(ref_p).max())
        np.testing.assert_allclose(to_np(Jc) / sc, ref_c / sc, atol=2e-4)
        np.testing.assert_allclose(to_np(Jp) / sp, ref_p / sp, atol=2e-4)
        rj, Jcj, Jpj = jb._obs_jacobians(*[J(a) for a in a_np])
        np.testing.assert_allclose(to_np(r), np.asarray(rj), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(to_np(Jc) / sc, np.asarray(Jcj) / sc, atol=1e-5)
        np.testing.assert_allclose(to_np(Jp) / sp, np.asarray(Jpj) / sp, atol=1e-5)


def test_ba_blocks_match_reference():
    """Every output of the block assembly within 1e-4 of its largest
    magnitude (float32 sums in other orders, the inverse's refinements)."""
    rng = np.random.default_rng(0)
    prob, _, _ = _make_ba_problem(rng)
    C = prob.K.shape[0]
    poses = rng.normal(scale=0.01, size=(C, 6)).astype(np.float32)
    pts = np.asarray(prob.points0)
    ref = jb.ba_blocks(prob, J(poses), J(pts), C)
    got = tb.ba_blocks(_port_problem(prob), T(poses), T(pts), C)
    for name, a, b in zip(("S", "b", "hpp", "b_p", "W_t", "cost"), ref, got):
        if isinstance(a, tuple):
            a, b = np.stack([np.asarray(x) for x in a]), torch.stack(list(b))
        assert tuple(b.shape) == np.shape(a), name
        assert _rel(a, b) < 1e-4, (name, _rel(a, b))


def test_small_inverses_match_reference():
    """Batched 3x3 inverses (adjugate plus two Newton steps) of SPD point
    blocks, full and in symmetric components, and the 3x3 solve: within
    1e-5 relative of the reference (float32, other summation orders)."""
    rng = np.random.default_rng(2)
    B = rng.normal(size=(50, 3, 3)).astype(np.float32)
    A = (B @ B.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32))
    b = rng.normal(size=(50, 3)).astype(np.float32)
    assert _rel(jb._inv3x3(J(A)), tb._inv3x3(T(A))) < 1e-5
    assert _rel(jb._solve3x3(J(A), J(b)), tb._solve3x3(T(A), T(b))) < 1e-5
    comps = [A[:, i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
    ref = np.stack([np.asarray(x) for x in jb._sym3_inv_comps([J(c) for c in comps])])
    got = torch.stack(tb._sym3_inv_comps([T(c) for c in comps]))
    assert _rel(ref, got) < 1e-5
    assert _rel(ref.reshape(3, 3, -1).transpose(2, 0, 1), tb._inv3x3(T(A))) < 1e-5


def _accepted(costs, rtol=1e-5):
    """Accepted LM steps that lowered the cost by more than ``rtol``: once
    converged, a step moves a float32 sum of hundreds of terms by its last
    bits, and whether that counts as lower is noise in either package."""
    c = np.asarray(costs, np.float64)
    return int((c[1:] < c[:-1] * (1.0 - rtol)).sum())


def test_bundle_adjust_structure_only_tracks_reference():
    """With the cameras fixed the problem is well conditioned: the same
    number of iterations and of accepted steps (above float32 noise, see
    `_accepted`), and costs within 1e-3 relative (seen: 1e-6)."""
    prob, _, _ = _make_ba_problem(np.random.default_rng(0))
    _, xj, cj = jb.bundle_adjust(prob, iterations=10, fix_cameras=True)
    _, xt, ct = tb.bundle_adjust(_port_problem(prob), iterations=10,
                                 fix_cameras=True)
    cj, ct = np.asarray(cj), to_np(ct)
    assert len(cj) == len(ct) and _accepted(cj) == _accepted(ct)
    np.testing.assert_allclose(ct, cj, rtol=1e-3)
    np.testing.assert_allclose(to_np(xt), np.asarray(xj), atol=1e-4)


def test_bundle_adjust_free_cameras_recovers_geometry():
    """The reference's 4-camera, 60-point problem with free cameras.

    Its reduced camera system has a near-null direction (scale about
    camera 0: eigenvalue ~1e-4 against ~5e6), so float32 rounding at the
    1e-7 level moves the first step along it: the reference, the port and
    the port in float64 reach costs 0.323, 0.308 and 0.293 after one
    step, and the trajectories part from there.  The port is held to the
    same start (initial cost within 1e-6 relative) and to the reference's
    own criteria (tests/test_ba.py:89-124)."""
    rng = np.random.default_rng(0)
    prob, Rt_true, pts_true = _make_ba_problem(rng, pixel_noise=0.0)
    tprob = _port_problem(prob)
    C = prob.K.shape[0]
    zero = np.zeros((C, 6), np.float32)
    c0j = float(jb.ba_cost(prob, J(zero), prob.points0, C))
    c0t = float(tb.ba_cost(tprob, T(zero), tprob.points0, C))
    assert abs(c0t - c0j) <= 1e-6 * c0j

    poses, points, costs = tb.bundle_adjust(tprob, iterations=10)
    costs = to_np(costs)
    assert abs(costs[0] - c0t) == 0
    assert costs[-1] < costs[0] * 1e-3 and costs[-1] < 1.0, costs
    R0, t0 = Rt_true[0][:, :3], Rt_true[0][:, 3]
    C0 = -R0.T @ t0
    est = to_np(points) - C0
    ref = pts_true - C0
    s = float((est * ref).sum() / np.maximum((est * est).sum(), 1e-12))
    err = np.linalg.norm(C0 + s * est - pts_true, axis=1)
    assert np.median(err) < 5e-3, (np.median(err), s)
    assert abs(s - 1.0) < 0.25, s
    Rt2 = tb.apply_pose(tprob.Rt0[2], poses[2])
    R2, t2 = Rt2[:, :3], Rt2[:, 3]
    assert np.abs(R2 - Rt_true[2][:, :3]).max() < 5e-3
    C2_aligned = C0 + s * (-R2.T @ t2 - C0)
    C2_true = -Rt_true[2][:, :3].T @ Rt_true[2][:, 3]
    assert np.abs(C2_aligned - C2_true).max() < 5e-3
    # apply_pose is the reference's composition
    np.testing.assert_allclose(Rt2, jb.apply_pose(np.asarray(prob.Rt0[2]),
                                                  to_np(poses[2])), atol=1e-12)


@pytest.mark.parametrize("bad", [-1, 4])
def test_bundle_adjust_rejects_camera_ids_out_of_range(bad):
    """A camera id outside [0, C) raises before the first step: the
    reference's one-hot gave it zero parameters (a NaN cost), an index
    gather would wrap -1 to camera C-1."""
    prob, _, _ = _make_ba_problem(np.random.default_rng(0))
    tprob = _port_problem(prob)
    assert tprob.K.shape[0] == 4
    cam = tprob.obs_cam.clone()
    cam[3, 1] = bad
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        tb.bundle_adjust(tprob._replace(obs_cam=cam), iterations=2)
    tb.bundle_adjust(tprob, iterations=1)


# --------------------------------------------------------------------------
# features, descriptors, tracks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def views():
    """The 3-view 160x120 scene of tests/test_ba.py:140 (numpy renders)."""
    cams, imgs, masks = make_stereo_scene(image_size=(160, 120), span_deg=10.0,
                                          num_cameras=3)
    grays = [img.mean(-1) for img in imgs]
    valids = [m > 200 for m in masks]
    return cams, grays, valids


def test_harris_corners_match(views):
    """The same keypoints (positions and validity, in the same order);
    responses within 1e-5 relative (float32 blur sums)."""
    _, grays, valids = views
    for g, v in zip(grays, valids):
        fj = jf.harris_corners(J(g), J(v), max_features=256)
        ft = tf.harris_corners(T(g), T(v), max_features=256)
        assert_equal(fj.ok, ft.ok, "ok")
        assert_equal(fj.xy, ft.xy, "xy")
        ok = np.asarray(fj.ok)
        assert ok.sum() > 50
        np.testing.assert_allclose(to_np(ft.score)[ok], np.asarray(fj.score)[ok],
                                   rtol=1e-5)
    # fixed capacity larger than the number of cells pads with ok = False
    img = np.random.default_rng(1).uniform(0, 255, (32, 40)).astype(np.float32)
    fj = jf.harris_corners(J(img), J(np.ones((32, 40), bool)), max_features=32)
    ft = tf.harris_corners(T(img), T(np.ones((32, 40), bool)), max_features=32)
    assert_equal(fj.xy, ft.xy, "padded xy")
    assert_equal(fj.ok, ft.ok, "padded ok")


def test_tracks_and_ba_from_features_match(views):
    """Descriptors within 1e-5, the same matches and tracks (observations
    bit-equal, midpoint points within 1e-5), structure-only BA costs within
    1e-3 relative, and test_tracks_and_ba_from_features' criteria."""
    cams, grays, valids = views
    fj, dj, ft, dt = [], [], [], []
    for g, v in zip(grays, valids):
        f = jf.harris_corners(J(g), J(v), max_features=256)
        fj.append(f)
        dj.append(jf.describe(J(g), f, radius=4))
        f2 = tf.harris_corners(T(g), T(v), max_features=256)
        ft.append(f2)
        dt.append(tf.describe(T(g), f2, radius=4))
        np.testing.assert_allclose(to_np(dt[-1]), np.asarray(dj[-1]), atol=1e-5)
    m_j = jt.match_descriptors(dj[0], fj[0].ok, dj[1], fj[1].ok, 0.7)
    m_t = tt.match_descriptors(dt[0], ft[0].ok, dt[1], ft[1].ok, 0.7)
    assert_equal(np.asarray(m_j).astype(np.int64), m_t, "matches")

    K = [np.asarray(c.K, np.float64) for c in cams]
    Rt = [np.asarray(c.Rt, np.float64) for c in cams]
    pairs = [(0, 1), (1, 2), (0, 2)]
    pj = jt.build_tracks(fj, dj, K, Rt, pairs=pairs, threshold=0.7)
    pt = tt.build_tracks(ft, dt, K, Rt, pairs=pairs, threshold=0.7)
    assert pt.points0.shape[0] > 20, pt.points0.shape
    for name in ("K", "Rt0", "obs_uv", "obs_cam", "obs_ok"):
        assert_equal(getattr(pj, name), getattr(pt, name), name)
    np.testing.assert_allclose(to_np(pt.points0), np.asarray(pj.points0),
                               atol=1e-5)

    _, xj, cj = jb.bundle_adjust(pj, iterations=6, fix_cameras=True)
    _, xt, ct = tb.bundle_adjust(pt, iterations=6, fix_cameras=True)
    ct = to_np(ct)
    np.testing.assert_allclose(ct, np.asarray(cj), rtol=1e-3)
    assert ct[-1] <= ct[0]
    p = to_np(xt)
    sel = (np.abs(p[:, 0]) < 1.5) & (np.abs(p[:, 1]) < 1.5)
    dz = p[sel][:, 2] - surface_fn(p[sel][:, 0], p[sel][:, 1])
    assert np.median(np.abs(dz)) < 0.1


def test_state_carried_across_gives_the_same_results(views):
    """A JAX BAProblem and JAX Features carried across by from_jax_state:
    the port's ba_cost within 1e-6 relative of the reference's, and its
    describe at the carried keypoints within 1e-5."""
    prob, _, _ = _make_ba_problem(np.random.default_rng(4))
    tprob = from_jax_state(prob)
    assert isinstance(tprob, tb.BAProblem)
    assert tprob.obs_cam.dtype == torch.int32 and tprob.obs_ok.dtype == torch.bool
    C = prob.K.shape[0]
    poses = np.random.default_rng(5).normal(scale=0.01, size=(C, 6)).astype(np.float32)
    cj = float(jb.ba_cost(prob, J(poses), prob.points0, C))
    ct = float(tb.ba_cost(tprob, T(poses), tprob.points0, C))
    assert abs(ct - cj) <= 1e-6 * cj

    _, grays, valids = views
    fj = jf.harris_corners(J(grays[0]), J(valids[0]), max_features=128)
    fcarried = from_jax_state(fj)
    assert isinstance(fcarried, tf.Features) and fcarried.ok.dtype == torch.bool
    np.testing.assert_allclose(to_np(tf.describe(T(grays[0]), fcarried, radius=3)),
                               np.asarray(jf.describe(J(grays[0]), fj, radius=3)),
                               atol=1e-5)


# --------------------------------------------------------------------------
# pose graph
# --------------------------------------------------------------------------

def test_pose_graph_chain_matches_reference():
    """tests/test_ba.py:175's chain of noisy odometry plus a loop closure:
    the reference's criteria, poses within 1e-4 of the reference's, and
    the first two costs within 1e-3 relative (later ones, ~5e-9, are
    residuals of ~1e-5 that float32 rounding of the 4x4 inverses moves by
    a few parts in 1e3)."""
    rng = np.random.default_rng(0)
    N = 8
    T_true = [np.eye(4)]
    for i in range(1, N):
        xi = np.concatenate([rng.normal(scale=0.1, size=3),
                             rng.normal(scale=0.5, size=3)])
        T_true.append(np.asarray(jpg._exp_se3(jnp.asarray(xi))) @ T_true[-1])
    T_true = np.stack(T_true)
    edges, Z = [], []
    for i in range(N - 1):
        edges.append([i, i + 1])
        Z.append(np.linalg.inv(T_true[i]) @ T_true[i + 1])
    edges.append([0, N - 1])
    Z.append(np.linalg.inv(T_true[0]) @ T_true[N - 1])
    edges = np.asarray(edges, np.int32)
    Z = np.stack(Z).astype(np.float32)
    T_init = T_true.copy()
    for i in range(1, N):
        xi = np.concatenate([rng.normal(scale=0.05, size=3),
                             rng.normal(scale=0.1, size=3)])
        T_init[i] = np.asarray(jpg._exp_se3(jnp.asarray(xi))) @ T_init[i]
    T_init = T_init.astype(np.float32)

    # the exponential map itself
    xi = rng.normal(scale=0.3, size=6).astype(np.float32)
    np.testing.assert_allclose(to_np(tpg._exp_se3(T(xi))),
                               np.asarray(jpg._exp_se3(J(xi))), atol=1e-6)

    Tj, cj = jpg.pose_graph_optimize(J(edges), J(Z), J(T_init), N, iterations=10)
    Tt, ct = tpg.pose_graph_optimize(T(edges), T(Z), T(T_init), N, iterations=10)
    ct = to_np(ct)
    assert ct[-1] < ct[0] * 1e-4
    assert np.abs(to_np(Tt) - T_true).max() < 1e-3
    np.testing.assert_allclose(to_np(Tt), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(ct[:2], np.asarray(cj)[:2], rtol=1e-3)
