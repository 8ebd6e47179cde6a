"""Port vs reference: the cloud stages (neighbor grids, SOR, radius filter,
normals, MLS, cross-view dedup, the native host path and the backend
rule), on the same seeded numpy inputs, both on the CPU.  Each tolerance
is stated where it is used; the measured margins are in CHANGES.md."""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import T, to_np

from reconstruction_tpu.cloud import dedup as jd
from reconstruction_tpu.cloud import filters as jf
from reconstruction_tpu.cloud import mls as jm
from reconstruction_tpu.cloud import neighbors as jn
from reconstruction_tpu.cloud import normals as jnm
from reconstruction_tpu_torch.cloud import dedup as td
from reconstruction_tpu_torch.cloud import filters as tf
from reconstruction_tpu_torch.cloud import mls as tm
from reconstruction_tpu_torch.cloud import neighbors as tn
from reconstruction_tpu_torch.cloud import normals as tnm

ROOT = Path(__file__).resolve().parent.parent


def _surface_cloud(rng, n=3000, noise=0.0):
    """Points on the paraboloid z = 0.1 (x^2 + y^2) (tests/test_cloud.py)."""
    xy = rng.uniform(-2, 2, size=(n, 2))
    z = 0.1 * (xy[:, 0] ** 2 + xy[:, 1] ** 2)
    return np.column_stack([xy, z + rng.normal(scale=noise, size=n)]).astype(np.float32)


def _with_outliers(rng, n=4000):
    pts = _surface_cloud(rng, n, noise=0.005)
    out = rng.uniform(-2, 2, size=(40, 3)).astype(np.float32)
    out[:, 2] += 5.0
    return np.vstack([pts, out])


# --------------------------------------------------------------- neighbors


def test_grid_geometry_equal(rng):
    pts = _with_outliers(rng)
    valid = rng.uniform(size=len(pts)) > 0.1
    np.testing.assert_array_equal(jn.robust_bbox(pts), tn.robust_bbox(pts))
    for cell, max_cells in ((0.05, 32_000_000), (0.01, 100_000)):
        a = jn.host_grid_geometry(pts, valid, cell, max_cells=max_cells)
        b = tn.host_grid_geometry(pts, valid, cell, max_cells=max_cells)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]


def _crowded(rng):
    """Many points a cell (a coarse cell over a dense slab), some invalid:
    which points of a full cell are candidates depends on a stable sort."""
    pts = rng.uniform(-1, 1, size=(6000, 3)).astype(np.float32)
    pts[:, 2] *= 0.05
    valid = rng.uniform(size=len(pts)) > 0.15
    origin, dims, cell = jn.host_grid_geometry(pts, valid, 0.2)
    return pts, valid, origin, dims, cell


def test_build_dense_grid_bit_equal(rng):
    pts, valid, origin, dims, cell = _crowded(rng)
    gj = jn.build_dense_grid(jnp.asarray(pts), jnp.asarray(valid), origin, cell, dims, pad=16)
    gt = tn.build_dense_grid(T(pts), T(valid), origin, cell, dims, pad=16)
    counts = np.diff(np.asarray(gj.starts))
    assert counts[:-2].max() > 16            # full cells: per_cell truncates
    for name in ("order", "starts", "sorted_pts"):
        np.testing.assert_array_equal(np.asarray(getattr(gj, name)),
                                      to_np(getattr(gt, name)), err_msg=name)


def _sets(cand, ok):
    return [frozenset(c[o].tolist()) for c, o in zip(cand, ok)]


def test_neighbor_map_dense_same_candidates(rng):
    pts, valid, origin, dims, cell = _crowded(rng)
    gj = jn.build_dense_grid(jnp.asarray(pts), jnp.asarray(valid), origin, cell, dims, pad=16)
    gt = tn.build_dense_grid(T(pts), T(valid), origin, cell, dims, pad=16)
    fn = lambda q, cand, cpts, d2, ok: (cand, ok)  # noqa: E731
    cj, okj = jn.neighbor_map_dense(gj, jnp.asarray(pts), jnp.asarray(valid), 0.15,
                                    fn, dims, per_cell=16, chunk=512, exclude_self=True)
    ct, okt = tn.neighbor_map_dense(gt, T(pts), T(valid), 0.15, fn, dims,
                                    per_cell=16, chunk=700, exclude_self=True)
    sj, st = _sets(np.asarray(cj), np.asarray(okj)), _sets(to_np(ct), to_np(okt))
    assert sj == st
    assert np.mean([len(s) for s in st]) > 20


def test_gather_neighbors_vs_bruteforce_and_dense(rng):
    """tests/test_cloud.py:21's contract on the port's sorted grid, and the
    dense grid (cells uncapped) gives the same sets."""
    pts = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    valid = np.ones(500, bool)
    radius = 0.25
    grid = tn.build_grid(T(pts), T(valid), radius)
    nb = tn.gather_neighbors(grid, T(pts), T(valid), radius, per_cell=32, chunk=128,
                             exclude_self=True)
    ok, idx = to_np(nb.ok), to_np(nb.idx)
    D2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    for i in range(0, 500, 37):
        want = set(np.nonzero(D2[i] <= radius ** 2)[0]) - {i}
        assert set(idx[i][ok[i]].tolist()) == want, i
    origin, dims, cell = tn.host_grid_geometry(pts, valid, radius)
    dg = tn.build_dense_grid(T(pts), T(valid), origin, cell, dims, pad=32)
    cd, okd = tn.neighbor_map_dense(dg, T(pts), T(valid), radius,
                                    lambda q, cand, cpts, d2, ok: (cand, ok), dims,
                                    per_cell=32, exclude_self=True)
    assert _sets(to_np(cd), to_np(okd)) == _sets(idx, ok)


# ----------------------------------------------------------------- normals


def test_eigen3x3_vs_reference_and_numpy(rng):
    """Well-separated spectra: eigenvalue within 1e-5 x trace of the
    reference's, |cos| >= 1 - 1e-5 between the vectors; and
    tests/test_cloud.py:39's numpy contract."""
    Q = np.linalg.qr(rng.normal(size=(400, 3, 3)))[0]
    lam = np.sort(rng.uniform(0.1, 1.0, size=(400, 3)), -1)
    lam[:, 1] += 0.3
    lam[:, 2] += 0.6
    A = np.einsum("nij,nj,nkj->nik", Q, lam, Q).astype(np.float32)
    lj, vj = map(np.asarray, jnm.smallest_eigenvector_3x3(jnp.asarray(A)))
    lt, vt = map(to_np, tnm.smallest_eigenvector_3x3(T(A)))
    tr = np.trace(A, axis1=1, axis2=2)
    assert (np.abs(lj - lt) <= 1e-5 * tr).all()
    assert (np.abs((vj * vt).sum(1)) >= 1 - 1e-5).all()
    for M in rng.normal(size=(50, 3, 3)):
        S = (M @ M.T).astype(np.float32)
        lam1, v1 = tnm.smallest_eigenvector_3x3(T(S)[None])
        w_np, v_np = np.linalg.eigh(S)
        np.testing.assert_allclose(float(lam1[0]), w_np[0],
                                   atol=1e-3 * max(1, abs(w_np).max()))
        assert abs(float(np.dot(to_np(v1)[0], v_np[:, 0]))) > 0.999


def test_estimate_normals_vs_reference(rng):
    """|cos| >= 1 - 1e-5 against the reference on >= 99.9% of the points;
    the flip equal wherever |n . to_cam| > 1e-3 |to_cam|; and
    tests/test_cloud.py:128's plane contract on the port."""
    pts = _surface_cloud(rng, 4000, noise=0.003)
    valid = rng.uniform(size=len(pts)) > 0.05
    vp = np.array([0.3, -0.2, 20.0], np.float32)
    nj = np.asarray(jnm.estimate_normals(jnp.asarray(pts), jnp.asarray(valid), 0.3,
                                         jnp.asarray(vp), chunk=512))
    nt = to_np(tnm.estimate_normals(T(pts), T(valid), 0.3, vp, chunk=600))
    cos = np.abs((nj * nt).sum(1))[valid]
    assert (cos >= 1 - 1e-5).mean() >= 0.999, (cos >= 1 - 1e-5).mean()
    to_cam = vp[None] - pts
    clear = np.abs((nt * to_cam).sum(1)) > 1e-3 * np.linalg.norm(to_cam, axis=1)
    sel = valid & clear
    np.testing.assert_array_equal(np.sign((nj * to_cam).sum(1))[sel],
                                  np.sign((nt * to_cam).sum(1))[sel])

    xy = rng.uniform(-1, 1, size=(2000, 2))
    plane = np.column_stack([xy, 0.2 * xy[:, 0] + 0.1 * xy[:, 1]]).astype(np.float32)
    n = to_np(tnm.estimate_normals(T(plane), T(np.ones(2000, bool)), 0.3,
                                   np.array([0.0, 0.0, 100.0], np.float32)))
    true_n = np.array([-0.2, -0.1, 1.0]) / np.linalg.norm([-0.2, -0.1, 1.0])
    assert ((n @ true_n) > 0.99).mean() > 0.95
    assert (n[:, 2] > 0).all()


# ----------------------------------------------------------------- filters


def test_knn_stat_vs_reference(rng):
    """The histogram k-NN statistic within 1e-5 relative of the reference's
    (its bins summed in another order)."""
    pts = _surface_cloud(rng, 4000, noise=0.003)
    valid = np.ones(len(pts), bool)
    k = 30
    cell = jf._mean_spacing(pts, valid) * float(np.sqrt(k)) * 0.6 + 1e-6
    assert cell == tf._mean_spacing(pts, valid) * float(np.sqrt(k)) * 0.6 + 1e-6
    origin, dims, cell = jn.host_grid_geometry(pts, valid, cell)
    gj = jn.build_dense_grid(jnp.asarray(pts), jnp.asarray(valid), origin, cell, dims, pad=32)
    gt = tn.build_dense_grid(T(pts), T(valid), origin, cell, dims, pad=32)
    mj, hj = jn.neighbor_map_dense(gj, jnp.asarray(pts), jnp.asarray(valid), cell,
                                   jf._knn_stat(k), dims, per_cell=32, chunk=512,
                                   exclude_self=True)
    mt, ht = tn.neighbor_map_dense(gt, T(pts), T(valid), cell, tf._knn_stat(k), dims,
                                   per_cell=32, chunk=512, exclude_self=True)
    mj, mt = np.asarray(mj), to_np(mt)
    np.testing.assert_array_equal(np.asarray(hj), to_np(ht))
    rel = np.abs(mj - mt) / np.maximum(np.abs(mj), 1e-30)
    assert rel.max() <= 1e-5, rel.max()


def test_sor_vs_reference_and_contract(rng):
    """Keep masks equal on >= 99.9% of the points; tests/test_cloud.py:51's
    contract (outliers dropped, surface kept) on the port."""
    allp = _with_outliers(rng)
    valid = np.ones(len(allp), bool)
    valid[::29] = False
    kj = np.asarray(jf.sor_filter(jnp.asarray(allp), jnp.asarray(valid), mean_k=30,
                                  std_thresh=1.0, chunk=512))
    kt = to_np(tf.sor_filter(T(allp), T(valid), mean_k=30, std_thresh=1.0, chunk=512))
    assert (kj == kt).mean() >= 0.999
    keep = to_np(tf.sor_filter(T(allp), T(np.ones(len(allp), bool)), mean_k=30))
    assert keep[:4000].mean() > 0.9
    assert keep[4000:].mean() < 0.2


def test_sor_gate_matches_numpy_twin(rng):
    n = 5000
    mean_d = rng.gamma(2.0, 0.01, n).astype(np.float32)
    has = rng.uniform(size=n) > 0.05
    valid = rng.uniform(size=n) > 0.1
    a = to_np(tf._sor_gate(T(mean_d), T(has), T(valid), 0.05, 1.0))
    b = tf._sor_gate_np(mean_d, has, valid, 0.05, 1.0)
    assert (a == b).mean() > 0.999


def test_radius_outlier_filter_vs_reference_and_brute(rng):
    """tests/test_cloud.py:64 on the port: device and host twins equal the
    brute-force count gate and the reference's mask."""
    pts = rng.uniform(-1, 1, size=(600, 3)).astype(np.float32)
    valid = np.ones(600, bool)
    valid[::17] = False
    radius, min_nb = 0.3, 8
    D2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    counts = ((D2 <= radius ** 2) & valid[None, :]).sum(1) - valid.astype(int)
    want = valid & (counts >= min_nb)
    np.testing.assert_array_equal(tf.radius_outlier_filter_np(pts, valid, radius, min_nb),
                                  want)
    got = to_np(tf.radius_outlier_filter(T(pts), T(valid), radius, min_nb,
                                         per_cell=64, chunk=128))
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jf.radius_outlier_filter(jnp.asarray(pts), jnp.asarray(valid),
                                              radius, min_nb, per_cell=64, chunk=128))
    np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------------------- mls


def test_mls_vs_reference_and_denoises(rng):
    """Points within 1e-5, ok equal, normals |cos| >= 1 - 1e-5 on >= 99.9%
    against the reference; tests/test_cloud.py:143's denoising contract."""
    pts = _surface_cloud(rng, 4000, noise=0.02)
    valid = rng.uniform(size=len(pts)) > 0.03
    vp = np.array([0.0, 0.0, 100.0], np.float32)
    n0 = np.asarray(jnm.estimate_normals(jnp.asarray(pts), jnp.asarray(valid), 0.3,
                                         jnp.asarray(vp), chunk=512))
    sj, nj, okj = map(np.asarray, jm.mls_smooth(jnp.asarray(pts), jnp.asarray(valid),
                                                0.3, jnp.asarray(n0), chunk=512))
    st, nt, okt = map(to_np, tm.mls_smooth(T(pts), T(valid), 0.3, n0, chunk=512))
    np.testing.assert_array_equal(okj, okt)
    assert np.abs(sj - st).max() <= 1e-5
    cos = np.abs((nj * nt).sum(1))[okt]
    assert (cos >= 1 - 1e-5).mean() >= 0.999
    assert okt.mean() > 0.9

    def resid(p):
        return p[:, 2] - 0.1 * (p[:, 0] ** 2 + p[:, 1] ** 2)

    assert np.abs(resid(st[okt])).mean() < 0.6 * np.abs(resid(pts[okt])).mean()


# ------------------------------------------------------------------- dedup


def _ring(npair, C_of, K):
    P0s, P1s, centers = [], [], []
    for j in range(npair):
        def cam(C):
            z = -C / np.linalg.norm(C)
            x = np.cross(np.array([0, 1, 0.0]), z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            R = np.stack([x, y, z])
            return K @ np.hstack([R, (-R @ C)[:, None]])
        C0, C1 = C_of(j)
        P0s.append(cam(C0))
        P1s.append(cam(C1))
        centers.append(C0)
    return (np.stack(P0s).astype(np.float32), np.stack(P1s).astype(np.float32),
            np.stack(centers).astype(np.float32))


def _dedup_both(pts, nrm, valid, P0, P1, centers, masks):
    got = td.cross_view_dedup(T(pts), T(nrm), T(valid),
                              td.DedupInputs(P0=T(P0), P1=T(P1), centers=T(centers),
                                             masks0=T(masks)))
    ref = jd.cross_view_dedup(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(valid),
                              jd.DedupInputs(P0=jnp.asarray(P0), P1=jnp.asarray(P1),
                                             centers=jnp.asarray(centers),
                                             masks0=jnp.asarray(masks)))
    return np.asarray(ref), to_np(got)


def test_dedup_bucket_rules_equal_reference():
    """tests/test_cloud.py:160's rig: the documented bucket rules."""
    H = W = 16
    K = np.array([[10.0, 0, 8], [0, 10, 8], [0, 0, 1]], np.float32)
    P0 = np.hstack([K, np.zeros((3, 1), np.float32)])[None]
    toward, away = np.array([0, 0, -1], np.float32), np.array([0, 0, 1], np.float32)
    pts = np.array([[0.0, 0.0, 5.0], [1.0, 0.0, 5.0], [1.2, 0.0, 6.0],
                    [0.0, 1.0, 5.0], [0.0, 1.2, 6.0], [-1.0, 0.0, 5.0]], np.float32)
    nrm = np.stack([toward, toward, toward, toward, away, toward])
    masks = np.ones((1, H, W), np.float32)
    masks[0, 8, 6] = 0.0
    ref, got = _dedup_both(pts, nrm, np.ones(6, bool), P0, P0,
                           np.zeros((1, 3), np.float32), masks)
    np.testing.assert_array_equal(ref, got)
    assert got.tolist() == [True, True, False, True, True, False]


def test_dedup_random_rigs_equal_reference(rng):
    """tests/test_cloud.py:200's and :274's rigs (random clouds, and a
    sphere with jittered duplicates) give the reference's keep masks."""
    K = np.array([[6.0, 0, 12], [0, 6, 12], [0, 0, 1]])
    P0, _, centers = _ring(3, lambda j: (np.array([8 * np.sin(2 * np.pi * j / 3), 0.5 * j,
                                                   8 * np.cos(2 * np.pi * j / 3)]),) * 2, K)
    for _ in range(4):
        pts = rng.uniform(-2, 2, size=(400, 3)).astype(np.float32)
        nrm = rng.normal(size=(400, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        valid = rng.uniform(size=400) > 0.1
        masks = (rng.uniform(size=(3, 24, 24)) > 0.2).astype(np.float32)
        ref, got = _dedup_both(pts, nrm, valid, P0, P0, centers, masks)
        np.testing.assert_array_equal(ref, got)

    K = np.array([[9.0, 0, 16], [0, 9, 16], [0, 0, 1]])
    P0, P1, centers = _ring(3, lambda j: (
        np.array([6 * np.sin(2 * np.pi * j / 3), 0.3, 6 * np.cos(2 * np.pi * j / 3)]),
        np.array([6 * np.sin(2 * np.pi * j / 3 + 0.12), 0.5,
                  6 * np.cos(2 * np.pi * j / 3 + 0.12)])), K)
    v = rng.normal(size=(500, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    base = v * 1.5
    pts = np.concatenate([base, base + rng.normal(0, 0.05, base.shape)]).astype(np.float32)
    nrm = np.concatenate([v, v]).astype(np.float32)
    ref, got = _dedup_both(pts, nrm, np.ones(len(pts), bool), P0, P1, centers,
                           np.ones((3, 32, 32), np.float32))
    np.testing.assert_array_equal(ref, got)
    assert 0 < got.sum() < len(pts)


# ------------------------------------------------------ native and backend


def test_native_sources_are_the_reference_copies():
    for name in ("cloud_stats.cpp", "marching_tets.cpp", "ply_codec.cpp"):
        assert ((ROOT / "reconstruction_tpu_torch/native/src" / name).read_bytes()
                == (ROOT / "reconstruction_tpu/native/src" / name).read_bytes()), name


def test_native_cloud_stats_vs_reference_library(rng):
    """The port's build of the same C++ against the reference's library:
    SOR statistics bit-equal; normals and MLS within 1e-6 (the two
    libraries were compiled for different CPUs with -march=native, so a
    multiply-add may be fused in one and not the other)."""
    from reconstruction_tpu import native as jnat
    from reconstruction_tpu_torch import native as tnat
    if not jnat.available():
        pytest.skip("the reference's native library is not loadable here")
    pts = _surface_cloud(rng, 3000, noise=0.01)
    valid = rng.uniform(size=len(pts)) > 0.05
    vp = np.array([0.0, 0.0, 100.0], np.float32)
    a, b = jnat.cloud_sor_stats(pts, valid, 0.25, 20), tnat.cloud_sor_stats(pts, valid, 0.25, 20)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    na, nb = jnat.cloud_normals(pts, valid, 0.3, vp), tnat.cloud_normals(pts, valid, 0.3, vp)
    np.testing.assert_allclose(na, nb, rtol=0, atol=1e-6)
    ma, mb = jnat.cloud_mls(pts, valid, 0.3, na), tnat.cloud_mls(pts, valid, 0.3, na)
    np.testing.assert_array_equal(ma[2], mb[2])
    np.testing.assert_allclose(ma[0], mb[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ma[1], mb[1], rtol=0, atol=1e-6)


def test_native_backend_contracts(rng):
    """tests/test_native_cloud.py:46-97 on the port: the host SOR drops the
    outliers (numpy out, no device), and its normals and MLS agree with
    the device path."""
    allp = _with_outliers(rng)
    keep = tf.sor_filter(allp, np.ones(len(allp), bool), mean_k=30, backend="native")
    assert isinstance(keep, np.ndarray)
    assert keep[:4000].mean() > 0.9 and keep[4000:].mean() < 0.2
    pts = _surface_cloud(rng, 3000, noise=0.01)
    valid = np.ones(len(pts), bool)
    vp = np.array([0.0, 0.0, 100.0], np.float32)
    n_nat = tnm.estimate_normals(pts, valid, 0.3, vp, backend="native")
    n_dev = to_np(tnm.estimate_normals(T(pts), T(valid), 0.3, vp, per_cell=64,
                                       backend="torch"))
    assert (np.abs((n_nat * n_dev).sum(1)) > 0.995).mean() > 0.97
    assert (n_nat[:, 2] > 0).all()
    sm_nat, _, ok_nat = tm.mls_smooth(pts, valid, 0.3, n_nat, backend="native")
    sm_dev, _, ok_dev = map(to_np, tm.mls_smooth(T(pts), T(valid), 0.3, n_nat,
                                                 per_cell=64, backend="torch"))
    both = ok_nat & ok_dev
    assert both.mean() > 0.95
    assert np.median(np.linalg.norm(sm_nat[both] - sm_dev[both], axis=1)) < 2e-3


def test_backend_rule(monkeypatch, tmp_path):
    """"auto" is the device path whatever the environment says; "native"
    raises when the library cannot be built; unknown names raise."""
    from reconstruction_tpu_torch import native
    from reconstruction_tpu_torch.cloud.backend import resolve_backend
    monkeypatch.setenv("RECON_CLOUD_BACKEND", "native")
    assert resolve_backend("auto") == "torch"
    assert resolve_backend("torch") == "torch"
    assert resolve_backend("native") == "native"
    with pytest.raises(ValueError):
        resolve_backend("jax")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_compilers", lambda: [str(tmp_path / "no-such-g++")])
    with pytest.raises(RuntimeError):
        resolve_backend("native")
