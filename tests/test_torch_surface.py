"""Port vs reference: the surface stages (Poisson, marching tetrahedra, the
mesh cleanup, texturing) and PLY I/O, on the same seeded numpy inputs,
both on the CPU; and tests/test_surface.py's contracts on the port's
functions.  Each tolerance is stated where it is used."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import T, to_np

from reconstruction_tpu.io import ply as jply
from reconstruction_tpu.surface import marching as jmt
from reconstruction_tpu.surface import mesh as jmesh
from reconstruction_tpu.surface import poisson as jpo
from reconstruction_tpu.surface import texture as jtx
from reconstruction_tpu_torch.io import ply as tply
from reconstruction_tpu_torch.surface import marching as tmt
from reconstruction_tpu_torch.surface import mesh as tmesh
from reconstruction_tpu_torch.surface import poisson as tpo
from reconstruction_tpu_torch.surface import texture as ttx


def _sphere_cloud(rng, n=20000, r=1.0, noise=0.0):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v * (r + rng.normal(scale=noise, size=(n, 1)))
    return pts.astype(np.float32), v.astype(np.float32)


def _poisson_both(pts, nrm, valid, **kw):
    ref = jpo.poisson_reconstruct(jnp.asarray(pts), jnp.asarray(nrm),
                                  jnp.asarray(valid), **kw)
    got = tpo.poisson_reconstruct(T(pts), T(nrm), T(valid), **kw)
    return ref, got


@pytest.mark.parametrize("R,point_weight", [(32, 0.0), (64, 0.0), (32, 4.0), (64, 4.0)])
def test_poisson_vs_reference(rng, R, point_weight):
    """origin and spacing equal; density within 1e-5 x its max; chi within
    1e-4 x max|chi|; iso within 1e-4 relative (rFFT against jnp.fft)."""
    pts, nrm = _sphere_cloud(rng, n=8000, noise=0.01)
    valid = rng.uniform(size=len(pts)) > 0.05
    ref, got = _poisson_both(pts, nrm, valid, resolution=R, cycles=4,
                             point_weight=point_weight)
    np.testing.assert_array_equal(np.asarray(ref.origin), to_np(got.origin))
    assert float(ref.spacing) == float(got.spacing)
    dj, dt = np.asarray(ref.density), to_np(got.density)
    assert np.abs(dj - dt).max() <= 1e-5 * dj.max()
    cj, ct = np.asarray(ref.chi), to_np(got.chi)
    assert np.abs(cj - ct).max() <= 1e-4 * np.abs(cj).max()
    assert abs(float(ref.iso) - float(got.iso)) <= 1e-4 * abs(float(ref.iso))


def test_poisson_sphere_contract(rng):
    """tests/test_surface.py:38 on the port."""
    pts, nrm = _sphere_cloud(rng, n=20000)
    res = tpo.poisson_reconstruct(T(pts), T(nrm), T(np.ones(len(pts), bool)),
                                  resolution=64, cycles=6)
    chi = to_np(res.chi)
    assert np.isfinite(chi).all()
    verts, faces = tmt.marching_tetrahedra(chi, float(res.iso), origin=to_np(res.origin),
                                           spacing=float(res.spacing))
    assert len(verts) > 1000
    rad = np.linalg.norm(verts, axis=1)
    shell = rad[(rad > 0.5) & (rad < 1.5)]
    assert len(shell) > 0.8 * len(rad)
    assert abs(np.median(shell) - 1.0) < 0.08
    assert shell.std() < 0.08


def test_poisson_splat_deterministic(rng):
    """Two splats of the same points give the same grid bit for bit."""
    pts, nrm = _sphere_cloud(rng, n=5000)
    valid = np.ones(len(pts), bool)
    a = tpo.poisson_reconstruct(T(pts), T(nrm), T(valid), resolution=32)
    b = tpo.poisson_reconstruct(T(pts), T(nrm), T(valid), resolution=32)
    assert torch.equal(a.density, b.density) and torch.equal(a.chi, b.chi)


def _sdf(R=48, r=15.0):
    g = np.arange(R) - (R - 1) / 2
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - r


@pytest.mark.parametrize("use_native", [True, False])
def test_marching_equal_reference_and_contract(use_native):
    """The copy gives the reference's mesh (native: the same C++, built
    here, vertices within 1e-9; NumPy: equal) and tests/test_surface.py:21's
    sphere contract."""
    sdf = _sdf()
    vj, fj = jmt.marching_tetrahedra(sdf, 0.0, use_native=use_native)
    vt, ft = tmt.marching_tetrahedra(sdf, 0.0, use_native=use_native)
    np.testing.assert_array_equal(fj, ft)
    np.testing.assert_allclose(vj, vt, rtol=0, atol=1e-9)
    assert len(vt) > 500 and len(ft) > 1000
    rad = np.linalg.norm(vt - (48 - 1) / 2, axis=1)
    assert abs(rad.mean() - 15.0) < 0.1 and rad.std() < 0.1
    assert len(tmesh.boundary_loops(ft)) == 0


def _trimmed_sphere(rng, R=48):
    pts, nrm = _sphere_cloud(rng, n=15000)
    res = jpo.poisson_reconstruct(jnp.asarray(pts), jnp.asarray(nrm),
                                  jnp.asarray(np.ones(len(pts), bool)),
                                  resolution=R, cycles=6)
    verts, faces = jmt.marching_tetrahedra(np.asarray(res.chi), float(res.iso),
                                           origin=np.asarray(res.origin),
                                           spacing=float(res.spacing))
    vg = (verts - np.asarray(res.origin)) / float(res.spacing)
    return verts, faces, np.asarray(res.density), vg


def test_mesh_cleanup_equal_reference(rng):
    """density_trim, remove_small_components, clean_mesh, close_holes and
    laplacian_smooth give the reference's arrays (the cotangent Laplacian
    in both libraries within 1e-9, and in NumPy equal); the contracts of
    tests/test_surface.py:57-108 on the port."""
    verts, faces, dens_grid, vg = _trimmed_sphere(rng)
    dj, dt = jmesh.vertex_density(dens_grid, vg), tmesh.vertex_density(dens_grid, vg)
    np.testing.assert_array_equal(dj, dt)
    a = jmesh.density_trim(verts, faces, dj, quantile=0.05)
    b = tmesh.density_trim(verts, faces, dt, quantile=0.05)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(b[1]) <= len(faces)
    a = jmesh.remove_small_components(*a, min_diag_frac=0.2)
    b = tmesh.remove_small_components(*b, min_diag_frac=0.2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert (np.abs(np.linalg.norm(b[0], axis=1) - 1.0) < 0.3).mean() > 0.99
    a, b = jmesh.clean_mesh(*a), tmesh.clean_mesh(*b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    sj = jmesh.laplacian_smooth(*a, iterations=5, cotangent=True)
    st = tmesh.laplacian_smooth(*b, iterations=5, cotangent=True)
    np.testing.assert_allclose(sj, st, rtol=0, atol=1e-9)
    sn = tmesh.laplacian_smooth(*b, iterations=5, cotangent=True, use_native=False)
    np.testing.assert_allclose(sn, st, rtol=0, atol=1e-9)
    rad0, rad1 = np.linalg.norm(b[0], axis=1), np.linalg.norm(st, axis=1)
    assert rad1.std() <= rad0.std() * 1.05 and np.isfinite(st).all()
    for m in (0, 1):
        np.testing.assert_array_equal(
            jmesh.laplacian_smooth(*a, iterations=3, cotangent=False)[m],
            tmesh.laplacian_smooth(*b, iterations=3, cotangent=False)[m])

    hole_v = np.vstack([[0, 0, 0], np.column_stack([np.cos(np.arange(6) * np.pi / 3),
                                                   np.sin(np.arange(6) * np.pi / 3),
                                                   np.zeros(6)])])
    hole_f = np.array([[0, 1 + i, 1 + (i + 1) % 6] for i in range(6)], np.int32)[:-1]
    for x, y in zip(jmesh.close_holes(hole_v, hole_f), tmesh.close_holes(hole_v, hole_f)):
        np.testing.assert_array_equal(x, y)
    v2, f2 = tmesh.close_holes(hole_v, hole_f, max_edges=30)
    assert len(f2) > len(hole_f)
    dup_v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], float)
    dup_f = np.array([[0, 1, 2], [2, 1, 0], [1, 2, 3], [1, 1, 2]], np.int32)
    assert len(tmesh.clean_mesh(dup_v, dup_f)[1]) == 2


@pytest.mark.parametrize("use_native", [True, False])
def test_ply_bytes_equal_reference(rng, tmp_path, use_native):
    """write_ply gives the reference's bytes (native and NumPy packing
    alike), and each package reads the other's file."""
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    nrm = rng.normal(size=(300, 3)).astype(np.float32)
    col = rng.uniform(0, 255, (300, 3))
    faces = rng.integers(0, 300, (200, 3)).astype(np.int32)
    for kw in (dict(colors=col, faces=faces, color_order="bgr"),
               dict(normals=nrm, colors=col), dict(faces=faces)):
        pj, pt = tmp_path / "j.ply", tmp_path / "t.ply"
        jply.write_ply(str(pj), xyz, **kw)
        tply.write_ply(str(pt), xyz, use_native=use_native, **kw)
        assert pj.read_bytes() == pt.read_bytes()
        a, b = jply.read_ply(str(pt)), tply.read_ply(str(pj))
        np.testing.assert_array_equal(a.xyz, b.xyz)
        if "faces" in kw:
            np.testing.assert_array_equal(a.faces, b.faces)
    tply.write_ply(str(tmp_path / "a.ply"), xyz, colors=col, binary=False)
    np.testing.assert_allclose(tply.read_ply(str(tmp_path / "a.ply")).xyz, xyz, rtol=1e-6)


def _views(rng, n=3):
    cams = []
    for k in range(n):
        K = np.array([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]])
        t = np.array([0.0, 0, 4.0 + k])
        P = (K @ np.hstack([np.eye(3), t[:, None]])).astype(np.float32)
        img = rng.uniform(0, 255, (64, 64, 3)).astype(np.float32)
        mask = (rng.uniform(size=(64, 64)) > 0.3).astype(np.float32) * 255
        cams.append((P, img, mask, -t))
    return cams


def test_texture_vs_reference(rng):
    """The device blend within 1e-3 (colors 0-255) of the reference's; the
    numpy blend and the single-view recolor equal the reference's."""
    V = 500
    verts = rng.uniform(-1, 1, (V, 3)).astype(np.float32)
    normals = rng.normal(size=(V, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    cams = _views(rng)
    a = jtx.texture_vertices(verts, normals, cams, backend="jax")
    b = ttx.texture_vertices(verts, normals, cams, device="cpu")
    assert np.abs(a - b).max() <= 1e-3
    tcams = [(P, T(img), T(m), c) for P, img, m, c in cams]
    np.testing.assert_array_equal(b, ttx.texture_vertices(verts, normals, tcams,
                                                          device="cpu"))
    np.testing.assert_array_equal(jtx.texture_vertices_np(verts, normals, cams),
                                  ttx.texture_vertices_np(verts, normals, cams))
    np.testing.assert_array_equal(ttx.texture_vertices(verts, normals, tcams,
                                                       backend="native"),
                                  ttx.texture_vertices_np(verts, normals, cams))
    P, img = cams[0][:2]
    np.testing.assert_array_equal(jtx.texture_single_view(verts, P, img),
                                  ttx.texture_single_view(verts, P, img))
