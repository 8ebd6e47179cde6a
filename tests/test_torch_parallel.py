"""The port's multi-device layer (`reconstruction_tpu_torch/parallel/`) on
worlds of 1, 2 and 4 gloo ranks on the CPU, spawned by
`parallel/launch.run_local` (tests/torch_parallel_work.py runs in each
rank).  Each world runs once per module; its results are held, test by
test, bit for bit to the port's single-device functions and, within the
JAX package's own tolerances (tests/test_parallel.py), to the JAX
package's sharded functions on the 8-device CPU mesh of conftest.py."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_parity import T, to_np, u8_image

from reconstruction_tpu.config import NOMATCH
from reconstruction_tpu.parallel.mesh import make_mesh as jax_make_mesh
from reconstruction_tpu_torch.parallel.launch import run_local

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_work as work  # noqa: E402

WORLDS = (1, 2, 4)
REFINE_ITERS = (10, 13)     # 13: the last exchange runs a partial T of 1


def _inputs():
    from test_ba import _make_ba_problem
    # scene8 of tests/test_parallel.py, its views on the uint8 grid (what
    # the pipeline feeds the matchers, and the only images K1 and K3 take
    # on the card; off the grid the port's CPU path rounds apart from XLA's).
    rng = np.random.default_rng(3)
    H, W, P = 32, 48, 4
    scene8 = dict(imgs0=u8_image(rng, (P, H, W, 3)), imgs1=u8_image(rng, (P, H, W, 3)),
                  masks=np.zeros((P, H, W), np.float32))
    scene8["masks"][:, 4:-4, 4:-4] = 255.0

    rng = np.random.default_rng(5)
    H, W = 64, 48
    imgL = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    imgR = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    disp = rng.integers(-2, 3, (H, W)).astype(np.float32)
    disp[rng.uniform(size=(H, W)) < 0.2] = NOMATCH
    valid = np.zeros((H, W), bool)
    valid[3:-3, 3:-3] = True
    disp[~valid] = NOMATCH
    refine = dict(imgL=imgL, imgR=imgR, disp=disp, valid=valid, iterations=REFINE_ITERS)

    rng = np.random.default_rng(7)
    clouds = dict(xyz=rng.normal(size=(4, 100, 3)).astype(np.float32),
                  colors=rng.uniform(0, 255, (4, 100, 3)).astype(np.float32),
                  valid=rng.uniform(size=(4, 100)) < 0.8)

    prob, Rt_true, _ = _make_ba_problem(np.random.default_rng(0), num_cams=4, num_pts=64)
    ba = {k: np.asarray(getattr(prob, k)) for k in prob._fields}
    ba.update(C=4, Rt_true=Rt_true)

    rng = np.random.default_rng(8)
    splat = dict(pts=rng.uniform(1, 14, (4, 64, 3)).astype(np.float32),
                 nrm=rng.normal(size=(4, 64, 3)).astype(np.float32),
                 valid=np.ones((4, 64), bool), R=16)

    rng = np.random.default_rng(11)
    R = 32
    f = np.zeros((R, R, R), np.float32)
    f[8, 8, 8] = 1.0
    f[24, 20, 16] = -1.0
    vcycle = dict(f=f, screen=(0.1 * rng.uniform(size=(R, R, R))).astype(np.float32),
                  cycles=6, levels=2, pre=2, post=2)
    return dict(scene8=scene8, refine=refine, clouds=clouds, ba=ba, splat=splat,
                vcycle=vcycle)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _frame_takes():
    """The two frames of tests/multihost_scene.frame_take."""
    H, W = 28, 36
    imgL, imgR = [], []
    for frame in range(2):
        rng = np.random.default_rng(1000 + frame)
        L = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
        imgL.append(L)
        imgR.append(np.roll(L, -(2 + frame), axis=1))
    mask = np.zeros((2, H, W), np.float32)
    mask[:, 4:-4, 4:-4] = 255.0
    return dict(imgL=np.stack(imgL), imgR=np.stack(imgR), mask=mask)


@pytest.fixture(scope="module", autouse=True)
def jobs(inputs):
    """The module's worlds, all started before its first test and run side
    by side while the pytest process computes the references: the core
    worlds of 1, 2 and 4 ranks, and two one-rank "hosts"."""
    arg = dict(inputs)
    arg["ba"] = {k: v for k, v in inputs["ba"].items() if k != "Rt_true"}
    with ThreadPoolExecutor(len(WORLDS) + 1) as pool:
        futs = {n: pool.submit(run_local, work.core, n, "cpu", arg, timeout=300)
                for n in WORLDS}
        futs["frames"] = pool.submit(run_local, work.frames, 2, "cpu", _frame_takes(),
                                     timeout=300)
        yield futs


@pytest.fixture(scope="module")
def worlds(jobs):
    return {n: jobs[n].result() for n in WORLDS}


def _every_rank(ranks, key):
    """``key``'s result, after checking that every rank holds the same."""
    first = ranks[0][key]
    for r in ranks[1:]:
        for k in (first if isinstance(first, dict) else [None]):
            a, b = (first, r[key]) if k is None else (first[k], r[key][k])
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return first


def test_mesh_axes():
    from reconstruction_tpu_torch.parallel.mesh import mesh_axes
    assert mesh_axes() == ("frame", "pair", "tile")


def test_factor_pod_equals_jax():
    from reconstruction_tpu.parallel.multihost import factor_pod as jax_factor_pod
    from reconstruction_tpu_torch.parallel.multihost import factor_pod
    for n in range(1, 65):
        for n_local in (1, 2, 4, 8):
            for req in (None, 1, 2, 3, 5, 7, n, n + 3):
                assert factor_pod(n, n_local, req) == jax_factor_pod(n, n_local, req)


def test_dense_vcycle_against_jax(inputs):
    """The port's dense multigrid (the sharded solver's reference) against
    the JAX package's, and it solves: the residual drops more than 100x."""
    from reconstruction_tpu.surface.poisson import _vcycle
    from reconstruction_tpu_torch.surface.poisson import _laplacian
    v = inputs["vcycle"]
    vcycle = jax.jit(_vcycle, static_argnums=(3, 4, 5))
    x = jnp.zeros(v["f"].shape, jnp.float32)
    for _ in range(v["cycles"]):
        x = vcycle(x, jnp.asarray(v["f"]), jnp.asarray(v["screen"]), v["levels"],
                   v["pre"], v["post"])
    got = _dense_vcycle_port(v)
    np.testing.assert_allclose(got, np.asarray(x), atol=1e-6)
    res = to_np(_laplacian(T(got))) - v["screen"] * got - v["f"]
    assert np.linalg.norm(res) < np.linalg.norm(v["f"]) / 100.0


# --- against the JAX package ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_pairs(inputs, cpu_devices):
    from reconstruction_tpu.parallel.sharded import match_level_pairs_sharded
    s = inputs["scene8"]
    mesh = jax_make_mesh(cpu_devices[:4], frame=1, pair=4, tile=1)
    return match_level_pairs_sharded(mesh, jnp.asarray(s["imgs0"]), jnp.asarray(s["imgs1"]),
                                     jnp.asarray(s["masks"]), jnp.asarray(s["masks"]),
                                     None, 0, refine_iters=4)


@pytest.mark.parametrize("n", WORLDS)
def test_match_level_pairs_sharded_against_jax(jax_pairs, worlds, n):
    got = _every_rank(worlds[n], "pairs")
    np.testing.assert_allclose(got["disp0"], np.asarray(jax_pairs.disp0), atol=1e-4)
    np.testing.assert_allclose(got["disp1"], np.asarray(jax_pairs.disp1), atol=1e-4)


@pytest.fixture(scope="module")
def jax_refine(inputs, cpu_devices):
    from reconstruction_tpu.parallel.sharded import refine_tiled
    from reconstruction_tpu.stereo.margins import find_margin
    r = inputs["refine"]
    m = find_margin(jnp.asarray(r["valid"]), 2)
    mesh = jax_make_mesh(cpu_devices[:4], frame=1, pair=1, tile=4)
    return {it: np.asarray(refine_tiled(mesh, jnp.asarray(r["disp"]), jnp.asarray(r["imgL"]),
                                        jnp.asarray(r["imgR"]), m, iterations=it,
                                        s_cap=32, band=8))
            for it in REFINE_ITERS}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("iters", REFINE_ITERS)
def test_refine_tiled_against_jax(jax_refine, worlds, n, iters):
    got = _every_rank(worlds[n], "refine")[iters]
    np.testing.assert_allclose(got, jax_refine[iters], atol=1e-4)


@pytest.mark.parametrize("n", WORLDS)
def test_ba_step_sharded_against_jax(worlds, inputs, n):
    """The JAX test's criteria (tests/test_parallel.py:72-108) against the
    JAX package's single-device step: the assembled cost, both post-step
    costs far below it and within 5x of each other, and the points equal
    up to the free scale about camera 0's center."""
    from reconstruction_tpu.ba.bundle_adjust import BAProblem, ba_cost, ba_step
    b = inputs["ba"]
    prob = BAProblem(*[jnp.asarray(b[k]) for k in BAProblem._fields])
    C = b["C"]
    p1, x1, c1 = ba_step(prob, jnp.zeros((C, 6)), prob.points0, C)
    got = _every_rank(worlds[n], "ba")
    np.testing.assert_allclose(float(c1), got["cost"], rtol=1e-5)
    after1 = float(ba_cost(prob, p1, x1, C))
    after2 = float(ba_cost(prob, jnp.asarray(got["poses"]), jnp.asarray(got["points"]), C))
    assert after1 < 0.01 * float(c1), (after1, float(c1))
    assert after2 < 0.01 * got["cost"], (after2, got["cost"])
    assert after1 / after2 < 5.0 and after2 / after1 < 5.0
    Rt_true = b["Rt_true"]
    R0, t0 = Rt_true[0][:, :3], Rt_true[0][:, 3]
    C0 = -R0.T @ t0
    a = got["points"] - C0
    bb = np.asarray(x1) - C0
    s = float((a * bb).sum() / np.maximum((a * a).sum(), 1e-12))
    assert abs(s - 1.0) < 0.05, s
    np.testing.assert_allclose(C0 + s * a, np.asarray(x1), atol=5e-3)


def test_ba_step_sharded_one_rank_equals_port_step(worlds, inputs):
    """One rank: the all-reduce adds nothing, so the step is `ba_step`'s."""
    from reconstruction_tpu_torch.ba.bundle_adjust import BAProblem, ba_step
    torch.set_num_threads(work.THREADS)
    b = inputs["ba"]
    prob = BAProblem(*[T(b[k]) for k in BAProblem._fields])
    p, x, c = ba_step(prob, torch.zeros((b["C"], 6)), prob.points0, b["C"])
    got = worlds[1][0]["ba"]
    np.testing.assert_array_equal(got["poses"], to_np(p))
    np.testing.assert_array_equal(got["points"], to_np(x))
    assert got["cost"] == float(c)


@pytest.mark.parametrize("n", WORLDS)
def test_distributed_splat_against_jax(worlds, inputs, n):
    from reconstruction_tpu.surface.poisson import _splat3
    s = inputs["splat"]
    R = s["R"]
    allp = jnp.asarray(s["pts"].reshape(-1, 3))
    alln = jnp.asarray(s["nrm"].reshape(-1, 3))
    ones = jnp.ones(len(allp))
    Vr = _splat3(jnp.zeros((R, R, R, 3)), allp, ones, alln)
    Dr = _splat3(jnp.zeros((R, R, R)), allp, ones, ones)
    got = _every_rank(worlds[n], "splat")
    np.testing.assert_allclose(got["V"], np.asarray(Vr), atol=1e-4)
    np.testing.assert_allclose(got["D"], np.asarray(Dr), atol=1e-4)


def _dense_vcycle_port(v):
    from reconstruction_tpu_torch.surface.poisson import _vcycle
    x = torch.zeros(v["f"].shape)
    for _ in range(v["cycles"]):
        x = _vcycle(x, T(v["f"]), T(v["screen"]), v["levels"], v["pre"], v["post"])
    return to_np(x)


@pytest.mark.parametrize("n", WORLDS)
def test_poisson_vcycle_sharded_equals_dense(worlds, inputs, n):
    """Z-plane-sharded multigrid == the dense V-cycle (bit for bit on one
    rank), and it solves: the residual drops more than 100x."""
    from reconstruction_tpu_torch.surface.poisson import _laplacian
    v = inputs["vcycle"]
    want = _dense_vcycle_port(v)
    got = _every_rank(worlds[n], "vcycle")
    if n == 1:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, atol=1e-6)
    res = to_np(_laplacian(T(got))) - v["screen"] * got - v["f"]
    assert np.linalg.norm(res) < np.linalg.norm(v["f"]) / 100.0


@pytest.mark.parametrize("n", WORLDS)
def test_poisson_vcycle_sharded_against_jax(worlds, inputs, cpu_devices, n):
    from reconstruction_tpu.parallel.poisson_sharded import poisson_vcycle_sharded
    v = inputs["vcycle"]
    mesh = jax_make_mesh(cpu_devices[:4], frame=1, pair=1, tile=4)
    want = np.asarray(poisson_vcycle_sharded(
        mesh, jnp.asarray(v["f"]), jnp.asarray(v["screen"]), levels=v["levels"],
        cycles=v["cycles"], pre=v["pre"], post=v["post"]))
    np.testing.assert_allclose(_every_rank(worlds[n], "vcycle"), want, atol=1e-6)


# --- port single-device references (CPU, 2 threads as in the ranks) ---------

@pytest.fixture(scope="module")
def port_refs(inputs):
    from reconstruction_tpu_torch.stereo.pipeline import match_one_level
    from reconstruction_tpu_torch.stereo.refine import disparity_refine
    from reconstruction_tpu_torch.stereo.margins import find_margin
    torch.set_num_threads(work.THREADS)
    s = inputs["scene8"]
    pairs = [match_one_level(T(s["imgs0"][p]), T(s["imgs1"][p]), T(s["masks"][p]),
                             T(s["masks"][p]), None, 0, refine_iters=4)
             for p in range(s["imgs0"].shape[0])]
    r = inputs["refine"]
    m = find_margin(T(r["valid"]), 2)
    refine = {it: to_np(disparity_refine(T(r["disp"]), T(r["imgL"]), T(r["imgR"]), m, it,
                                         s_cap=32, band=8, recenter_every=0))
              for it in REFINE_ITERS}
    return dict(disp0=np.stack([to_np(p.disp0) for p in pairs]),
                disp1=np.stack([to_np(p.disp1) for p in pairs]),
                drift0=np.stack([to_np(p.refine_drift0) for p in pairs]), refine=refine)


@pytest.mark.parametrize("n", WORLDS)
def test_match_level_pairs_sharded_equals_sequential_port(worlds, port_refs, n):
    got = _every_rank(worlds[n], "pairs")
    for k in ("disp0", "disp1", "drift0"):
        np.testing.assert_array_equal(got[k], port_refs[k])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("iters", REFINE_ITERS)
def test_refine_tiled_equals_unsharded_port(worlds, port_refs, n, iters):
    got = _every_rank(worlds[n], "refine")[iters]
    np.testing.assert_array_equal(got, port_refs["refine"][iters])


@pytest.mark.parametrize("n", WORLDS)
def test_all_gather_clouds(worlds, inputs, n):
    got = _every_rank(worlds[n], "clouds")
    c = inputs["clouds"]
    np.testing.assert_array_equal(got["xyz"], c["xyz"].reshape(400, 3))
    np.testing.assert_array_equal(got["colors"], c["colors"].reshape(400, 3))
    np.testing.assert_array_equal(got["valid"], c["valid"].reshape(400))


def test_block_lanes_pad_with_pair_zero(worlds):
    """3 items over the ranks: ceil(3 / n) lanes each, the padded lanes
    repeat item 0 (the reference's rule)."""
    assert [r["lanes"] for r in worlds[2]] == [([0, 1], [True, True]), ([2, 0], [True, False])]
    assert [r["lanes"] for r in worlds[4]] == [([0], [True]), ([1], [True]), ([2], [True]),
                                              ([0], [False])]


# --- two "hosts" --------------------------------------------

@pytest.fixture(scope="module")
def frame_world(jobs):
    return jobs["frames"].result()


def test_two_hosts_frame_axis_spans_hosts(frame_world):
    """tests/test_multihost.py's counterpart: with one rank a host, the pod
    mesh is (2, 1, 1) and frame row f is host f; a sum over the world."""
    for r in frame_world:
        assert r["shape"] == (2, 1, 1)
        assert r["frame_rows"] == [[0], [1]]
        assert r["total"] == 2.0


def test_two_hosts_gather_frame_takes_equal_jax(frame_world):
    from multihost_scene import frame_take
    for r in frame_world:
        for f in range(2):
            seq = frame_take(f)
            np.testing.assert_allclose(r["disp0"][f], seq, atol=1e-5)
            assert (seq != -10000.0).sum() > 100


def test_run_local_starts_again_when_its_port_was_taken(monkeypatch):
    """A port taken between its choice and rank 0's bind (another world
    took it) costs a restart on another port, not the run."""
    import socket
    import reconstruction_tpu_torch.parallel.multihost as multihost
    with socket.socket() as busy:
        busy.bind(("localhost", 0))
        busy.listen()
        ports = iter([busy.getsockname()[1]])
        real = multihost.free_port
        monkeypatch.setattr(multihost, "free_port", lambda: next(ports, None) or real())
        assert run_local(work.rank_and_world, 2, "cpu", timeout=120) == [(0, 2), (1, 2)]
