"""The port's headline bench (`reconstruction_tpu_torch/bench.py`) and its
cost models (`reconstruction_tpu_torch/utils/profiling.py`) against the
JAX package's (`bench.py`, `reconstruction_tpu/utils/profiling.py`), on
the CPU: the models' counts, the configuration, the scene, the merged
line, the kernel cells' bounds, the kernels phase at a small shape and a
whole run at a small configuration."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 (two intra-op threads a test worker)
from reconstruction_tpu.utils import profiling as jprof
from reconstruction_tpu_torch import bench as tbench
from reconstruction_tpu_torch.utils import profiling as tprof
from test_torch_dome import assert_same_config

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench as jbench  # noqa: E402  (the JAX package's bench.py)

# The bench's own shapes (bench.py:258, 274, 343, 347) and a small one.
SWEEP_SHAPES = [(1920, 1280, 3, 2, 64), (48, 80, 1, 1, 16)]
BENCH_ENV = ("RECON_BENCH_BASE", "RECON_BENCH_LEVELS", "RECON_BENCH_GRID",
             "RECON_REFINE_CV_DTYPE", "RECON_BENCH_MODE", "RECON_BENCH_PHASE",
             "RECON_BENCH_KERNELS", "RECON_BENCH_PAIRS", "RECON_BENCH_REPS",
             "RECON_BENCH_REFINE_SCALE", "RECON_REFINE_IMPL")
# The kernels phase at a small shape.
SMALL_KERNELS = dict(H=48, W=80, num_shifts=16, ba_cameras=4, ba_points=256,
                     ba_obs=4, reps=1)
CELLS = ("ncc_sweep", "ncc_sweep_mxu", "refine", "ba_schur")
UTIL_KEYS = {"gflops_per_s", "flops_util", "hbm_gbps", "hbm_util", "bound"}
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "chip", "matching_s", "total_s",
             "cold_total_s", "stages_s", "mesh", "host", "all_runs_s", "stereo_only",
             "kernels", "phase_attempts", "card"}


@pytest.fixture
def clean_env(monkeypatch):
    for k in BENCH_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_ncc_sweep_cost_equals_the_reference(shape):
    got, ref = tprof.ncc_sweep_cost(*shape), jprof.ncc_sweep_cost(*shape)
    assert rel(got.flops, ref.flops) <= 1e-12
    assert rel(got.hbm_bytes, ref.hbm_bytes) <= 1e-12


@pytest.mark.parametrize("resolution", [256, 32])
def test_poisson_cost_equals_the_reference(resolution):
    got, ref = tprof.poisson_cost(resolution), jprof.poisson_cost(resolution)
    assert rel(got.flops, ref.flops) <= 1e-12
    assert rel(got.hbm_bytes, ref.hbm_bytes) <= 1e-12


def test_utilization_keeps_the_reference_keys():
    """The five keys of the reference's utilization.  Its costs of vector
    work add "compute_unit" (the TPU's VPU against its MXU); the H100's
    table has one float32 rate, so the port's keys are the five."""
    ref = jprof.poisson_cost(64).utilization(0.01, "v5e")
    got = tprof.poisson_cost(64).utilization(0.01)
    assert set(got) == set(ref) == UTIL_KEYS
    vpu = jprof.ncc_sweep_cost(*SWEEP_SHAPES[0]).utilization(0.01, "v5e")
    assert set(tprof.ncc_sweep_cost(*SWEEP_SHAPES[0]).utilization(0.01)) \
        == set(vpu) - {"compute_unit"}
    c = tprof.KernelCost(flops=67e9, hbm_bytes=3.35e9 * 2)
    u = c.utilization(0.002)
    assert u["flops_util"] == pytest.approx(0.5) and u["hbm_util"] == pytest.approx(1.0)
    assert u["bound"] == "hbm"


@pytest.mark.parametrize("shape", [(1920, 1280, 30, 128, 40), (96, 64, 13, 32, 9)])
def test_refine_cost_by_hand(shape):
    """The volume build (the reference's sweep model at C 3, r 1), the
    volume written once, 25 bytes and 94 operations a pixel and sweep; no
    slab or launch term, so it is linear in the pixels."""
    H, W, it, s_cap, bs = shape
    px = H * W
    flops = px * ((2 * 3 - 1) + 4 * 1 + 10) * bs + it * px * 94
    nbytes = px * (8 * 3 + 37) + px * s_cap * 4 + it * px * 25
    got = tprof.refine_cost(H, W, it, s_cap, build_shifts=bs)
    assert got.flops == flops and got.hbm_bytes == nbytes
    twice = tprof.refine_cost(2 * H, W, it, s_cap, build_shifts=bs)
    assert twice.flops == 2 * flops and twice.hbm_bytes == 2 * nbytes


@pytest.mark.parametrize("shape", [(1 << 16, 8, 16), (1000, 6, 32)])
def test_schur_cost_by_hand(shape):
    """The reference's count with He read once instead of once a camera:
    the only term that differs."""
    m, o, c = shape
    n = m * o
    flops = n * (250 + 160) + m * (c * 6 * 3 * 3 + c * c * 36 * 3)
    nbytes = n * (40 + 54) * 4 + n * 18 * 4 + 6 * (c * 6) * m * 4
    got = tprof.schur_cost(m, o, c)
    assert got.flops == flops and got.hbm_bytes == nbytes
    ref = jprof.schur_cost(m, o, c)
    assert got.flops == ref.flops
    assert ref.hbm_bytes - got.hbm_bytes == n * 18 * 4 * (2 * c - 1)


ENV_CASES = [{}, {"RECON_BENCH_BASE": "40x60"}, {"RECON_BENCH_LEVELS": "2"},
             {"RECON_BENCH_GRID": "32"}, {"RECON_REFINE_CV_DTYPE": "bfloat16"},
             {"RECON_BENCH_BASE": "40x60", "RECON_BENCH_LEVELS": "2",
              "RECON_BENCH_GRID": "32", "RECON_REFINE_CV_DTYPE": "bfloat16"}]


@pytest.mark.parametrize("npairs", [1, 4])
@pytest.mark.parametrize("env", ENV_CASES)
def test_bench_config_matches_the_reference(clean_env, npairs, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert_same_config(tbench.bench_config(npairs), jbench.bench_config(npairs))


def test_synth_pair_is_the_reference():
    for a, b in zip(tbench.synth_pair(40, 72, np.random.default_rng(3)),
                    jbench.synth_pair(40, 72, np.random.default_rng(3))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_build_rig_matches_the_reference(monkeypatch, tmp_path):
    """Each bench's rig at 64x96 in a cache of its own: cameras equal,
    masks and 8-bit images within `tests/test_torch_core.py`'s scene
    parity; a second call reads the same arrays back from the cache."""
    monkeypatch.setattr(tbench, "CACHE", str(tmp_path / "port"))
    monkeypatch.setattr(jbench, "CACHE", str(tmp_path / "jax"))
    got = tbench.build_rig((64, 96), device="cpu")
    ref = jbench.build_rig((64, 96))
    assert len(got[0]) == len(ref[0]) == 8
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a["K"], b["K"])
        np.testing.assert_array_equal(a["Rt"], b["Rt"])
    for ma, mb in zip(got[2], ref[2]):
        assert (ma == mb).mean() > 0.999
    for ia, ib, ma, mb in zip(got[1], ref[1], got[2], ref[2]):
        assert ia.dtype == ib.dtype == np.uint8
        both = (ma > 0) & (mb > 0)
        assert np.abs(ia.astype(np.float32) - ib)[both].max() < 1e-3
    again = tbench.build_rig((64, 96), device="cpu")
    assert len(list((tmp_path / "port").iterdir())) == 1
    for x, y in zip(again[1] + again[2], got[1] + got[2]):
        np.testing.assert_array_equal(x, y)


# The two cases of tests/test_bench.py.
MERGE_CASES = [
    ({"stereo": {"matching_s": 1.0, "total_s": 1.0, "views_per_s": 2.0,
                 "stages_s": {"stereo": 1.0}, "mesh": {}, "chip": "TPU v5 lite"},
      "kernels": {"kernels": {"refine": {"seconds": 0.05}}, "chip": "TPU v5 lite"}},
     {"stereo": 1, "full": 2, "kernels": 1}),
    ({"stereo": {"matching_s": 1.0, "views_per_s": 2.0, "chip": "c"},
      "full": {"matching_s": 14.0, "total_s": 44.0, "views_per_s": 0.18,
               "stages_s": {}, "mesh": {"surface_rmse": 0.0076}, "chip": "c"}},
     {"stereo": 1, "full": 1}),
]


@pytest.mark.parametrize("results, attempts", MERGE_CASES)
def test_merge_and_print_is_the_reference_line(capsys, results, attempts):
    jbench.merge_and_print(results, attempts)
    ref = json.loads(capsys.readouterr().out.strip())
    tbench.merge_and_print(results, attempts, "NVIDIA H100 80GB HBM3, 700.00 W")
    got = json.loads(capsys.readouterr().out.strip())
    assert got.pop("card") == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert got == ref


@pytest.mark.parametrize("H, W", [(1920, 1280), (64, 128)])
def test_kernel_sweep_bounds_are_exactly_64_shifts(H, W):
    """The kernel cells' bounds span the 64 shifts the cost model counts,
    s in [0, 63], and are the reference bench's (bench.py:275-277)."""
    lo, hi = tbench.sweep_bounds(H, W, 64, "cpu")
    x = np.arange(W, dtype=np.int32)[None, :]
    lo, hi = lo.numpy(), hi.numpy()
    assert (lo - x).min() == 0 and (hi - x).max() == 63
    span = hi - lo + 1
    assert span.max() <= 64 and span.min() >= 1
    np.testing.assert_array_equal(lo, np.broadcast_to(x, (H, W)))
    np.testing.assert_array_equal(hi, np.minimum(lo + 63, W - 1))


def test_kernels_phase_on_the_cpu():
    out = tbench.measure_kernels("h100", "cpu", **SMALL_KERNELS)
    assert tuple(out) == CELLS
    costs = {"ncc_sweep": tprof.ncc_sweep_cost(48, 80, 3, 2, 16),
             "ncc_sweep_mxu": tprof.ncc_sweep_cost(48, 80, 3, 2, 16),
             "refine": tprof.refine_cost(48, 80, 30, 128, build_shifts=40),
             "ba_schur": tprof.schur_cost(256, 4, 4)}
    for name, cell in out.items():
        assert set(cell) == {"seconds"} | UTIL_KEYS
        assert cell["seconds"] > 0
        assert cell == dict(seconds=cell["seconds"],
                            **costs[name].utilization(cell["seconds"]))


@pytest.mark.parametrize("env, phases", [
    ({}, ["kernels", "stereo", "full"]),
    ({"RECON_BENCH_MODE": "stereo"}, ["stereo"]),
    ({"RECON_BENCH_KERNELS": "0"}, ["stereo", "full"]),
    ({"RECON_BENCH_PHASE": "kernels"}, ["kernels"]),
    ({"RECON_BENCH_PHASE": "full", "RECON_BENCH_KERNELS": "0"}, ["full"]),
])
def test_phases_the_environment_selects(clean_env, env, phases):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert tbench.phases_to_run() == phases


@pytest.mark.parametrize("env", [{"RECON_BENCH_PHASE": "link"},
                                 {"RECON_BENCH_MODE": "fast"}])
def test_unknown_phase_or_mode_is_refused(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError):
        tbench.phases_to_run()


def test_the_bench_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        return  # a card is present: the refusal cannot be shown here
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.run_phase("kernels")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main()


def small_run(env, tmp_path, capsys):
    for k, v in dict(RECON_BENCH_PAIRS="1", RECON_BENCH_LEVELS="2",
                     RECON_BENCH_BASE="40x60", RECON_BENCH_GRID="32",
                     RECON_BENCH_REPS="1").items():
        env.setenv(k, v)
    env.setattr(tbench, "CACHE", str(tmp_path))
    rc = tbench.main(device="cpu", kernel_kw=SMALL_KERNELS)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


def test_whole_bench_on_the_cpu(clean_env, tmp_path, capsys):
    rc, line, _ = small_run(clean_env, tmp_path, capsys)
    assert rc == 0
    assert set(line) == LINE_KEYS
    assert line["metric"] == "views_fused_per_sec_per_chip" and line["unit"] == "views/s"
    assert line["value"] == pytest.approx(2.0 / line["total_s"], abs=1e-4, rel=1e-3)
    assert line["vs_baseline"] == round(line["value"] / 0.017, 2)
    assert set(line["mesh"]) == {"verts", "faces", "cloud_points", "surface_rmse"}
    assert line["mesh"]["verts"] > 0
    assert set(line["host"]) == {"rss_mb", "load1", "cpu_over_wall"}
    assert len(line["all_runs_s"]) == 2
    assert line["matching_s"] == line["stages_s"]["stereo"]
    assert set(line["stereo_only"]) == {"matching_s", "views_per_s"}
    assert tuple(line["kernels"]) == CELLS
    assert line["phase_attempts"] == {"kernels": 1, "stereo": 1, "full": 1}
    assert line["card"] == "cpu"
    assert line["chip"].startswith("cpu")


def test_a_failed_phase_is_reported_and_exits_nonzero(clean_env, tmp_path, capsys):
    """The full phase raises: the line still comes, with the stereo
    protocol's value and "full_error", and the exit code is 1."""
    def broken(*a, **k):
        raise RuntimeError("full phase broken on purpose")

    clean_env.setenv("RECON_BENCH_KERNELS", "0")
    clean_env.setattr(tbench, "run_full", broken)
    rc, line, err = small_run(clean_env, tmp_path, capsys)
    assert rc == 1
    assert "full_error" in line and line["value"] > 0
    assert line["phase_attempts"] == {"stereo": 1, "full": 1}
    assert "full phase broken on purpose" in err


def test_ba_problem_is_well_posed():
    """The ba_schur cell's problem: Gauss-Newton steps lower the cost and
    stay finite (the JAX bench's one-pose problem gives a singular system)."""
    from reconstruction_tpu_torch.ba.bundle_adjust import ba_step
    prob, Rt_true, pts = tbench.ba_problem(4, 256, 4, device="cpu")
    assert prob.obs_cam.shape == (256, 4) and Rt_true.shape == (4, 3, 4)
    assert all(len(set(row)) == 4 for row in prob.obs_cam.tolist())
    poses, points = torch.zeros((4, 6)), prob.points0
    costs = []
    for _ in range(3):
        poses, points, cost = ba_step(prob, poses, points, 4)
        costs.append(float(cost))
    assert costs[-1] < 1e-3 * costs[0]
    assert torch.isfinite(poses).all() and torch.isfinite(points).all()
