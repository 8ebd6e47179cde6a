"""The port's scaling harness (`reconstruction_tpu_torch/tools/bench_scaling.py`)
on the CPU: worlds of 1, 2 and 4 gloo ranks on the pair axis and 2 on the
frame axis at --base 40 30 --levels 2, started by the harness itself in
two threads at the module's first test, while the pytest process computes
the JAX references.

The final disparities of every world are bit-equal to the JAX tool's
recipe (`reconstruction_tpu.parallel.sharded.match_level_pairs_sharded` on
a JAX CPU mesh of the same size, fed the same seeded, quantized pyramids)
and to a chain of `match_one_level` calls in this process; the harness
compares them through `pair_digests` (sha256 of the float32 bytes), so
the tolerance is exact equality.  On the CPU the wrappers launch nothing,
so `launches_per_pair` counts the calls of the kernels' plain versions
(`launches_from`: "plain calls").

The `cuda` case runs a world of 2 gloo ranks on the card and skips here;
on the card: python -m pytest --noconftest tests/test_torch_bench_scaling.py -q -m cuda
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from reconstruction_tpu_torch.tools import bench_scaling as bs

LEVELS = 2
BASE = (40, 30)
PAIR_WORLDS = (1, 2, 4)
JAX_KEYS = {"axis", "devices", "pairs", "finest", "levels", "wall_s", "views_per_sec",
            "cpu_s_per_pair", "wall_eff_vs_host_bound", "cpu_eff"}
PORT_KEYS = {"backend", "cards", "card", "launches_per_pair", "launches_from",
             "kernel_ms_per_pair", "dev_eff", "wall_eff_vs_card_bound", "comm_bytes",
             "digest"}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The pair axis through `main` (flags and --json), the frame axis
    through `run_axis`, side by side."""
    path = str(tmp_path_factory.mktemp("scaling") / "scaling.json")
    argv = ["--device", "cpu", "--base", *map(str, BASE), "--levels", str(LEVELS),
            "--counts", *map(str, PAIR_WORLDS), "--repeats", "1", "--json", path]
    with ThreadPoolExecutor(2) as pool:
        pair = pool.submit(bs.main, argv)
        frame = pool.submit(bs.run_axis, "frame", (2,), LEVELS, BASE, 1, "cpu")
        yield dict(pair=pair, frame=frame, path=path)


@pytest.fixture(scope="module")
def records(jobs):
    assert jobs["pair"].result() == 0
    with open(jobs["path"]) as f:
        pair = json.load(f)
    return {("pair", r["devices"]): r for r in pair} | {
        ("frame", r["devices"]): r for r in jobs["frame"].result()}


@pytest.fixture(scope="module")
def chain():
    """The recipe as a chain of `match_one_level` calls, pair by pair."""
    return bs.reference_digests(max(PAIR_WORLDS), LEVELS, BASE, "cpu")


@pytest.fixture(scope="module")
def jax_digests(jobs):
    """The JAX tool's recipe at worlds of 1 and 2, computed while the
    harness's worlds run."""
    return {n: _jax_digests(n) for n in (1, 2)}


def _jax_digests(P: int) -> list:
    """The JAX tool's recipe on a JAX CPU mesh of P devices (tests/conftest.py
    gives 8), P pairs, its pyramid levels rounded to the uint8 grid."""
    import jax
    import jax.numpy as jnp
    from reconstruction_tpu.core.pyramid import build_pyramid
    from reconstruction_tpu.parallel.mesh import make_mesh
    from reconstruction_tpu.parallel.sharded import match_level_pairs_sharded
    from reconstruction_tpu_torch.stereo.pipeline import LevelState

    W0, H0 = BASE
    batch = bs.make_batch(P, H0 << (LEVELS - 1), W0 << (LEVELS - 1))
    pyr = [[jnp.clip(jnp.round(level), 0, 255)
            for level in jax.vmap(lambda a: build_pyramid(a, LEVELS))(jnp.asarray(b))]
           for b in batch]
    mesh = make_mesh(jax.devices("cpu")[:P], frame=1, pair=P, tile=1)
    state = None
    for level in range(LEVELS):
        state = match_level_pairs_sharded(mesh, pyr[0][level], pyr[1][level], pyr[2][level],
                                          pyr[2][level], state, level, axis="pair",
                                          refine_iters=6 + 6 * level)
    return bs.pair_digests(LevelState(disp0=torch.tensor(np.asarray(state.disp0)),
                                      disp1=torch.tensor(np.asarray(state.disp1))))


@pytest.mark.parametrize("n", (1, 2))
def test_sharded_recipe_equals_the_jax_tools(jax_digests, records, n):
    assert records[("pair", n)]["digest"] == jax_digests[n]


@pytest.mark.parametrize("axis, n", [("pair", n) for n in PAIR_WORLDS] + [("frame", 2)])
def test_worlds_equal_the_match_one_level_chain(records, chain, axis, n):
    rec = records[(axis, n)]
    assert rec["pairs"] == n
    assert rec["digest"] == chain[:n]


def test_launches_per_pair_equal_across_worlds(records):
    # Per pair and level: K1 twice in each direction (brute or guided, then
    # rematch), K3 once in each, K2 once a 6-sweep window in each (levels
    # 0 and 1 refine 6 and 12 sweeps, the latter re-extracted at 6).
    want = {"ncc_sweep": 8.0, "cost_volume": 4.0, "refine_sweeps_fused": 6.0}
    for rec in records.values():
        assert rec["launches_from"] == "plain calls"
        assert rec["launches_per_pair"] == want


def test_line_keys_are_a_superset_of_the_jax_tools(records):
    for (axis, n), rec in records.items():
        assert JAX_KEYS | PORT_KEYS <= set(rec)
        assert (rec["axis"], rec["devices"], rec["levels"]) == (axis, n, LEVELS)
        assert rec["finest"] == [BASE[0] << (LEVELS - 1), BASE[1] << (LEVELS - 1)]
        assert rec["backend"] == "gloo" and rec["cards"] == 0 and rec["card"] == "cpu"
        assert rec["kernel_ms_per_pair"] is None and rec["dev_eff"] is None
        assert rec["wall_eff_vs_card_bound"] is None
        assert rec["views_per_sec"] == pytest.approx(2 * n / rec["wall_s"])
        # every rank's block of the pairs comes back by all_gather, level by level
        assert rec["comm_bytes"] > 0


def test_first_count_is_its_own_base(records):
    rec = records[("pair", 1)]
    assert rec["cpu_eff"] == 1.0 and rec["wall_eff_vs_host_bound"] == 1.0


def test_efficiency_formulas():
    base = dict(devices=1, wall_s=2.0, cpu_s_per_pair=3.0, kernel_ms_per_pair=10.0,
                cards=1)
    rec = dict(devices=4, wall_s=5.0, cpu_s_per_pair=4.0, kernel_ms_per_pair=12.5,
               cards=1)
    eff = bs.efficiencies(base, rec, cores=2)
    assert eff["wall_eff_vs_host_bound"] == pytest.approx(2.0 * 4 / 2 / 5.0)
    assert eff["cpu_eff"] == pytest.approx(3.0 / 4.0)
    assert eff["wall_eff_vs_card_bound"] == pytest.approx(2.0 * 4 / 1 / 5.0)
    assert eff["dev_eff"] == pytest.approx(10.0 / 12.5)
    eff = bs.efficiencies(base, dict(rec, cards=4), cores=8)
    assert eff["wall_eff_vs_host_bound"] == pytest.approx(2.0 / 5.0)
    assert eff["wall_eff_vs_card_bound"] == pytest.approx(2.0 / 5.0)
    eff = bs.efficiencies(dict(base, kernel_ms_per_pair=None),
                          dict(rec, cards=0, kernel_ms_per_pair=None), cores=8)
    assert eff["dev_eff"] is None and eff["wall_eff_vs_card_bound"] is None


def test_without_cuda_the_harness_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bs.run_axis("pair", (1,), LEVELS, BASE, 1)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bs.main(["--counts", "1"])


def test_count_above_the_cores_is_skipped(capsys):
    n = bs.host_cores() + 1
    assert bs.run_axis("pair", (n,), LEVELS, BASE, 1, "cpu") == []
    err = capsys.readouterr().err
    assert f"count {n} skipped" in err and "cores" in err


def test_backend_choice(monkeypatch):
    assert bs.choose_backend(4, "cpu") == "gloo"
    with pytest.raises(ValueError, match="NCCL"):
        bs.choose_backend(1, "cpu", "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert bs.choose_backend(2, "cuda") == "nccl"
    assert bs.choose_backend(4, "cuda") == "gloo"
    assert bs.choose_backend(1, "cuda", "gloo") == "gloo"
    with pytest.raises(ValueError, match="refuses two ranks"):
        bs.choose_backend(4, "cuda", "nccl")


@pytest.mark.parametrize("counts, backend", [((1, 2), "nccl"), ((1, 2, 4), "gloo"),
                                             ((4, 1), "gloo")])
def test_one_backend_for_every_count(monkeypatch, counts, backend):
    """On a host of 2 cards the world of 4 ranks needs gloo, and so does
    every count of its run: the base shares the counts' collective path."""
    from reconstruction_tpu_torch.ops import _build
    from reconstruction_tpu_torch.parallel import launch
    from reconstruction_tpu_torch.utils import profiling
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(_build, "load", lambda: None)
    monkeypatch.setattr(profiling, "card_line", lambda device="cuda": "a card, 700 W")
    monkeypatch.setattr(bs, "host_cores", lambda: 8)
    used = []

    def fake_world(fn, n, device, *args, backend=None):
        used.append(backend)
        return [dict(seconds=dict(setup=0.0, warm=0.0, profile=0.0, sessions=1),
                     digest=["d"] * n, walls=[1.0], cpus=[1.0], launches={"ncc_sweep": 1},
                     kernel_ms=1.0, device=f"cuda:{r % 2}", comm_bytes=8) for r in range(n)]

    monkeypatch.setattr(launch, "run_local", fake_world)
    recs = bs.run_axis("pair", counts, LEVELS, BASE, 1, "cuda")
    assert used == [backend] * len(counts)
    assert [r["backend"] for r in recs] == [backend] * len(counts)


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    recs = bs.run_axis("pair", (1, 2), LEVELS, BASE, 1, "cuda", "gloo")
    assert [r["devices"] for r in recs] == [1, 2]
    assert recs[0]["launches_per_pair"] == recs[1]["launches_per_pair"]
    assert min(recs[0]["launches_per_pair"].values()) > 0
    assert recs[1]["digest"][:1] == recs[0]["digest"]
    assert recs[1]["digest"] == bs.reference_digests(2, LEVELS, BASE, "cuda")
    assert all(r["kernel_ms_per_pair"] > 0 and r["cards"] == 1 for r in recs)
