"""The tensor gather of the port's production pair-sharded stereo
(`parallel/production.match_pairs_sharded`, `gather_results`) on gloo
ranks on the CPU: 3 pairs over 2 ranks and 5 pairs over 4 (padded lanes,
and a rank with no pair), every rank holding every pair's result in input
order, bit-equal to the sequential `match_pair`, on its own device; results
whose shapes differ by rank and by item; the collectives `COMM` counts; and
the spans under a profiler session (a call on no pair: the profiler's
own cost grows with the work it records).  Both worlds start before the module's
first test and run while the pytest process computes the sequential
references; each has 55 s."""

import os
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from reconstruction_tpu_torch.config import preset
from reconstruction_tpu_torch.parallel.launch import run_local
from reconstruction_tpu_torch.pipeline.reconstruct import PairInput
from reconstruction_tpu_torch.stereo.pipeline import match_pair
from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_work as work  # noqa: E402

CFG = preset("tiny").replace(pyramid_levels=2, lowest_level_size=(48, 40),
                             cam_pairs=((0, 1), (2, 3), (1, 2), (3, 4), (0, 2)))
WORLDS = {2: 3, 4: 5}            # ranks: pairs
SPANS = ["gather", "gather_meta", "gather_tensors", "local"]
ALIGN = 16


def _pairs(n):
    cams, imgs, masks = make_stereo_scene(image_size=(96, 80), span_deg=24.0, num_cameras=5,
                                          device="cpu")
    return [PairInput(image0=imgs[a], image1=imgs[b], mask0=masks[a], mask1=masks[b],
                      K0=np.asarray(cams[a].K), Rt0=np.asarray(cams[a].Rt),
                      K1=np.asarray(cams[b].K), Rt1=np.asarray(cams[b].Rt))
            for a, b in CFG.cam_pairs[:n]]


@pytest.fixture(scope="module")
def scene():
    return _pairs(max(WORLDS.values()))


@pytest.fixture(scope="module", autouse=True)
def worlds(scene):
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        yield {w: pool.submit(run_local, work.gather, w, "cpu",
                              CFG.replace(cam_pairs=CFG.cam_pairs[:n]), scene[:n], timeout=55)
               for w, n in WORLDS.items()}


@pytest.fixture(scope="module")
def sequential(scene):
    """Each pair's sequential `match_pair`, with the ranks' thread count."""
    torch.set_num_threads(work.THREADS)
    return [match_pair(CFG, p.image0, p.image1, p.mask0, p.mask1, p.K0, p.Rt0, p.K1, p.Rt1,
                       device="cpu") for p in scene]


@pytest.fixture(scope="module")
def ranks(worlds):
    return {w: f.result() for w, f in worlds.items()}


def assert_same(got, want, where="result"):
    """Nested host values equal: arrays bit for bit, with their dtypes."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        assert got.shape == want.shape, where
        np.testing.assert_array_equal(np.ascontiguousarray(got).reshape(-1).view(np.uint8),
                                      np.ascontiguousarray(want).reshape(-1).view(np.uint8),
                                      err_msg=where)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


def _aligned_bytes(results):
    return sum(-(-t.numel() * t.element_size() // ALIGN) * ALIGN
               for r in results for t in work.tensors_of(r))


def _blocks(n, world):
    per = -(-n // world)
    return [list(range(r * per, min((r + 1) * per, n))) for r in range(world)]


CASES = [(w, r, pi) for w, n in WORLDS.items() for r in range(w) for pi in range(n)]


@pytest.mark.parametrize("world,rank,pi", CASES)
def test_every_pair_on_every_rank(ranks, sequential, world, rank, pi):
    """Pair ``pi`` on ``rank`` equals the sequential `match_pair` in every
    field, tensors bit for bit, in input order."""
    got = ranks[world][rank]["pairs"]
    assert len(got) == WORLDS[world]
    assert_same(got[pi], work.arrays_of(sequential[pi]), f"pair {pi} on rank {rank}")


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_results_on_the_rank_device(ranks, world):
    for r, out in enumerate(ranks[world]):
        assert out["rank"] == r
        assert out["devices"] == [out["device"]] == out["odd_devices"]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_shapes_differ(ranks, world):
    """Rank r sends r + 1 results whose shapes depend on r and the item;
    every rank holds them all, in rank order, bit for bit."""
    want = [work.arrays_of(work.odd_result(r, i)) for r in range(world) for i in range(r + 1)]
    for out in ranks[world]:
        assert out["odd_types"] == ["Odd"] * len(want)
        assert_same(out["odd"], want, f"rank {out['rank']}")


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_comm_counts_the_gather(ranks, sequential, world):
    """Two collectives a gather: the object gather of the host values and
    the layout (a few kB a pair), and the byte buffer, padded to the largest
    rank's (`COMM` counts what a rank sends)."""
    blocks = _blocks(WORLDS[world], world)
    width = max(_aligned_bytes([sequential[pi] for pi in b]) for b in blocks)
    odd_width = max(_aligned_bytes([work.odd_result(r, i) for i in range(r + 1)])
                    for r in range(world))
    meta_cap = 4096 + max(len(b) for b in blocks) * max(
        len(pickle.dumps(r.rectification)) + 2048 for r in sequential)
    for out in ranks[world]:
        assert out["comm"]["calls"] == 2 and out["odd_comm"]["calls"] == 2
        assert width < out["comm"]["bytes"] < width + meta_cap
        assert odd_width < out["odd_comm"]["bytes"] < odd_width + 4096


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_spans_under_the_profiler(ranks, world):
    for out in ranks[world]:
        assert out["timer"] == SPANS
        spans = {tuple(s) for s in out["spans"]}
        assert {("match_pairs_sharded", None), ("local", "match_pairs_sharded"),
                ("gather", "match_pairs_sharded"), ("gather_meta", "gather"),
                ("gather_tensors", "gather")} <= spans
        assert not any(name == "match_pair" for name, _ in spans)
