"""The program's span log (`reconstruction_tpu_torch/utils/timing.span`): on
exactly while a torch.profiler session is active, nested per thread, on
the profiler's clock, and recorded where the work happens (`match_pair`,
the cloud filter, the mesh clean-up) without changing `Timer.spans`.

No JAX here: the `cuda` case runs on the card with
`python -m pytest --noconftest tests/test_torch_spans.py -q -m cuda`.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from reconstruction_tpu_torch.config import preset
from reconstruction_tpu_torch.pipeline.reconstruct import PairInput, reconstruct
from reconstruction_tpu_torch.stereo.pipeline import match_pair
from reconstruction_tpu_torch.utils import timing
from reconstruction_tpu_torch.utils.synthetic import make_stereo_scene

PAIR_CHILDREN = {"rectify", "rectify_map", "upload", "remap", "pyramid", "levels",
                 "triangulate"}
LEVEL_CHILDREN = {"match", "constraints", "rematch", "median", "refine"}
CLEANUP_STEPS = {"density", "density_trim", "small_components", "clean", "laplacian",
                 "close_holes"}


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def scene():
    cams, imgs, masks = make_stereo_scene(image_size=(160, 120), span_deg=24.0)
    return PairInput(image0=imgs[0], image1=imgs[1], mask0=masks[0], mask1=masks[1],
                     K0=np.asarray(cams[0].K), Rt0=np.asarray(cams[0].Rt),
                     K1=np.asarray(cams[1].K), Rt1=np.asarray(cams[1].Rt))


def tiny_config():
    cfg = preset("tiny")
    return cfg.replace(surface=dataclasses.replace(cfg.surface, grid_resolution=32))


def test_off_records_nothing():
    mark = timing.span_mark()
    a, b = timing.span("a"), timing.span("b")
    assert a is b
    with a:
        with timing.span("c"):
            pass
    t = timing.Timer("cpu")
    with t.span("stage"):
        pass
    assert timing.span_mark() == mark and timing.span_records(mark) == []
    assert list(t.spans) == ["stage"]


def test_on_nests_per_thread():
    def work(outer, inner, ready):
        with timing.span(outer):
            ready.wait(5)
            with timing.span(inner):
                pass

    ready = threading.Barrier(2)
    with cpu_profile():
        mark = timing.span_mark()
        other = threading.Thread(target=work, args=("t_outer", "t_inner", ready))
        other.start()
        work("m_outer", "m_inner", ready)
        other.join(10)
    assert not other.is_alive()
    recs = {r.name: r for r in timing.span_records(mark)}
    assert set(recs) == {"t_outer", "t_inner", "m_outer", "m_inner"}
    assert recs["m_inner"].parent == "m_outer" and recs["m_outer"].parent is None
    assert recs["t_inner"].parent == "t_outer" and recs["t_outer"].parent is None
    assert recs["m_outer"].thread == threading.get_ident()
    assert recs["t_outer"].thread != recs["m_outer"].thread
    for inner, outer in (("m_inner", "m_outer"), ("t_inner", "t_outer")):
        assert recs[outer].start_ns <= recs[inner].start_ns <= recs[inner].end_ns
        assert recs[inner].end_ns <= recs[outer].end_ns
    # after the session: off again
    assert timing.span("x") is timing.span("y")


def test_span_log_is_bounded_and_read_from_a_mark(monkeypatch):
    monkeypatch.setattr(timing, "_LOG", timing.deque(maxlen=3))
    with cpu_profile():
        mark = timing.span_mark()
        for i in range(5):
            with timing.span(f"s{i}"):
                pass
        mid = timing.span_mark()
        with timing.span("last"):
            pass
    assert [r.name for r in timing.span_records(mark)] == ["s3", "s4", "last"]
    assert [r.name for r in timing.span_records(mid)] == ["last"]
    assert timing.span_records(timing.span_mark()) == []


def test_span_holds_a_record_function_event():
    """The span's clock is the profiler's: an event recorded inside the
    span lies inside it."""
    with cpu_profile() as prof:
        mark = timing.span_mark()
        with timing.span("outer"):
            with record_function("probe"):
                torch.ones(64).sum()
    rec, = timing.span_records(mark)
    probe = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe"]
    assert len(probe) == 1
    start = probe[0].start_ns()
    assert rec.start_ns <= start <= start + probe[0].duration_ns() <= rec.end_ns


def test_timer_keeps_its_synchronization(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    t = timing.Timer("cpu")
    t.sync = True
    with t.span("off"):
        pass
    off = len(calls)
    with cpu_profile():
        mark = timing.span_mark()
        with t.span("on"):
            pass
    assert off == 2 and len(calls) == 4
    assert list(t.spans) == ["off", "on"]
    assert [r.name for r in timing.span_records(mark)] == ["on"]


def test_match_pair_records_its_children(scene):
    cfg = preset("tiny")
    p = scene
    with cpu_profile():
        mark = timing.span_mark()
        match_pair(cfg, p.image0, p.image1, p.mask0, p.mask1, p.K0, p.Rt0, p.K1, p.Rt1,
                   device="cpu")
    recs = timing.span_records(mark)
    root, = [r for r in recs if r.name == "match_pair"]
    assert root.parent is None
    by_parent = {}
    for r in recs:
        by_parent.setdefault(r.parent, []).append(r)
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    assert {r.name for r in by_parent["match_pair"]} == PAIR_CHILDREN
    assert [r.name for r in by_parent["match_pair"]].count("rectify_map") == 2
    assert [r.name for r in by_parent["match_pair"]].count("upload") == 2
    assert [r.name for r in by_parent["match_pair"]].count("remap") == 2
    levels = [f"level{k}" for k in range(cfg.pyramid_levels)]
    assert [r.name for r in by_parent["levels"]] == levels
    for lv in levels:
        assert {r.name for r in by_parent[lv]} == LEVEL_CHILDREN
    # the children are back to back inside the pair: they cover most of it
    covered = sum(r.end_ns - r.start_ns for r in by_parent["match_pair"])
    assert covered > 0.9 * (root.end_ns - root.start_ns)


def test_timer_spans_unchanged_under_a_profiler(scene):
    cfg = tiny_config()
    plain = reconstruct(cfg, [scene], device="cpu")
    with cpu_profile():
        mark = timing.span_mark()
        traced = reconstruct(cfg, [scene], device="cpu")
    recs = timing.span_records(mark)
    assert list(traced.timer.spans) == list(plain.timer.spans)
    names = {r.name for r in recs}
    assert set(plain.timer.spans) <= names
    parents = {r.name: r.parent for r in recs}
    assert parents["sor"] == parents["normals"] == "pair0/filter"
    assert parents["match_pair"] == "pair0/stereo"
    for step in CLEANUP_STEPS:
        assert parents[step] == "mesh_cleanup"
    np.testing.assert_array_equal(traced.vertices, plain.vertices)


@pytest.mark.cuda
def test_device_interval_inside_its_span():
    """On the card: a kernel launched inside a span, then synchronized
    inside it, runs inside the span on the profiler's device clock."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    x = torch.ones(1 << 24, device="cuda")
    for _ in range(3):                       # a session's first events may be dropped
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            mark = timing.span_mark()
            with timing.span("kernel"):
                y = x * 2.0 + 1.0
                torch.cuda.synchronize()
        dev = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
        if dev:
            break
    assert dev, "the profiler recorded no device event"
    rec, = timing.span_records(mark)
    slack = 50_000
    for e in dev:
        assert rec.start_ns - slack <= e.start_ns(), (rec, e.start_ns())
        assert e.start_ns() + e.duration_ns() <= rec.end_ns + slack, (rec, e.start_ns())
    assert float(y[0]) == 3.0
