"""The render loop's recorder (``gvr_tpu_torch.utils.profiling``): off
unless a torch.profiler runs or a RenderStats collects; under the
profiler, the spans and counters of each render path on the profiler's
own clock, ranges in its trace only where the program annotates it; and
the benchmark's per-layer readers of them (``benchmark_torch/metrics``)."""

import contextlib
import functools
import math
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_common  # noqa: F401  (sets torch threads)
from benchmark_torch import spec
from gvr_tpu_torch.cameras import PinholeCamera
from gvr_tpu_torch.config import RenderConfig
from gvr_tpu_torch.integrators.multiscatter import render_multiscatter
from gvr_tpu_torch.scene.generators import random_gaussian_scene
from gvr_tpu_torch.scene.scene import parse_gmm
from gvr_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
ITERATION, LIVE_READ = profiling.ITERATION_SPANS
# path: (Gaussians, RenderConfig's keys, its kernel)
PATHS = {"mega": (24, dict(spp=2), "mega"),
         "step": (24, dict(spp=2, wavefront="step"), "step"),
         "big": (2100, dict(spp=1, engine="dense"), "big"),
         "grid": (2100, dict(spp=1, engine="grid"), "grid")}


@functools.cache
def _scene(n: int):
    return parse_gmm(random_gaussian_scene(n, seed=0), device="cpu")


def _render(path: str, stats) -> None:
    n, kw, _ = PATHS[path]
    cam = PinholeCamera.create([0, 1, 6], [0, 1, 0], math.radians(45.0),
                               device="cpu")
    render_multiscatter(_scene(n), cam, RenderConfig(width=8, height=8,
                                                     **kw),
                        device="cpu", stats=stats)


def _traced(path: str, annotate: bool = False):
    """(stats, recording, Kineto user annotations as {name: [(start,
    end)]}) of one render under torch.profiler, inside
    ``profiling.annotating()`` where ``annotate``."""
    profiling.recorded().clear()
    stats = {}
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with profiling.annotating() if annotate else contextlib.nullcontext():
            _render(path, stats)
    finally:
        prof.stop()
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            marks.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return stats, profiling.recorded(), marks


def test_a_render_records_nothing_by_default(monkeypatch):
    """No profiler and no RenderStats: nothing recorded, no
    record_function opened, every span site the one null context."""
    opened = []
    real = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or real(*a, **k))
    profiling.recorded().clear()
    for path in ("mega", "step"):
        _render(path, {})
    assert opened == []
    assert profiling.recorded().spans == []
    assert profiling.recorded().counters == {}
    assert profiling.span("chunk") is profiling.span("render.prepare", a=1)
    profiling.count("lanes_traced", 5)
    assert profiling.recorded().counters == {}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_traced_render_records_its_spans_and_counters(path):
    """Under torch.profiler().start(): the root span, render.prepare,
    the chunks, one wavefront.iteration per iteration each with one
    wavefront.live_read child, render.readback, and the wavefronts'
    counters, lanes_traced equal to the render's bounce evaluations; and
    no range in the profiler's trace, which the program did not
    annotate."""
    stats, rec, marks = _traced(path)
    assert not {s.name for s in rec.spans} & set(marks)
    assert stats["kernel"] == PATHS[path][2]
    by_id = {s.id: s for s in rec.spans}
    named = lambda name: [s for s in rec.spans if s.name == name]
    assert rec.renders() == 1
    (root,) = [s for s in rec.spans if s.parent is None]
    assert root.name == "render_multiscatter" and root.extra["paths"] == \
        64 * PATHS[path][1]["spp"]
    assert len({s.render for s in rec.spans}) == 1
    for name in ("render.prepare", "render.readback"):
        (s,) = named(name)
        assert s.parent == root.id
    chunks = named("chunk")
    assert len(chunks) == stats["chunks"]
    assert all(c.parent == root.id for c in chunks)
    iters = named(ITERATION)
    assert len(iters) == stats["iterations"]
    assert all(by_id[s.parent].name == "chunk" for s in iters)
    reads = {}
    for s in named(LIVE_READ):
        reads[s.parent] = reads.get(s.parent, 0) + 1
    assert all(reads.get(s.id) == 1 for s in iters)
    # and one before each chunk's first iteration
    assert sum(reads.values()) == len(iters) + (len(chunks) if iters
                                                else 0)
    for s in rec.spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    if path == "mega":
        assert rec.counters == {}
    else:
        counters = rec.counters[root.render]
        assert counters["lanes_traced"] == stats["bounce_evals"]
        assert counters["lane_slots"] == 64 * stats["iterations"]
    if path == "grid":
        grids = named("grid_for")
        assert grids and grids[-1].extra == {"built": False}
        assert all(by_id[g.parent].name == "render.prepare" for g in grids)


@pytest.mark.parametrize("path", ["step", "grid"])
def test_recorded_spans_are_on_the_profilers_clock(path):
    """Each recorded span lies within 1 ms of the Kineto user annotation
    of the same name and order, where the program annotates the trace: a
    clock of its own would be off by seconds or more."""
    _, rec, marks = _traced(path, annotate=True)
    names = {s.name for s in rec.spans}
    assert {"render_multiscatter", "chunk", ITERATION} <= names
    for name in names:
        ours = sorted((s.start_ns, s.end_ns) for s in rec.spans
                      if s.name == name)
        theirs = sorted(marks[name])
        assert len(ours) == len(theirs), name
        for (a0, a1), (b0, b1) in zip(ours, theirs):
            assert abs(a0 - b0) < 1_000_000 and abs(a1 - b1) < 1_000_000, \
                (name, a0 - b0, a1 - b1)


@pytest.mark.parametrize("path", ["mega", "big"])
def test_the_benchmark_reads_the_recording(path):
    """prepare_ms, iteration_host_us and lane_fill_pct from the
    recording, and None where it is empty, or its renders are not the
    profiled ones."""
    read = {m: spec.reader(REPO, m) for m in
            ("prepare_ms", "iteration_host_us", "lane_fill_pct")}
    _, rec, _ = _traced(path)
    run = dict(trace=dict(renders=1))
    dur = lambda s: s.end_ns - s.start_ns
    (prep,) = [s for s in rec.spans if s.name == "render.prepare"]
    assert read["prepare_ms"](run) == dur(prep) / 1e6
    iters = [s for s in rec.spans if s.name == ITERATION]
    own = [dur(i) - sum(dur(r) for r in rec.spans
                        if r.name == LIVE_READ and r.parent == i.id)
           for i in iters]
    totals = rec.totals()
    if path == "mega":
        assert read["iteration_host_us"](run) is None
        assert read["lane_fill_pct"](run) is None
    else:
        assert read["iteration_host_us"](run) == sum(own) / len(own) / 1e3
        assert read["lane_fill_pct"](run) == \
            100.0 * totals["lanes_traced"] / totals["lane_slots"]
        assert 0 < read["lane_fill_pct"](run) <= 100
    for bad in (dict(trace=dict(renders=2)), dict(trace=None)):
        assert all(r(bad) is None for r in read.values())
    rec.clear()
    assert all(r(run) is None for r in read.values())


def test_render_stats_collect_and_sum_the_iterations():
    """A RenderStats given to a wavefront render collects its spans and
    counters without a profiler; its report sums the iterations' spans
    into a line a name."""
    profiling.recorded().clear()
    stats = profiling.RenderStats()
    _render("step", stats)
    assert profiling.recorded().spans == []
    names = [s.name for s in stats.spans]
    assert names.count(ITERATION) == stats["iterations"] > 0
    assert stats.counters["lanes_traced"] == stats["bounce_evals"]
    report = stats.report().splitlines()
    assert f"spans={stats['iterations']}" in \
        [x for x in report if x.startswith(f"[gvr] {ITERATION}:")][0]
    assert sum(x.startswith(f"[gvr] {ITERATION}:") for x in report) == 1
    assert report[-1].startswith("[gvr] counters: lanes_traced=")
