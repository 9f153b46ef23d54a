"""Render observability: the render loop's spans and counters,
throughput and the profiler trace.

Counterpart of ``gvr_tpu/utils/profiling.py``, with a recorder the JAX
package lacks.  ``span(name, **attrs)`` times a stretch of the host's
work and ``count(name, n)`` adds to a per-render counter; the render
loop (``integrators/multiscatter``, ``integrators/gridscatter``) calls
them at its boundaries, and ``render`` numbers each render.  They record
only while a ``torch.profiler`` runs or a ``RenderStats`` collects a
render; otherwise a span costs one flag check and returns a shared null
context.  Under the profiler each span is kept in ``recorded()`` with
its start and end on the profiler's own clock (``clock_ns``), its
parent, its render and its attributes; the counters are kept per
render.  Inside ``annotating()`` (``device_trace``, the trace the
program writes itself) each span is also a ``record_function`` range of
its name, so it sits in the Kineto trace and the Chrome trace beside the
kernels it launched.  Under another profiler it is not: a range that
launches kernels gets a twin on the device's timeline, which a reader of
that profiler's events may count as device activity (the benchmark's
``devtrace`` does with torch 2.11's events, which carry no activity
type).  No span or counter synchronises the device, reads a device value
or launches a kernel: counters take numbers the host holds already.

``RenderStats`` collects the same spans and counters and prints them in
the JAX package's format; it is also the dict of the last render's
summary that the integrators fill (engine, kernel, seconds, paths...).
``device_trace`` records the kernels' timeline with ``torch.profiler``
into a Chrome trace (the CLI's ``--trace``); unlike the JAX package's,
it raises where the profiler fails.  ``path_statistics`` traces a
subsample of pixel-centre paths with the multiscatter estimator's
survival rules and counts their rays and scatter events, the bounce
histogram behind the Mrays/s of ``gvr_tpu_torch.bench_series``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler

from gvr_tpu_torch.config import RenderConfig, Solver

TRACE_FILE = "trace.json"
# the spans of every wavefront iteration, which RenderStats.report sums
ITERATION_SPANS = ("wavefront.iteration", "wavefront.live_read")

# The profiler's clock: torch stamps its host events with the system
# clock in ns since the epoch (c10::getTime, read through the TSC and
# converted), which is time.time_ns().
clock_ns = time.time_ns


@dataclasses.dataclass
class Span:
    """A timed stretch: its name, seconds and attributes (``extra``); a
    recorded span also has its start and end (ns, ``clock_ns``), its id,
    its parent's id (None at the top) and its render (None outside
    one)."""
    name: str
    seconds: float
    extra: Dict
    start_ns: int = 0
    end_ns: int = 0
    id: int = -1
    parent: Optional[int] = None
    render: Optional[int] = None


class Recording:
    """What the recorder kept while a torch.profiler ran: the finished
    spans in the order they ended, and {render: {counter: total}}."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[Optional[int], Dict[str, int]] = {}

    def renders(self) -> int:
        """The number of renders with a span recorded."""
        return len({s.render for s in self.spans if s.render is not None})

    def totals(self) -> Dict[str, int]:
        """Each counter summed over the renders."""
        out: Dict[str, int] = {}
        for per in self.counters.values():
            for k, v in per.items():
                out[k] = out.get(k, 0) + v
        return out

    def self_ns(self) -> Dict[int, int]:
        """{span id: its duration less its recorded children's}."""
        own = {s.id: s.end_ns - s.start_ns for s in self.spans}
        for s in self.spans:
            if s.parent in own:
                own[s.parent] -= s.end_ns - s.start_ns
        return own

    def clear(self) -> None:
        self.spans.clear()
        self.counters.clear()


class _State:
    next_id = 0                     # spans opened in this process
    renders = 0                     # renders begun in this process
    render: Optional[int] = None    # the render in progress
    stack: List[int] = []           # the open spans' ids, innermost last
    collectors: list = []           # the RenderStats collecting now
    annotate = False                # spans are record_function ranges


_RECORDING = Recording()


def recorded() -> Recording:
    """The spans and counters recorded under torch.profiler so far in
    this process; ``recorded().clear()`` empties it."""
    return _RECORDING


class _NullSpan:
    def set(self, **attrs) -> None:
        pass


_NULL = contextlib.nullcontext(_NullSpan())


class _OpenSpan:
    __slots__ = ("name", "attrs", "id", "parent", "range", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        self.id = _State.next_id
        _State.next_id += 1
        self.parent = _State.stack[-1] if _State.stack else None
        _State.stack.append(self.id)
        self.range = None
        self.t0 = clock_ns()
        if _State.annotate:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = clock_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _State.stack.pop()
        s = Span(self.name, (t1 - self.t0) / 1e9, self.attrs, self.t0, t1,
                 self.id, self.parent, _State.render)
        if _profiler._is_profiler_enabled:
            _RECORDING.spans.append(s)
        for c in _State.collectors:
            c.spans.append(s)
        return False


def span(name: str, **attrs):
    """A context manager that times its body as the span ``name`` while
    recording is on (a torch.profiler runs, or a RenderStats collects),
    and a shared null context otherwise; ``as sp`` gives
    ``sp.set(**attrs)`` for attributes known only inside."""
    if not (_profiler._is_profiler_enabled or _State.collectors):
        return _NULL
    return _OpenSpan(name, attrs)


def count(name: str, n: int) -> None:
    """Add n, a number the host holds, to the render's counter ``name``
    while recording is on."""
    if not (_profiler._is_profiler_enabled or _State.collectors):
        return
    if _profiler._is_profiler_enabled:
        per = _RECORDING.counters.setdefault(_State.render, {})
        per[name] = per.get(name, 0) + n
    for c in _State.collectors:
        c.counters[name] = c.counters.get(name, 0) + n


@contextlib.contextmanager
def annotating():
    """Inside, each recorded span is also a ``record_function`` range of
    its name in the running profiler's trace."""
    outer, _State.annotate = _State.annotate, True
    try:
        yield
    finally:
        _State.annotate = outer


@contextlib.contextmanager
def render(name: str, stats=None):
    """The root span ``name`` of a render, which numbers the render (a
    per-process count) for the spans and counters inside; a
    ``RenderStats`` given as ``stats`` collects them."""
    _State.renders += 1
    outer, _State.render = _State.render, _State.renders
    collect = isinstance(stats, RenderStats)
    if collect:
        _State.collectors.append(stats)
    try:
        with span(name) as root:
            yield root
    finally:
        if collect:
            _State.collectors.remove(stats)
        _State.render = outer


class RenderStats(dict):
    """Named spans and counters with a compact report (``report``: the
    JAX package's format), and, as a dict, the summary of the last render
    (the keys an integrator's ``stats=`` dict receives).  Given as
    ``render_multiscatter``'s ``stats``, it collects the render's spans
    and counters."""

    def __init__(self):
        super().__init__()
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, **extra):
        _State.collectors.append(self)
        try:
            with span(name, **extra):
                yield
        finally:
            _State.collectors.remove(self)

    def add(self, name: str, seconds: float, **extra):
        self.spans.append(Span(name, seconds, extra))

    def report(self) -> str:
        """A line a span in the JAX package's format, those of the
        wavefront iterations summed into a line a name; the counters."""
        lines, summed = [], {}
        for s in self.spans:
            if s.name in ITERATION_SPANS:
                n, sec = summed.get(s.name, (0, 0.0))
                summed[s.name] = (n + 1, sec + s.seconds)
                continue
            kv = " ".join(f"{k}={v}" for k, v in s.extra.items())
            lines.append(f"[gvr] {s.name}: {s.seconds:.3f}s {kv}".rstrip())
        lines += [f"[gvr] {name}: {sec:.3f}s spans={n}"
                  for name, (n, sec) in summed.items()]
        if self.counters:
            lines.append("[gvr] counters: " + " ".join(
                f"{k}={v}" for k, v in self.counters.items()))
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Record the work inside the context with ``torch.profiler`` (CPU
    activity, and CUDA activity where a card is visible), the render
    loop's spans as ranges (``annotating``), and write its Chrome trace
    to ``log_dir/trace.json``.  A no-op when log_dir is
    empty; raises where the profiler cannot start (one is running
    already: a second would crash the process) or cannot export."""
    if not log_dir:
        yield
        return
    if torch.autograd.profiler._is_profiler_enabled:
        raise RuntimeError("device_trace: a profiler is running already")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof, annotating():
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def mrays_per_sec(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-9) / 1e6


def path_statistics(scene, camera, cfg: RenderConfig,
                    sample_pixels: int = 16384, device="cuda") -> dict:
    """{'rays_per_path', 'mean_scatter_events'} over at most
    ``sample_pixels`` pixel-centre paths spread over the image (sample 0):
    each bounce adds a ray for every live path and a shadow ray for each
    one that scatters; the throughput decays by the albedo and Russian
    roulette ends paths as in the wavefront.  The count holds [n, N]
    arrays, so n is capped by an element budget."""
    from gvr_tpu_torch.integrators.multiscatter import _roulette
    from gvr_tpu_torch.integrators.test_hit import pixel_rays
    from gvr_tpu_torch.kernels.rng import BOUNCE_DRAWS
    from gvr_tpu_torch.ops.sampling import dir_from_xi, uniform_planes
    from gvr_tpu_torch.ops.solvers import sample_free_flight
    from gvr_tpu_torch.ops.transmittance import (albedo_at_from_rg,
                                                 tau_coeffs)

    scene = scene.to(device)
    camera = camera.to(device)
    gmm = scene.medium
    budget = max(256, (3 << 25) // max(gmm.n, 1))
    n = min(sample_pixels, budget, cfg.width * cfg.height)
    ids = torch.from_numpy(np.linspace(0, cfg.width * cfg.height - 1, n,
                                       dtype=np.int32)).to(device)
    o, d = pixel_rays(camera, cfg, ids)
    thr = torch.ones((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    rays = bounces = 0
    for bounce in range(cfg.max_bounces):
        if not bool(alive.any()):
            break
        rg = tau_coeffs(gmm, o, d)
        xi = uniform_planes(ids, 0, bounce, BOUNCE_DRAWS, cfg.seed)
        target = -torch.log(torch.clamp(1.0 - xi[0], min=1e-12))
        t_sc, scattered = sample_free_flight(
            rg, target, cfg.solver, cfg.solver_iters,
            xi[8] if cfg.solver == Solver.UNIFORM else None,
            finisher=cfg.solver_finisher)
        hits = alive & scattered
        rays += int(alive.sum()) + int(hits.sum())
        bounces += int(hits.sum())
        t_pos = torch.clamp(t_sc, min=0.0)
        albedo = albedo_at_from_rg(rg, gmm.albedo, t_pos)
        thr_n, killed = _roulette(cfg, thr, albedo, bounce, xi[5])
        alive = hits & ~killed
        thr = torch.where(alive[:, None], thr_n, thr)
        o = o + t_pos[:, None] * d
        d = dir_from_xi(xi[6:8].T)
    return {"rays_per_path": rays / n, "mean_scatter_events": bounces / n}
