"""The render loop's spans and counters, read from the program's own
recorder (``gvr_tpu_torch.utils.profiling.recorded``) for the per-layer
metrics of the render loop.  The recorder records while a torch.profiler
runs, so a ``--trace 1`` run has them for its profiled renders, their
times on the profiler's clock.  A program without the recorder, an empty
recording, or one whose renders are not the profiled ones gives None, and
the metric is left out of the result line."""

from __future__ import annotations

import sys

ITERATION = "wavefront.iteration"
LIVE_READ = "wavefront.live_read"


def recording(run):
    """The program's recording of the profiled renders, or None."""
    t = run.get("trace")
    if not t or not t.get("renders"):
        return None
    try:
        from gvr_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    rec = recorded()
    n = rec.renders()
    if n == 0:
        return None
    if n != t["renders"]:
        print(f"benchmark_torch: the program recorded {n} renders, the "
              f"profiler {t['renders']}", file=sys.stderr)
        return None
    return rec


def durations_ns(rec, name: str) -> list:
    """The durations of the recorded spans ``name``, ns."""
    return [s.end_ns - s.start_ns for s in rec.spans if s.name == name]


def iteration_self_ns(rec) -> list:
    """Each wavefront iteration's duration less its live-lane read's."""
    read = {}
    for s in rec.spans:
        if s.name == LIVE_READ and s.parent is not None:
            read[s.parent] = read.get(s.parent, 0) + s.end_ns - s.start_ns
    return [s.end_ns - s.start_ns - read.get(s.id, 0) for s in rec.spans
            if s.name == ITERATION]
