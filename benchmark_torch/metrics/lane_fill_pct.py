"""100 x the lanes the wavefront iterations traced / the lanes they had
(the program's counters ``lanes_traced`` and ``lane_slots``, a chunk's
lanes x its iterations), over the profiled renders: the share of each
iteration's fixed host cost that still does work."""

from benchmark_torch import program_spans


def read(run):
    rec = program_spans.recording(run)
    if rec is None:
        return None
    totals = rec.totals()
    slots = totals.get("lane_slots", 0)
    return 100.0 * totals.get("lanes_traced", 0) / slots if slots else None
