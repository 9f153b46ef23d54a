"""Host time a profiled render spends before its first chunk, ms: the
program's ``render.prepare`` span (the engine choice with ``grid_for``,
the moves to the device, the tile order, the chunk size and the tables),
summed over the recorded renders / their number."""

from benchmark_torch import program_spans


def read(run):
    rec = program_spans.recording(run)
    if rec is None:
        return None
    spans = program_spans.durations_ns(rec, "render.prepare")
    return sum(spans) / rec.renders() / 1e6 if spans else None
