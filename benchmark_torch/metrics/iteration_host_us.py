"""Host time a wavefront iteration spends enqueuing its launches, us:
the mean over the profiled renders' ``wavefront.iteration`` spans of
each one's duration less its ``wavefront.live_read`` child (the one host
read, which waits for the device)."""

from benchmark_torch import program_spans


def read(run):
    rec = program_spans.recording(run)
    if rec is None:
        return None
    own = program_spans.iteration_self_ns(rec)
    return sum(own) / len(own) / 1e3 if own else None
