"""The profiled renders of a ``--trace 1`` run, read from torch.profiler's
trace: a copy of ``profile_render._summary``'s idea with its two faults
mended.  The busy time is the union of the device's activity intervals
(kernels, copies, fills), not a sum of rows, and it is divided by the
wall time of the same profiled renders, not of another render.  The
renders are the spans of ``record_function(MARKER)`` around each call.

The raw Kineto events are read (``prof.profiler.kineto_results``): the
grid cell's render makes about 200,000 launches, whose FunctionEvent
tree takes minutes to build.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

MARKER = "bench.render"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
PORT_KERNELS = "gvr::"          # the namespace of the port's CUDA kernels
TOP = 10


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    return fn() if fn is not None else int(getattr(e, f"{what}_us")() * 1e3)


def events(prof):
    """(device, host, markers): lists of (start_ns, end_ns, name) of the
    device's activities, the host's ops and runtime calls, and the
    MARKER spans, from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device, host, markers = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = _ns(e, "start")
        span = (start, start + _ns(e, "duration"), name)
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        if e.device_type() == DeviceType.CUDA:
            if name != MARKER and (kind is None
                                   or kind in DEVICE_ACTIVITIES):
                device.append(span)
        elif name == MARKER:
            markers.append(span)
        elif not (hasattr(e, "is_user_annotation")
                  and e.is_user_annotation()):
            host.append(span)
    return sorted(device), sorted(host), sorted(markers)


def _short(name: str) -> str:
    name = name.split("(")[0]
    return name[5:] if name.startswith("void ") else name


def _idle_by_host(gaps, host) -> dict:
    """The time of the idle ``gaps`` split among the outermost host ops
    that overlap them; the time no op covers is 'python'."""
    top, end = [], None
    for h in host:
        if end is None or h[0] >= end:
            top.append(h)
            end = h[1]
        elif h[1] > end:                  # overlapping ops of two threads
            end = h[1]
    idle, k = defaultdict(int), 0
    for g0, g1 in gaps:
        while k < len(top) and top[k][1] <= g0:
            k += 1
        covered, j = 0, k
        while j < len(top) and top[j][0] < g1:
            part = min(g1, top[j][1]) - max(g0, top[j][0])
            if part > 0:
                idle[top[j][2]] += part
                covered += part
            j += 1
        idle["python"] += (g1 - g0) - covered
    return idle


def summarize(prof) -> dict:
    """Of the profiled renders: 'renders', 'window_s' (first render's call
    to the last one's return), 'busy_s' (union of device activity),
    'launches' (kernel-launch calls), 'port_kernels' (device executions
    of the port's kernels), 'device_ops' and 'idle_gaps' (the TOP device
    ops by time, and the device's idle time split among the outermost
    host ops that ran in it, as [name, seconds])."""
    device, host, markers = events(prof)
    if not markers:
        raise RuntimeError(f"the profiler recorded no {MARKER!r} span")
    lo, hi = markers[0][0], max(m[1] for m in markers)
    busy, gaps, cursor = 0, [], lo
    ops = defaultdict(int)
    port = 0
    for s, e, name in device:
        if e <= lo or s >= hi:
            continue
        ops[_short(name)] += e - s
        port += PORT_KERNELS in name
        s, e = max(s, lo), min(e, hi)
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    lo_k = bisect.bisect_left(host, (lo,))
    in_window = [h for h in host[lo_k:] if h[0] < hi]
    idle = _idle_by_host(gaps, in_window)
    top = lambda d: [[k, v / 1e9] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return dict(renders=len(markers), window_s=(hi - lo) / 1e9,
                busy_s=busy / 1e9,
                launches=sum(h[2] in LAUNCHES for h in in_window),
                port_kernels=port, device_ops=top(ops), idle_gaps=top(idle))
