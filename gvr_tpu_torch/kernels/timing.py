"""A kernel's device time, apart from the host's dispatch of its call.

    kernel_ms(fn, "span_tau_kernel", reps=20) -> (times, fn's last result)

CUDA events around back-to-back calls measure the slower of the device and
the host that enqueues: where a kernel runs shorter than its wrapper's host
work (allocation, argument checks, the ctypes call), they give the host's
rate.  So ``fn`` runs ``reps`` times under ``torch.profiler`` and the
kernel's time is the mean CUPTI duration of the kernels whose name
matches; ``reps`` more calls between two CUDA events give the call's time,
whose excess over the kernel's is the dispatch.
Imports torch only, so a script can load this file beside any checkout's
package.
"""

from __future__ import annotations

import re

PROFILE_TRIES = 3


def kernel_ms(fn, kernel: str, reps: int, per_call: int = 1):
    """({'ms': device ms of one call's matching kernels, 'events_ms': ms
    of one call by CUDA events, 'dispatch_us': their difference in µs,
    'recorded': the share of the reps * per_call launches the profiler
    recorded}, fn's last result).  ``per_call``: matching kernels a call
    launches.  'ms' is the mean recorded duration times ``per_call``: in
    a long process the profiler may record fewer launches than ran
    (PERF.md), and a sum over reps would count the missing ones as 0.

    ``kernel`` is a kernel's function name ("span_tau_kernel" matches
    "gvr::span_tau_kernel(...)", not "wave_uniforms_kernel" for
    "uniforms_kernel").  Raises where the profiler records no device time
    for it in PROFILE_TRIES windows: a call that launched no such kernel,
    or a profiler that sees no device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                                      # warm-up (build, caches)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    events_ms = start.elapsed_time(end) / reps
    name = re.compile(rf"\b{re.escape(kernel)}\b")
    # late in a long process the profiler may record a fraction of the
    # launches, or none of them, so a window that recorded none is taken
    # again, up to PROFILE_TRIES times
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                out = fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name.search(e.key)]
        dev_us = sum(e.device_time_total for e in rows)
        n = sum(e.count for e in rows)
        if n and dev_us > 0:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded no device time for "
                           f"{kernel!r} in {PROFILE_TRIES} windows")
    ms = dev_us / 1e3 / n * per_call
    return {"ms": ms, "events_ms": events_ms,
            "dispatch_us": (events_ms - ms) * 1e3,
            "recorded": n / (reps * per_call)}, out
