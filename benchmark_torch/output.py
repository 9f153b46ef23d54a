"""The last line of a run: one JSON object on standard output, and the
numbers compared, each beside its limit, as the last lines on standard
error.

The line's keys, in order: ``correct``, ``attempted``, ``failed``,
``metrics`` ({name: {"value", "unit"}}), ``device`` (platform, kind,
count, memory_peak_bytes; with ``--trace 1`` also busy_s and window_s),
``breakdown`` (``--trace 1`` only: device_ops and idle_gaps, at most 10
[name, seconds] each) and, last, ``checks`` ({name: {"value",
"limit"}}).  Every value is as measured, unrounded.
"""

from __future__ import annotations

import json
import sys

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict,
                breakdown: dict | None = None) -> str:
    """The JSON object of a run, keys in their order."""
    res = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["checks"] = checks
    return json.dumps(res)


def emit(line: str, checks: dict) -> None:
    """Print the checks to standard error and then the line to standard
    output, each as the last thing printed there."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
