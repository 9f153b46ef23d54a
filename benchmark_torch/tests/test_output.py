"""The last-line writer."""

from __future__ import annotations

import json

from benchmark_torch import output

CHECKS = {"off_frac": {"value": 0.001, "limit": 0.02},
          "failed": {"value": 0, "limit": 0}}
DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "memory_peak_bytes": 123}


def test_keys_in_order_with_checks_last():
    line = output.result_line(True, 10, 0, {"setup_s": {"value": 1.5,
                                                       "unit": "s"}},
                              DEVICE, CHECKS)
    res = json.loads(line)
    assert list(res) == list(output.KEYS) + ["checks"]
    assert res["checks"] == CHECKS


def test_breakdown_only_when_given():
    bd = {"device_ops": [["gvr::mega_kernel<false>", 0.1]],
          "idle_gaps": [["python", 0.01]]}
    res = json.loads(output.result_line(False, 3, 1, {}, DEVICE, CHECKS,
                                        bd))
    assert list(res) == list(output.KEYS) + ["breakdown", "checks"]
    assert res["correct"] is False and res["failed"] == 1


def test_emit_prints_checks_last_on_stderr_and_the_line_last(capsys):
    line = output.result_line(True, 1, 0, {}, DEVICE, CHECKS)
    output.emit(line, CHECKS)
    cap = capsys.readouterr()
    assert cap.out.strip().splitlines()[-1] == line
    err = cap.err.strip().splitlines()
    assert err[-2:] == ["check off_frac: 0.001 (limit 0.02)",
                        "check failed: 0 (limit 0)"]
