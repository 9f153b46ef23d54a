"""The render loop's per-layer metrics, read from the program's own
recorder in a traced run, and left out where the program has none.  The
recording is the process's, and a run is a process of its own: each test
starts from an empty one."""

from __future__ import annotations

import pytest

SPANS = ("prepare_ms", "iteration_host_us", "lane_fill_pct")


@pytest.fixture(autouse=True)
def fresh_recording():
    from gvr_tpu_torch.utils import profiling
    profiling.recorded().clear()


def test_a_traced_big_n_run_reports_the_render_loop(tiny_root, run_line):
    res = run_line(tiny_root, "tiny-big", trace=1)
    m = res["metrics"]
    assert set(SPANS) <= set(m)
    assert m["prepare_ms"]["unit"] == "ms" and m["prepare_ms"]["value"] > 0
    assert m["iteration_host_us"]["value"] > 0
    assert 0 < m["lane_fill_pct"]["value"] <= 100


def test_a_traced_megakernel_run_reports_its_preparation(tiny_root,
                                                         run_line):
    m = run_line(tiny_root, "tiny-mega", trace=1)["metrics"]
    assert m["prepare_ms"]["value"] > 0
    assert "iteration_host_us" not in m and "lane_fill_pct" not in m


@pytest.mark.parametrize("trace", [0, 1])
def test_a_program_without_the_recorder_leaves_them_out(
        tiny_root, run_line, monkeypatch, trace):
    from gvr_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "recorded")
    m = run_line(tiny_root, "tiny-big", trace=trace)["metrics"]
    assert not set(SPANS) & set(m)
