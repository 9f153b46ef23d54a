"""The profiler summary on a synthetic trace: busy time is a union of
intervals, launches and the port's kernels are counted inside the
profiled renders only, idle time goes to the outermost host op that ran
in it."""

from __future__ import annotations

from types import SimpleNamespace

from torch.autograd import DeviceType

from benchmark_torch import devtrace


def _ev(name, start, dur, dev=False, kind=None):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: DeviceType.CUDA if dev else DeviceType.CPU,
        activity_type=lambda: kind or ("kernel" if dev else "cpu_op"),
        is_user_annotation=lambda: kind == "user_annotation")


def _prof(evs):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))


def test_union_of_overlapping_kernels_and_gap_labels():
    evs = [
        _ev(devtrace.MARKER, 100, 900, kind="user_annotation"),
        _ev(devtrace.MARKER, 100, 900, dev=True, kind="gpu_user_annotation"),
        _ev("aten::nonzero", 100, 150),
        _ev("cudaLaunchKernel", 300, 10, kind="cuda_runtime"),
        _ev("cudaLaunchKernel", 320, 10, kind="cuda_runtime"),
        _ev("cudaLaunchKernel", 2000, 10, kind="cuda_runtime"),
        _ev("void gvr::mega_kernel<false>(float const*)", 200, 300, dev=True),
        _ev("void at::elementwise_kernel<4>(int)", 400, 200, dev=True),
        _ev("Memcpy DtoH", 700, 100, dev=True, kind="gpu_memcpy"),
        _ev("void gvr::mega_kernel<false>(float const*)", 5000, 10,
            dev=True),
    ]
    s = devtrace.summarize(_prof(evs))
    assert s["renders"] == 1
    assert s["window_s"] == 900 / 1e9
    assert s["busy_s"] == (600 - 200 + 800 - 700) / 1e9
    assert s["launches"] == 2 and s["port_kernels"] == 1
    assert s["device_ops"][0] == ["gvr::mega_kernel<false>", 300 / 1e9]
    idle = dict(s["idle_gaps"])
    assert idle["aten::nonzero"] == 100 / 1e9          # 100-200
    assert idle["python"] == (700 - 600 + 1000 - 800) / 1e9
    assert "cudaLaunchKernel" not in idle               # ran while busy
