"""One run of one cell of the port's benchmark.

    python3 -m benchmark_torch.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up: the cell's kind (``kinds/<kind>.py``, named by its traffic
file) makes the scene of the cell's configuration on the card and hands
the program its entry; one warm-up render of the cell's own shape builds
or loads the kernels and, on the grid engine, the grid.  The warm-up
must run the cell's kernel (``stats['kernel']``), or the run fails.
Then one client renders back to back for ``--seconds`` seconds (the
window); render i takes the RNG seed ``traffic.render_seed(seed, i)``,
and a reservoir drawn from the seed keeps ``check_renders`` of the
images (``check.Reservoir``).

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from the window's first ``trace_renders`` renders
under torch.profiler (``devtrace``), with the work their paths need
(the kind's ``work_bound``, counted by the reference on a pixel sample).
A traced run whose profiler recorded fewer executions of the port's
kernels than the program's launch counters say fails.

After the window (memory peak read, the program's state dropped) the
kind's reference checks the kept renders at pixels drawn from the seed
(``check``).  The result is the last line of standard output
(``output``).  A run without a CUDA card,
or with fewer than the cell asks for, fails and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import os
import pathlib
import pkgutil
import sys
import time
import traceback

from benchmark_torch import check, devtrace, output, spec, traffic

ROOT = pathlib.Path(__file__).resolve().parents[1]
NO_CARD = 3          # exit code: no card, or fewer than the cell asks for
RUN_FAULT = 4        # exit code: the wrong kernel ran, or the profiler fault


def process_start() -> float:
    """``time.perf_counter()`` at the moment this process started (from
    /proc, to 10 ms), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        age = 0.0
    return time.perf_counter() - (age if 0.0 <= age < 600.0 else 0.0)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="benchmark_torch.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cuda_device(chips: int):
    """cuda:0 where the card count covers ``chips``; else exit NO_CARD."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark_torch: the cell needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        raise SystemExit(NO_CARD)
    return torch.device("cuda", 0)


def launch_counters() -> dict:
    """The program's launch counters: every function of
    ``gvr_tpu_torch.kernels`` with an int ``launches`` that is not a
    plain version's."""
    import gvr_tpu_torch.kernels as pkg
    out = {}
    for m in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{m.name}")
        for name, fn in vars(mod).items():
            if (callable(fn) and isinstance(getattr(fn, "launches", None),
                                            int)
                    and getattr(fn, "__module__", None) == mod.__name__
                    and not name.endswith("_reference")):
                out[f"{m.name}.{name}"] = fn
    return out


def report_setup(phases: list) -> None:
    """One line on standard error: the set-up's phases, from
    [(phase, perf_counter at its end)], the first the process's start."""
    parts = [f"{name} {t - t0:.3f}"
             for (_, t0), (name, t) in zip(phases, phases[1:])]
    print(f"benchmark_torch: set-up {phases[-1][1] - phases[0][1]:.3f} s: "
          + ", ".join(parts), file=sys.stderr)


def run_cell(root, cell: spec.Cell, args, device, phases: list):
    """Set up, run the window, check; returns (line, checks).  ``phases``
    holds the set-up's phases so far, [(phase, perf_counter)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    tr = cell.traffic
    want = cell.cell["kernel"]
    kind = spec.kind(root, cell)
    prog = kind.setup(cell, args.seed, device)
    phases.append(("scene", time.perf_counter()))
    if cuda:
        # the kernels' build (the first run in a checkout) or load, apart
        # from the warm-up that would otherwise hide it
        for name, fn in prog.get("build", {}).items():
            phases.append((f"{name} {'built' if fn() else 'loaded'}",
                           time.perf_counter()))
    render = prog["render"]
    st = {}
    render(0, st)
    if st.get("kernel") != want:
        print(f"benchmark_torch: the warm-up render ran kernel "
              f"{st.get('kernel')!r}, the cell {cell.name} needs {want!r}",
              file=sys.stderr)
        raise SystemExit(RUN_FAULT)
    sync()
    kept = check.Reservoir(args.seed, tr["check_renders"])
    counters = launch_counters() if args.trace else {}
    prof, marks, n_trace = None, None, tr["trace_renders"] if args.trace else 0
    attempted, raised, wrong = 0, 0, 0
    phases.append(("warm-up", time.perf_counter()))
    setup_s = phases[-1][1] - phases[0][1]
    report_setup(phases)
    if n_trace:
        # started before the window: the profiler's own start-up (CUPTI's)
        # takes seconds
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        prof.start()
        before = {k: fn.launches for k, fn in counters.items()}

    t_w0 = t_end = time.perf_counter()
    while time.perf_counter() - t_w0 < args.seconds:
        i = attempted + 1
        st = {}
        ctx = record_function(devtrace.MARKER) if prof is not None and \
            i <= n_trace else contextlib.nullcontext()
        attempted += 1
        try:
            with ctx:
                img = render(i, st)
        except Exception:
            traceback.print_exc()
            raised += 1
            break
        t_end = time.perf_counter()
        wrong += st.get("kernel") != want
        kept.offer(i, img)
        if prof is not None and i == n_trace:
            prof.stop()
            marks = {k: fn.launches - before[k] for k, fn in counters.items()}
    if prof is not None and marks is None:
        prof.stop()
        marks = {k: fn.launches - before[k] for k, fn in counters.items()}
    renders = attempted - raised

    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=1,
               memory_peak_bytes=(torch.cuda.max_memory_allocated(device)
                                  if cuda else 0))
    text = prog["text"]
    del prog, render
    if cuda:
        torch.cuda.empty_cache()

    trace = None
    if prof is not None:
        trace = devtrace.summarize(prof)
        counted = sum(marks.values())
        print(f"benchmark_torch: the profiler recorded "
              f"{trace['port_kernels']} executions of the port's kernels; "
              f"the launch counters say {counted} "
              f"({ {k: v for k, v in marks.items() if v} })",
              file=sys.stderr)
        if trace["port_kernels"] < counted:
            print("benchmark_torch: the profiler lost launches; the traced "
                  "run cannot report", file=sys.stderr)
            raise SystemExit(RUN_FAULT)
        trace.update(kind.work_bound(cell, text, args.seed, trace["renders"],
                                     device))
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])

    sample = kept.kept()
    ids = kind.checked(cell, text, args.seed, device)
    numbers = check.agreement(
        [kind.values(img, ids) for _, img in sample],
        kind.reference_values(cell, text, args.seed, [i for i, _ in sample],
                              ids, device) if sample else [])
    numbers.update(wrong_kernel=wrong, failed=raised)
    correct, checks = check.judge(numbers, cell.cell["limits"])
    paths = traffic.paths(tr)
    run = dict(setup_s=setup_s, trace=trace,
               window=dict(renders=renders, paths=paths * renders,
                           seconds=t_end - t_w0))
    metrics = spec.read_metrics(
        root, cell.per_layer if args.trace else cell.end_to_end, run)
    breakdown = None if trace is None else dict(
        device_ops=trace["device_ops"], idle_gaps=trace["idle_gaps"])
    line = output.result_line(correct, attempted, raised + wrong, metrics,
                              dev, checks, breakdown)
    return line, checks


def main(argv=None, root=ROOT, device=None) -> int:
    """Run one cell once; ``device`` given skips the look for a card."""
    phases = [("start", process_start()), ("imports", time.perf_counter())]
    args = parse_args(argv)
    cell = spec.load_cell(root, args.workload)
    traffic.check_traffic(cell.traffic)
    if device is None:
        device = cuda_device(cell.chips)
    phases.append(("card", time.perf_counter()))
    line, checks = run_cell(root, cell, args, device, phases)
    output.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
