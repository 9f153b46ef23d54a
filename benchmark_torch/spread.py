"""Sets of runs of one cell, each run a process of its own, and the spread
of each metric, from which its bound is set:

    python3 -m benchmark_torch.spread --workload <cell> \
        --seeds 11,12,13,14,15,16 [--sets 2] [--trace-seeds 21,22,23] \
        [--seconds S] [--out FILE]

Every set runs the seeds in order (the same seeds in every set) at
``--seconds`` (BENCHMARK.json's ``run_seconds`` by default), then
``--trace-seeds`` run once each with ``--trace 1``.  For each metric and
set: the median and the spread, (q3 - q1) / median with the quartiles of
``statistics.quantiles(values, n=4)``; the widest set's spread, the
bound it suggests (5 x, at least 1 %), the mean spread of the sets
with each set's run farthest from its median left out, the spread of
all the runs together, and of all but the first (which builds the
kernels).  A JSON line a run, then the summary.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from benchmark_torch import run, spec


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "benchmark_torch.run", "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         cwd=run.ROOT)
    row = dict(seed=seed, trace=trace, rc=res.returncode,
               wall_s=time.perf_counter() - t0)
    lines = res.stdout.strip().splitlines()
    try:
        row["result"] = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        row["result"] = None
    if res.returncode or not (row["result"] or {}).get("correct"):
        row["stderr"] = res.stderr[-4000:]
    else:
        row["stderr"] = res.stderr.strip().splitlines()[-12:]
    return row


def spread(values) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("inf")


def summarize(rows: list, sets: int) -> dict:
    out = {}
    names = sorted({m for r in rows if r["result"] for m in
                    r["result"]["metrics"]})
    for name in names:
        per_set, trimmed = [], []
        for k in range(sets):
            vals = [r["result"]["metrics"][name]["value"] for r in rows
                    if r.get("set") == k and r["result"]
                    and name in r["result"]["metrics"]]
            if len(vals) < 3:
                continue
            med = statistics.median(vals)
            far = max(range(len(vals)), key=lambda j: abs(vals[j] - med))
            per_set.append(dict(median=med, spread=spread(vals),
                                values=vals))
            rest = vals[:far] + vals[far + 1:]
            if len(rest) >= 3:
                trimmed.append(spread(rest))
        if not per_set:
            continue
        widest = max(s["spread"] for s in per_set)
        every = [v for s in per_set for v in s["values"]]
        out[name] = dict(sets=per_set, widest=widest,
                         bound=max(0.01, 5 * widest),
                         trimmed_mean=(statistics.mean(trimmed)
                                       if trimmed else None),
                         all_runs=spread(every),
                         after_first=spread(every[1:]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark_torch.spread",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seconds = args.seconds or spec.benchmark(run.ROOT)["run_seconds"]
    rows = []
    for k in range(args.sets):
        for seed in (int(s) for s in args.seeds.split(",")):
            row = dict(one(args.workload, seed, seconds, 0), set=k)
            print(json.dumps(row), flush=True)
            rows.append(row)
    for seed in (int(s) for s in args.trace_seeds.split(",") if s):
        row = one(args.workload, seed, seconds, 1)
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = dict(workload=args.workload, seconds=seconds,
                   runs=len(rows),
                   correct=sum(bool(r["result"] and r["result"]["correct"])
                               for r in rows),
                   metrics=summarize(rows, args.sets))
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, runs=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
