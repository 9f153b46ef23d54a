"""The readings that a cell's limits are set from (``cells/<cell>.json``):

    python3 -m benchmark_torch.calibrate --workload <cell> \
        --seeds 101,102,... [--control 4] [--faults 3] [--out FILE]

For each seed, what a run's check compares (``check_renders`` renders,
renders 1, 2, ..., of the run at that seed, and ``check_pixels`` of each,
drawn as a run draws them), read for:

* the program (``program``): the renders through ``render_multiscatter``
  against the float64 reference; the lower reading of a number is its
  largest over the seeds;
* the control (``control``, first ``--control`` seeds): the reference
  one precision step below the configuration's (``check.CONTROL``) in the
  program's place; the upper reading is its least;
* each fault of ``faults.FAULTS`` planted in the program (first
  ``--faults`` seeds).

Prints a JSON line a reading and, last, the summary, which ``--out``
also receives.  It needs a card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from benchmark_torch import check, faults, run, spec

NUMBERS = ("off_frac", "mean_diff")


def readings(cell: spec.Cell, kind, seed: int, device, control: bool,
             fault_list) -> list:
    """One seed's readings: a dict of ``check.agreement`` for the program,
    each fault and (``control``) the control."""
    tr = cell.traffic
    t0 = time.perf_counter()
    prog = kind.setup(cell, seed, device)
    ids = kind.checked(cell, prog["text"], seed, device)
    idx = list(range(1, tr["check_renders"] + 1))

    def program_values():
        out = []
        for i in idx:
            st = {}
            img = prog["render"](i, st)
            if st["kernel"] != cell.cell["kernel"]:
                raise RuntimeError(f"kernel {st['kernel']} ran")
            out.append(kind.values(img, ids))
        return np.stack(out)

    got = {"program": program_values()}
    for fault in fault_list:
        with faults.planted(cell.cell["entry"], fault):
            got[fault] = program_values()
    t_prog = time.perf_counter() - t0

    t = time.perf_counter()
    ref64 = kind.reference_values(cell, prog["text"], seed, idx, ids, device)
    t_ref = time.perf_counter() - t
    if control:
        got["control"] = kind.reference_values(
            cell, prog["text"], seed, idx, ids, device,
            check.CONTROL[cell.config["precision"]])
    return [dict(seed=seed, reading=name, **check.agreement(v, ref64),
                 reference_s=t_ref, program_s=t_prog)
            for name, v in got.items()]


def main(argv=None, root=run.ROOT) -> int:
    ap = argparse.ArgumentParser(prog="benchmark_torch.calibrate",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, a dozen or more")
    ap.add_argument("--control", type=int, default=4)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.load_cell(root, args.workload)
    kind = spec.kind(root, cell)
    device = run.cuda_device(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for k, seed in enumerate(seeds):
        for r in readings(cell, kind, seed, device, k < args.control,
                          faults.FAULTS if k < args.faults else ()):
            print(json.dumps(r), flush=True)
            rows.append(r)
    summary = {"workload": cell.name, "seeds": seeds}
    for name in sorted({r["reading"] for r in rows}):
        sel = [r for r in rows if r["reading"] == name]
        summary[name] = {n: dict(max=max(r[n] for r in sel),
                                 min=min(r[n] for r in sel),
                                 n=len(sel)) for n in NUMBERS}
    summary["reference_s_max"] = max(r["reference_s"] for r in rows)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, readings=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
