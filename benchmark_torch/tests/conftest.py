"""A copy of the benchmark's files in a temporary root, with tiny cells
that the CPU runs through the program's plain versions: ``tiny-mega``
(250 Gaussians, 16² spp 4, K1's path) and ``tiny-big`` (2,100 Gaussians,
8² spp 2, engine dense), each held to the limits, and compared with the
reference's solve, of the cell it stands for."""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest
import torch

# several test processes at once each start torch's full thread pool, and
# together they starve one another; two threads a process run them all
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[2]
PKG = "benchmark_torch"
TINY = {"tiny-mega": ("gmm250", 250, 16, 4, "auto", "mega",
                      "gmm250-headline"),
        "tiny-big": ("gmm10k", 2100, 8, 2, "dense", "big", "gmm10k-bign")}
ENTRIES = {k: f"gvr_tpu_torch.integrators.multiscatter.{e}" for k, e in
           (("mega", "mega_call"), ("big", "wavefront_pixels_big"))}


def add_entries(root: pathlib.Path, configs=(), workloads=(), metrics=()):
    """Append entries to root's BENCHMARK.json."""
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["configs"] += list(configs)
    bench["workloads"] += list(workloads)
    for m in metrics:
        bench["per_layer" if "layer" in m else "end_to_end"].append(m)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w["name"] for w in workloads]
    path.write_text(json.dumps(bench, indent=1))


def write(path: pathlib.Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


@pytest.fixture
def tiny_root(tmp_path):
    """A root with BENCHMARK.json, the benchmark's files and the TINY
    cells."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / PKG, tmp_path / PKG,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    configs, workloads = [], []
    for cell, (base, n, size, spp, engine, kernel, like) in TINY.items():
        cfg = json.loads((REPO / PKG / "configs" / f"{base}.json")
                         .read_text())
        cfg.update(name=cell, n=n)
        write(tmp_path / PKG / "configs" / f"{cell}.json", cfg)
        tr = dict(name=cell, kind="multiscatter",
                  render=dict(width=size, height=size, spp=spp,
                              engine=engine),
                  trace_renders=2, check_renders=2, check_pixels=size * size,
                  count_pixels=32)
        write(tmp_path / PKG / "traffic" / f"{cell}.json", tr)
        write(tmp_path / PKG / "cells" / f"{cell}.json",
              dict(json.loads((REPO / PKG / "cells" / f"{like}.json")
                              .read_text()), kernel=kernel,
                   entry=ENTRIES[kernel]))
        configs.append(dict(name=cell, source="a tiny stand-in",
                            file=f"{PKG}/configs/{cell}.json", reduced=["n"],
                            why="a CPU test"))
        workloads.append(dict(name=cell, config=cell, traffic=cell, chips=1,
                              why="a CPU test"))
    add_entries(tmp_path, configs, workloads)
    return tmp_path


@pytest.fixture
def run_line(capsys):
    """run_line(root, cell, seed=, trace=, seconds=): the result line of
    one run of ``cell`` on the CPU, the look for a card skipped."""
    from benchmark_torch import run

    def go(root, cell, seed=2 ** 33 + 7, trace=0, seconds=0.5):
        capsys.readouterr()
        assert run.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)],
                        root=root, device="cpu") == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    return go
