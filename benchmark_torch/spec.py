"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``BENCHMARK.json`` gives, and a traffic mix, read from
``benchmark_torch/traffic/<traffic>.json``, which names the cell's kind,
``benchmark_torch/kinds/<kind>.py`` (the program's scene and entry, the
reference's check).  What belongs to the cell alone, the kernel it must
run, the entry where a fault is planted, the reference's solve and the
limits of its comparison, is in ``benchmark_torch/cells/<cell>.json``.
Each metric is read by ``benchmark_torch/metrics/<metric>.py``'s
``read(run)``.  A cell reports the end-to-end metrics and (``--trace
1``) the per-layer metrics whose ``workloads`` list it, or that have no
such list.  So a later cell, mix, kind or metric is a new file and a new
entry, and no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

PKG = "benchmark_torch"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    cell: dict
    end_to_end: list
    per_layer: list


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root) -> dict:
    return _json(pathlib.Path(root) / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root, name: str) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files."""
    root = pathlib.Path(root)
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(root / PKG / "traffic" / f"{w['traffic']}.json")
    cell = _json(root / PKG / "cells" / f"{name}.json")
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                cell=cell,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def _module(root, folder: str, name: str):
    """The module ``benchmark_torch/<folder>/<name>.py`` under root."""
    path = pathlib.Path(root) / PKG / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PKG}.{folder}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(root, cell: Cell):
    """The module of the cell's kind, ``kinds/<traffic's kind>.py``."""
    return _module(root, "kinds", cell.traffic["kind"])


def reader(root, metric: str):
    """``read`` of ``benchmark_torch/metrics/<metric>.py`` under root."""
    return _module(root, "metrics", metric).read


def read_metrics(root, metrics: list, run: dict) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read in ``run``."""
    out = {}
    for m in metrics:
        value = reader(root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
