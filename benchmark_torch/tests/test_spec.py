"""BENCHMARK.json in its required form, and the files it names."""

from __future__ import annotations

import hashlib
import json

from benchmark_torch import spec
from conftest import PKG, REPO, add_entries, write

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == [PKG]
    assert BENCH["command"] == ["python3", "-m", "benchmark_torch.run"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"]
              for k in ("name", "config", "traffic")]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(spec.NAME.match(n) for n in names), names
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(spec.UNIT.match(u) for u in units), units
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in BENCH[group]]
        assert len(set(group_names)) == len(group_names)
    for text in ([e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text


def test_every_cell_has_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert (REPO / configs[w["config"]]["file"]).is_file()
        assert (REPO / PKG / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / PKG / "cells" / f"{w['name']}.json").is_file()
        assert w["chips"] in (1, 4)
        cell = spec.load_cell(REPO, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (REPO / PKG / "metrics" / f"{m['name']}.py").is_file()


def test_each_moves_names_an_end_to_end_metric_its_cells_report():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        reports = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= reports, m["name"]
    for cell in cells:
        c = spec.load_cell(REPO, cell)
        assert "setup_s" in [m["name"] for m in c.end_to_end]
        assert len(c.end_to_end) >= 2 and c.per_layer


def test_bounds_lie_between_one_and_twenty_five_percent():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / PKG).rglob("*") if p.is_file()}


def test_a_cell_mix_kind_and_metric_are_new_files_and_entries_only(
        tiny_root, run_line):
    before = _digests(tiny_root)
    base = json.loads((REPO / PKG / "configs" / "gmm250.json").read_text())
    write(tiny_root / PKG / "configs" / "gmm12.json", dict(base, n=12,
                                                           name="gmm12"))
    write(tiny_root / PKG / "traffic" / "still-8-spp1.json",
          dict(name="still-8-spp1", kind="stills",
               render=dict(width=8, height=8, spp=1, engine="auto"),
               trace_renders=1, check_renders=1, check_pixels=64,
               count_pixels=16))
    # a kind of its own, found by its name: the multiscatter kind's
    # functions in a file of its own
    write(tiny_root / PKG / "kinds" / "stills.py",
          'import pathlib\n'
          'exec((pathlib.Path(__file__).parent / "multiscatter.py")'
          '.read_text())\n')
    write(tiny_root / PKG / "cells" / "gmm12-still.json",
          dict(kernel="mega",
               entry="gvr_tpu_torch.integrators.multiscatter.mega_call",
               limits=dict(off_frac=0.05, mean_diff=1e-3)))
    write(tiny_root / PKG / "metrics" / "renders_per_s.py",
          'def read(run):\n    w = run["window"]\n'
          '    return w["renders"] / w["seconds"]\n')
    add_entries(
        tiny_root,
        configs=[dict(name="gmm12", source="x", reduced=["n"], why="x",
                      file=f"{PKG}/configs/gmm12.json")],
        workloads=[dict(name="gmm12-still", config="gmm12",
                        traffic="still-8-spp1", chips=1, why="x")],
        metrics=[dict(name="renders_per_s", unit="1/s", better="higher",
                      bound=0.05, source="host_clock",
                      workloads=["gmm12-still"])])
    res = run_line(tiny_root, "gmm12-still")
    assert res["correct"]
    assert {"mpaths_per_s", "setup_s", "renders_per_s"} <= set(
        res["metrics"])
    after = _digests(tiny_root)
    assert all(after[p] == d for p, d in before.items())
