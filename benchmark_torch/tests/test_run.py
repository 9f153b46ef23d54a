"""A run without a card, a run's imports, and whole runs on the CPU."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

from conftest import REPO

# Blocks jax, the JAX package and the JAX benchmark's modules, then runs a
# whole tiny cell on the CPU and lists what it imported.
NO_JAX = textwrap.dedent("""
    import importlib.abc, json, pathlib, sys
    BLOCKED = ("jax", "jaxlib", "gvr_tpu", "bench", "benchmarks")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"the benchmark imported {name}")
            return None

    sys.meta_path.insert(0, Block())
    from benchmark_torch import calibrate, run, spread
    run.main(["--workload", "tiny-mega", "--seed", "5", "--seconds", "0.2",
              "--trace", "1"], root=pathlib.Path(sys.argv[1]), device="cpu")
    print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")


def _env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2",
                PYTHONPATH=str(REPO))


def test_no_card_exits_nonzero_with_no_result():
    res = subprocess.run(
        [sys.executable, "-m", "benchmark_torch.run", "--workload",
         "gmm250-headline", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_nothing_run_imports_imports_jax(tiny_root):
    res = subprocess.run([sys.executable, "-c", NO_JAX, str(tiny_root)],
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    imported = set(__import__("json").loads(
        res.stdout.strip().splitlines()[-1]))
    assert "gvr_tpu_torch" in imported and "torch" in imported
    assert not imported & {"jax", "jaxlib", "gvr_tpu", "bench",
                           "benchmarks"}


@pytest.mark.parametrize("cell", ["tiny-mega", "tiny-big"])
def test_a_sound_run_is_correct(tiny_root, run_line, cell):
    res = run_line(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"mpaths_per_s", "setup_s"}
    assert res["metrics"]["mpaths_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"


def test_a_traced_run_reports_the_per_layer_metrics(tiny_root, run_line):
    res = run_line(tiny_root, "tiny-mega", trace=1)
    assert res["correct"]
    assert "launches_per_render" in res["metrics"]
    assert "mpaths_per_s" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def test_the_wrong_kernel_fails_the_run(tiny_root, run_line):
    from benchmark_torch import run
    path = tiny_root / "benchmark_torch" / "cells" / "tiny-mega.json"
    path.write_text(path.read_text().replace('"mega"', '"grid"'))
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "tiny-mega", "--seed", "1", "--seconds",
                  "0.1"], root=tiny_root, device="cpu")
    assert exc.value.code == run.RUN_FAULT
