"""Package-level guards of the port: it never imports JAX or gvr_tpu, it
picks the JAX package's engine, and its wrappers take the plain version
only for CPU tensors."""

import ast
import pathlib

import pytest
import torch

import _torch_common  # noqa: F401  (sets torch threads)
from gvr_tpu_torch.config import RenderConfig, Solver
from gvr_tpu_torch.integrators.common import pick_chunk
from gvr_tpu_torch.integrators.multiscatter import GRID_MIN_N, engine_for
from gvr_tpu_torch.kernels import _build
from gvr_tpu_torch.scene.generators import random_gaussian_scene
from gvr_tpu_torch.scene.scene import parse_gmm

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the package and the port's kernel A/B tool, which runs on the card's
# machine, where there is no JAX
PORT_FILES = sorted((ROOT / "gvr_tpu_torch").rglob("*.py")) + [
    ROOT / "scripts" / "ab_kernels.py"]


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "gvr_tpu" or module.startswith("gvr_tpu."))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("kw", [
    dict(solver=Solver.BISECTION), dict(solver=Solver.ANALYTIC_BISECTION),
    dict(solver=Solver.UNIFORM), dict(candidate_k=8)],
    ids=["bisection", "analytic_bisection", "uniform", "candidate_k"])
def test_unported_knobs_raise(kw):
    """The knobs that the port refused before the XLA engine came are
    accepted and routed as the JAX package routes them on its
    accelerator: a non-kernel solver takes the dense XLA engine ('xla')
    under auto and dense at any N, and engine='grid' refuses it with the
    JAX package's ValueError; candidate_k leaves the kernel engines'
    choice as it is (only the XLA engine and single scatter apply it)."""
    cfg = RenderConfig(**kw)
    mix = parse_gmm(random_gaussian_scene(GRID_MIN_N + 1, seed=0)).medium
    if "candidate_k" in kw:
        assert cfg.candidate_k == 8
        assert engine_for(cfg, mix) == "grid"
        assert engine_for(cfg.replace(engine="dense"), mix) == "dense"
        return
    for engine in ("auto", "dense"):
        for m in (mix, parse_gmm(random_gaussian_scene(4, seed=0)).medium):
            assert engine_for(cfg.replace(engine=engine), m) == "xla"
    with pytest.raises(ValueError, match=f"engine='grid' implements the "
                       rf"\(analytic-\)Newton solver only; solver="
                       f"{cfg.solver.name} requires engine='dense' or "
                       f"'auto'"):
        engine_for(cfg.replace(engine="grid"), mix)


def test_kernel_solvers_and_engines_are_accepted():
    for solver in (Solver.NEWTON, Solver.ANALYTIC_NEWTON):
        RenderConfig(solver=solver)
    for engine in ("auto", "dense", "grid"):
        assert RenderConfig(engine=engine).engine == engine
    with pytest.raises(ValueError):
        RenderConfig(engine="sparse")


def test_engine_for_keeps_the_jax_thresholds():
    class Mix:
        def __init__(self, n):
            self.n = n
    assert engine_for(RenderConfig(), Mix(GRID_MIN_N)) == "dense"
    assert engine_for(RenderConfig(engine="dense"), Mix(2048)) == "dense"
    # above GRID_MIN_N, 'auto' takes the grid (its build decides S_CAP_MAX)
    mix = parse_gmm(random_gaussian_scene(GRID_MIN_N + 1, seed=0)).medium
    assert engine_for(RenderConfig(), mix) == "grid"
    # above MEGA_MAX_GAUSSIANS the dense engine is the big-N one, up to
    # its 96 chunks of 256 Gaussians
    assert engine_for(RenderConfig(engine="dense"), Mix(2049)) == "dense"
    assert engine_for(RenderConfig(engine="dense"), Mix(24576)) == "dense"
    with pytest.raises(ValueError, match="engine='grid'"):
        engine_for(RenderConfig(engine="dense"), Mix(24577))


@pytest.mark.parametrize("n", [1, 250, 2000, 10_000])
def test_pick_chunk_budget_only_on_cpu(n):
    """The [chunk, N] element budget binds the plain versions on the CPU
    and the dense paths (the XLA engine, single scatter, the marchers, the
    hit mask) on any device; a kernel launch on the card takes
    cfg.ray_chunk whole."""
    cfg = RenderConfig()
    assert pick_chunk(cfg, n, "cuda") == cfg.ray_chunk
    cpu = pick_chunk(cfg, n, "cpu")
    assert cpu % 256 == 0 and cpu * n <= max(1 << 25, 256 * n)
    assert cpu == min(cfg.ray_chunk, (((1 << 25) // n) // 256) * 256)
    assert pick_chunk(cfg, n, "cuda", dense=True) == cpu
    assert pick_chunk(cfg, n, "cpu", dense=True) == cpu


def test_build_sources_and_checks():
    names = {p.name for p in _build.CSRC.iterdir()}
    assert {"kernels.cu", "bounce.cuh", "grid.cuh", "big.cuh", "rng.cuh",
            "common.cuh"} <= names
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.library_path().parent == ROOT / "gvr_tpu_torch" / "_build"
    t = torch.zeros((4, 16))
    _build.check(t, "t", torch.float32, (None, 16), t.device)
    with pytest.raises(ValueError, match="dtype"):
        _build.check(t, "t", torch.int32, (4, 16), t.device)
    with pytest.raises(ValueError, match="contiguous"):
        _build.check(t.T, "t", torch.float32, (16, 4), t.device)


def test_profile_render_summarises_a_render(capsys):
    """The profiler tool on the CPU: a warm render, then a profiled one;
    the CPU has no device time and no kernel launches; the render loop's
    spans by their self time."""
    from gvr_tpu_torch import profile_render
    res = profile_render.main(["--gaussians", "12", "--size", "8", "--spp",
                               "1", "--top", "5", "--device", "cpu"])
    assert res["engine"] == "dense" and res["warm_seconds"] > 0
    assert res["device_busy_ms"] == 0 and res["kernel_launches"] == 0
    assert len(res["by_host"]) == 5
    assert "render.prepare" in res["span_self_ms"]
    out = capsys.readouterr().out
    assert "--- by host time" in out and '"busy_share": 0.0' in out
    assert "--- by span time (self)" in out


@pytest.mark.parametrize("args,key", [
    (["--solver", "bisection"], ("dense", "xla", "multiscatter")),
    (["--integrator", "raymarch"], (None, None, "raymarch"))],
    ids=["xla_engine", "raymarch"])
def test_profile_render_profiles_the_other_paths(args, key):
    """The profiler tool drives the dense XLA engine (an ablation solver)
    and the other integrators on the CPU."""
    from gvr_tpu_torch import profile_render
    res = profile_render.main(["--gaussians", "12", "--size", "8", "--spp",
                               "1", "--top", "3", "--device", "cpu"] + args)
    assert (res["engine"], res["kernel"], res["integrator"]) == key
    assert res["warm_seconds"] > 0 and res["kernel_launches"] == 0
