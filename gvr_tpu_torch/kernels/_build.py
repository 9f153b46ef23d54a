"""Build ``csrc/*.cu`` with nvcc at first use and bind the C entry points.

The kernels are compiled into one shared library with a plain C interface
(no PyTorch headers, so nvcc takes seconds) and loaded with ctypes.  The
library lands in ``gvr_tpu_torch/_build/`` (git-ignored), named by a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
loads the existing file.  Flags: ``sm_90a``, ``-O3``, and no
``--use_fast_math``: the stratum and root math rely on IEEE division,
``sqrtf``, ``expf`` and ``erff``.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
``launch`` raises on a non-zero code.

``host_library`` builds a host-only C++ source of ``csrc/`` (the GIF
encoder, ``gif_native.cpp``) with the host C++ compiler ``c++`` (the one
nvcc itself uses) into the same directory, named by its own hash, and
loads it with ctypes; the kernels' hash covers the ``.cu``/``.cuh`` files
only, so it does not change the kernels' build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, \
    ctypes.c_float
# argument types of each C entry point, the stream last (gvr_mega_resident
# launches nothing and takes none)
SIGNATURES = {
    "gvr_uniforms": [_P, _P, _P, _U, _I, _I, _U, _U, _P, _P],
    "gvr_wave_uniforms": [_P, _P, _P, _I, _I, _U, _U, _P, _P],
    "gvr_bounce": [_P, _I, _P, _P, _P, _I, _P, _I, _P, _I, _I, _P, _P],
    "gvr_mega": [_P, _P, _I, _P, _I, _P, _I, _P, _F, _I, _I, _I, _I, _U,
                 _U, _I, _I, _I, _F, _I, _F, _I, _I, _I, _P, _P, _P, _P],
    "gvr_mega_resident": [_P, _P],
    "gvr_span_tau": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P, _P,
                     _P, _P, _I, _I, _P, _P],
    "gvr_grid_solve": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "gvr_big_stage1": [_I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _P,
                       _P, _P, _P],
    "gvr_big_nee": [_I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P],
    "gvr_wave_pre": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _U, _U, _P,
                     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "gvr_wave_post": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _I, _I, _P, _I, _P, _F, _F, _I, _F, _I,
                      _F, _I, _I, _P, _P],
}


HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgvr_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels unless this source hash is built already.
    Returns {'path', 'seconds', 'built', 'log'} (log: nvcc's output,
    including ptxas register and spill counts)."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False,
                "log": log.read_text() if log.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(p) for p in _sources() if p.suffix == ".cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    log.write_text(res.stdout + res.stderr)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "built": True, "log": res.stdout + res.stderr}


def host_library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_host(name: str) -> dict:
    """Compile ``csrc/<name>.cpp`` with ``c++`` unless this source hash is
    built already.  Returns {'path', 'seconds', 'built'}; raises where no
    compiler exists or the compile fails."""
    out = host_library_path(name)
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False}
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("c++ not found: the host library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *HOST_FLAGS, "-o", tmp, str(CSRC / f"{name}.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"c++ failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "built": True}


@functools.lru_cache(maxsize=None)
def host_library(name: str) -> ctypes.CDLL:
    """The host library of ``csrc/<name>.cpp``, built at first use."""
    return ctypes.CDLL(build_host(name)["path"])


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gvr_error_string.argtypes = [ctypes.c_int]
    lib.gvr_error_string.restype = ctypes.c_char_p
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (a shape entry of None matches any size)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != ts for s, ts in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _c_args(args) -> tuple:
    """``args`` with each tensor passed as its data pointer."""
    return tuple(ptr(a) if isinstance(a, torch.Tensor) else a for a in args)


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = lib.gvr_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def launch(name: str, *args, device: torch.device) -> None:
    """Call C entry point ``name`` on the current stream of ``device``
    (a tensor in ``args`` passed as its data pointer) and raise if the
    launch reported a CUDA error."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(lib, name,
              getattr(lib, name)(*_c_args(args), ctypes.c_void_p(stream)))


def bind(name: str, *args, device: torch.device):
    """``launch`` with the trailing arguments ``args`` bound once, for a
    loop that launches one kernel over the same buffers many times:
    returns ``call(*lead)``, which calls ``name(*lead, *args)`` on the
    stream current on ``device`` now and raises if the launch reported a
    CUDA error.  A tensor in ``args`` is passed as its data pointer and
    kept alive as long as ``call``."""
    lib = library()
    fn = getattr(lib, name)
    tail = _c_args(args) + (ctypes.c_void_p(
        torch.cuda.current_stream(device).cuda_stream),)

    def call(*lead):
        _raise_on(lib, name, fn(*lead, *tail))

    call.tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return call
