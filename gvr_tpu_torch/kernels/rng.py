"""Counter-hash RNG: the plain version and the CUDA kernel (K3).

Replaces ``gvr_tpu/kernels/rng.py:86 _uniforms_call`` (body ``_make_kernel``
:70 around ``_uniform_cols`` :50).  A splitmix32 chain keyed by
(pixel, sample, bounce, seed) gives n uniforms in [0,1) from the 23 high
bits, bit-exact with ``gvr_tpu/ops/sampling.path_uniforms``.

Plain version: torch's CPU uint32 has no ``>>``, ``+`` or compare, so the
chain runs on int64 masked to 32 bits.  A product of two 32-bit values
overflows int64, so every multiply is split into 16-bit halves
(``_mul32``) and every intermediate stays below 2^49.

Kernels (``csrc/rng.cuh`` device functions): one thread a lane, native
uint32 arithmetic, ~40 integer ops a (pixel, sample, bounce) key and ~14 a
draw, 4 bytes written a draw, so bound by the output writes.  The
megakernel (K1) inlines them.  The grid and big-N wavefronts launch
``wave_uniforms`` (``kernels.cu:gvr_wave_uniforms``) once an iteration: it
keys a lane's path once and writes the jitter pair and the bounce's draws
in one launch, where two launches paid their host dispatch twice.
``planes_uniforms`` (``kernels.cu:gvr_uniforms``, one key an element)
draws for the other integrators and the inverse renderer
(``ops/sampling.uniform_planes``).
"""

from __future__ import annotations

import ctypes

import torch

from gvr_tpu_torch.kernels import _build

MASK = 0xFFFFFFFF
_M1, _M2, _M3 = 0x9E3779B9, 0x21F0AAAD, 0x735A2D97
JITTER_TAG = 0x7FFF0000          # the bounce tag of the sub-pixel jitter


def mix32_py(x: int) -> int:
    """splitmix32 finalizer on a Python int (host-side seed mixing)."""
    x = (x + _M1) & MASK
    x = ((x ^ (x >> 16)) * _M2) & MASK
    x = ((x ^ (x >> 15)) * _M3) & MASK
    return x ^ (x >> 15)


def seed_words(seed: int):
    """(seed_mix, seed_raw) as the kernels take them."""
    raw = seed & MASK
    return mix32_py(raw), raw


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK


def _mix32(x):
    x = (x + _M1) & MASK
    x = _mul32(x ^ (x >> 16), _M2)
    x = _mul32(x ^ (x >> 15), _M3)
    return x ^ (x >> 15)


def _as_u32(x, like):
    """An int or integer tensor as int64 holding its uint32 bit pattern."""
    if isinstance(x, int):
        return torch.full_like(like, x & MASK)
    return x.to(torch.int64) & MASK


def uniform_cols(pid, sample, bounce, n: int, seed: int = 0):
    """n float32 tensors of pid's shape: the path_uniforms hash chain.

    pid is an integer tensor; sample and bounce are integer tensors that
    broadcast against it, or ints (bounce e.g. JITTER_TAG)."""
    pid = pid.to(torch.int64) & MASK
    s = _as_u32(sample, pid)
    b = _as_u32(bounce, pid)
    seed_mix, seed_raw = seed_words(seed)
    h1 = _mix32(_mul32(pid, 0x85EBCA6B) ^ _mul32(s, 0xC2B2AE35) ^ seed_mix)
    h2 = _mix32((_mul32(pid ^ 0xDEADBEEF, 0x9E3779B1)
                 + _mul32(s, 0x6C078965) + seed_raw) & MASK)
    b1 = _mix32(h1 ^ _mul32(b, 0x27D4EB2F))
    b2 = _mix32((h2 + _mul32(b, 0x41C64E6D)) & MASK)
    cols = []
    for i in range(n):
        c = _mix32(((b1 ^ ((0x165667B1 * (i + 1)) & MASK)) + b2) & MASK)
        cols.append((c >> 9).to(torch.float32) * (2.0 ** -23))
    return cols


def planes_uniforms_reference(pid, sample, bounce, n: int, seed: int = 0):
    """Plain version of K3: [n, *pid.shape] float32 uniforms."""
    planes_uniforms_reference.launches += 1
    return torch.stack(uniform_cols(pid, sample, bounce, n, seed), dim=0)


planes_uniforms_reference.launches = 0


def planes_uniforms(pid, sample, bounce, n: int, seed: int = 0):
    """[n, *pid.shape] float32 uniforms, bit-exact with path_uniforms.

    pid/sample: int32 tensors of one shape; bounce: an int32 tensor of that
    shape or an int (e.g. JITTER_TAG).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if pid.device.type == "cpu":
        return planes_uniforms_reference(pid, sample, bounce, n, seed)
    static = isinstance(bounce, int)
    tensors = {"pid": pid, "sample": sample}
    if not static:
        tensors["bounce"] = bounce
    for name, t in tensors.items():
        _build.check(t, name, torch.int32, pid.shape, pid.device)
    out = torch.empty((n,) + tuple(pid.shape), dtype=torch.float32,
                      device=pid.device)
    seed_mix, seed_raw = seed_words(seed)
    _build.launch(
        "gvr_uniforms", _build.ptr(pid), _build.ptr(sample),
        None if static else _build.ptr(bounce),
        ctypes.c_uint32((bounce if static else 0) & MASK),
        ctypes.c_int(pid.numel()), ctypes.c_int(n),
        ctypes.c_uint32(seed_mix), ctypes.c_uint32(seed_raw),
        _build.ptr(out), device=pid.device)
    planes_uniforms.launches += 1
    return out


planes_uniforms.launches = 0


# Draws of a bounce that the wavefronts' K3 launch writes after the jitter
# pair: the bounce's xi[0..8] (free flight, NEE choice and direction, RR,
# the scattered direction)
BOUNCE_DRAWS = 9


def wave_uniforms_reference(pid, sample, bounce, seed: int = 0):
    """Plain version of the wavefront's K3 launch: [2 + BOUNCE_DRAWS,
    *pid.shape] float32, the jitter pair (bounce tag JITTER_TAG) of each
    (pid, sample) and then the draws of its bounce."""
    wave_uniforms_reference.launches += 1
    return torch.stack(
        uniform_cols(pid, sample, JITTER_TAG, 2, seed)
        + uniform_cols(pid, sample, bounce, BOUNCE_DRAWS, seed), dim=0)


wave_uniforms_reference.launches = 0


def wave_uniforms(pid, sample, bounce, seed: int = 0, out=None):
    """One wavefront iteration's uniforms, [2 + BOUNCE_DRAWS, B] float32:
    planes 0-1 the jitter pair of (pid, sample), the others the draws of
    (pid, sample, bounce), each bit-exact with path_uniforms.  pid, sample,
    bounce: int32 [B].  ``out``, if given, is the float32 output buffer to
    write (a loop allocates it once).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if pid.device.type == "cpu":
        res = wave_uniforms_reference(pid, sample, bounce, seed)
        return res if out is None else out.copy_(res)
    dev = pid.device
    b = pid.shape[0]
    for name, t in (("pid", pid), ("sample", sample), ("bounce", bounce)):
        _build.check(t, name, torch.int32, (b,), dev)
    if out is None:
        out = torch.empty((2 + BOUNCE_DRAWS, b), dtype=torch.float32,
                          device=dev)
    _build.check(out, "out", torch.float32, (2 + BOUNCE_DRAWS, b), dev)
    seed_mix, seed_raw = seed_words(seed)
    _build.launch(
        "gvr_wave_uniforms", _build.ptr(pid), _build.ptr(sample),
        _build.ptr(bounce), ctypes.c_int(b), ctypes.c_int(BOUNCE_DRAWS),
        ctypes.c_uint32(seed_mix), ctypes.c_uint32(seed_raw),
        _build.ptr(out), device=dev)
    wave_uniforms.launches += 1
    return out


wave_uniforms.launches = 0
