"""The port's counter-hash RNG against gvr_tpu's path_uniforms: bit-exact.

The plain version runs int64 arithmetic masked to 32 bits with split
16-bit multiplies; these tests pin it to the JAX uint32 chain on pixel ids
up to 2^31 - 1, the jitter tag and seeds on both sides of 2^31."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (sets torch threads)
from gvr_tpu.ops.sampling import path_uniforms as jax_path_uniforms
from gvr_tpu_torch.kernels import rng as trng
from gvr_tpu_torch.ops.sampling import path_uniforms

N_TRIPLES = 100_000


def _triples(seed):
    r = np.random.default_rng(seed)
    pid = r.integers(0, 2**31 - 1, N_TRIPLES, dtype=np.int64)
    pid[:4] = [0, 1, 2**31 - 1, 2**31 - 2]
    sample = r.integers(0, 1 << 20, N_TRIPLES, dtype=np.int64)
    bounce = r.integers(0, 64, N_TRIPLES, dtype=np.int64)
    bounce[::7] = trng.JITTER_TAG
    return pid.astype(np.int32), sample.astype(np.int32), \
        bounce.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 77, 2**32 - 1])
def test_path_uniforms_bit_exact(seed):
    pid, sample, bounce = _triples(seed & 0xFFFF)
    # a uint32 array: JAX refuses Python ints >= 2^31 as int32 scalars
    want = np.asarray(jax_path_uniforms(jnp.asarray(pid), jnp.asarray(sample),
                                        jnp.asarray(bounce), 9,
                                        jnp.asarray(np.uint32(seed))))
    got = path_uniforms(torch.from_numpy(pid), torch.from_numpy(sample),
                        torch.from_numpy(bounce), 9, seed).numpy()
    assert got.dtype == np.float32 and got.shape == (N_TRIPLES, 9)
    assert np.array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("bounce", ["array", "jitter_tag"])
def test_planes_uniforms_cpu_is_plain_and_bit_exact(bounce):
    pid, sample, b = _triples(3)
    pid2, s2 = pid.reshape(400, 250), sample.reshape(400, 250)
    b_arg = b.reshape(400, 250) if bounce == "array" else trng.JITTER_TAG
    want = np.asarray(jax_path_uniforms(
        jnp.asarray(pid2), jnp.asarray(s2),
        jnp.asarray(b_arg) if bounce == "array" else b_arg, 3, 7))
    before = (trng.planes_uniforms_reference.launches,
              trng.planes_uniforms.launches)
    got = trng.planes_uniforms(
        torch.from_numpy(pid2), torch.from_numpy(s2),
        torch.from_numpy(b_arg) if bounce == "array" else b_arg, 3, 7)
    assert (trng.planes_uniforms_reference.launches,
            trng.planes_uniforms.launches) == (before[0] + 1, before[1])
    assert got.shape == (3, 400, 250)
    assert np.array_equal(np.moveaxis(got.numpy(), 0, -1), want)


def test_mix32_py_matches_jax_kernel_helper():
    from gvr_tpu.kernels.rng import _mix32_py
    for x in (0, 1, 2**31, 2**32 - 1, 0xDEADBEEF):
        assert trng.mix32_py(x) == _mix32_py(x)


@pytest.mark.parametrize("bounce", ["array", "static"])
@pytest.mark.parametrize("seed", [0, 2**31 + 77])
def test_wave_uniforms_plain_is_both_launches(bounce, seed):
    """The wavefronts' one K3 launch (plain version on the CPU): planes 0-1
    are the jitter pair and planes 2-10 the bounce's nine draws, each bit
    for bit the separate planes_uniforms_reference call it replaces and
    JAX's path_uniforms, with a bounce array and with one bounce for
    every lane (a static bounce on the old side)."""
    pid, sample, b = _triples(seed & 0xFFFF)
    pid, sample, b = pid[:5000], sample[:5000], b[:5000]
    b_old = b if bounce == "array" else 5
    b_new = b if bounce == "array" else np.full_like(b, 5)
    t = lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    before = (trng.wave_uniforms_reference.launches,
              trng.wave_uniforms.launches)
    got = trng.wave_uniforms(t(pid), t(sample), t(b_new), seed)
    assert (trng.wave_uniforms_reference.launches,
            trng.wave_uniforms.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.float32 and got.shape == (11, 5000)
    jit = trng.planes_uniforms_reference(t(pid), t(sample), trng.JITTER_TAG,
                                         2, seed)
    xi = trng.planes_uniforms_reference(t(pid), t(sample), t(b_old), 9, seed)
    assert torch.equal(got[:2], jit) and torch.equal(got[2:], xi)
    j = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
    s = jnp.asarray(np.uint32(seed))
    want_jit = np.asarray(jax_path_uniforms(j(pid), j(sample),
                                            trng.JITTER_TAG, 2, s))
    want_xi = np.asarray(jax_path_uniforms(j(pid), j(sample), j(b_old), 9,
                                           s))
    assert np.array_equal(got[:2].numpy().T, want_jit)
    assert np.array_equal(got[2:].numpy().T, want_xi)
    out = torch.empty((11, 5000))
    assert trng.wave_uniforms(t(pid), t(sample), t(b_new), seed,
                              out=out) is out
    assert torch.equal(out, got)
