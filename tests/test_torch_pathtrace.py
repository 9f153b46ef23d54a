"""The fused bounce (K2): the port's plain version against gvr_tpu's Pallas
bounce kernel in interpret mode, at the bars of
tests/test_pallas_kernels.py:_check, and the CUDA kernel against the plain
version on the card."""

import jax.numpy as jnp
import pytest
import torch

from _torch_common import check_bounce, port_scene, random_rays
from gvr_tpu.kernels.pathtrace import bounce_step_pallas
from gvr_tpu.kernels.pathtrace import pack_table as jax_pack_table
from gvr_tpu.scene.generators import random_gaussian_scene
from gvr_tpu.scene.scene import parse_gmm as jax_parse_gmm
from gvr_tpu_torch.kernels import pathtrace as tpt

LIGHTS = {0: (), 3: ((0.0, 5.0, 0.1, 50.0, 0.0, 0.0),
                     (-3.0, 3.0, 0.3, 0.0, 30.0, 0.0),
                     (3.0, 3.0, -0.2, 0.0, 0.0, 30.0))}


def _scene(n_lights):
    # the test_small_kernel_matches_xla configuration
    return jax_parse_gmm(random_gaussian_scene(
        120, seed=1, diameter=(0.1, 0.4), density=(0.5, 2.0),
        lights=LIGHTS[n_lights]))


@pytest.mark.parametrize("finisher", [False, True])
@pytest.mark.parametrize("n_lights", [0, 3])
def test_bounce_reference_matches_pallas(finisher, n_lights):
    sc = _scene(n_lights)
    o, d, xi = random_rays(512, seed=0)
    want = bounce_step_pallas(
        jax_pack_table(sc.medium), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(xi), sc.lights_p, sc.lights_i, sc.env_color,
        solver_iters=14, interpret=True, finisher=finisher)
    ts = port_scene(sc)
    before = (tpt.bounce_core_reference.launches, tpt.bounce_step.launches)
    got = tpt.bounce_step(tpt.pack_table(ts.medium), torch.from_numpy(o),
                          torch.from_numpy(d), torch.from_numpy(xi),
                          ts.lights(), ts.env_color, solver_iters=14,
                          finisher=finisher)
    assert (tpt.bounce_core_reference.launches,
            tpt.bounce_step.launches) == (before[0] + 1, before[1])
    check_bounce([x.numpy() for x in got[:5]], want)
    if finisher:
        assert got[5].any()           # the analytic root was taken somewhere
