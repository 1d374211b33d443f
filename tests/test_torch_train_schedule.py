"""``streamed.train_guide`` against the JAX package's
``examples/streamed_training.py`` schedule on the same rays, on the CPU in
float64.

The schedule is the example's own: the 12 x 10-ring guide (242 triangles),
12 bounces with ``remat``, 4 blocks a step, 4 momentum steps of lr 3e-3 at
momentum 0.8 on the mean lost flux.  The port draws each block from its
generator; the JAX side traces the same rays through
``engine.streamed_value_and_grad`` with the example's block loss and
update.  The losses agree step by step, and both rebound: the fourth step's
loss is above the third's, and on one of the two draws above the first's,
so the example's own test (the last loss below the first) fails in the JAX
package too.  Only the ray count is cut.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import FINISHED as J_FINISHED
from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import config, streamed

F64 = torch.float64
N_BLOCKS, STEPS, BOUNCES, LR, MOMENTUM = 4, 4, 12, 3e-3, 0.8


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; this test asks for the CPU, on
    one thread (its traces issue thousands of small operations)."""
    previous = config.set_default_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_default_device(previous)


def port_rays(block, seed):
    """The rays ``train_guide`` draws, as numpy: ``(p0, p1)`` of shape
    (steps, blocks, block, 3)."""
    source = streamed.lambertian_source(block)
    p0, p1 = [], []
    for s in range(STEPS):
        step_seed = streamed.fold_in(seed, s)
        for i in range(N_BLOCKS):
            gen = torch.Generator("cpu").manual_seed(
                streamed.fold_in(step_seed, i))
            rays = source.sample(gen, F64, "cpu")
            p0.append(rays.p0.numpy())
            p1.append(rays.p1.numpy())
    shape = (STEPS, N_BLOCKS, block, 3)
    return np.stack(p0).reshape(shape), np.stack(p1).reshape(shape)


@functools.lru_cache(maxsize=None)
def jax_example():
    """``examples/streamed_training.py``'s guide and its streamed value and
    gradient, with the step's rays passed through as aux arguments (one
    compiled program for every draw of one shape)."""
    dtype = jnp.float64
    guide = j_bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 6.0), minimum_radius=0.3,
        theta_res=12, z_res=10, rotationally_symmetric=True,
        initial_taper=(0.7, 0.0), mat_in=1, mat_out=0, dtype=dtype)
    half = 0.35
    target = JTriangleSet.make(
        [[-half, -half, 6.05], [half, half, 6.05]],
        [[half, -half, 6.05], [-half, half, 6.05]],
        [[half, half, 6.05], [-half, -half, 6.05]], dtype=dtype)
    cfg = JTraceConfig(max_bounces=BOUNCES, remat=True)
    exit_center = jnp.asarray([0.0, 0.0, 6.05], dtype)

    def block_loss(params, i, step_p0, step_p1):
        scene = JScene3D.build(optical=[guide.build(params)],
                               targets=[target])
        rays = JRaySet.make(step_p0[i], step_p1[i], streamed.WAVELENGTH,
                            dtype=dtype)
        res = j_engine.trace(rays, scene, (j_mats.vacuum, j_mats.acrylic),
                             cfg)
        dist2 = jnp.sum((res.rays.p1 - exit_center) ** 2, axis=1)
        return jnp.sum(jnp.where(res.rays.state != J_FINISHED, dist2, 0.0))

    return guide, j_engine.streamed_value_and_grad(block_loss, N_BLOCKS)


def jax_schedule(p0, p1):
    """The example's training loop on the given rays: the per-step losses
    and the final guide parameters."""
    guide, run = jax_example()
    n_total = N_BLOCKS * p0.shape[2]
    params = guide.init_params()
    vel = jnp.zeros_like(params)
    losses = []
    for s in range(STEPS):
        value, g = run(params, jnp.asarray(p0[s]), jnp.asarray(p1[s]))
        losses.append(float(value) / n_total)
        vel = MOMENTUM * vel - LR * g / n_total
        params = params + vel
    return losses, np.asarray(params)


@pytest.mark.parametrize("block,seed,last_above_first",
                         [(256, 5, False), (256, 1, True)])
def test_train_guide_schedule_matches_jax(block, seed, last_above_first):
    losses, params, _ = streamed.train_guide(
        rays_per_step=N_BLOCKS * block, block=block, steps=STEPS,
        bounces=BOUNCES, lr=LR, momentum=MOMENTUM, seed=seed, dtype=F64,
        device="cpu", verbose=False)
    j_losses, j_params = jax_schedule(*port_rays(block, seed))
    np.testing.assert_allclose(losses, j_losses, rtol=1e-9)
    np.testing.assert_allclose(params.numpy(), j_params, rtol=0, atol=1e-7)
    for ls in (losses, j_losses):
        assert ls[3] > ls[2]  # the momentum step overshoots
        assert (ls[3] > ls[0]) == last_above_first
