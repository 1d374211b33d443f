"""The slice's two ``Optimizer(optax_tx=...)`` designs against the same
loss and update written with the JAX package's API and optax, on the CPU
in float64, at small sizes.

* ``examples/asphere_singlet.py`` at resolution 16 and 20 rays: 5 steps of
  the asphere design (Adam under the cosine schedule, the freedom mask)
  against ``optax`` on ``jax.grad``: per-step squared spots and the
  parameters within rtol 1e-9.
* ``examples/strehl_lens.py`` at 16 segments and 24 rays: 3 Adam steps of
  the first stage, then the Strehl at 550 nm: within rtol 1e-9.

BASELINE config 2 and the image-quality test are in
``tests/test_torch_baseline_designs.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import trace as j_trace
from tensorflowraytrace_tpu.analysis import huygens_psf as j_huygens_psf
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.models.rays import RaySet as JRaySet
from tensorflowraytrace_tpu.operations import (
    optical_path_reaction as j_optical_path_reaction,
)
from tensorflowraytrace_tpu.operations import seed_optical_path as j_seed_opl
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import config, scenes2d

F64 = torch.float64
J64 = jnp.float64
RTOL = 1e-9
STEPS = 5


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU, on
    one torch thread (the traces are many small operations)."""
    previous = config.set_default_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_default_device(previous)


def close(t, j, rtol=RTOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=1e-15)


# ----------------------------------------------------------------------
# the asphere singlet
# ----------------------------------------------------------------------

def jax_asphere(resolution, n_rays):
    """``examples/asphere_singlet.py``'s ``spot_sq`` in float64."""
    materials = (j_mats.vacuum,
                 j_mats.build_constant_material(scenes2d.ASPHERE_GLASS))
    cfg = JTraceConfig(max_bounces=scenes2d.ASPHERE_BOUNCES)
    front = j_bd.ParametricAsphereSegment(
        scenes2d.ASPHERE_X[0], scenes2d.ASPHERE_SURF_AP,
        resolution=resolution, n_aspheric=1, mat_in=1, mat_out=0, dtype=J64)
    back = j_bd.ParametricAsphereSegment(
        scenes2d.ASPHERE_X[1], scenes2d.ASPHERE_SURF_AP,
        resolution=resolution, n_aspheric=1, mat_in=0, mat_out=1, dtype=J64)
    screen = JSegmentSet.make([[scenes2d.ASPHERE_SCREEN_X, -3.0]],
                              [[scenes2d.ASPHERE_SCREEN_X, 3.0]], dtype=J64)
    ys = jnp.linspace(-scenes2d.ASPHERE_HALF_AP, scenes2d.ASPHERE_HALF_AP,
                      n_rays, dtype=J64)
    p0 = jnp.stack([jnp.full((n_rays,), -1.0, J64), ys], axis=1)
    rays = JRaySet.make(p0, p0 + jnp.asarray([1.0, 0.0], J64), 550.0,
                        dtype=J64)

    def spot_sq(params):
        scene = JScene2D.build(
            optical_segments=[front.build(params[:3]), back.build(params[3:])],
            target_segments=[screen])
        res = j_trace(rays, scene, materials, cfg)
        return jnp.mean(res.rays.p1[:, 1] ** 2)

    return spot_sq


def test_asphere_singlet_steps_match_jax():
    lr, mask = 6e-3, scenes2d.ASPHERE_MASK
    vag = jax.jit(jax.value_and_grad(jax_asphere(16, 20)))
    tx = optax.adam(optax.cosine_decay_schedule(lr, STEPS, alpha=1e-2))
    params = jnp.asarray(scenes2d.ASPHERE_START, J64)
    state = tx.init(params)
    j_err = []
    for _ in range(STEPS):
        v, g = vag(params)
        upd, state = tx.update(g * jnp.asarray(mask, J64), state)
        params = optax.apply_updates(params, upd)
        j_err.append(float(v))
    spot_sq, start = scenes2d.asphere_problem(16, 20, F64, "cpu")
    assert not spot_sq.cfg.use_kernel
    opt = scenes2d.asphere_optimizer(spot_sq, start, mask, STEPS, lr)
    close(opt.run_phase(STEPS), j_err)
    close(opt.parameters[0], params)


# ----------------------------------------------------------------------
# the Strehl lens
# ----------------------------------------------------------------------

def jax_strehl(n_segments, n_rays):
    """``examples/strehl_lens.py``'s ``strehl(xs, lam)`` in float64."""
    materials = (j_mats.vacuum,
                 j_mats.build_constant_material(scenes2d.STREHL_GLASS))
    cfg = JTraceConfig(max_bounces=2)
    reaction = j_optical_path_reaction()
    half = scenes2d.STREHL_HALF_AP
    ys_v = jnp.linspace(-1.15 * half, 1.15 * half, n_segments + 1, dtype=J64)
    ray_ys = jnp.linspace(-half, half, n_rays, dtype=J64)
    p0 = jnp.stack([jnp.full((n_rays,), scenes2d.STREHL_LAUNCH_X, J64),
                    ray_ys], axis=1)
    rays = j_seed_opl(JRaySet.make(p0, p0 + jnp.asarray([1.0, 0.0], J64),
                                   550.0, dtype=J64))
    focus = scenes2d.STREHL_FOCUS
    target = JSegmentSet.make([[focus, -3.0]], [[focus, 3.0]], dtype=J64)
    grid = jnp.asarray([[focus, 0.0]], J64)

    def strehl(xs, lam):
        verts = jnp.stack([xs, ys_v], axis=1)
        surf = JSegmentSet.make(verts[:-1], verts[1:], mat_in=1, mat_out=0,
                                dtype=J64)
        scene = JScene2D.build(optical_segments=[surf],
                               target_segments=[target])
        res = j_trace(rays, scene, materials, cfg, reaction=reaction)
        amp = (res.rays.state == 1).astype(xs.dtype)
        peak = j_huygens_psf(res.rays.p0, res.rays.fields["opl"], lam, grid,
                             amplitudes=amp,
                             medium_n=scenes2d.STREHL_GLASS)[0]
        return peak / jnp.maximum(jnp.sum(amp), 1.0) ** 2

    return strehl, np.asarray(ys_v)


def test_strehl_lens_steps_match_jax():
    j_strehl, ys = jax_strehl(16, 24)
    lam, lr, _ = scenes2d.strehl_stages(3)[0]
    tx = optax.adam(lr)
    xs = jnp.asarray(scenes2d.strehl_sphere_x(ys), J64)
    state = tx.init(xs)
    vg = jax.jit(jax.value_and_grad(lambda q: -j_strehl(q, lam)))
    j_err = []
    for _ in range(3):
        v, g = vg(xs)
        upd, state = tx.update(g, state, xs)
        xs = optax.apply_updates(xs, upd)
        j_err.append(float(v))
    t_strehl, t_ys = scenes2d.strehl_problem(16, 24, F64, "cpu")
    np.testing.assert_allclose(t_ys, ys, rtol=1e-15, atol=1e-16)
    opt = scenes2d.strehl_optimizer(
        t_strehl, torch.as_tensor(scenes2d.strehl_sphere_x(ys)), lam, lr)
    close(opt.run_phase(3), j_err)
    close(opt.parameters[0], xs)
    with torch.no_grad():
        close(t_strehl(opt.parameters[0], scenes2d.STREHL_LAMBDA),
              jax.jit(j_strehl)(xs, scenes2d.STREHL_LAMBDA))
