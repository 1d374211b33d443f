"""The slice as a whole against the JAX package, on the CPU in float64:
the hexalens problem of ``examples/hexalens.py`` and the point-source trace
of ``examples/trace_3d.py``, at the size ``tests/test_examples.py`` runs
the hexalens (128 rays, mesh edge 0.3).

* The hexalens loss and its gradient with respect to both surfaces'
  parameters within rtol 1e-9 of JAX's, at the same parameters and the
  same draws (the port is fed the uniforms JAX's samplers draw from the
  key); the final ray states exactly JAX's.  ``use_kernel`` runs K1's
  plain version (the kernel's arithmetic in PyTorch) in place of the
  Cramer search.
* ``scenes3d.trace_3d``: the per-bounce and final states exactly JAX's,
  the landing points within rtol 1e-9.
* Two port training steps (``hexalens.train``, float32) lower the error
  on a fixed sample of rays.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_analysis import jax_point_source_scene
from tensorflowraytrace_tpu import FINISHED as J_FINISHED
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import trace as j_trace
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import mesh as j_mesh
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import FINISHED, config, hexalens, scenes3d
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from tensorflowraytrace_tpu_torch.utils.convert import hexalens_params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
RAYS, MESH_STEP = 128, 0.3
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples")


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_hexalens(ray_count, mesh_step):
    """examples/hexalens.py's source, lens, target and loss in float64:
    ``(lens, run, loss)`` with ``run(params, key)`` the trace and
    ``loss(result)`` the example's loss of a trace result."""
    ex = load_example("hexalens")
    start = j_dist.RandomUniformCircle(ray_count, ex.OBJECT_SIZE)
    end = j_dist.RandomUniformCircle(ray_count, 0.98 * ex.LENS_APERATURE,
                                     theta_start=ex.THETA_START,
                                     theta_end=ex.THETA_END)
    source = j_src.AperatureSource(
        3, j_dist.BasePointTransformation(
            start, translation=(-ex.SOURCE_DISTANCE, 0.0, 0.0), lift_to_3d=True),
        j_dist.BasePointTransformation(end, lift_to_3d=True),
        [575.0] * ray_count, dense=False, rank_domain="start_point",
        extra_fields={"aperature_polar_ranks": ("end_point", end, "polar_ranks")})
    zero_mesh = ex.wedge_mesh(ex.LENS_APERATURE, mesh_step, ex.THETA_START,
                              ex.THETA_END)
    top = j_mesh.get_closest_point(zero_mesh, (0.0, 0.0, 0.0))
    vum, _ = j_mesh.mesh_parametrization_tools(zero_mesh, top)
    lens = j_bd.ParametricMultiTriangleBoundary(
        zero_mesh, j_bd.FromVectorVG((1.0, 0.0, 0.0)),
        [j_bd.ThicknessConstraint(0.0, "min"), j_bd.ThicknessConstraint(0.2, "min")],
        [True, False], vertex_update_map=vum,
        material_list=[{"mat_in": 1, "mat_out": 0}] * 2, dtype=jnp.float64)
    half, td = 50.0, ex.TARGET_DISTANCE
    target = JTriangleSet.make(
        [[td, -half, -half], [td, half, half]],
        [[td, half, -half], [td, -half, half]],
        [[td, half, half], [td, -half, -half]], dtype=jnp.float64)
    cfg = JTraceConfig(max_bounces=3)
    goal_scale = -(ex.MAGNIFICATION * ex.OBJECT_SIZE)
    outer = jnp.asarray(ex.OUTER_DISPLACEMENT)

    def run(params, key):
        scene = JScene3D.build(optical=lens.build(params), targets=[target])
        return j_trace(source.sample(key, jnp.float64), scene,
                       (j_mats.vacuum, j_mats.acrylic), cfg)

    def loss(res):
        finished = res.rays.state == J_FINISHED
        out = res.rays.p1[:, 1:]
        inner_goal = res.rays.fields["rank"] * goal_scale
        is_inner = res.rays.fields["aperature_polar_ranks"][:, 0] < 1.0 / 3.0
        goal = jnp.where(is_inner[:, None], inner_goal, inner_goal + outer)
        return jnp.sum(jnp.where(finished, jnp.sum((out - goal) ** 2, axis=1),
                                 0.0))

    return lens, run, loss


def jax_uniforms(key, n):
    """The draws JAX's hexalens source makes from ``key``: it splits the key
    between its two circles, and each circle splits its own between r^2 and
    theta."""
    def rows(k):
        return np.stack([np.array(jax.random.uniform(kk, (n,), jnp.float64))
                         for kk in jax.random.split(k)])

    ks, ke = jax.random.split(key)
    return {"start_point": rows(ks), "end_point": rows(ke)}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's loss, gradient and final states at random parameters, once."""
    j_lens, j_run, j_loss = jax_hexalens(RAYS, MESH_STEP)
    rng = np.random.default_rng(42)
    params = [rng.normal(0, 0.02, np.asarray(p).shape)
              for p in j_lens.init_params()]
    key = jax.random.PRNGKey(3)

    def loss_and_states(p):
        res = j_run(p, key)
        return j_loss(res), res.rays.state

    (j_val, j_states), j_grads = jax.value_and_grad(
        loss_and_states, has_aux=True)([jnp.asarray(p) for p in params])
    return params, key, float(j_val), [np.asarray(g) for g in j_grads], \
        np.asarray(j_states)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_hexalens_loss_gradient_and_states_match_jax(jax_side, use_kernel):
    params, key, j_val, j_grads, j_states = jax_side
    lens, source, loss = hexalens.problem(RAYS, MESH_STEP, F64, "cpu",
                                          use_kernel)
    hexalens_params_from_numpy(lens, params)
    rays = source.sample(dtype=F64, device="cpu",
                         uniforms=jax_uniforms(key, RAYS))
    launches = tk.LAUNCHES
    val = loss(None, rays)
    val.backward()
    assert tk.LAUNCHES == launches  # no CUDA kernel on the CPU
    assert j_val > 0
    np.testing.assert_allclose(float(val.detach()), j_val, rtol=1e-9)
    for p, g in zip(lens.param_list(), j_grads):
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-9,
                                   atol=1e-12 * np.abs(g).max())
    with torch.no_grad():
        res = loss.trace(None, rays)
    np.testing.assert_array_equal(res.rays.state.numpy(), j_states)
    assert (j_states == J_FINISHED).sum() > RAYS // 2


def test_trace_3d_states_match_jax():
    res = scenes3d.trace_3d(dtype=F64, device="cpu")
    j_rays, j_scene, j_materials, _ = jax_point_source_scene(4)
    j_res = j_trace(j_rays, j_scene, j_materials,
                    JTraceConfig(max_bounces=4, keep_history=True))
    np.testing.assert_array_equal(res.history_state.numpy(),
                                  np.asarray(j_res.history_state))
    np.testing.assert_array_equal(res.rays.state.numpy(),
                                  np.asarray(j_res.rays.state))
    counts = np.bincount(res.rays.state.numpy(), minlength=4)
    np.testing.assert_array_equal(
        counts, np.bincount(np.asarray(j_res.rays.state), minlength=4))
    assert counts[FINISHED] == 200
    np.testing.assert_allclose(res.rays.p1.numpy(), np.asarray(j_res.rays.p1),
                               rtol=1e-9, atol=1e-12)


def test_two_training_steps_lower_the_error():
    errors, params = hexalens.train(steps=2, ray_count=RAYS,
                                    mesh_step=MESH_STEP, device="cpu")
    assert len(errors) == 2 and np.all(np.isfinite(errors))
    lens, source, loss = hexalens.problem(512, MESH_STEP, device="cpu")
    rays = source.sample(torch.Generator().manual_seed(11), device="cpu")
    with torch.no_grad():
        before = float(loss(lens.init_params(), rays))
        after = float(loss(params, rays))
    assert after < before
