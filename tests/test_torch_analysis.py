"""Parity of the port's analysis core and ``landing_histogram_fold`` with
the JAX package's, on the CPU in float64.

* ``histogram2d``: counts exactly equal, edge clamping included (points on
  the range's ends, just outside and far outside it, and non-finite
  landing coordinates under zero weight); weighted sums within rtol 1e-12.
* ``soft_histogram2d``: values and the gradient with respect to the points
  and the weights within rtol 1e-12.
* ``DistributionDifferential``: hard (a float32 histogram, as JAX bins it:
  rtol 1e-6) and soft (rtol 1e-12, its gradient too), with an
  ``oob_penalty``.
* ``imaging_test`` on a fixed sampler (exact: both call
  ``np.histogram2d``) and ``inner_product``.
* ``landing_histogram_fold`` on a 3-bounce trace of the 3D point-source
  scene (``scenes3d``, examples/trace_3d.py): counts exactly JAX's and
  exactly ``histogram2d`` of the finished landings; with ``weight_field``
  within rtol 1e-12 of JAX's.
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import FINISHED as J_FINISHED
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import analysis as j_an
from tensorflowraytrace_tpu import landing_histogram_fold as j_fold
from tensorflowraytrace_tpu import trace as j_trace
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import mesh as j_mesh
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import FINISHED, config, landing_histogram_fold, trace
from tensorflowraytrace_tpu_torch import analysis as t_an
from tensorflowraytrace_tpu_torch import scenes3d
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

PI = math.pi
F64 = torch.float64
RANGE = ((-0.6, 0.6), (-0.5, 0.7))
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples")


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def close(t, j, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def edge_points(rng, n=400):
    """Points over and around RANGE: inside, on both ends, just and far
    outside."""
    x = rng.uniform(-1.0, 1.0, n)
    y = rng.uniform(-0.9, 1.1, n)
    x[:6] = [-0.6, 0.6, -0.6 - 1e-12, 0.6 + 1e-12, -30.0, 1e7]
    y[:6] = [0.7, -0.5, 0.7 + 1e-12, -0.5 - 1e-12, 50.0, -1e7]
    return x, y


@pytest.mark.parametrize("bins", [(16, 12), (7, None)])
def test_histogram2d_counts_equal_jax(rng, bins):
    x, y = edge_points(rng)
    x_bins, y_bins = bins
    j = j_an.histogram2d(x, y, RANGE, x_bins, y_bins)
    t = t_an.histogram2d(torch.as_tensor(x), torch.as_tensor(y), RANGE,
                         x_bins, y_bins)
    assert t.dtype == torch.float32 and t.shape == j.shape
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert float(t.sum()) == len(x)
    w = rng.uniform(0, 2, len(x))
    close(t_an.histogram2d(torch.as_tensor(x), torch.as_tensor(y), RANGE,
                           x_bins, y_bins, dtype=F64,
                           weights=torch.as_tensor(w)),
          j_an.histogram2d(x, y, RANGE, x_bins, y_bins, dtype=jnp.float64,
                           weights=jnp.asarray(w)))


def test_histogram2d_ignores_unweighted_non_finite_points():
    x = torch.tensor([0.0, float("nan"), float("inf"), -1e300], dtype=F64)
    y = torch.tensor([0.1, 0.0, float("-inf"), 1e300], dtype=F64)
    h = t_an.histogram2d(x, y, RANGE, 4, 4, dtype=F64,
                         weights=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=F64))
    assert float(h.sum()) == 1.0 and float(h[2, 2]) == 1.0


def test_soft_histogram2d_values_and_gradient_match_jax(rng):
    x, y = edge_points(rng, 300)
    x, y = x[6:], y[6:]  # away from the clamps' kinks
    w = rng.uniform(0.5, 1.5, len(x))
    probe = rng.normal(size=(10, 14))

    def j_obj(x, y, w):
        return jnp.sum(j_an.soft_histogram2d(x, y, RANGE, 14, 10, weights=w)
                       * probe)

    j_vals = j_an.soft_histogram2d(x, y, RANGE, 14, 10, weights=w)
    j_grads = jax.grad(j_obj, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(y),
                                                 jnp.asarray(w))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, y, w)]
    t_vals = t_an.soft_histogram2d(*leaves[:2], RANGE, 14, 10,
                                   weights=leaves[2])
    close(t_vals, j_vals)
    torch.sum(t_vals * torch.as_tensor(probe)).backward()
    for leaf, g in zip(leaves, j_grads):
        close(leaf.grad, g, atol=1e-12)


def test_soft_histogram2d_defaults_and_mass(rng):
    x, y = rng.uniform(-0.5, 0.5, 50), rng.uniform(-0.4, 0.6, 50)
    h = t_an.soft_histogram2d(torch.as_tensor(x), torch.as_tensor(y), RANGE, 9)
    close(h, j_an.soft_histogram2d(x, y, RANGE, 9))
    np.testing.assert_allclose(float(h.sum()), 50.0, rtol=1e-12)


@pytest.mark.parametrize("soft", [False, True])
def test_distribution_differential_matches_jax(rng, soft):
    x, y = edge_points(rng, 300)

    def goal(gx, gy):
        return np.exp(-(gx ** 2 + (gy - 0.1) ** 2) / 0.1)

    def penalty(d):
        return d ** 2

    j_dd = j_an.DistributionDifferential(goal, RANGE, 12, 10,
                                         oob_penalty=penalty, soft=soft)
    t_dd = t_an.DistributionDifferential(goal, RANGE, 12, 10,
                                         oob_penalty=penalty, soft=soft)
    j_val = j_dd(x, y)
    xt, yt = (torch.tensor(a, requires_grad=True) for a in (x, y))
    t_val = t_dd(xt, yt)
    # the hard histogram is float32, as JAX bins it; the soft one float64
    rtol = 1e-12 if soft else 1e-6
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=rtol)
    close(t_dd.saved_histo, j_dd.saved_histo, rtol=rtol, atol=rtol * 1e-2)
    if soft:
        j_g = jax.grad(lambda a, b: j_dd(a, b), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(y))
        t_val.backward()
        close(xt.grad, j_g[0], atol=1e-12)
        close(yt.grad, j_g[1], atol=1e-12)
    with pytest.raises(ValueError):
        t_an.DistributionDifferential(np.ones(3), RANGE)
    # an explicit goal image, no penalty
    image = goal(*np.meshgrid(np.linspace(-0.55, 0.55, 12),
                              np.linspace(-0.45, 0.65, 10)))
    np.testing.assert_allclose(
        float(t_an.DistributionDifferential(image, RANGE, soft=soft)(
            torch.as_tensor(x), torch.as_tensor(y))),
        float(j_an.DistributionDifferential(image, RANGE, soft=soft)(x, y)),
        rtol=rtol)


def test_imaging_test_and_inner_product_match_jax(rng):
    batches = [rng.normal(0, 0.4, (50, 3)) for _ in range(4)]

    def sampler(as_tensor):
        it = iter(batches)
        return lambda: torch.as_tensor(next(it)) if as_tensor else next(it)

    for weighted in (False, True):
        t = t_an.imaging_test(sampler(True), RANGE, batch_count=4, bins=16,
                              verbose=False, weighted=weighted)
        j = j_an.imaging_test(sampler(False), RANGE, batch_count=4, bins=16,
                              verbose=False, weighted=weighted)
        for a, b in zip(t[:3], j[:3]):
            np.testing.assert_array_equal(a, b)
        assert t[3] is None
    with pytest.raises(ValueError):
        t_an.imaging_test(lambda: torch.zeros(3, 2), RANGE, batch_count=1,
                          verbose=False, weighted=True)
    a, b = rng.uniform(size=(5, 6)), rng.uniform(size=(5, 6))
    assert t_an.inner_product(torch.as_tensor(a), b) == pytest.approx(
        j_an.inner_product(a, b), rel=1e-14)


def jax_point_source_scene(max_bounces):
    """examples/trace_3d.py's scene in the JAX package (its own sphere_mesh),
    with the port's default epsilons (float64)."""
    spec = importlib.util.spec_from_file_location(
        "trace_3d_example", os.path.join(EXAMPLES, "trace_3d.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    disk = j_mesh.hexagonal_mesh(1.0, 6)
    pts = disk.points.copy()
    disk.points = np.stack([pts[:, 2], pts[:, 0], pts[:, 1]], axis=1)
    lens_b = j_bd.ParametricTriangleBoundary(
        disk, j_bd.FromVectorVG((1.0, 0.0, 0.0)), mat_in=1, mat_out=0,
        dtype=jnp.float64)
    r2 = np.linalg.norm(np.asarray(lens_b.zero)[:, 1:], axis=1) ** 2
    lens = lens_b.build(jnp.asarray(0.3 * (1 - r2)))
    sphere = example.sphere_mesh((2.0, 0.0, 2.0), 0.5)
    mirror = JTriangleSet.from_vertices_faces(sphere.points, sphere.faces,
                                              mat_in=1, mat_out=0,
                                              dtype=jnp.float64)
    half = 20.0
    target = JTriangleSet.make(
        [[6.0, -half, -half], [6.0, half, half]],
        [[6.0, half, -half], [6.0, -half, half]],
        [[6.0, half, half], [6.0, -half, -half]], dtype=jnp.float64)
    source = j_src.PointSource(3, (-3.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                               j_dist.StaticUniformSphere(PI / 24, 200), [575.0])
    rays = source.sample(jax.random.PRNGKey(0), jnp.float64)
    scene = JScene3D.build(optical=[lens, mirror], targets=[target])
    cfg = JTraceConfig(max_bounces=max_bounces)
    return rays, scene, (j_mats.vacuum, j_mats.acrylic), cfg


def test_landing_histogram_fold_matches_jax_and_histogram2d(rng):
    rays, scene, cfg = scenes3d.point_source_scene(
        max_bounces=3, keep_history=False, dtype=F64, device="cpu")
    j_rays, j_scene, j_mats_, j_cfg = jax_point_source_scene(3)
    w = rng.uniform(0.5, 2.0, rays.n_rays)
    rays = rays.with_field("w", torch.as_tensor(w))
    j_rays = j_rays.with_field("w", jnp.asarray(w))

    init, fn = landing_histogram_fold(RANGE, 16, 12, dtype=F64, axes=(1, 2),
                                      device="cpu")
    res = trace(rays, scene, scenes3d.MATERIALS, cfg, fold_fn=fn,
                fold_init=init)
    j_init, j_fn = j_fold(RANGE, 16, 12, dtype=jnp.float64, axes=(1, 2))
    j_res = j_trace(j_rays, j_scene, j_mats_, j_cfg, fold_fn=j_fn,
                    fold_init=j_init)
    fin = res.rays.state == FINISHED
    assert int(fin.sum()) == int((j_res.rays.state == J_FINISHED).sum()) > 100
    np.testing.assert_array_equal(res.fold.numpy(), np.asarray(j_res.fold))
    p1 = res.rays.p1[fin]
    np.testing.assert_array_equal(
        res.fold.numpy(),
        t_an.histogram2d(p1[:, 1], p1[:, 2], RANGE, 16, 12, dtype=F64).numpy())
    # the default float32 image on the device given
    init32, fn32 = landing_histogram_fold(RANGE, 16, 12, axes=(1, 2),
                                          device="cpu")
    res32 = trace(rays, scene, scenes3d.MATERIALS, cfg, fold_fn=fn32,
                  fold_init=init32)
    assert res32.fold.dtype == torch.float32
    np.testing.assert_array_equal(res32.fold.numpy(), res.fold.numpy())

    # weighted by a ray field, read from the record's fields
    init, fn = landing_histogram_fold(RANGE, 16, 12, dtype=F64, axes=(1, 2),
                                      weight_field="w", device="cpu")
    res = trace(rays, scene, scenes3d.MATERIALS, cfg, fold_fn=fn,
                fold_init=init, fold_fields=True)
    j_init, j_fn = j_fold(RANGE, 16, 12, dtype=jnp.float64, axes=(1, 2),
                          weight_field="w")
    j_res = j_trace(j_rays, j_scene, j_mats_, j_cfg, fold_fn=j_fn,
                    fold_init=j_init, fold_fields=True)
    close(res.fold, j_res.fold)
    with pytest.raises(KeyError, match="fold_fields"):
        trace(rays, scene, scenes3d.MATERIALS, cfg, fold_fn=fn, fold_init=init)
