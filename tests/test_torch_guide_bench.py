"""``scenes3d.structured_guide`` and ``scenes3d.guide_trace_bench`` against
examples/guide_trace_bench.py on the CPU.

The example builds its guide and rays inside ``main`` in the JAX
package's default float32; here the same construction runs through the
JAX package in float64 (the example's guide, Morton sort, target and
numpy rays) against ``structured_guide`` in float64, at the example's CI
size in tests/test_examples.py's CASES (512 rays, 3 bounces, 6 x 6
facets): the triangles, the rays and the traced endpoints within rtol
1e-9.  Then ``guide_trace_bench`` at that size, with the kernels' plain
versions (``use_kernel=True`` on the CPU: ``"grid"`` + re-sort, ``cull``
± re-sort, brute) and without: its four checksums equal, and equal to the
JAX trace's within rtol 1e-9 in float64.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import trace as j_trace
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.models.acceleration import (
    morton_sort_triangles as j_morton_sort_triangles,
)
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import config, scenes3d
from tensorflowraytrace_tpu_torch.engine import TraceConfig, trace
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
J64 = jnp.float64
N_RAYS, BOUNCES, THETA_RES, Z_RES = 512, 3, 6, 6


@pytest.fixture(autouse=True)
def on_cpu():
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def close(t, j, rtol=1e-9, atol=1e-12):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def jax_guide():
    """The example's scene and rays, built in float64."""
    guide = j_bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 40.0), minimum_radius=0.3,
        theta_res=THETA_RES, z_res=Z_RES, rotationally_symmetric=True,
        initial_taper=(0.7, 0.0), mat_in=1, mat_out=0, dtype=J64)
    surf, _ = j_morton_sort_triangles(guide.build(guide.init_params()))
    half = 0.35
    target = JTriangleSet.make(
        [[-half, -half, 40.05], [half, half, 40.05]],
        [[half, -half, 40.05], [-half, half, 40.05]],
        [[half, half, 40.05], [-half, -half, 40.05]], dtype=J64)
    scene = JScene3D.build(optical=[surf], targets=[target])
    rng = np.random.default_rng(0)
    r = 0.2 * np.sqrt(rng.uniform(0, 1, N_RAYS))
    th = rng.uniform(0, 2 * math.pi, N_RAYS)
    p0 = np.stack([r * np.cos(th), r * np.sin(th), np.full(N_RAYS, 0.1)],
                  1).astype(np.float32)
    d = rng.normal(0, 1, (N_RAYS, 3))
    d[:, 2] = np.abs(d[:, 2]) * 3 + 1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = JRaySet.make(jnp.asarray(p0, J64),
                        jnp.asarray(p0 + d.astype(np.float32), J64), 575.0,
                        dtype=J64)
    return rays, scene


def test_structured_guide_matches_jax():
    j_rays, j_scene = jax_guide()
    rays, scene = scenes3d.structured_guide(N_RAYS, THETA_RES, Z_RES, F64,
                                            "cpu")
    assert scene.triangles.n_surfaces == j_scene.triangles.n_surfaces == 74
    for f in ("vp", "v1", "v2"):
        close(getattr(scene.triangles, f), getattr(j_scene.triangles, f))
    close(rays.p0, j_rays.p0)
    close(rays.p1, j_rays.p1)
    j_res = j_trace(j_rays, j_scene, (j_mats.vacuum, j_mats.acrylic),
                    JTraceConfig(max_bounces=BOUNCES))
    res = trace(rays, scene, scenes3d.MATERIALS,
                TraceConfig(max_bounces=BOUNCES))
    assert np.array_equal(res.rays.state.numpy(), np.asarray(j_res.rays.state))
    close(res.rays.p1, j_res.rays.p1)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_guide_trace_bench_runs(use_kernel):
    j_rays, j_scene = jax_guide()
    j_sum = float(j_trace(j_rays, j_scene, (j_mats.vacuum, j_mats.acrylic),
                          JTraceConfig(max_bounces=BOUNCES)).rays.p1.sum())
    out = scenes3d.guide_trace_bench(N_RAYS, BOUNCES, THETA_RES, Z_RES,
                                     reps=1, use_kernel=use_kernel,
                                     dtype=F64, device="cpu", verbose=False)
    assert [m for m, _ in scenes3d.GUIDE_MODES] == list(out["modes"])
    sums = {v["checksum"] for v in out["modes"].values()}
    assert len(sums) == 1
    close(sums.pop(), j_sum)
    assert out["triangles"] == 74
    # float32, as the example and the card run it: the modes agree
    out32 = scenes3d.guide_trace_bench(N_RAYS, BOUNCES, THETA_RES, Z_RES,
                                       reps=0, use_kernel=use_kernel,
                                       device="cpu", verbose=False)
    assert len({v["checksum"] for v in out32["modes"].values()}) == 1
