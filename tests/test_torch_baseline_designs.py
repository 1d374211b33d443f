"""BASELINE config 2 and the image-quality test of the hexalens against
the same loss, update and trace written with the JAX package's API, on the
CPU in float64, at small sizes.

* BASELINE config 2 (``tests/test_config2_multisegment.py``): its first
  step and 4 more through the builtin optimizer on both sides: errors and
  parameters within rtol 1e-9.
* ``examples/image_quality_3d.py`` on a coarse hexalens exported as STL
  (mesh edge 0.3): the same rays through the STL surfaces land the same
  (states equal, landing points within 1e-9), and the port's histogram of
  two batches equals ``np.histogram2d`` of the JAX landings.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import FINISHED as J_FINISHED
from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import concat_rays as j_concat_rays
from tensorflowraytrace_tpu import trace as j_trace
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import mesh as j_mesh
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.models.rays import RaySet as JRaySet
from tensorflowraytrace_tpu.optim import Optimizer as JOptimizer
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu.ops.spectrum import RAINBOW_6
from tensorflowraytrace_tpu_torch import FINISHED, config, hexalens, scenes2d
from tensorflowraytrace_tpu_torch import scenes3d, trace
from tensorflowraytrace_tpu_torch.optim import Optimizer

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
# BASELINE config 2
# ----------------------------------------------------------------------

def jax_config2():
    """``tests/test_config2_multisegment.py``'s lens, rays and loss."""
    zero = j_dist.StaticUniformAperaturePoints((0.0, -1.2), (0.0, 1.2), 21)
    one = j_dist.StaticUniformAperaturePoints((1.0, -1.2), (1.0, 1.2), 21)
    lens = j_bd.ParametricMultiSegmentBoundary(
        zero, one,
        [j_bd.ThicknessConstraint(0.0, "min"),
         j_bd.ThicknessConstraint(0.15, "min")],
        flip_norm=[True, False],
        material_list=[{"mat_in": 1, "mat_out": 0}] * 2, dtype=J64)
    target = JSegmentSet.make([[6.0, -50.0]], [[6.0, 50.0]], dtype=J64)
    beam = j_dist.StaticUniformBeam(-1.0, 1.0, 10)
    angles = j_dist.StaticUniformAngularDistribution(0.0, 0.0, 1)
    s1 = j_src.AngularSource(2, (-2.0, 0.0), 0.0, angles, beam, RAINBOW_6)
    ap_start = j_dist.StaticUniformAperaturePoints((-2.0, -0.8), (-2.0, 0.8), 8)
    ap_end = j_dist.StaticUniformAperaturePoints((-1.0, -0.8), (-1.0, 0.8), 8)
    s2 = j_src.AperatureSource(2, ap_start, ap_end, [575.0] * 8, dense=False)
    rays0 = j_concat_rays([s1.sample(dtype=J64), s2.sample(dtype=J64)])
    materials = (j_mats.vacuum, j_mats.flint_glass)
    cfg = JTraceConfig(max_bounces=4)

    def loss(params, key):
        scene = JScene2D.build(optical_segments=lens.build(params),
                               target_segments=[target])
        res = j_trace(rays0, scene, materials, cfg)
        fin = res.rays.state == J_FINISHED
        return jnp.sum(jnp.where(fin, res.rays.p1[:, 1] ** 2, 0.0))

    return lens, rays0, loss


def test_config2_steps_match_jax():
    lens, rays0, j_loss = jax_config2()
    j_opt = JOptimizer(j_loss, lens.init_params(), learning_rate=1.0,
                       grad_clip=5e-3)
    t_lens, t_rays, _, t_loss = scenes2d.multisegment_problem(F64, "cpu")
    np.testing.assert_array_equal(t_rays.wavelength.numpy(),
                                  np.asarray(rays0.wavelength))
    close(t_rays.p1, rays0.p1, 1e-15)
    t_opt = Optimizer(t_loss, t_lens.init_params(), learning_rate=1.0,
                      grad_clip=5e-3)
    kw = dict(lr_scale=2e-3, momentum=0.8)
    close(t_opt.single_step(None, **kw), j_opt.single_step(None, **kw))
    # the JAX side steps one by one (one compile instead of two)
    close(t_opt.run_phase(STEPS - 1, None, **kw),
          [j_opt.single_step(None, **kw) for _ in range(STEPS - 1)])
    for t, j in zip(t_opt.parameters, j_opt.parameters):
        close(t, j)


# ----------------------------------------------------------------------
# the image quality of the hexalens, through STL
# ----------------------------------------------------------------------

def jax_stl_scene(first, second):
    """The two STL surfaces and the example's target with the JAX API, in
    float64 (``TriangleSet.from_vertices_faces``: the JAX package's
    ``manual_triangle_boundary`` makes float32 triangles whatever dtype
    it is given)."""
    def surface(path):
        mesh = j_mesh.TriMesh.read(path)
        return JTriangleSet.from_vertices_faces(
            jnp.asarray(mesh.points, J64), mesh.faces, mat_in=1, mat_out=0,
            dtype=J64)

    half, td = 50.0, scenes3d.IMAGE_SOURCE_DISTANCE
    target = JTriangleSet.make(
        [[td, -half, -half], [td, half, half]],
        [[td, half, -half], [td, -half, half]],
        [[td, half, half], [td, -half, -half]], dtype=J64)
    return JScene3D.build(optical=[surface(first), surface(second)],
                          targets=[target])


def test_image_quality_3d_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    lens, _, _ = hexalens.problem(mesh_step=0.3, dtype=F64, device="cpu")
    params = [torch.as_tensor(rng.uniform(-0.05, 0.05, p.shape[0]))
              for p in lens.init_params()]
    first, second, built = scenes3d.hexalens_stls(params, mesh_step=0.3,
                                                  out_dir=tmp_path,
                                                  device="cpu")
    for path, surf in zip((first, second), built):
        back = scenes3d.bd.manual_triangle_boundary(file_name=path,
                                                    dtype=F64, device="cpu")
        # the STL reader rounds to 7 decimals before merging vertices
        np.testing.assert_allclose(back.vp.numpy(), surf.vp.detach().numpy(),
                                   rtol=0, atol=1e-7)
    batches, n = 2, 300
    out = scenes3d.image_quality_3d(batches, n, first_stl=first,
                                    second_stl=second, dtype=F64,
                                    device="cpu")
    assert not out["cfg"].use_kernel
    # the same draws again, traced by both packages
    source = scenes3d.image_quality_source(n)
    gen = torch.Generator().manual_seed(scenes3d.IMAGE_SEED)
    j_scene = jax_stl_scene(first, second)
    j_run = jax.jit(lambda r: j_trace(r, j_scene, (j_mats.vacuum,
                                                   j_mats.acrylic),
                                      JTraceConfig(max_bounces=3)))
    landed = []
    for _ in range(batches):
        rays = source.sample(gen, F64, "cpu")
        res = trace(rays, out["scene"], scenes3d.MATERIALS, out["cfg"])
        j_res = j_run(JRaySet.make(rays.p0.numpy(), rays.p1.numpy(),
                                   rays.wavelength.numpy(), dtype=J64))
        np.testing.assert_array_equal(res.rays.state.numpy(),
                                      np.asarray(j_res.rays.state))
        close(res.rays.p1, j_res.rays.p1)
        fin = np.asarray(j_res.rays.state) == J_FINISHED
        landed.append(np.asarray(j_res.rays.p1)[fin][:, 1:])
        assert int((res.rays.state == FINISHED).sum()) == int(fin.sum()) > 0
    pts = np.concatenate(landed)
    ext = scenes3d.IMAGE_EXTENT
    h, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=scenes3d.IMAGE_BINS,
                             range=[[-ext, ext]] * 2)
    np.testing.assert_array_equal(out["histogram"], h)
    assert out["landed"] == int(h.sum()) > 0
    assert math.isclose(out["central"] + out["displaced"],
                        sum(scenes3d.image_fluxes(h, out["xedges"])[1:]))
