"""The hexalens: a 30-degree wedge lens designed to form two images.

Counterpart of ``examples/hexalens.py`` (the reference's dev/hexalens.py),
without its drawing.  An aperture source sends rays from a disk of radius
0.2 (the object, 10 units before the lens) to random points of the lens's
wedge aperture (theta in [0, pi/6], radius 0.98).  The lens is a
ParametricMultiTriangleBoundary of two surfaces on a ``circular_mesh``
wedge turned to face +x, with thickness constraints and the mesh's vertex
update map; the target plane is at x = 10.  Each ray carries two goals
through the trace: ``rank``, the object point over the object radius
(the start points' circle ranks), and ``aperature_polar_ranks``, the
polar coordinates of its aperture point, taken from the same draw as the
end points.  A ray through the inner third of the aperture radius should
land on the inverted image of its object point, a ray through the outer two
thirds on the same image moved by ``OUTER_DISPLACEMENT``; the loss is the
summed squared distance of each finished ray from its goal.

    lens, source, loss = problem()          # loss(params, rays)
    errors, params = train()                # the example's design run

Both run on CUDA unless given ``device=``, with the CUDA kernels there
(``use_kernel=None``), in float32 (``problem`` takes a ``dtype=``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.config import FINISHED, resolve_device
from tensorflowraytrace_tpu_torch.engine import TraceConfig, start_epsilon, trace
from tensorflowraytrace_tpu_torch.models import boundaries as bd
from tensorflowraytrace_tpu_torch.models import distributions as dist
from tensorflowraytrace_tpu_torch.models import mesh as mt
from tensorflowraytrace_tpu_torch.models import sources as src
from tensorflowraytrace_tpu_torch.models.surfaces import Scene3D, TriangleSet
from tensorflowraytrace_tpu_torch.ops import materials as mats
from tensorflowraytrace_tpu_torch.optim import Optimizer

PI = math.pi

SOURCE_DISTANCE = 10.0
MAGNIFICATION = 1.0
TARGET_DISTANCE = SOURCE_DISTANCE * MAGNIFICATION
OBJECT_SIZE = 0.2
OUTER_DISPLACEMENT = (0.6, 0.0)
LENS_APERATURE = 1.0
THETA_START, THETA_END = 0.0, PI / 6
WAVELENGTH = 575.0
MAX_BOUNCES = 3
MATERIALS = (mats.vacuum, mats.acrylic)
# where the two images land on the target plane, (y, z)
IMAGE_RANGE = ((-0.6, 1.2), (-0.6, 0.6))


def wedge_mesh(radius, step, theta_start, theta_end):
    """A wedge of a disk (``mesh.circular_mesh``) turned from the z = 0
    plane to face +x."""
    mesh = mt.circular_mesh(radius, step, theta_start=theta_start,
                            theta_end=theta_end)
    mesh.points = mesh.points[:, [2, 0, 1]]
    return mesh


def lens_tools(mesh_step):
    """The lens's zero mesh, its vertex update map and gradient accumulator
    (``mesh_parametrization_tools`` from the vertex nearest the axis)."""
    mesh = wedge_mesh(LENS_APERATURE, mesh_step, THETA_START, THETA_END)
    top = mt.get_closest_point(mesh, (0.0, 0.0, 0.0))
    vertex_update_map, accumulator = mt.mesh_parametrization_tools(mesh, top)
    return mesh, vertex_update_map, accumulator


def make_source(ray_count):
    """Object disk to lens-aperture wedge, one ray per start point, with the
    end points' polar ranks as the field ``aperature_polar_ranks``.  Its
    ``uniforms`` are keyed ``start_point`` and ``end_point``, two rows each
    (``RandomUniformCircle``'s)."""
    start_points = dist.RandomUniformCircle(ray_count, OBJECT_SIZE)
    end_points = dist.RandomUniformCircle(
        ray_count, 0.98 * LENS_APERATURE, theta_start=THETA_START,
        theta_end=THETA_END)
    return src.AperatureSource(
        3,
        dist.BasePointTransformation(
            start_points, translation=(-SOURCE_DISTANCE, 0.0, 0.0),
            lift_to_3d=True),
        dist.BasePointTransformation(end_points, lift_to_3d=True),
        np.full(ray_count, WAVELENGTH), dense=False,
        rank_domain="start_point",
        extra_fields={
            "aperature_polar_ranks": ("end_point", end_points, "polar_ranks"),
        },
    )


def target_plane(dtype, device):
    """The image plane: a 100 x 100 square at x = TARGET_DISTANCE."""
    half, x = 50.0, TARGET_DISTANCE
    return TriangleSet.make(
        [[x, -half, -half], [x, half, half]],
        [[x, half, -half], [x, -half, half]],
        [[x, half, half], [x, -half, -half]], dtype=dtype, device=device)


class Objective:
    """The hexalens's trace and loss at given lens parameters (a list of
    per-surface tensors; None: the lens's own)."""

    def __init__(self, lens, target, cfg):
        self.lens = lens
        self.target = target
        self.cfg = cfg
        self._outer = torch.as_tensor(OUTER_DISPLACEMENT,
                                      dtype=target.vp.dtype,
                                      device=target.vp.device)

    def trace(self, params, rays, **trace_kw):
        """``engine.trace`` of ``rays`` through the lens at ``params`` onto
        the target (``trace_kw``: folds, ...)."""
        scene = Scene3D.build(optical=self.lens.build(params),
                              targets=[self.target])
        return trace(rays, scene, MATERIALS, self.cfg, **trace_kw)

    def __call__(self, params, rays):
        res = self.trace(params, rays)
        finished = res.rays.state == FINISHED
        out = res.rays.p1[:, 1:]
        # the inverted image of the object point (rank = object yz over the
        # object radius), moved for rays through the outer aperture
        inner_goal = res.rays.fields["rank"] * -(MAGNIFICATION * OBJECT_SIZE)
        is_inner = res.rays.fields["aperature_polar_ranks"][:, 0] < 1.0 / 3.0
        goal = torch.where(is_inner[:, None], inner_goal,
                           inner_goal + self._outer)
        per_ray = torch.sum((out - goal) ** 2, dim=1)
        return torch.sum(torch.where(finished, per_ray,
                                     torch.zeros_like(per_ray)))


def problem(ray_count=2000, mesh_step=0.08, dtype=torch.float32, device=None,
            use_kernel=None):
    """Build the hexalens problem at ``ray_count`` rays a sample and a mesh
    of edge ``mesh_step``.  ``use_kernel=None`` takes the CUDA kernels on a
    CUDA device.  Returns ``(lens, source, loss)``: ``loss(params, rays)``
    is an :class:`Objective`, whose ``trace`` method traces without the
    loss.  A float32 scene on the card starts children
    ``engine.start_epsilon`` past their surface, taken at the initial
    lens."""
    device = resolve_device(device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    mesh, vertex_update_map, _ = lens_tools(mesh_step)
    lens = bd.ParametricMultiTriangleBoundary(
        mesh, bd.FromVectorVG((1.0, 0.0, 0.0)),
        [bd.ThicknessConstraint(0.0, "min"), bd.ThicknessConstraint(0.2, "min")],
        [True, False], vertex_update_map=vertex_update_map,
        material_list=[{"mat_in": 1, "mat_out": 0}] * 2,
        dtype=dtype, device=device)
    target = target_plane(dtype, device)
    cfg = TraceConfig(max_bounces=MAX_BOUNCES, use_kernel=use_kernel,
                      ray_start_epsilon=start_epsilon(Scene3D.build(
                          optical=lens.build(), targets=[target])))
    return lens, make_source(ray_count), Objective(lens, target, cfg)


def routine(steps, accumulator):
    """The example's two phases: accumulated SGD at momentum 0.5, no
    smoother (the bifocal goal needs a sharp ring at r = 1/3)."""
    return [
        {"steps": steps // 2, "learning_rate": 1e-4, "momentum": 0.5,
         "accumulators": [accumulator] * 2},
        {"steps": steps - steps // 2, "learning_rate": (5e-5, 1e-5),
         "momentum": 0.5, "accumulators": [accumulator] * 2},
    ]


def train(steps=150, ray_count=2000, mesh_step=0.08, device=None,
          use_kernel=None):
    """Design the hexalens: the optimization of ``examples/hexalens.py``
    (its defaults: 2000 rays a step, mesh edge 0.08, 3 bounces, 150 steps
    in two chained phases, ``grad_clip=1e-3``) in float32, without its STL
    export and image.  Every step samples fresh rays from one generator
    seeded 0.
    Returns ``(errors, params)``: the per-step errors (floats) and the final
    per-surface parameters."""
    device = resolve_device(device)
    dtype = torch.float32
    lens, source, loss = problem(ray_count, mesh_step, dtype, device,
                                 use_kernel)
    _, _, accumulator = lens_tools(mesh_step)

    def error(params, generator):
        return loss(params, source.sample(generator, dtype, device))

    opt = Optimizer(error, lens.init_params(), learning_rate=1.0,
                    grad_clip=1e-3,
                    generator=torch.Generator(device).manual_seed(0))
    errors = opt.training_routine(routine(steps, accumulator),
                                  report_frequency=0, show_time=False,
                                  chain=True)
    return errors, opt.parameters
