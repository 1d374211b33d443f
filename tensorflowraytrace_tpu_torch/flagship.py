"""The flagship problem: a two-surface parametric lens imaging a square.

Counterpart of ``_flagship`` and ``entry`` in the repository's
``__graft_entry__.py`` and of ``examples/simple_3d_optimize.py`` (the
reference's dev/simple_3d_optimize.py): a random square source 4 units
before a lens of two hexagonal-mesh surfaces, imaged at magnification 2 onto
a target plane; the loss is the squared distance of each finished ray's
landing point from where its base point should image.

    forward, (params, generator) = entry()     # one forward step
    loss = forward(params, generator)
    errors, params = train()                   # the lens-design run

Both run on CUDA unless given ``device=``; there is no CPU fallback.
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

SOURCE_DISTANCE = 4.0
MAGNIFICATION = 2.0
OBJECT_SIZE = 0.2


def target_plane(dtype, device):
    """The image plane: a 100 x 100 square at x = 8, as two triangles."""
    half = 50.0
    td = SOURCE_DISTANCE * MAGNIFICATION
    return TriangleSet.make(
        [[td, -half, -half], [td, half, half]],
        [[td, half, -half], [td, -half, half]],
        [[td, half, half], [td, -half, -half]], dtype=dtype, device=device)


def lens_mesh(mesh_steps):
    """The lens surfaces' zero mesh: a hexagon of radius 1.2 with
    ``mesh_steps`` rings, turned from the z = 0 plane to face the optical
    axis x."""
    mesh = mt.hexagonal_mesh(1.2, mesh_steps)
    mesh.points = mesh.points[:, [2, 0, 1]]
    return mesh


def _flagship(dtype, bp_count, mesh_steps, max_bounces, use_kernel, device,
              vertex_update_map=None):
    """Build the problem.  Returns ``(lens, source, loss)`` where
    ``loss(params, rays)`` traces ``rays`` through the lens built from
    ``params`` (a list of per-surface tensors; None = the lens's own
    parameters).  ``vertex_update_map`` limits which faces move which
    vertices (``mesh.mesh_parametrization_tools``)."""
    ray_count = bp_count * bp_count
    base_points = dist.RandomUniformSquare(OBJECT_SIZE, bp_count)
    angles = dist.RandomUniformSphere(math.pi / 16.0, ray_count)
    source = src.AngularSource(
        3, (-SOURCE_DISTANCE, 0.0, 0.0), (1.0, 0.0, 0.0), angles, base_points,
        # an array, not a list: at 2^20 rays a list costs ~0.1 s per sample
        np.full(ray_count, 575.0), dense=False,
    )

    lens = bd.ParametricMultiTriangleBoundary(
        lens_mesh(mesh_steps), bd.FromVectorVG((1.0, 0.0, 0.0)),
        [bd.ThicknessConstraint(0.0, "min"), bd.ThicknessConstraint(0.2, "min")],
        [True, False], vertex_update_map=vertex_update_map,
        material_list=[{"mat_in": 1, "mat_out": 0}] * 2,
        dtype=dtype, device=device,
    )
    target = target_plane(dtype, device)

    materials = (mats.vacuum, mats.acrylic)
    # ray_start_epsilon at the initial lens
    cfg = TraceConfig(max_bounces=max_bounces, use_kernel=use_kernel,
                      ray_start_epsilon=start_epsilon(Scene3D.build(
                          optical=lens.build(), targets=[target])))
    goal_scale = -(MAGNIFICATION * OBJECT_SIZE)

    def loss(params, rays):
        surfaces = lens.build(params)
        scene = Scene3D.build(optical=surfaces, targets=[target])
        res = trace(rays, scene, materials, cfg)
        fin = res.rays.state == FINISHED
        out = res.rays.p1[:, 1:]
        goal = res.rays.fields["rank"] * goal_scale
        per_ray = torch.sum((out - goal) ** 2, dim=1)
        return torch.sum(torch.where(fin, per_ray, torch.zeros_like(per_ray)))

    return lens, source, loss


def entry(device=None, use_kernel=None):
    """Forward step of the flagship at its full size: 32 x 32 base points
    (1024 rays), 8 mesh rings per surface, 4 bounces, float32.  Runs on
    CUDA unless given ``device``, with the CUDA kernels there.
    Returns ``(forward, (params, generator))``."""
    device = resolve_device(device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    dtype = torch.float32
    lens, source, loss = _flagship(dtype, bp_count=32, mesh_steps=8,
                                   max_bounces=4, use_kernel=use_kernel,
                                   device=device)
    generator = torch.Generator(device=device).manual_seed(0)

    def forward(params, generator):
        rays = source.sample(generator, dtype=dtype, device=device)
        return loss(params, rays)

    return forward, (lens.param_list(), generator)


def training_tools(mesh_steps):
    """The vertex update map, gradient accumulator and smoother of the lens
    mesh, as ``examples/simple_3d_optimize.py`` makes them."""
    mesh = lens_mesh(mesh_steps)
    top = mt.get_closest_point(mesh, (0, 0, 0))
    vertex_update_map, accumulator = mt.mesh_parametrization_tools(mesh, top)
    smoother = mt.mesh_smoothing_tool(mesh, [300, 50, 20, 10, 5])
    return vertex_update_map, accumulator, smoother


def routine(steps, accumulator, smoother):
    """The three training phases of ``examples/simple_3d_optimize.py``."""
    return [
        {"steps": steps // 2, "learning_rate": 2e-4, "momentum": 0.8,
         "accumulators": [accumulator] * 2, "smoothers": [smoother] * 2},
        {"steps": steps // 3, "learning_rate": (1e-4, 5e-5), "momentum": 0.9,
         "accumulators": [accumulator] * 2, "smoothers": [smoother] * 2},
        {"steps": steps - steps // 2 - steps // 3,
         "learning_rate": (5e-5, 2e-5), "momentum": 0.95,
         "accumulators": [accumulator] * 2},
    ]


def train(steps=150, bp_count=45, mesh_steps=8, max_bounces=3, device=None,
          use_kernel=None):
    """Design the flagship lens by gradient descent: the optimization of
    ``examples/simple_3d_optimize.py`` (its defaults: 45 x 45 = 2025 rays
    per step, 217-vertex surfaces, 3 bounces, 150 steps in three phases with
    the mesh accumulator and smoother, ``grad_clip=1e-3``, each phase
    chained) in float32, without its STL export and imaging page.  Every
    step samples fresh rays from one generator seeded 0.  Runs on
    CUDA unless given ``device``, with the CUDA kernels there.

    Returns ``(errors, params)``: the per-step errors (a list of floats)
    and the final per-surface parameters.
    """
    device = resolve_device(device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    dtype = torch.float32
    vertex_update_map, accumulator, smoother = training_tools(mesh_steps)
    lens, source, loss = _flagship(dtype, bp_count, mesh_steps, max_bounces,
                                   use_kernel, device, vertex_update_map)

    def error(params, generator):
        return loss(params, source.sample(generator, dtype, device))

    opt = Optimizer(error, lens.init_params(), learning_rate=1.0,
                    grad_clip=1e-3,
                    generator=torch.Generator(device).manual_seed(0))
    errors = opt.training_routine(routine(steps, accumulator, smoother),
                                  report_frequency=0, show_time=False,
                                  chain=True)
    return errors, opt.parameters
