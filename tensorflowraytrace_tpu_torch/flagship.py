"""The flagship problem: a two-surface parametric lens imaging a square.

Counterpart of ``_flagship`` and ``entry`` in the repository's
``__graft_entry__.py`` (the reference's dev/simple_3d_optimize.py): a random
square source 4 units before a lens of two hexagonal-mesh surfaces, imaged
at magnification 2 onto a target plane; the loss is the squared distance
of each finished ray's landing point from where its base point should
image.

    forward, (params, generator) = entry()
    loss = forward(params, generator)
"""

from __future__ import annotations

import math

import torch

from tensorflowraytrace_tpu_torch.config import FINISHED
from tensorflowraytrace_tpu_torch.engine import TraceConfig, trace
from tensorflowraytrace_tpu_torch.models import boundaries as bd
from tensorflowraytrace_tpu_torch.models import distributions as dist
from tensorflowraytrace_tpu_torch.models import mesh as mt
from tensorflowraytrace_tpu_torch.models import sources as src
from tensorflowraytrace_tpu_torch.models.surfaces import Scene3D, TriangleSet
from tensorflowraytrace_tpu_torch.ops import materials as mats

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


def _flagship(dtype, bp_count, mesh_steps, max_bounces, use_kernel, device):
    """Build the problem.  Returns ``(lens, source, loss)`` where
    ``loss(params, rays)`` traces ``rays`` through the lens built from
    ``params`` (a list of per-surface tensors; None = the lens's own
    parameters)."""
    ray_count = bp_count * bp_count
    base_points = dist.RandomUniformSquare(OBJECT_SIZE, bp_count)
    angles = dist.RandomUniformSphere(math.pi / 16.0, ray_count)
    source = src.AngularSource(
        3, (-SOURCE_DISTANCE, 0.0, 0.0), (1.0, 0.0, 0.0), angles, base_points,
        [575.0] * ray_count, dense=False,
    )

    zero_mesh = mt.hexagonal_mesh(1.2, mesh_steps)
    pts = zero_mesh.points.copy()
    # the mesh is generated in the z = 0 plane; the optical axis is x
    zero_mesh.points = pts[:, [2, 0, 1]]
    lens = bd.ParametricMultiTriangleBoundary(
        zero_mesh, bd.FromVectorVG((1.0, 0.0, 0.0)),
        [bd.ThicknessConstraint(0.0, "min"), bd.ThicknessConstraint(0.2, "min")],
        [True, False], material_list=[{"mat_in": 1, "mat_out": 0}] * 2,
        dtype=dtype, device=device,
    )
    target = target_plane(dtype, device)

    materials = (mats.vacuum, mats.acrylic)
    cfg = TraceConfig(max_bounces=max_bounces, use_kernel=use_kernel)
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
    CUDA when it is available, with the CUDA triangle search there.
    Returns ``(forward, (params, generator))``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
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
