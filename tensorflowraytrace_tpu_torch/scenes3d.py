"""The 3D point-source scene: a point source through a curved lens and past
a mirror sphere onto a target plane.

Counterpart of ``examples/trace_3d.py`` (the reference's dev/3d_trace.py),
without its drawing: 200 rays of a ``StaticUniformSphere`` cap of half-angle
pi/24 from (-3, 0, 0) along +x at 575 nm, through a lens on a 6-ring
hexagonal mesh of radius 1 at x = 0 bent to the profile 0.3 (1 - r^2)
(acrylic inside), past a 12-ring mirror sphere of radius 0.5 at (2, 0, 2)
(acrylic inside, as in the example), onto a 40 x 40 target at x = 6;
4 bounces with the per-bounce history kept.

    res = trace_3d()                  # engine.TraceResult

It runs on CUDA unless given ``device=``, with the CUDA kernels there
(``use_kernel=None``), and in float32 unless given ``dtype=``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.config import resolve_device
from tensorflowraytrace_tpu_torch.engine import TraceConfig, start_epsilon, trace
from tensorflowraytrace_tpu_torch.models import boundaries as bd
from tensorflowraytrace_tpu_torch.models import distributions as dist
from tensorflowraytrace_tpu_torch.models import mesh as mt
from tensorflowraytrace_tpu_torch.models import sources as src
from tensorflowraytrace_tpu_torch.models.surfaces import Scene3D, TriangleSet
from tensorflowraytrace_tpu_torch.ops import materials as mats
from tensorflowraytrace_tpu_torch.ops.spectrum import YELLOW

PI = math.pi
MATERIALS = (mats.vacuum, mats.acrylic)
SAMPLE_COUNT = 200


def sphere_mesh(center, radius, n=12) -> mt.TriMesh:
    """A UV sphere: n - 1 rings of 2n points between two poles on the x
    axis, the poles fanned to the first and last rings."""
    pts = []
    faces = []
    for i in range(1, n):
        phi = PI * i / n
        for j in range(2 * n):
            theta = PI * j / n
            pts.append([radius * math.cos(phi),
                        radius * math.sin(phi) * math.cos(theta),
                        radius * math.sin(phi) * math.sin(theta)])
    top = len(pts)
    pts.append([radius, 0.0, 0.0])
    bot = len(pts)
    pts.append([-radius, 0.0, 0.0])
    ring = 2 * n
    for j in range(ring):
        faces.append([top, j, (j + 1) % ring])
        base = (n - 2) * ring
        faces.append([bot, base + (j + 1) % ring, base + j])
    for i in range(n - 2):
        for j in range(ring):
            a = i * ring + j
            b = i * ring + (j + 1) % ring
            c = (i + 1) * ring + j
            d = (i + 1) * ring + (j + 1) % ring
            faces.append([a, b, c])
            faces.append([b, d, c])
    return mt.TriMesh(np.asarray(pts) + np.asarray(center), np.asarray(faces))


def point_source_scene(max_bounces=4, keep_history=True, dtype=torch.float32,
                       device=None, use_kernel=None):
    """The scene, its rays and its trace configuration:
    ``(rays, scene, cfg)``.  ``use_kernel=None`` takes the CUDA kernels on
    a CUDA device; a float32 scene on the card starts children
    ``engine.start_epsilon`` past their surface."""
    device = resolve_device(device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    disk = mt.hexagonal_mesh(1.0, 6)
    disk.points = disk.points[:, [2, 0, 1]]
    lens_b = bd.ParametricTriangleBoundary(
        disk, bd.FromVectorVG((1.0, 0.0, 0.0)), mat_in=1, mat_out=0,
        dtype=dtype, device=device)
    r2 = np.linalg.norm(lens_b.zero.cpu().numpy()[:, 1:], axis=1) ** 2
    lens = lens_b.build(torch.as_tensor(0.3 * (1 - r2), dtype=dtype,
                                        device=device))  # a convex profile

    mirror_mesh = sphere_mesh((2.0, 0.0, 2.0), 0.5)
    corners = mirror_mesh.points[mirror_mesh.faces]
    mirror = TriangleSet.make(corners[:, 0], corners[:, 1], corners[:, 2],
                              mat_in=1, mat_out=0, dtype=dtype, device=device)

    half = 20.0
    target = TriangleSet.make(
        [[6.0, -half, -half], [6.0, half, half]],
        [[6.0, half, -half], [6.0, -half, half]],
        [[6.0, half, half], [6.0, -half, -half]], dtype=dtype, device=device)
    scene = Scene3D.build(optical=[lens, mirror], targets=[target])

    source = src.PointSource(3, (-3.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                             dist.StaticUniformSphere(PI / 24, SAMPLE_COUNT),
                             [YELLOW])
    rays = source.sample(dtype=dtype, device=device)
    cfg = TraceConfig(max_bounces=max_bounces, keep_history=keep_history,
                      use_kernel=use_kernel,
                      ray_start_epsilon=start_epsilon(scene))
    return rays, scene, cfg


def trace_3d(max_bounces=4, keep_history=True, dtype=torch.float32,
             device=None, use_kernel=None):
    """Trace the scene of :func:`point_source_scene`; returns the
    ``engine.TraceResult``."""
    rays, scene, cfg = point_source_scene(max_bounces, keep_history, dtype,
                                          device, use_kernel)
    return trace(rays, scene, MATERIALS, cfg)
