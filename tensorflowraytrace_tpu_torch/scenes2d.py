"""The 2D problems the port is driven with: one trainable arc, a tapered
light guide at full width, and the random sets of the kernel checks.

- ``single_arc``: the problem of ``examples/optimize_single_arc.py`` (the
  reference's dev/optimize_single_arc.py).  A uniform beam at 6 wavelengths
  passes through one refractive arc whose centre x equals its radius (the
  one trained parameter, so the arc's left rim stays at the origin) into
  acrylic, onto a target segment at x = 10; the loss is the sum of the
  squared landing heights of the finished rays.
- ``light_guide``: a 40-long acrylic guide of two tapered polyline walls
  through (x, +-h(x)), h(x) = 1 - 0.3 (x/40)^2, closed by an entry segment
  at x = 0 and an exit face at x = 40 of convex lenslet arcs across
  |y| <= 0.7, with a target segment at x = 50, |y| <= 10.  Every surface is
  traversed clockwise (normals point out; acrylic is ``mat_in``), as in
  ``examples/light_guide.py``, whose source (a Lambertian fan from a beam
  just before the entry) and trace settings (``dead_ray_length`` 10, up to
  50 bounces) it keeps.  The segments and the arcs are Morton-sorted.
- ``guide_design``: the light guide as a design problem, its lenslets'
  centres and radii the parameters and the squared landing heights of the
  rays that finish on the target the loss (``landing_loss_fold``), summed
  bounce by bounce so that a 50-bounce trace keeps no history.
- ``random_segments``, ``random_arcs``, ``random_rays``: the sets of
  ``examples/tpu_kernel_check.py``, Morton-sorted.

Both build on CUDA unless given ``device=``; there is no CPU fallback.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.config import FINISHED, resolve_device
from tensorflowraytrace_tpu_torch.engine import (
    TraceConfig, landing_sum_fold, trace,
)
from tensorflowraytrace_tpu_torch.models import distributions as dist
from tensorflowraytrace_tpu_torch.models import sources as src
from tensorflowraytrace_tpu_torch.models.acceleration import (
    morton_sort_arcs, morton_sort_segments,
)
from tensorflowraytrace_tpu_torch.models.surfaces import ArcSet, Scene2D, SegmentSet
from tensorflowraytrace_tpu_torch.ops import materials as mats

PI = math.pi
# red, orange, yellow, green, blue, purple (nm)
RAINBOW_6 = (680.0, 620.0, 575.0, 510.0, 450.0, 400.0)

GUIDE_LENGTH = 40.0
EXIT_HALF_HEIGHT = 0.7
TARGET_X = 50.0
GUIDE_BOUNCES = 50
DEAD_RAY_LENGTH = 10.0


# ----------------------------------------------------------------------
# one trainable arc
# ----------------------------------------------------------------------

def single_arc(beam_count=10, dtype=torch.float32, device=None,
               max_bounces=2, use_kernel=False):
    """The single-arc focusing problem.  Returns ``(loss, params)``:
    ``loss(params) -> scalar``, the squared landing heights of the finished
    rays with the arc built from ``params[0][0]``, and the initial
    ``params`` ``[tensor([5.0])]``.  ``beam_count`` beam points times the 6
    wavelengths are traced (10 in the example)."""
    device = resolve_device(device)
    beam = dist.StaticUniformBeam(-1.5, 1.5, beam_count)
    angles = dist.StaticUniformAngularDistribution(0.0, 0.0, 1)
    source = src.AngularSource(2, (-1.0, 0.0), 0.0, angles, beam, RAINBOW_6)
    rays = source.sample(dtype=dtype, device=device)
    target = SegmentSet.make([[10.0, -5.0]], [[10.0, 5.0]], dtype=dtype,
                             device=device)
    materials = (mats.vacuum, mats.acrylic)
    cfg = TraceConfig(max_bounces=max_bounces, use_kernel=use_kernel)

    def build_scene(p):
        arc = ArcSet.make(torch.stack([torch.stack([p, torch.zeros_like(p)])]),
                          3 * PI / 4, 5 * PI / 4, p, mat_in=1, mat_out=0,
                          dtype=dtype, device=device)
        return Scene2D.build(optical_arcs=[arc], target_segments=[target])

    def loss(params):
        res = trace(rays, build_scene(params[0][0]), materials, cfg)
        finished = res.rays.state == FINISHED
        return torch.sum(torch.where(finished, res.rays.p1[:, 1] ** 2, 0.0))

    return loss, [torch.tensor([5.0], dtype=dtype, device=device)]


# ----------------------------------------------------------------------
# the light guide
# ----------------------------------------------------------------------

def guide_surfaces(n_wall=2048, n_lenslets=512):
    """The guide's geometry as float64 numpy arrays: ``(segments, target,
    lenslets)`` with ``segments = (p0, p1)`` of its 2 * n_wall + 1 wall and
    entry segments, ``target = (p0, p1)`` of the target segment and
    ``lenslets = (center, angle_start, angle_end, radius)`` of the exit
    face's arcs."""
    x = GUIDE_LENGTH * np.arange(n_wall + 1) / n_wall
    h = 1.0 - 0.3 * (x / GUIDE_LENGTH) ** 2
    top = np.stack([x, h], 1)
    bottom = np.stack([x, -h], 1)
    # clockwise: top wall left to right, bottom wall right to left, entry up
    p0 = np.concatenate([top[:-1], bottom[1:], [[0.0, -1.0]]])
    p1 = np.concatenate([top[1:], bottom[:-1], [[0.0, 1.0]]])

    # lenslet k spans y in [y_k, y_k + w] at x = 40: an arc about a centre
    # w inside the face through both ends, bulging out by ~0.118 w
    w = 2 * EXIT_HALF_HEIGHT / n_lenslets
    y_mid = -EXIT_HALF_HEIGHT + w * (np.arange(n_lenslets) + 0.5)
    center = np.stack([np.full(n_lenslets, GUIDE_LENGTH - w), y_mid], 1)
    half_angle = math.atan2(w / 2, w)
    radius = np.full(n_lenslets, math.hypot(w, w / 2))
    lenslets = (center, np.full(n_lenslets, -half_angle),
                np.full(n_lenslets, half_angle), radius)
    target = (np.array([[TARGET_X, -10.0]]), np.array([[TARGET_X, 10.0]]))
    return (p0, p1), target, lenslets


def light_guide(n_rays=1 << 20, n_wall=2048, n_lenslets=512,
                dtype=torch.float32, device=None, generator=None,
                uniforms=None):
    """The light guide: ``(rays, scene, materials)``.  ``n_rays`` rays start
    on a beam across |y| <= 0.95 at x = -0.001, in Lambertian directions
    within +-0.4 pi of +x (``AngularSource(2, (-0.001, 0), 0,
    RandomLambertianAngularDistribution(-0.4 pi, 0.4 pi, N),
    RandomUniformBeam(-0.95, 0.95, N), [575] * N, dense=False)``), drawn
    from ``generator`` (seeded 0 when none is given) or taken from
    ``uniforms`` (``{"angle": (1, N), "base_point": (1, N)}``)."""
    device = resolve_device(device)
    (p0, p1), target, lenslets = guide_surfaces(n_wall, n_lenslets)
    walls = SegmentSet.make(p0, p1, mat_in=1, mat_out=0, dtype=dtype,
                            device=device)
    exit_face = ArcSet.make(*lenslets, mat_in=1, mat_out=0, dtype=dtype,
                            device=device)
    target = SegmentSet.make(*target, dtype=dtype, device=device)
    scene = Scene2D.build(optical_segments=[walls], target_segments=[target],
                          optical_arcs=[exit_face])
    scene = Scene2D(segments=morton_sort_segments(scene.segments)[0],
                    arcs=morton_sort_arcs(scene.arcs)[0])

    source = src.AngularSource(
        2, (-0.001, 0.0), 0.0,
        dist.RandomLambertianAngularDistribution(-0.4 * PI, 0.4 * PI, n_rays),
        dist.RandomUniformBeam(-0.95, 0.95, n_rays), [575.0] * n_rays,
        dense=False)
    if generator is None and uniforms is None:
        generator = torch.Generator(device).manual_seed(0)
    rays = source.sample(generator, dtype, device, uniforms)
    return rays, scene, (mats.vacuum, mats.acrylic)


def guide_config(**kw):
    """The guide's trace settings (50 bounces, dead rays stretched 10x);
    ``kw`` adds or overrides fields (``use_kernel``, ``cull``, ...)."""
    return TraceConfig(**{"max_bounces": GUIDE_BOUNCES,
                          "dead_ray_length": DEAD_RAY_LENGTH, **kw})


def landing_loss_fold(dtype, device=None):
    """The guide's loss as a fold: ``landing_sum_fold`` of the squared
    landing height y^2 of the rays at the bounce they finish on the target
    (x = ``TARGET_X``, the guide's only target)."""
    return landing_sum_fold(lambda p1: p1[:, 1] ** 2, dtype, FINISHED, device)


def guide_design(n_rays=1 << 20, n_wall=2048, n_lenslets=512,
                 dtype=torch.float32, device=None, generator=None,
                 uniforms=None):
    """The light guide of :func:`light_guide` (same arguments, same rays and
    Morton-sorted scene) as a design problem: ``(loss, params, scene)``.

    ``params`` are the exit face's lenslet centres (M, 2) and radii (M,), in
    the scene's order, as leaf tensors that require grad.  ``loss(params,
    cfg)`` traces the rays under ``cfg`` through the guide with those
    lenslets and returns the landing loss (:func:`landing_loss_fold`), a
    scalar.  ``scene`` is the guide at the initial parameters (what
    ``TraceConfig.recommended`` reads)."""
    rays, scene, materials = light_guide(n_rays, n_wall, n_lenslets, dtype,
                                         device, generator, uniforms)
    arcs = scene.arcs
    params = [arcs.center.detach().clone().requires_grad_(True),
              arcs.radius.detach().clone().requires_grad_(True)]

    def loss(params, cfg):
        designed = Scene2D(segments=scene.segments, arcs=dataclasses.replace(
            arcs, center=params[0], radius=params[1]))
        init, fn = landing_loss_fold(rays.p0.dtype, rays.p0.device)
        return trace(rays, designed, materials, cfg, fold_fn=fn,
                     fold_init=init).fold

    return loss, params, scene


# ----------------------------------------------------------------------
# random sets for the kernel checks
# ----------------------------------------------------------------------

def random_rays(rng, n_rays, dtype=torch.float32, device=None):
    """``n_rays`` unit rays from uniform points in [-4, 4]^2 in uniform
    directions: ``(p0, p1)`` (N, 2) tensors."""
    p0 = rng.uniform(-4, 4, (n_rays, 2)).astype(np.float32)
    th = rng.uniform(0, 2 * PI, n_rays).astype(np.float32)
    p1 = p0 + np.stack([np.cos(th), np.sin(th)], 1)
    return tuple(torch.as_tensor(a, dtype=dtype, device=resolve_device(device))
                 for a in (p0, p1))


def random_segments(rng, n, dtype=torch.float32, device=None):
    """``examples/tpu_kernel_check.py``'s segments: about unit length around
    uniform midpoints in [-3, 3]^2, Morton-sorted."""
    mid = rng.uniform(-3, 3, (n, 2))
    ends = [(mid + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
            for _ in range(2)]
    seg = SegmentSet.make(*ends, mat_in=1, dtype=dtype, device=device)
    return morton_sort_segments(seg)[0]


def random_arcs(rng, n, dtype=torch.float32, device=None, full=False):
    """``examples/tpu_kernel_check.py``'s arcs: centres uniform in [-3, 3]^2,
    radii 0.3-1.5 of either sign, windows from a uniform start sweeping
    0.3-5.8 rad (``full``: the whole circle), Morton-sorted."""
    center = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    a1 = rng.uniform(-PI, PI, n).astype(np.float32)
    sweep = (np.full(n, 2 * PI) if full
             else rng.uniform(0.3, 5.8, n)).astype(np.float32)
    radius = (rng.uniform(0.3, 1.5, n)
              * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    arc = ArcSet.make(center, a1, a1 + sweep, radius, mat_in=1, dtype=dtype,
                      device=device)
    return morton_sort_arcs(arc)[0]
