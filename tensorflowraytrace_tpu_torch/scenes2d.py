"""The 2D problems the port is driven with: one trainable arc, a tapered
light guide at full width, two reaction examples, three lens designs, and
the random sets of the kernel checks.

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
- ``stray_light``: ``examples/stray_light.py``, a lens in a barrel whose
  walls scatter (``rough_surface_reaction``) and absorb
  (``surface_absorber_reaction``); the ghost power outside the nominal
  image at three roughnesses and two absorptivities, over four stream
  seeds.
- ``ghost_analysis``: ``examples/ghost_analysis.py``, a BK7 singlet, bare
  and MgF2-coated, traced under every forced branch schedule of depth 4
  (``branch_override_reaction`` under ``thin_film_intensity_reaction``),
  checked against the analytic ghost powers.
- ``asphere_singlet``: ``examples/asphere_singlet.py``, a biconvex
  singlet of two ``ParametricAsphereSegment``s designed twice by Adam under
  a cosine schedule (``Optimizer(optax_tx=...)``), curvatures alone and
  all six parameters, with the example's two checks.
- ``multisegment_lens``: BASELINE config 2
  (``tests/test_config2_multisegment.py``), a two-surface
  ``ParametricMultiSegmentBoundary`` in flint glass under an angular
  rainbow beam and an aperture source, and the test's three checks.
- ``strehl_lens``: ``examples/strehl_lens.py``, one polyline surface whose
  vertices maximise the Huygens PSF's on-axis peak (``analysis.huygens_psf``
  of an ``optical_path_reaction`` trace) in three annealed stages of Adam.
- ``engine_internals``: ``examples/engine_internals.py``, one
  ``single_pass`` through an arc (every ray refracted), the projection of
  a wide beam onto a short segment (misses stretched) and a parametric
  two-surface lens's normal and parameter arrows, drawn when given a path.
- ``random_segments``, ``random_arcs``, ``random_rays``: the sets of
  ``examples/tpu_kernel_check.py``, Morton-sorted.
- ``arc_edge_cases``: ray-arc sets at the edges of the arc searches' exact
  reject (a discriminant or |a| within float32 steps of ``intersect_eps``,
  tangent rays, rays 13000 radii away, full circles, windows wider than pi,
  exact ties, parked rays).
- ``gate_edge_cases``: ray sets whose hits lie where a per-ray gate's
  chunk boxes must reach (past a segment's ends under a large
  ``size_eps``, a tangent pair's snapped point off its circle, a window's
  end, seen from near and from thousands of radii away), and parked and
  all-miss batches.
- ``block_rays``: rays in blocks of which every ray, one ray or no ray
  reaches the surfaces.

Both build on CUDA unless given ``device=``; there is no CPU fallback.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.drawing import figure
from tensorflowraytrace_tpu_torch.config import (
    ACTIVE, DEAD, FINISHED, resolve_device,
)
from tensorflowraytrace_tpu_torch.engine import (
    TraceConfig, landing_sum_fold, single_pass, start_epsilon, trace,
)
from tensorflowraytrace_tpu_torch.models import boundaries as bd
from tensorflowraytrace_tpu_torch.models import distributions as dist
from tensorflowraytrace_tpu_torch.models import sources as src
from tensorflowraytrace_tpu_torch.models.acceleration import (
    morton_sort_arcs, morton_sort_segments,
)
from tensorflowraytrace_tpu_torch.models.rays import RaySet, concat_rays
from tensorflowraytrace_tpu_torch.models.surfaces import ArcSet, Scene2D, SegmentSet
from tensorflowraytrace_tpu_torch.operations import (
    all_branch_schedules, branch_override_reaction, rough_surface_reaction,
    seed_branch_counter, seed_scatter, surface_absorber_reaction,
    thin_film_intensity_reaction,
)
from tensorflowraytrace_tpu_torch.ops import materials as mats
from tensorflowraytrace_tpu_torch.ops import thinfilm
from tensorflowraytrace_tpu_torch.optim import Optimizer
from tensorflowraytrace_tpu_torch.streamed import fold_in

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

def single_arc_parts(beam_count=10, dtype=torch.float32, device=None,
                     max_bounces=2, use_kernel=False):
    """The pieces of the single-arc focusing problem
    (``examples/stepwise_optimize.py``'s ``build_problem``): a dict of
    ``rays`` (``beam_count`` beam points times the 6 wavelengths),
    ``target`` (the landing segment), ``materials``, ``build_scene(p)``
    (the scene with the arc of radius ``p``), ``cfg``, ``init`` (the
    initial radius, ``tensor([5.0])``) and ``loss`` (:func:`single_arc`'s
    loss)."""
    device = resolve_device(device)
    beam = dist.StaticUniformBeam(-1.5, 1.5, beam_count)
    angles = dist.StaticUniformAngularDistribution(0.0, 0.0, 1)
    source = src.AngularSource(2, (-1.0, 0.0), 0.0, angles, beam, RAINBOW_6)
    rays = source.sample(dtype=dtype, device=device)
    target = SegmentSet.make([[10.0, -5.0]], [[10.0, 5.0]], dtype=dtype,
                             device=device)

    def build_scene(p):
        arc = ArcSet.make(torch.stack([torch.stack([p, torch.zeros_like(p)])]),
                          3 * PI / 4, 5 * PI / 4, p, mat_in=1, mat_out=0,
                          dtype=dtype, device=device)
        return Scene2D.build(optical_arcs=[arc], target_segments=[target])

    init = torch.tensor([5.0], dtype=dtype, device=device)
    # ray_start_epsilon at the initial arc
    cfg = TraceConfig(max_bounces=max_bounces, use_kernel=use_kernel,
                      ray_start_epsilon=start_epsilon(build_scene(init[0])))
    materials = (mats.vacuum, mats.acrylic)

    def loss(params):
        res = trace(rays, build_scene(params[0][0]), materials, cfg)
        finished = res.rays.state == FINISHED
        return torch.sum(torch.where(finished, res.rays.p1[:, 1] ** 2, 0.0))

    return {"rays": rays, "target": target, "materials": materials,
            "build_scene": build_scene, "cfg": cfg, "init": init,
            "loss": loss}


def single_arc(beam_count=10, dtype=torch.float32, device=None,
               max_bounces=2, use_kernel=False):
    """The single-arc focusing problem.  Returns ``(loss, params)``:
    ``loss(params) -> scalar``, the squared landing heights of the finished
    rays with the arc built from ``params[0][0]``, and the initial
    ``params`` ``[tensor([5.0])]``.  ``beam_count`` beam points times the 6
    wavelengths are traced (10 in the example); :func:`single_arc_parts`
    makes the pieces."""
    parts = single_arc_parts(beam_count, dtype, device, max_bounces,
                             use_kernel)
    return parts["loss"], [parts["init"]]


def engine_internals(dtype=torch.float32, device=None, png=None):
    """Run ``examples/engine_internals.py``: one :func:`single_pass` of a
    9-point beam at the 6 wavelengths through an acrylic arc (each ray
    must refract), and one of an 11-point beam onto a short segment with
    ``dead_ray_length=10`` (some, not all, must miss).  Returns the
    printed counts ``rays``, ``refracted``, ``beam`` and ``missed``.
    ``png``: a path to write the three panels to (the parents projected
    onto the arc and their children, the projection with the misses
    stretched, and the example's parametric lens with its normal and
    parameter arrows through ``drawing.TriangleDrawer``)."""
    from tensorflowraytrace_tpu_torch import drawing
    from tensorflowraytrace_tpu_torch.models import mesh as mt

    device = resolve_device(device)
    materials = (mats.vacuum, mats.acrylic)
    angles = dist.StaticUniformAngularDistribution(0.0, 0.0, 1)
    source = src.AngularSource(2, (-1.0, 0.0), 0.0, angles,
                               dist.StaticUniformBeam(-1.5, 1.5, 9),
                               RAINBOW_6)
    rays = source.sample(dtype=dtype, device=device)
    arc = ArcSet.make([[5.0, 0.0]], 3 * PI / 4, 5 * PI / 4, 5.0, mat_in=1,
                      mat_out=0, dtype=dtype, device=device)
    new_rays, (p0, p1, state, _) = single_pass(
        rays, Scene2D.build(optical_arcs=[arc]), materials,
        TraceConfig(max_bounces=1))
    n_active = int((state == ACTIVE).sum())

    source2 = src.AngularSource(2, (-1.0, 0.0), 0.0, angles,
                                dist.StaticUniformBeam(-4.0, 4.0, 11),
                                [575.0] * 11)
    rays2 = source2.sample(dtype=dtype, device=device)
    short_seg = SegmentSet.make([[3.0, -2.0]], [[3.0, 2.0]], mat_in=1,
                                mat_out=0, dtype=dtype, device=device)
    _, (q0, q1, state2, _) = single_pass(
        rays2, Scene2D.build(optical_segments=[short_seg]), materials,
        TraceConfig(max_bounces=1, dead_ray_length=10.0))
    n_dead = int((state2 == DEAD).sum())
    out = {"rays": rays.n_rays, "refracted": n_active,
           "beam": rays2.n_rays, "missed": n_dead}
    if not (n_active == rays.n_rays and 0 < n_dead < rays2.n_rays):
        raise RuntimeError(f"engine internals: the checks fail on {out}")

    if png is not None:
        def ray_dict(a, b, wavelength):
            a, b = drawing.host_array(a), drawing.host_array(b)
            return {"x_start": a[:, 0], "y_start": a[:, 1],
                    "x_end": b[:, 0], "y_end": b[:, 1],
                    "wavelength": wavelength}

        fig = figure(figsize=(16, 6))
        ax1 = fig.add_subplot(1, 3, 1)
        ax2 = fig.add_subplot(1, 3, 2)
        ax3 = fig.add_subplot(1, 3, 3, projection="3d")
        ax1.set_title("single_pass: parents projected onto arc + children")
        ax1.set_aspect("equal")
        drawing.ArcDrawer(ax1, arc, color="cyan", draw_norm_arrows=True).draw()
        drawing.RayDrawer2D(ax1, ray_dict(p0, p1, rays.wavelength)).draw()
        drawing.RayDrawer2D(ax1, ray_dict(new_rays.p0, new_rays.p1,
                                          new_rays.wavelength)).draw()
        ax2.set_title("projection: hits projected, misses stretched")
        ax2.set_aspect("equal")
        drawing.SegmentDrawer(ax2, short_seg, color="black",
                              draw_norm_arrows=True).draw()
        drawing.RayDrawer2D(ax2, ray_dict(q0, q1, rays2.wavelength)).draw()

        zm = mt.hexagonal_mesh(1.0, 3)
        pts = zm.points.copy()
        zm.points = np.stack([pts[:, 2], pts[:, 0], pts[:, 1]], axis=1)
        lens = bd.ParametricMultiTriangleBoundary(
            zm, bd.FromVectorVG((1.0, 0.0, 0.0)),
            [bd.ThicknessConstraint(0.0, "min"),
             bd.ThicknessConstraint(0.3, "min")],
            [True, False], material_list=[{"mat_in": 1, "mat_out": 0}] * 2,
            dtype=dtype, device=device)
        params = lens.init_params()
        ax3.set_title("parametric lens: norm (cyan) + parameter (red) arrows")
        for surf, boundary, sub in zip(lens.build(params), lens.surfaces,
                                       params):
            drawing.TriangleDrawer(
                ax3, surf, show_edges=True, alpha=0.25,
                draw_norm_arrows=True, norm_arrow_length=0.2,
                draw_parameter_arrows=True, parameter_arrow_length=0.3,
                boundary=boundary, params=sub).draw()
        ax3.set_xlim(-1, 1.5)
        ax3.set_ylim(-1.2, 1.2)
        ax3.set_zlim(-1.2, 1.2)
        fig.savefig(png, dpi=100)
    return out


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


def guide_config(scene, **kw):
    """The trace settings of the guide ``scene`` (50 bounces, dead rays
    stretched 10x, ``engine.start_epsilon``'s ``ray_start_epsilon``);
    ``kw`` adds or overrides fields (``use_kernel``, ``cull``, ...)."""
    return TraceConfig(**{"max_bounces": GUIDE_BOUNCES,
                          "dead_ray_length": DEAD_RAY_LENGTH,
                          "ray_start_epsilon": start_epsilon(scene), **kw})


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
# examples/stray_light.py: rough, absorbing barrel walls
# ----------------------------------------------------------------------

STRAY_IMAGE_HALF = 0.6   # the nominal image on the detector
STRAY_BOUNCES = 12
STRAY_SIGMAS = (0.0, 0.05, 0.2)
STRAY_ABSORPTIVITIES = (0.0, 0.9)
STRAY_KEYS = 4
STRAY_SEED = 7


def stray_light_scene(dtype=torch.float32, device=None):
    """A biconvex lens (n = 1.5) at x ~ 1 in a barrel whose walls (y = +-1,
    mirror sentinels facing the inside) scatter and absorb, and a detector
    at x = 8: ``(scene, materials)``; the merged segments are [top wall,
    bottom wall, detector]."""
    device = resolve_device(device)
    r = 4.0
    th = math.asin(0.95 / r)
    kw = dict(dtype=dtype, device=device)
    front = ArcSet.make([[1.0 + r, 0.0]], [PI - th], [PI + th], [r],
                        mat_in=1, mat_out=0, **kw)
    back = ArcSet.make([[1.4 - r, 0.0]], [-th], [th], [r], mat_in=1,
                       mat_out=0, **kw)
    top = SegmentSet.make([[7.5, 1.0]], [[0.0, 1.0]], mat_in=2, mat_out=0,
                          **kw)
    bot = SegmentSet.make([[0.0, -1.0]], [[7.5, -1.0]], mat_in=2, mat_out=0,
                          **kw)
    det = SegmentSet.make([[8.0, -3.0]], [[8.0, 3.0]], **kw)
    scene = Scene2D.build(optical_arcs=[front, back],
                          optical_segments=[top, bot],
                          target_segments=[det])
    return scene, (mats.vacuum, mats.build_constant_material(1.5),
                   mats.reflective)


def stray_light_rays_np(n):
    """The example's wide fan, drawn by numpy (seed 0) in float64: ``(p0,
    p1)``, from x = -0.5 across |y| < 0.95 within +-0.35 rad of +x."""
    rng = np.random.default_rng(0)
    ys = rng.uniform(-0.95, 0.95, n)
    ang = rng.uniform(-0.35, 0.35, n)
    p0 = np.stack([np.full(n, -0.5), ys], axis=1)
    return p0, p0 + np.stack([np.cos(ang), np.sin(ang)], axis=1)


def stray_light_rays(n, dtype=torch.float32, device=None):
    """:func:`stray_light_rays_np` as a RaySet at 550 nm with
    ``scatter_ctr`` and unit ``intensity``."""
    p0, p1 = stray_light_rays_np(n)
    rays = seed_scatter(RaySet.make(p0, p1, 550.0, dtype=dtype,
                                    device=resolve_device(device)))
    return rays.with_field("intensity", torch.ones_like(rays.wavelength))


def ghost_fraction(sigma, absorptivity, key, rays, scene, materials, cfg):
    """The example's wall-mediated ghost power a launched ray: the power
    landing outside the nominal image after more than the two lens
    interactions (``scatter_ctr`` counts every reaction), with the walls
    scattering by ``sigma`` from the stream ``key`` and absorbing
    ``absorptivity`` a hit.  Returns a 0-d tensor."""
    device = rays.p0.device
    rough_ids = {"segments": torch.tensor([0, 0, -1], dtype=torch.int32,
                                          device=device)}
    absorb = {"segments": torch.tensor([absorptivity, absorptivity, 0.0],
                                       dtype=rays.p0.dtype, device=device)}
    rx = surface_absorber_reaction(
        absorb, base_reaction=rough_surface_reaction([sigma], rough_ids, key))
    with torch.no_grad():
        res = trace(rays, scene, materials, cfg, reaction=rx)
    out = res.rays
    ghost = ((out.state == FINISHED)
             & (torch.abs(out.p1[:, 1]) > STRAY_IMAGE_HALF)
             & (out.fields["scatter_ctr"] > 2))
    return torch.sum(torch.where(ghost, out.fields["intensity"], 0.0)) / (
        rays.n_rays)


def stray_light(rays=4000, dtype=torch.float32, device=None, verbose=True):
    """Run ``examples/stray_light.py``: the ghost fraction at every wall
    roughness of ``STRAY_SIGMAS`` and absorptivity of
    ``STRAY_ABSORPTIVITIES``, averaged over ``STRAY_KEYS`` stream seeds
    drawn from ``STRAY_SEED``, 12
    bounces under ``TraceConfig.recommended`` (on the card: K5 and K6).
    The keys are looped: a trace that launches CUDA kernels cannot be
    vmapped.  Checks the example's three assertions and returns
    ``{(sigma, absorptivity): mean ghost fraction}``."""
    device = resolve_device(device)
    scene, materials = stray_light_scene(dtype, device)
    rays0 = stray_light_rays(rays, dtype, device)
    cfg = TraceConfig.recommended(scene, max_bounces=STRAY_BOUNCES)
    keys = [fold_in(STRAY_SEED, i) for i in range(STRAY_KEYS)]
    results = {}
    for sigma in STRAY_SIGMAS:
        for absorb in STRAY_ABSORPTIVITIES:
            vals = [float(ghost_fraction(sigma, absorb, k, rays0, scene,
                                         materials, cfg)) for k in keys]
            results[(sigma, absorb)] = float(np.mean(vals))
            if verbose:
                print(f"  wall sigma {sigma:4.2f}  absorptivity {absorb:3.1f}"
                      f"  -> ghost power {results[(sigma, absorb)]:.4f}")
    # wall-mediated ghost power exists, and black paint suppresses it
    if not (results[(0.2, 0.0)] > 0.0
            and results[(0.2, 0.9)] < 0.3 * results[(0.2, 0.0)]
            and results[(0.0, 0.9)] < 0.3 * results[(0.0, 0.0)]):
        raise RuntimeError(f"stray light: the example's assertions fail on "
                           f"{results}")
    return results


# ----------------------------------------------------------------------
# examples/ghost_analysis.py: the branch tree of a coated singlet
# ----------------------------------------------------------------------

N_BK7 = 1.5168
N_MGF2 = 1.38
GHOST_WAVELENGTH = 550.0
# the analytic checks' relative tolerance: the example's in float64, and
# float32's rounding of the complex64 stack and the traced power
GHOST_RTOL = {torch.float64: 1e-6, torch.float32: 1e-5}


def ghost_lens(dtype=torch.float32, device=None):
    """A symmetric biconvex BK7 singlet (two arcs of radius 6, aperture
    +-1.5) and a detector at x = 8: ``(scene, materials)``."""
    device = resolve_device(device)
    r, half = 6.0, 1.5
    sag = r - math.sqrt(r * r - half * half)
    th = math.asin(half / r)
    kw = dict(dtype=dtype, device=device)
    entry = ArcSet.make([[sag - r + 1.0, 0.0]], [-th], [th], [r], mat_in=1,
                        mat_out=0, **kw)
    exit_ = ArcSet.make([[r - sag + 1.4, 0.0]], [PI - th], [PI + th], [r],
                        mat_in=1, mat_out=0, **kw)
    tgt = SegmentSet.make([[8.0, -8.0]], [[8.0, 8.0]], **kw)
    scene = Scene2D.build(optical_arcs=[entry, exit_], target_segments=[tgt])
    return scene, (mats.vacuum, mats.build_constant_material(N_BK7))


def ghost_beam(n, dtype=torch.float32, device=None):
    """``n`` parallel rays across |y| <= 1 from x = -1 along +x at 550 nm,
    with ``branch_ctr`` and unit ``intensity``; ray n // 2 is on axis."""
    ys = np.linspace(-1.0, 1.0, n)
    p0 = np.stack([np.full(n, -1.0), ys], axis=1)
    rays = RaySet.make(p0, p0 + [1.0, 0.0], GHOST_WAVELENGTH, dtype=dtype,
                       device=resolve_device(device))
    return seed_branch_counter(rays).with_field(
        "intensity", torch.ones_like(rays.wavelength))


def schedule_name(row):
    """A branch schedule as letters: T transmit, R reflect."""
    return "".join("TR"[int(b)] for b in row)


def _close(got, want, rtol, what):
    rel = abs(got - want) / abs(want)
    if not rel <= rtol:
        raise RuntimeError(f"ghost analysis: {what} {got!r} against "
                           f"{want!r} (rel {rel:.3e}, rtol {rtol:g})")
    return rel


def ghost_analysis(rays=801, depth=4, dtype=torch.float32, device=None,
                   verbose=True, png=None):
    """Run ``examples/ghost_analysis.py``: trace the beam through the bare
    and the MgF2 quarter-wave AR-coated singlet under every forced branch
    schedule of ``depth`` interactions (``all_branch_schedules``, one trace
    a schedule: the JAX example's vmap is a loop here) with
    ``thin_film_intensity_reaction`` over ``branch_override_reaction``,
    ``depth + 1`` bounces under ``TraceConfig.recommended`` (on the card:
    K5 and K6).  Checks, on the on-axis ray, the main path's power against
    T^2, the double-bounce ghost's (TRRT) against T^2 R^2 and their ratio
    against R^2, with R from the same stack at normal incidence, within
    ``GHOST_RTOL`` of the dtype (the example's 1e-6 in float64; 1e-5 in
    float32), and that the coating cuts the beam's ghost power more than
    8x.  Returns
    ``(results, names)``: per coating the landed power of every schedule
    summed over the beam (``tot``) and by ray (``power``), the landing
    heights (``y``), the final ``branch_ctr`` (``ctr``), ``R`` and the
    analytic checks' relative errors (``rel``); ``names`` the schedules'
    letters.  ``png``: a path to write the example's figure to (the bare
    singlet's landed power by height, main path and ghost x100)."""
    device = resolve_device(device)
    rtol = GHOST_RTOL[dtype]
    scene, materials = ghost_lens(dtype, device)
    beam = ghost_beam(rays, dtype, device)
    cfg = TraceConfig.recommended(scene, max_bounces=depth + 1)
    d_qw = float(thinfilm.quarter_wave_thickness(N_MGF2, GHOST_WAVELENGTH))
    coatings = {"bare": ([], {}),
                "AR-coated": ([[(N_MGF2, d_qw)]], {"arcs": torch.tensor(
                    [0, 0], dtype=torch.int32, device=device)})}
    schedules = all_branch_schedules(depth, device)
    names = [schedule_name(r) for r in schedules.cpu().numpy()]
    main_k, ghost_k = names.index("TT" + "T" * (depth - 2)), names.index(
        "TRRT")

    results = {}
    for label, (stacks, coat_ids) in coatings.items():
        power, y, ctr = [], [], []
        with torch.no_grad():
            for sched in schedules:
                rx = thin_film_intensity_reaction(
                    stacks, coat_ids,
                    base_reaction=branch_override_reaction(sched))
                res = trace(beam, scene, materials, cfg, reaction=rx)
                landed = res.rays.state == FINISHED
                power.append(torch.where(landed,
                                         res.rays.fields["intensity"], 0.0))
                y.append(res.rays.p1[:, 1])
                ctr.append(res.rays.fields["branch_ctr"])
        power = torch.stack(power).cpu().numpy()
        r = dict(tot=power.sum(axis=1), power=power,
                 y=torch.stack(y).cpu().numpy(),
                 ctr=torch.stack(ctr).cpu().numpy())

        # the on-axis ray meets both faces at normal incidence: ghost TRRT
        # power = T1 R2 R1 T2 with R from the same stack
        one = torch.ones(1, dtype=dtype, device=device)
        n_layers = 1 if stacks else 0
        ln = torch.full((n_layers, 1), N_MGF2, dtype=dtype, device=device)
        ld = torch.full((n_layers, 1), d_qw, dtype=dtype, device=device)
        R = float(thinfilm.stack_R_unpolarized(
            one, N_BK7 * one, one, GHOST_WAVELENGTH * one, ln, ld)[0])
        T = 1.0 - R
        i_mid = rays // 2
        p_main = float(power[main_k, i_mid])
        p_ghost = float(power[ghost_k, i_mid])
        r["R"] = R
        r["rel"] = {
            "main": _close(p_main, T * T, rtol, f"[{label}] main TT power"),
            "ghost": _close(p_ghost, T * T * R * R, rtol,
                            f"[{label}] ghost TRRT power"),
            "ratio": _close(p_ghost / p_main, R * R, rtol,
                            f"[{label}] ghost / main")}
        results[label] = r
        if verbose:
            print(f"[{label}] on-axis R = {R:.5f}: main TT {p_main:.6f} "
                  f"(T^2 {T * T:.6f}), ghost TRRT {p_ghost:.6e} (T^2 R^2 "
                  f"{T * T * R * R:.6e}), relative errors {r['rel']}")
    bare_ghost = results["bare"]["tot"][ghost_k]
    ar_ghost = results["AR-coated"]["tot"][ghost_k]
    if verbose:
        print(f"AR coating cut the double-bounce ghost by "
              f"{bare_ghost / max(ar_ghost, 1e-30):.0f}x")
    if not ar_ghost < bare_ghost / 8:
        raise RuntimeError(f"ghost analysis: the coating cut the ghost from "
                           f"{bare_ghost} to {ar_ghost}, not 8x")
    if png is not None:
        fig = figure(figsize=(7, 4))
        ax = fig.subplots()
        r = results["bare"]
        bins = np.linspace(-6, 6, 241)
        ax.hist(r["y"][main_k], bins=bins, weights=r["power"][main_k],
                label="main (TT)", alpha=0.8)
        ax.hist(r["y"][ghost_k], bins=bins, weights=r["power"][ghost_k] * 100,
                label="ghost (TRRT) x100", alpha=0.8)
        ax.set_xlabel("detector y")
        ax.set_ylabel("landed power / bin")
        ax.set_yscale("log")
        ax.legend()
        ax.set_title("bare singlet: ghost spread vs main focus")
        fig.tight_layout()
        fig.savefig(png, dpi=110)
    return results, names


# ----------------------------------------------------------------------
# lens designs: the asphere singlet, BASELINE config 2, the Strehl lens
# ----------------------------------------------------------------------

def _on_card(device):
    """Whether a design on ``device`` takes the CUDA kernels: exactly on a
    CUDA device."""
    return device.type == "cuda"


def cosine_decay(lr, steps, alpha):
    """``optax.cosine_decay_schedule(lr, steps, alpha)`` as a factory
    ``params -> (Adam, LambdaLR)`` for ``Optimizer(optax_tx=...)``: the
    rate at step t is lr ((1 - alpha) (1 + cos(pi min(t, T) / T)) / 2 +
    alpha)."""
    def factor(t):
        decay = 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))
        return (1.0 - alpha) * decay + alpha

    def factory(params):
        adam = torch.optim.Adam(params, lr=lr)
        return adam, torch.optim.lr_scheduler.LambdaLR(adam, factor)

    return factory


def masked(p, mask):
    """``p`` in value whose gradient is multiplied by ``mask`` (0 or 1)."""
    return p * mask + (p * (1 - mask)).detach()


ASPHERE_GLASS = 1.5
ASPHERE_SCREEN_X = 2.5      # the fixed image plane
ASPHERE_X = (0.0, 0.35)     # the front and back vertices
ASPHERE_HALF_AP = 0.8       # the ray bundle's half-aperture
ASPHERE_SURF_AP = 0.95      # the surfaces' half-aperture
ASPHERE_BOUNCES = 3
# the biconvex spherical start [c1, k1, a4_1, c2, k2, a4_2]
ASPHERE_START = (0.42, 0.0, 0.0, -0.42, 0.0, 0.0)
SPHERE_MASK = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
ASPHERE_MASK = (1.0,) * 6


def asphere_problem(resolution=256, n_rays=160, dtype=torch.float32,
                    device=None):
    """``examples/asphere_singlet.py``'s singlet: two
    ``ParametricAsphereSegment``s of ``resolution`` segments (n = 1.5
    between them) and a screen at x = 2.5, ``n_rays`` collimated rays over
    |y| <= 0.8 at 550 nm, 3 bounces.  Returns ``(spot_sq, start)``:
    ``spot_sq(params)`` the mean squared landing height of every ray with
    ``params[0]`` = [c1, k1, a4_1, c2, k2, a4_2], and the start."""
    device = resolve_device(device)
    materials = (mats.vacuum, mats.build_constant_material(ASPHERE_GLASS))
    front = bd.ParametricAsphereSegment(
        ASPHERE_X[0], ASPHERE_SURF_AP, resolution=resolution, n_aspheric=1,
        mat_in=1, mat_out=0, dtype=dtype, device=device)
    back = bd.ParametricAsphereSegment(
        ASPHERE_X[1], ASPHERE_SURF_AP, resolution=resolution, n_aspheric=1,
        mat_in=0, mat_out=1, dtype=dtype, device=device)
    screen = SegmentSet.make([[ASPHERE_SCREEN_X, -3.0]],
                             [[ASPHERE_SCREEN_X, 3.0]], dtype=dtype,
                             device=device)
    ys = dist._linspace(-ASPHERE_HALF_AP, ASPHERE_HALF_AP, n_rays, dtype,
                        device)
    p0 = torch.stack([torch.full_like(ys, -1.0), ys], dim=1)
    rays = RaySet.make(p0, p0 + torch.tensor([1.0, 0.0], dtype=dtype,
                                             device=device), 550.0,
                       dtype=dtype, device=device)
    start = torch.tensor(ASPHERE_START, dtype=dtype, device=device)

    def scene(params):
        return Scene2D.build(
            optical_segments=[front.build(params[:3]),
                              back.build(params[3:])],
            target_segments=[screen])

    cfg = TraceConfig(max_bounces=ASPHERE_BOUNCES,
                      use_kernel=_on_card(device),
                      ray_start_epsilon=start_epsilon(scene(start)))

    def spot_sq(params):
        res = trace(rays, scene(params[0]), materials, cfg)
        return torch.mean(res.rays.p1[:, 1] ** 2)

    spot_sq.cfg = cfg
    return spot_sq, start


def asphere_optimizer(spot_sq, start, mask, steps, lr):
    """The example's design step with a freedom ``mask`` over the six
    parameters: Adam under ``optax.cosine_decay_schedule(lr, steps, 1e-2)``
    on the masked gradient, through ``Optimizer(optax_tx=...)`` (no clip:
    the example clips nothing)."""
    mask = torch.as_tensor(mask, dtype=start.dtype, device=start.device)
    return Optimizer(lambda params: spot_sq([masked(params[0], mask)]),
                     [start], learning_rate=1.0, grad_clip=math.inf,
                     pass_key=False, optax_tx=cosine_decay(lr, steps, 1e-2))


def asphere_singlet(steps=1500, resolution=256, n_rays=160, lr=6e-3,
                    dtype=torch.float32, device=None):
    """``examples/asphere_singlet.py``: the singlet designed twice from the
    same spherical start, with the curvatures alone free (the sphere
    control) and with all six parameters (the asphere), ``steps`` steps
    each, and the example's two checks: the asphere's RMS spot below a
    third of the sphere's and a fifth of the start's.  Returns a dict of
    the three RMS spots, the designed parameters, each design's per-step
    squared spots and its wall seconds (``run_phase`` ends on a read of
    its errors)."""
    spot_sq, start = asphere_problem(resolution, n_rays, dtype, device)
    with torch.no_grad():
        rms0 = float(torch.sqrt(spot_sq([start])))
    out = {"rms_start": rms0}
    for label, mask in (("sphere", SPHERE_MASK), ("asphere", ASPHERE_MASK)):
        opt = asphere_optimizer(spot_sq, start, mask, steps, lr)
        t0 = time.perf_counter()
        errors = opt.run_phase(steps)
        out[f"seconds_{label}"] = time.perf_counter() - t0
        with torch.no_grad():
            out[f"rms_{label}"] = float(torch.sqrt(spot_sq(opt.parameters)))
        out[f"params_{label}"] = opt.parameters[0]
        out[f"errors_{label}"] = errors
    if not (out["rms_asphere"] < out["rms_sphere"] / 3
            and out["rms_asphere"] < rms0 / 5):
        raise AssertionError(f"asphere singlet checks failed: {out}")
    return out


CONFIG2_THICKNESS = 0.15
CONFIG2_BOUNCES = 4


def multisegment_problem(dtype=torch.float32, device=None):
    """BASELINE config 2 (``tests/test_config2_multisegment.py``): a
    two-surface ``ParametricMultiSegmentBoundary`` on 21 shared base points
    (thickness >= 0 and >= 0.15, flint glass), an angular ``RAINBOW_6``
    beam of 60 rays and an 8-ray aperture source, a target at x = 6, 4
    bounces.  Returns ``(lens, rays, trace_fn, loss)``: ``trace_fn(params)``
    traces the rays at the lens's parameters, ``loss(params, generator)``
    is the sum of the finished rays' squared landing heights."""
    device = resolve_device(device)
    zero = dist.StaticUniformAperaturePoints((0.0, -1.2), (0.0, 1.2), 21)
    one = dist.StaticUniformAperaturePoints((1.0, -1.2), (1.0, 1.2), 21)
    lens = bd.ParametricMultiSegmentBoundary(
        zero, one,
        [bd.ThicknessConstraint(0.0, "min"),
         bd.ThicknessConstraint(CONFIG2_THICKNESS, "min")],
        flip_norm=[True, False],
        material_list=[{"mat_in": 1, "mat_out": 0}] * 2,
        dtype=dtype, device=device)
    target = SegmentSet.make([[6.0, -50.0]], [[6.0, 50.0]], dtype=dtype,
                             device=device)
    beam = dist.StaticUniformBeam(-1.0, 1.0, 10)
    angles = dist.StaticUniformAngularDistribution(0.0, 0.0, 1)
    s1 = src.AngularSource(2, (-2.0, 0.0), 0.0, angles, beam, RAINBOW_6)
    ap_start = dist.StaticUniformAperaturePoints((-2.0, -0.8), (-2.0, 0.8), 8)
    ap_end = dist.StaticUniformAperaturePoints((-1.0, -0.8), (-1.0, 0.8), 8)
    s2 = src.AperatureSource(2, ap_start, ap_end, [575.0] * 8, dense=False)
    rays = concat_rays([s1.sample(dtype=dtype, device=device),
                        s2.sample(dtype=dtype, device=device)])
    materials = (mats.vacuum, mats.flint_glass)

    def scene(params):
        return Scene2D.build(optical_segments=lens.build(params),
                             target_segments=[target])

    cfg = TraceConfig(max_bounces=CONFIG2_BOUNCES,
                      use_kernel=_on_card(device),
                      ray_start_epsilon=start_epsilon(scene(None)))

    def trace_fn(params):
        return trace(rays, scene(params), materials, cfg)

    def loss(params, generator=None):
        res = trace_fn(params)
        fin = res.rays.state == FINISHED
        return torch.sum(torch.where(fin, res.rays.p1[:, 1] ** 2, 0.0))

    loss.cfg = cfg
    return lens, rays, trace_fn, loss


def multisegment_lens(steps=60, dtype=torch.float32, device=None):
    """BASELINE config 2's optimization (``grad_clip=5e-3``, one step then
    ``steps`` more at ``lr_scale=2e-3``, momentum 0.8) and its test's three
    checks: the last error below half the first; the 680 nm and 400 nm
    rays landing apart; the constrained thickness at least 0.15 less a
    margin (the test's 1e-9 in float64; 1e-6 in float32, a few roundings
    of the constraint's shift at coordinates of order 1).  Returns a dict
    of the first error, the per-step errors, the landing heights of the
    two wavelengths, the least thickness and the parameters."""
    margin = 1e-9 if dtype == torch.float64 else 1e-6
    lens, rays, trace_fn, loss = multisegment_problem(dtype, device)
    opt = Optimizer(loss, lens.init_params(), learning_rate=1.0,
                    grad_clip=5e-3)
    e0 = opt.single_step(None, lr_scale=2e-3, momentum=0.8)
    errors = opt.run_phase(steps, None, lr_scale=2e-3, momentum=0.8)
    with torch.no_grad():
        res = trace_fn(opt.parameters)
        p0, p1 = lens.constrain(opt.parameters)
        thickness = float(torch.min(p1 - p0))
    fin = (res.rays.state == FINISHED).cpu().numpy()
    wl = res.rays.wavelength.cpu().numpy()[fin]
    y = res.rays.p1[:, 1].cpu().numpy()[fin]
    reds, blues = y[wl == 680.0], y[wl == 400.0]
    out = {"e0": e0, "errors": errors, "reds": reds, "blues": blues,
           "thickness": thickness, "params": opt.parameters}
    checks = {
        "error halved": errors[-1] < 0.5 * e0,
        "dispersion": bool(reds.size and blues.size and not np.allclose(
            np.sort(reds)[:len(blues)], np.sort(blues)[:len(reds)],
            atol=1e-9)),
        "thickness": thickness >= CONFIG2_THICKNESS - margin,
    }
    if not all(checks.values()):
        raise AssertionError(f"config 2 checks failed: {checks}, "
                             f"e0 {e0}, last {errors[-1]}, thickness "
                             f"{thickness}")
    return out


STREHL_GLASS = 1.5
STREHL_FOCUS = 3.0
STREHL_HALF_AP = 0.6
STREHL_LAUNCH_X = -2.0
STREHL_LAMBDA = 0.55e-3     # 550 nm in the example's mm units
STREHL_BOUNCES = 2


def strehl_sphere_x(y, f=STREHL_FOCUS, n=STREHL_GLASS):
    """The paraxial sphere R = f (n - 1) / n: focuses at f to first order,
    with strong spherical aberration at this aperture."""
    r = f * (n - 1.0) / n
    return r - np.sqrt(np.maximum(r * r - y * y, 0.0))


def strehl_hyperbola_x(y, f=STREHL_FOCUS, n=STREHL_GLASS):
    """The analytic hyperbola that focuses a collimated beam at f."""
    a = 1.0 - 1.0 / n ** 2
    b = -2.0 * f * (1.0 - 1.0 / n)
    return (-b - np.sqrt(b * b - 4 * a * y ** 2)) / (2 * a)


def strehl_problem(n_segments=48, n_rays=128, dtype=torch.float32,
                   device=None):
    """``examples/strehl_lens.py``'s lens: one polyline surface of
    ``n_segments`` segments (its vertices' x the parameters, glass of
    n = 1.5 on its left), ``n_rays`` collimated rays carrying their optical
    path (``optical_path_reaction``), a target at the focus x = 3, 2
    bounces.  Returns ``(strehl, ys)``: ``strehl(xs, lam)`` the on-axis
    Huygens PSF peak (``analysis.huygens_psf`` at the focus, in the
    profiler range ``strehl_psf``) over its ideal (the finished rays'
    count squared), and the vertices' heights (numpy)."""
    from tensorflowraytrace_tpu_torch.analysis import huygens_psf
    from tensorflowraytrace_tpu_torch.operations import (
        optical_path_reaction, seed_optical_path,
    )

    device = resolve_device(device)
    materials = (mats.vacuum, mats.build_constant_material(STREHL_GLASS))
    reaction = optical_path_reaction()
    ys_np = np.asarray(dist._linspace(-1.15 * STREHL_HALF_AP,
                                      1.15 * STREHL_HALF_AP, n_segments + 1,
                                      torch.float64, "cpu"))
    ys_v = torch.as_tensor(ys_np, dtype=dtype, device=device)
    ray_ys = dist._linspace(-STREHL_HALF_AP, STREHL_HALF_AP, n_rays, dtype,
                            device)
    p0 = torch.stack([torch.full_like(ray_ys, STREHL_LAUNCH_X), ray_ys], dim=1)
    rays = seed_optical_path(RaySet.make(
        p0, p0 + torch.tensor([1.0, 0.0], dtype=dtype, device=device), 550.0,
        dtype=dtype, device=device))
    target = SegmentSet.make([[STREHL_FOCUS, -3.0]], [[STREHL_FOCUS, 3.0]],
                             dtype=dtype, device=device)
    grid = torch.tensor([[STREHL_FOCUS, 0.0]], dtype=dtype, device=device)

    def scene(xs):
        verts = torch.stack([xs, ys_v], dim=1)
        surf = SegmentSet.make(verts[:-1], verts[1:], mat_in=1, mat_out=0,
                               dtype=dtype, device=device)
        return Scene2D.build(optical_segments=[surf], target_segments=[target])

    start = torch.as_tensor(strehl_sphere_x(ys_np), dtype=dtype, device=device)
    cfg = TraceConfig(max_bounces=STREHL_BOUNCES,
                      use_kernel=_on_card(device),
                      ray_start_epsilon=start_epsilon(scene(start)))

    def strehl(xs, lam):
        res = trace(rays, scene(xs), materials, cfg, reaction=reaction)
        # wavelets at each ray's last refraction point; unfinished rays
        # (a wild step's misses) are masked out
        amp = (res.rays.state == FINISHED).to(xs.dtype)
        with torch.profiler.record_function("strehl_psf"):
            peak = huygens_psf(res.rays.p0, res.rays.fields["opl"], lam, grid,
                               amplitudes=amp, medium_n=STREHL_GLASS)[0]
        return peak / torch.clamp(torch.sum(amp), min=1.0) ** 2

    strehl.cfg = cfg
    return strehl, ys_np


def strehl_stages(steps):
    """The example's annealed wavelengths (100, 10 and 1 times 550 nm),
    each with Adam at 0.2 of it, ``steps`` steps a stage."""
    return [(lam, 0.2 * lam, steps) for lam in
            (100 * STREHL_LAMBDA, 10 * STREHL_LAMBDA, STREHL_LAMBDA)]


def strehl_optimizer(strehl, xs, lam, lr):
    """One stage's optimizer: Adam at ``lr`` on -Strehl at ``lam`` through
    ``Optimizer(optax_tx=...)`` (no clip, as in the example)."""
    return Optimizer(lambda params: -strehl(params[0], lam), [xs],
                     learning_rate=1.0, grad_clip=math.inf, pass_key=False,
                     optax_tx=lambda ps: torch.optim.Adam(ps, lr=lr))


def strehl_lens(steps=300, n_segments=48, n_rays=128, dtype=torch.float32,
                device=None):
    """``examples/strehl_lens.py``: from the paraxial sphere, three stages
    of ``steps`` Adam steps maximise the Strehl ratio at 100, 10 and 1
    times 550 nm, and the example's check: the final Strehl at 550 nm above
    0.8 of the discretised hyperbola's and above 0.5.  Returns a dict of
    the start's, the design's and the hyperbola's Strehl at 550 nm, each
    stage's last Strehl and wall seconds, and the designed vertices."""
    strehl, ys = strehl_problem(n_segments, n_rays, dtype, device)
    device = resolve_device(device)
    xs = torch.as_tensor(strehl_sphere_x(ys), dtype=dtype, device=device)
    with torch.no_grad():
        s0 = float(strehl(xs, STREHL_LAMBDA))
    stage_strehl, stage_seconds = [], []
    for lam, lr, n in strehl_stages(steps):
        opt = strehl_optimizer(strehl, xs, lam, lr)
        t0 = time.perf_counter()
        errors = opt.run_phase(n)
        stage_seconds.append(time.perf_counter() - t0)
        xs = opt.parameters[0]
        stage_strehl.append(-float(errors[-1]))
    with torch.no_grad():
        s1 = float(strehl(xs, STREHL_LAMBDA))
        s_hyp = float(strehl(torch.as_tensor(strehl_hyperbola_x(ys),
                                             dtype=dtype, device=device),
                             STREHL_LAMBDA))
    out = {"strehl_start": s0, "strehl": s1, "strehl_hyperbola": s_hyp,
           "stages": stage_strehl, "stage_seconds": stage_seconds, "xs": xs}
    if not (s1 > 0.8 * s_hyp and s1 > 0.5):
        raise AssertionError(f"Strehl lens check failed: {out}")
    return out


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


def _steps(x, k):
    """float32 x and its k float32 neighbours on either side, ascending."""
    out = [np.float32(x)]
    for _ in range(k):
        out.append(np.nextafter(out[-1], np.float32(np.inf)))
        out.insert(0, np.nextafter(out[0], np.float32(-np.inf)))
    return np.array(out, np.float32)


def arc_edge_cases(dtype=torch.float32, device=None, i_eps=1e-6):
    """Ray-arc sets at the edges of the arc searches' reject test (the
    discriminant 4 (a - (x_r x d_r)^2) snapped to 0 below ``i_eps``, and
    |a| >= ``i_eps``): a list of ``(label, p0, p1, arcs)``, the rays (N, 2)
    and an ArcSet, unsorted so that the indices stay where they are put.

    - "tangent": unit circles at the origin (a half window, a window of 1.5
      pi and a full circle, each twice, the copies 300 arcs apart, in
      another 256-arc tile) against rays along x at heights within 80
      float32 steps of +-1 and rays along y at x within 80 steps of +-1:
      the discriminant runs through 0 and +-``i_eps`` (one step of height
      moves it ~5e-7 below 1 and ~1e-6 above).
    - "small a": the same circles against rays from inside whose direction
      is within 64 steps of sqrt(``i_eps``) long, so that a = |d|^2 / r^2
      runs through ``i_eps``.
    - "far": 64 lenslets of radius 0.003 across |y| <= 0.2 at x = 40 (the
      2D guide's exit face) against rays from x = 0 aimed within the face:
      they start ~13000 radii away.
    - "wide windows": random arcs sweeping between pi and 2 pi against
      random rays.
    - "ties": a circle twice (indices 0 and 300), its mirror image, and
      rays through their common centre line: equal u on different arcs.
    - "parked": rays at 1e30 against the tangent set."""
    device = resolve_device(device)
    rng = np.random.default_rng(13)

    def rays(p0, d):
        p0 = np.asarray(p0, np.float32)
        return (torch.as_tensor(p0, dtype=dtype, device=device),
                torch.as_tensor(p0 + np.asarray(d, np.float32), dtype=dtype,
                                device=device))

    def arcs(center, start, sweep, radius, spacer=0):
        """The arcs, each repeated after ``spacer`` filler arcs far away."""
        center = np.asarray(center, np.float32)
        start = np.asarray(start, np.float32)
        sweep = np.asarray(sweep, np.float32)
        radius = np.asarray(radius, np.float32)
        if spacer:
            fill = np.full((spacer, 2), 1000.0, np.float32)
            center = np.concatenate([center, fill, center])
            start = np.concatenate([start, np.zeros(spacer, np.float32), start])
            sweep = np.concatenate([sweep, np.full(spacer, 1.0, np.float32),
                                    sweep])
            radius = np.concatenate([radius, np.ones(spacer, np.float32),
                                     radius])
        return ArcSet.make(center, start, start + sweep, radius, mat_in=1,
                           dtype=dtype, device=device)

    unit = arcs(np.zeros((3, 2)), [0.0, -0.25 * PI, 0.0],
                [PI, 1.5 * PI, 2 * PI], [1.0, 1.0, 1.0], spacer=297)
    cases = []
    hy = np.concatenate([_steps(1.0, 80), _steps(-1.0, 80)])
    p0 = np.concatenate([np.stack([np.full_like(hy, -2.0), hy], 1),
                         np.stack([hy, np.full_like(hy, -2.0)], 1)])
    d = np.concatenate([np.tile([[1.0, 0.0]], (hy.size, 1)),
                        np.tile([[0.0, 1.0]], (hy.size, 1))])
    cases.append(("tangent", *rays(p0, d), unit))

    small = np.concatenate([_steps(math.sqrt(i_eps), 64),
                            -_steps(math.sqrt(i_eps), 64)])
    p0 = np.tile([[-0.5, 0.25]], (2 * small.size, 1))
    d = np.concatenate([np.stack([small, np.zeros_like(small)], 1),
                        np.stack([np.zeros_like(small), small], 1)])
    cases.append(("small a", *rays(p0, d), unit))

    k = 64
    yc = np.linspace(-0.2, 0.2, k)
    lens = arcs(np.stack([np.full(k, 40.0), yc], 1), np.full(k, -0.5 * PI),
                np.full(k, PI), np.full(k, 0.003))
    n = 4096
    p0 = np.stack([np.zeros(n), rng.uniform(-0.5, 0.5, n)], 1)
    aim = np.stack([np.full(n, 40.0), rng.uniform(-0.21, 0.21, n)], 1)
    cases.append(("far", *rays(p0, aim - p0), lens))

    m = 300
    wide = arcs(rng.uniform(-3, 3, (m, 2)), rng.uniform(-PI, PI, m),
                rng.uniform(PI + 0.01, 2 * PI - 0.01, m),
                rng.uniform(0.3, 1.5, m) * rng.choice([-1.0, 1.0], m))
    th = rng.uniform(0, 2 * PI, n)
    cases.append(("wide windows",
                  *rays(rng.uniform(-4, 4, (n, 2)),
                        np.stack([np.cos(th), np.sin(th)], 1)), wide))

    twins = arcs([[0.0, 0.0], [0.0, 0.0]], [0.5 * PI, -0.5 * PI], [PI, PI],
                 [1.0, -1.0], spacer=298)
    y = np.linspace(-0.9, 0.9, 64)
    cases.append(("ties", *rays(np.stack([np.full_like(y, -3.0), y], 1),
                                np.tile([[1.0, 0.0]], (y.size, 1))), twins))

    parked = np.full((512, 2), 1e30, np.float32)
    cases.append(("parked", *rays(parked, parked * np.float32(1e-6)), unit))
    return cases


def gate_edge_cases(dtype=torch.float32, device=None):
    """Rays and surfaces whose accepted hits lie at the edge of what a chunk
    box must hold when each ray passes its own gate (K7, K9, K10): a list
    of ``(label, p0, p1, surfaces, size_eps)``, ``surfaces`` a SegmentSet
    or an ArcSet of 512 (or 300) surfaces, two chunks of 256, unsorted so
    that the indices stay where they are put.

    - "segment ends": unit segments along x at y = 0, 1, ..., 511 against
      rays up the y axis from 0.5 below each, through the segment's line
      at seg_u -0.0101, -0.005, its end 0 and the float32 steps beside it,
      0.5, 1 and its steps, 1.005 and 1.0101: under ``size_eps`` 1e-2 the
      hits up to 0.01 past an end count, and lie outside the chunk's raw
      box by more than its rounding margin.
    - "segment ends, small size_eps": the same under 1e-6.
    - "tangent snap": lenslets of radius 0.003 stacked along y (centres
      0.006 apart at x = 0; windows of +-pi/2 and of +-0.05 about +x, in
      turns) against short rays up the y axis (|d| from 1.0 to 10 times
      1e-3 r, a = |d|^2 / r^2 from 1e-6) passing 0.87 to 1.115 radii from
      the centres: where 4 a |1 - D^2 / r^2| < 1e-6 the discriminant snaps
      to 0 and the hit is the closest point, up to 0.13 r inside or 0.12 r
      outside the circle, outside the short arcs' boxes.
    - "window ends": 300 random arcs against rays from 1-4 away aimed at
      each window's float32 end points and the points a float32 step of
      the aim either side.
    - "far ends": the 2D guide's 512 exit lenslets (radius 0.003 at x = 40)
      against rays from x = 0 aimed at the joints of neighbouring lenslets,
      chunk 0's and chunk 1's included: ~13000 radii away.
    - "parked" (p0 = 1e30) and "all-miss" (rays at 100 pointing away)
      against both kinds."""
    device = resolve_device(device)
    rng = np.random.default_rng(17)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), dtype=dtype,
                               device=device)

    def rays(p0, d):
        p0 = np.asarray(p0, np.float32)
        return tensor(p0), tensor(p0 + np.asarray(d, np.float32))

    cases = []
    y = np.arange(512, dtype=np.float32)
    segs = SegmentSet.make(np.stack([np.zeros(512), y], 1),
                           np.stack([np.ones(512), y], 1), mat_in=1,
                           dtype=dtype, device=device)
    xs = np.concatenate([[-0.0101, -0.005], _steps(0.0, 2), [0.5],
                         _steps(1.0, 2), [1.005, 1.0101]]).astype(np.float32)
    p0 = np.stack([np.tile(xs, 512), np.repeat(y, xs.size) - 0.5], 1)
    up = np.tile([[0.0, 1.0]], (p0.shape[0], 1))
    cases.append(("segment ends", *rays(p0, up), segs, 1e-2))
    cases.append(("segment ends, small size_eps", *rays(p0, up), segs, 1e-6))

    r, k = 0.003, 512
    yc = (0.006 * (np.arange(k) - k / 2)).astype(np.float32)
    half = np.where(np.arange(k) % 2 == 0, 0.5 * PI, 0.05)
    lens = ArcSet.make(np.stack([np.zeros(k), yc], 1), -half, half,
                       np.full(k, r), mat_in=1, dtype=dtype, device=device)
    dist = np.array([0.87, 0.9, 0.95, 1.0, 1.05, 1.1, 1.115])
    length = np.array([1.0, 1.05, 1.1, 1.5, 2.0, 10.0]) * 1e-3 * r
    pick = np.arange(0, k, 7)
    grid = np.stack(np.meshgrid(pick, dist, length, indexing="ij"),
                    -1).reshape(-1, 3)
    p0 = np.stack([grid[:, 1] * r, yc[grid[:, 0].astype(int)] - 0.5 * r], 1)
    d = np.stack([np.zeros(grid.shape[0]), grid[:, 2]], 1)
    cases.append(("tangent snap", *rays(p0, d), lens, 1e-6))

    m = 300
    center = rng.uniform(-3, 3, (m, 2)).astype(np.float32)
    a1 = rng.uniform(-PI, PI, m).astype(np.float32)
    a2 = a1 + rng.uniform(0.3, 5.8, m).astype(np.float32)
    radius = (rng.uniform(0.3, 1.5, m)
              * rng.choice([-1.0, 1.0], m)).astype(np.float32)
    arcs = ArcSet.make(center, a1, a2, radius, mat_in=1, dtype=dtype,
                       device=device)
    ends = np.concatenate([
        center + np.abs(radius)[:, None] * np.stack(
            [np.cos(a), np.sin(a)], 1).astype(np.float32) for a in (a1, a2)])
    th = rng.uniform(0, 2 * PI, ends.shape[0])
    start = ends + rng.uniform(1, 4, (ends.shape[0], 1)) * np.stack(
        [np.cos(th), np.sin(th)], 1)
    aims = [ends, np.nextafter(ends, np.float32(np.inf)),
            np.nextafter(ends, np.float32(-np.inf))]
    p0 = np.concatenate([start] * 3).astype(np.float32)
    cases.append(("window ends", *rays(p0, np.concatenate(aims) - p0), arcs,
                  1e-6))

    _, _, lenslets = guide_surfaces()
    exit_face = ArcSet.make(*lenslets, mat_in=1, dtype=dtype, device=device)
    w = 2 * EXIT_HALF_HEIGHT / 512
    joints = (-EXIT_HALF_HEIGHT + w * np.arange(1, 512)).astype(np.float32)
    aim = np.stack([np.full(joints.size, GUIDE_LENGTH), joints], 1)
    aim = np.concatenate([aim, aim + [0.0, 1e-6], aim - [0.0, 1e-6]])
    p0 = np.stack([np.zeros(aim.shape[0]),
                   rng.uniform(-0.5, 0.5, aim.shape[0])], 1)
    cases.append(("far ends", *rays(p0, aim - p0), exit_face, 1e-6))

    parked = np.full((512, 2), 1e30, np.float32)
    away = np.full((512, 2), 100.0, np.float32)
    for label, q0, dq in (("parked", parked, parked * np.float32(1e-6)),
                          ("all-miss", away, np.ones_like(away))):
        cases.append((f"{label} segments", *rays(q0, dq), segs, 1e-2))
        cases.append((f"{label} arcs", *rays(q0, dq), lens, 1e-6))
    return cases


def block_rays(rng, surfaces, block, dtype=torch.float32, device=None):
    """``3 block + 5`` unit rays from uniform points in [-4, 4]^2, ``(p0,
    p1)``: in the first block of ``block`` rays every ray is aimed at a
    point of one of ``surfaces`` (a SegmentSet's middles or an ArcSet's
    window middles), in the second only the first ray, in the third none,
    and the 5 rays of the ragged last block all are; the rays not aimed
    start at (100, 100) and point away."""
    if isinstance(surfaces, SegmentSet):
        targets = (surfaces.p0 + surfaces.p1) / 2
    else:
        sweep = torch.remainder(surfaces.angle_end - surfaces.angle_start,
                                2 * PI)
        mid = surfaces.angle_start + sweep / 2
        unit = torch.stack([torch.cos(mid), torch.sin(mid)], 1)
        targets = surfaces.center + surfaces.radius.abs()[:, None] * unit
    targets = targets.detach().cpu().double().numpy()
    n = 3 * block + 5
    p0 = np.full((n, 2), 100.0)
    p1 = p0 + 1.0
    aimed = np.r_[0:block + 1, 3 * block:n]
    start = rng.uniform(-4, 4, (aimed.size, 2))
    d = targets[rng.integers(0, len(targets), aimed.size)] - start
    p0[aimed] = start
    p1[aimed] = start + d / np.linalg.norm(d, axis=1, keepdims=True)
    return tuple(torch.as_tensor(a.astype(np.float32), dtype=dtype,
                                 device=resolve_device(device))
                 for a in (p0, p1))
