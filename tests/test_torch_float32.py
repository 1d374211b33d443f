"""The port's two float32 repairs, and its exports, on the CPU.

* The arc refine (``ops/geometry.raw_line_circle_intersect``) computes its
  radicand as 4 (a - (x_r x d_r)^2), the form of the CUDA arc searches.
  The JAX package keeps b^2 - 4 a c, equal in exact arithmetic; for rays
  thousands of radii from a small arc that form is float32 noise, so the
  port is held here to a float64 numpy evaluation of the cross form, not
  to JAX.
* ``TraceConfig.recommended`` on the card sets ``ray_start_epsilon`` from
  the scene's largest coordinate magnitude (``engine.start_epsilon``).  The
  float32 light guide of ``scenes2d.light_guide`` (4096 rays, 50 bounces)
  under it finishes within 1% as many rays as in float64, and none of its
  lenslet hits lies more than 1% of the radius from the float64 refine of
  the same ray, arc and branch.  The traces run the kernels' plain
  versions, as the wrappers do for CPU tensors.
* The package exports the JAX package's fold helpers and Morton sorts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tensorflowraytrace_tpu as jax_pkg
import tensorflowraytrace_tpu_torch as torch_pkg
from tensorflowraytrace_tpu_torch import FINISHED, TraceConfig, config, scenes2d
from tensorflowraytrace_tpu_torch import engine as t_engine
from tensorflowraytrace_tpu_torch.models.surfaces import Scene3D, TriangleSet
from tensorflowraytrace_tpu_torch.ops import geometry as t_geo
from tensorflowraytrace_tpu_torch.ops import intersect as t_isect
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F32, F64 = torch.float32, torch.float64
GUIDE_RAYS = 4096


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def recommended_on_card(scene, **kw):
    """``TraceConfig.recommended`` as it reads a CUDA default device (set
    without building a tensor); the fixture's CPU default comes back."""
    previous = config.set_default_device("cuda")
    try:
        return TraceConfig.recommended(scene, **kw)
    finally:
        config.set_default_device(previous)


# ----------------------------------------------------------------------
# the arc refine
# ----------------------------------------------------------------------

def cross_form_f64(xs, ys, xe, ye, xc, yc, r):
    """Both roots of the line-circle quadratic in float64 numpy, with the
    radicand 4 (a - (x_r x d_r)^2): ``(u_plus, u_minus, rad)``."""
    xs, ys, xe, ye, xc, yc, r = (np.asarray(a, np.float64)
                                 for a in (xs, ys, xe, ye, xc, yc, r))
    xr, yr = (xs - xc) / r, (ys - yc) / r
    xd, yd = (xe - xs) / r, (ye - ys) / r
    a = xd * xd + yd * yd
    b = 2.0 * (xr * xd + yr * yd)
    rad = 4.0 * (a - (xr * yd - yr * xd) ** 2)
    sq = np.sqrt(np.maximum(rad, 0.0))
    return (-b + sq) / (2 * a), (-b - sq) / (2 * a), rad


def test_refine_far_from_a_small_arc_matches_float64_cross_form():
    """Rays from 1000-13000 radii away aimed within the 0.003 radius of the
    lenslet-sized circle: the float32 refine's hit points lie within 1% of
    r of the float64 ones, on both branches, and every ray is valid."""
    rng = np.random.default_rng(0)
    n, r = 2000, 0.003
    centre = np.array([40.0, 0.35])
    dist = r * rng.uniform(1000, 13000, n)
    angle = rng.uniform(-np.pi, np.pi, n)
    start = centre + dist[:, None] * np.stack([np.cos(angle), np.sin(angle)], 1)
    aim = centre + r * rng.uniform(-0.9, 0.9, (n, 1)) * np.stack(
        [-np.sin(angle), np.cos(angle)], 1)
    d = aim - start
    end = start + d / np.linalg.norm(d, axis=1, keepdims=True)
    args = [a.astype(np.float32) for a in (start[:, 0], start[:, 1], end[:, 0],
                                           end[:, 1], np.full(n, centre[0]),
                                           np.full(n, centre[1]),
                                           np.full(n, r))]
    plus, minus = t_geo.raw_line_circle_intersect(
        *[torch.as_tensor(a) for a in args])
    u_plus, u_minus, rad = cross_form_f64(*args)
    assert (rad > 0).all()
    assert bool(plus["valid"].all()) and bool(minus["valid"].all())
    xs, ys, xe, ye = (a.astype(np.float64) for a in args[:4])
    for branch, u in ((plus, u_plus), (minus, u_minus)):
        x, y = xs + (xe - xs) * u, ys + (ye - ys) * u
        off = np.hypot(branch["x"].numpy() - x, branch["y"].numpy() - y) / r
        assert off.max() < 0.01, off.max()


# ----------------------------------------------------------------------
# ray_start_epsilon on the card
# ----------------------------------------------------------------------

def test_start_epsilon_rule():
    """Four float32 spacings of the largest coordinate magnitude, never
    below the float32 default, on the card only and in float32 only (None,
    the dtype's default, otherwise); recommended and the guide's config
    take it from engine.start_epsilon."""
    assert t_engine.float32_start_epsilon(40.0) == 4 * 2.0 ** -18
    assert t_engine.float32_start_epsilon(50.0) == 4 * 2.0 ** -18
    assert t_engine.float32_start_epsilon(1.0) == 1e-6
    tri = [np.zeros((3, 3)), np.ones((3, 3)), np.full((3, 3), -40.0)]
    for dtype, want in ((F32, 4 * 2.0 ** -18), (F64, None)):
        scene = Scene3D.build(optical=[TriangleSet.make(*tri, dtype=dtype)])
        assert t_engine.start_epsilon(scene, "cuda") == want
        assert t_engine.start_epsilon(scene) is None      # the CPU's scene
        assert recommended_on_card(scene).ray_start_epsilon == want
        assert TraceConfig.recommended(scene).ray_start_epsilon is None
    _, scene, _ = scenes2d.light_guide(16, n_wall=8, n_lenslets=4,
                                       device="cpu")
    assert t_engine.start_epsilon(scene, "cuda") == 4 * 2.0 ** -18  # x to 50
    assert scenes2d.guide_config(scene).ray_start_epsilon is None


@pytest.fixture(scope="module")
def guide_traces():
    """The light guide in float32 and float64 under recommended on the card,
    forward only (until no ray is active); per dtype ``(finished count, lenslet hits)``, the hits as
    (p0, p1, point, centre, radius, branch) of each ACTIVE ray whose
    nearest hit is an arc, gathered from every bounce's projection."""
    previous = config.set_default_device("cpu")
    out = {}
    try:
        for dtype in (F32, F64):
            rays, scene, mats = scenes2d.light_guide(GUIDE_RAYS, dtype=dtype,
                                                     device="cpu")
            # early_exit: the 50-bounce trace's result, without the
            # bounces after every ray has ended
            cfg = recommended_on_card(scene, max_bounces=50,
                                      dead_ray_length=scenes2d.DEAD_RAY_LENGTH,
                                      early_exit=True)
            assert cfg.use_kernel and not cfg.cull
            hits = []
            project = t_engine.project_2d

            def spy(r, s, m, c, hit=None):
                proj = project(r, s, m, c, hit)
                sel = (proj.hit_valid & (proj.kind == t_isect.KIND_ARC)
                       & (r.state == 0))
                i = hit.idx[sel].long()
                hits.append((r.p0[sel], r.p1[sel], proj.point[sel],
                             s.arcs.center[i], s.arcs.radius[i],
                             hit.branch[sel]))
                return proj

            t_engine.project_2d = spy
            try:
                with torch.no_grad():
                    res = t_engine.trace(rays, scene, mats, cfg)
            finally:
                t_engine.project_2d = project
            out[dtype] = (int((res.rays.state == FINISHED).sum()),
                          [torch.cat(x) for x in zip(*hits)])
    finally:
        config.set_default_device(previous)
    return out


def test_float32_guide_finishes_as_float64(guide_traces):
    f32, f64 = guide_traces[F32][0], guide_traces[F64][0]
    assert f64 > GUIDE_RAYS // 2
    assert abs(f32 - f64) <= 0.01 * f64, (f32, f64)


def test_float32_guide_lenslet_hits_match_float64_refine(guide_traces):
    p0, p1, point, centre, radius, branch = guide_traces[F32][1]
    assert p0.shape[0] > 1000
    plus, minus = t_geo.raw_line_circle_intersect(
        *(t.double() for t in (p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1],
                               centre[:, 0], centre[:, 1], radius)))
    x = torch.where(branch, minus["x"], plus["x"])
    y = torch.where(branch, minus["y"], plus["y"])
    off = torch.hypot(point[:, 0].double() - x,
                      point[:, 1].double() - y) / radius.double().abs()
    assert float(off.max()) < 0.01, (int((off >= 0.01).sum()), float(off.max()))


# ----------------------------------------------------------------------
# exports
# ----------------------------------------------------------------------

EXPORTS = ("newly_terminated", "path_length_fold", "bounce_count_fold",
           "landing_sum_fold", "morton_sort_segments", "morton_sort_triangles")


@pytest.mark.parametrize("name", EXPORTS)
def test_exports_match_the_jax_package(name):
    assert name in dir(jax_pkg)
    assert callable(getattr(torch_pkg, name))
    assert getattr(torch_pkg, name).__name__ == getattr(jax_pkg, name).__name__


def test_recommended_guide_config_is_unchanged_apart_from_the_rule():
    """On the card the guide's recommended config differs from the CPU one
    in use_kernel and ray_start_epsilon only."""
    _, scene, _ = scenes2d.light_guide(16, n_wall=8, n_lenslets=4,
                                       device="cpu")
    card = recommended_on_card(scene, max_bounces=50)
    cpu = TraceConfig.recommended(scene, max_bounces=50)
    assert dataclasses.replace(card, use_kernel=False,
                               ray_start_epsilon=None) == cpu


# ----------------------------------------------------------------------
# the float32 default off the card: children that re-hit their surface
# ----------------------------------------------------------------------

def short_guide_rehits(pkg, eps):
    """Children of ``examples/streamed_training.py``'s float32 guide
    (coordinates up to 6.05) that hit the surface they start from again:
    the segments of active rays shorter than the card's start epsilon,
    over 6 bounces of 2048 of its Lambertian rays (the port draws them;
    both packages trace the same float32 values).  ``eps`` is the trace's
    ``ray_start_epsilon`` (None: the float32 default, 1e-6)."""
    from tensorflowraytrace_tpu import RaySet as JRaySet
    from tensorflowraytrace_tpu import Scene3D as JScene3D
    from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
    from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
    from tensorflowraytrace_tpu import engine as j_engine
    from tensorflowraytrace_tpu.models import boundaries as j_bd
    from tensorflowraytrace_tpu.ops import materials as j_mats
    from tensorflowraytrace_tpu_torch import streamed
    import jax.numpy as jnp

    rays = streamed.lambertian_source(2048).sample(
        torch.Generator().manual_seed(0), F32, "cpu")
    if pkg == "torch":
        guide, target = streamed.short_guide(12, 10, F32, "cpu")
        with torch.no_grad():
            scene = Scene3D.build(optical=[guide.build()], targets=[target])
            res = t_engine.trace(rays, scene, streamed.MATERIALS,
                                 TraceConfig(max_bounces=6, keep_history=True,
                                             ray_start_epsilon=eps))
    else:
        guide = j_bd.ParametricCylindricalGuide(
            (0.0, 0.0, 0.0), (0.0, 0.0, 6.0), minimum_radius=0.3,
            theta_res=12, z_res=10, rotationally_symmetric=True,
            initial_taper=(0.7, 0.0), mat_in=1, mat_out=0, dtype=jnp.float32)
        half = 0.35
        target = JTriangleSet.make(
            [[-half, -half, 6.05], [half, half, 6.05]],
            [[half, -half, 6.05], [-half, half, 6.05]],
            [[half, half, 6.05], [-half, -half, 6.05]], dtype=jnp.float32)
        scene = JScene3D.build(optical=[guide.build(guide.init_params())],
                               targets=[target])
        res = j_engine.trace(
            JRaySet.make(jnp.asarray(rays.p0.numpy()),
                         jnp.asarray(rays.p1.numpy()), 575.0,
                         dtype=jnp.float32),
            scene, (j_mats.vacuum, j_mats.acrylic),
            JTraceConfig(max_bounces=6, keep_history=True,
                         ray_start_epsilon=eps))
    seg = np.linalg.norm(np.asarray(res.history_p1) - np.asarray(
        res.history_p0), axis=-1)
    active = np.asarray(res.history_state) == 0
    return int(((seg < t_engine.float32_start_epsilon(6.05)) & active).sum())


def test_float32_default_start_epsilon_rehits_as_the_jax_package_does():
    """Off the card a float32 trace keeps the 1e-6 default, two float32
    spacings at coordinates near 6: in both packages some children re-hit
    the surface they start from (on different rays: the packages part in
    the last bit), each such ray stays active and its gradient grows by
    orders of magnitude.  The card's rule, four spacings of the scene's
    extent, leaves none in either.  A reference behaviour the port copies,
    recorded in ROADMAP queue 3."""
    card = t_engine.float32_start_epsilon(6.05)
    for pkg in ("jax", "torch"):
        assert short_guide_rehits(pkg, None) > 0
        assert short_guide_rehits(pkg, card) == 0
