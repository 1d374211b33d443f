"""The 2D geometry, surfaces, sources and distributions of the PyTorch port
against the JAX package, on the CPU, in float64.

* ``raw_line_intersect``, ``raw_line_circle_intersect`` (with tangent,
  missing and degenerate rays), ``snells_law_2D`` (refraction, TIR,
  mirrors, exactly critical incidence, a degenerate ray),
  ``angle_in_interval`` and ``rotate_2d``: values within rtol 1e-10, and
  ``torch.autograd`` against ``jax.grad`` within rtol 1e-10.
* ``SegmentSet``, ``ArcSet`` and ``Scene2D.build`` hold the same columns.
* The 2D angle and beam distributions and the 2D ``AngularSource``: the
  same numbers, the random ones fed JAX's own uniforms.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.models import surfaces as j_surf
from tensorflowraytrace_tpu.ops import geometry as j_geo
from tensorflowraytrace_tpu.utils import quaternion as j_quat
from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.models import distributions as t_dist
from tensorflowraytrace_tpu_torch.models import sources as t_src
from tensorflowraytrace_tpu_torch.models import surfaces as t_surf
from tensorflowraytrace_tpu_torch.ops import geometry as t_geo
from tensorflowraytrace_tpu_torch.utils import quaternion as t_quat
from tensorflowraytrace_tpu_torch.utils.convert import (
    arcs_from_numpy, segments_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
PI = math.pi


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def t64(a, grad=False):
    return torch.as_tensor(np.asarray(a), dtype=F64).requires_grad_(grad)


def close(t, j, rtol=1e-10, atol=1e-14):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def grads_match(j_fn, t_fn, inputs, rtol=1e-10, atol=1e-13):
    """jax.grad and torch.autograd of the same scalar function of the same
    numpy inputs, every argument; both finite."""
    j_g = jax.grad(j_fn, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(a) for a in inputs])
    t_in = [t64(a, grad=True) for a in inputs]
    t_g = torch.autograd.grad(t_fn(*t_in), t_in)
    for t, j in zip(t_g, j_g):
        assert np.all(np.isfinite(np.asarray(j)))
        assert torch.isfinite(t).all()
        close(t, j, rtol, atol)


# ----------------------------------------------------------------------
# line x line, line x circle
# ----------------------------------------------------------------------

def line_inputs(rng, n=80):
    r0 = rng.uniform(-2, 2, (n, 2))
    r1 = r0 + rng.normal(0, 1, (n, 2))
    s0 = rng.uniform(-2, 2, (n, 2))
    s1 = s0 + rng.normal(0, 1, (n, 2))
    s1[0] = s0[0] + 2.5 * (r1[0] - r0[0])       # parallel: the safe divide
    return [r0[:, 0], r0[:, 1], r1[:, 0], r1[:, 1],
            s0[:, 0], s0[:, 1], s1[:, 0], s1[:, 1]]


def test_raw_line_intersect_matches_jax(rng):
    args = line_inputs(rng)
    want = j_geo.raw_line_intersect(*[jnp.asarray(a) for a in args])
    got = t_geo.raw_line_intersect(*[t64(a) for a in args])
    assert not bool(got[2][0])
    for t, j in zip(got, want):
        close(t, j)


def test_raw_line_intersect_gradient_matches_jax(rng):
    args = line_inputs(rng)
    w = rng.normal(0, 1, (4, len(args[0])))

    def loss(geo, lib):
        def f(*a):
            x, y, valid, u, v = geo.raw_line_intersect(*a)
            return lib.sum(lib.asarray(w[0]) * x + lib.asarray(w[1]) * y
                           + lib.asarray(w[2]) * u + lib.asarray(w[3]) * v)
        return f

    grads_match(loss(j_geo, jnp), loss(t_geo, torch), args)


def circle_inputs(rng, n=80):
    """Random rays and circles, plus a tangent ray, a missing ray and a
    degenerate (zero-length) ray in the first three slots."""
    r0 = rng.uniform(-2, 2, (n, 2))
    r1 = r0 + rng.normal(0, 1, (n, 2))
    c = rng.uniform(-1, 1, (n, 2))
    r = rng.uniform(0.3, 1.5, n) * rng.choice([-1.0, 1.0], n)
    # tangent: the ray y = c_y + |r| along x
    r0[0], r1[0] = [c[0, 0] - 2, c[0, 1] + abs(r[0])], [c[0, 0] + 2,
                                                        c[0, 1] + abs(r[0])]
    r0[1], r1[1] = c[1] + 3 * abs(r[1]), c[1] + [5 * abs(r[1]), 3 * abs(r[1])]
    r1[2] = r0[2]
    return [r0[:, 0], r0[:, 1], r1[:, 0], r1[:, 1], c[:, 0], c[:, 1], r]


def test_raw_line_circle_intersect_matches_jax(rng):
    args = circle_inputs(rng)
    want = j_geo.raw_line_circle_intersect(*[jnp.asarray(a) for a in args])
    got = t_geo.raw_line_circle_intersect(*[t64(a) for a in args])
    for t_branch, j_branch in zip(got, want):
        for key in ("x", "y", "valid", "u", "v"):
            close(t_branch[key], j_branch[key])
    plus, minus = got
    assert plus["valid"][0] and float(plus["u"][0]) == float(minus["u"][0])
    assert not plus["valid"][1] and not plus["valid"][2]


def test_nxm_line_wrappers_match_jax(rng):
    """``line_intersect`` and ``line_circle_intersect``: N lines against M
    lines or circles, each output (M, N) with the second set on axis 0.
    The circles lie within a few radii of the lines, where the port's
    radicand 4 (a - (x_r x d_r)^2) and JAX's b^2 - 4ac agree to rounding
    (rtol 1e-10); far from a circle only the port's form keeps its
    digits (tests/test_torch_float32.py)."""
    n, m = 30, 20
    lines = line_inputs(rng, n)
    second = line_inputs(rng, m)[4:]
    want = j_geo.line_intersect(*[jnp.asarray(a) for a in lines[:4] + second])
    got = t_geo.line_intersect(*[t64(a) for a in lines[:4] + second])
    assert got[0].shape == (m, n)
    for t, j in zip(got, want):
        close(t, j)
    circles = circle_inputs(rng, m)[4:]
    want = j_geo.line_circle_intersect(*[jnp.asarray(a)
                                         for a in lines[:4] + circles])
    got = t_geo.line_circle_intersect(*[t64(a) for a in lines[:4] + circles])
    assert got[0]["x"].shape == (m, n)
    assert 0 < int(got[0]["valid"].sum()) < n * m
    for t_branch, j_branch in zip(got, want):
        for key in ("x", "y", "valid", "u", "v"):
            close(t_branch[key], j_branch[key])
    assert "4 (a - (x_r x d_r)^2)" in t_geo.line_circle_intersect.__doc__


def test_raw_line_circle_intersect_promotes_dtypes(rng):
    """A float32 circle against float64 rays is solved in float64 (the
    promotion before 1 / r)."""
    args = circle_inputs(rng)
    mixed = [t64(a) for a in args[:4]] + [torch.as_tensor(a, dtype=torch.float32)
                                          for a in args[4:]]
    plus, _ = t_geo.raw_line_circle_intersect(*mixed)
    assert plus["u"].dtype == F64
    want, _ = j_geo.raw_line_circle_intersect(
        *[jnp.asarray(a) for a in args[:4]],
        *[jnp.asarray(a, jnp.float32) for a in args[4:]])
    close(plus["u"], want["u"])


def test_raw_line_circle_intersect_gradient_matches_jax(rng):
    """Without the tangent and the degenerate ray, whose sqrt(0) has no
    finite derivative in either package; the missing ray stays."""
    args = [np.delete(a, [0, 2]) for a in circle_inputs(rng)]
    w = rng.normal(0, 1, (6, len(args[0])))

    def loss(geo, lib):
        def f(*a):
            plus, minus = geo.raw_line_circle_intersect(*a)
            terms = [b[key] for b in (plus, minus) for key in ("x", "u", "v")]
            return lib.sum(sum(lib.asarray(w[k]) * t
                               for k, t in enumerate(terms)))
        return f

    grads_match(loss(j_geo, jnp), loss(t_geo, torch), args)


# ----------------------------------------------------------------------
# Snell, angles, rotation
# ----------------------------------------------------------------------

def snell_inputs(rng, n=60):
    """Rays ending on surfaces with random normal angles: refraction, TIR,
    mirrors (n_in = 0), exactly critical incidence in slot 0 and a
    degenerate (zero-length) ray in slot 1."""
    p1 = rng.uniform(-1, 1, (n, 2))
    ang = rng.uniform(-PI, PI, n)
    p0 = p1 - np.stack([np.cos(ang), np.sin(ang)], 1)
    norm = rng.uniform(-2 * PI, 2 * PI, n)
    n_in = rng.choice([0.0, 1.0, 1.5, 1.49], n)
    n_out = rng.choice([1.0, 1.3, 2.0], n)
    # critical: from glass (1.5) into air at asin(1 / 1.5) to the normal 0
    crit = math.asin(1 / 1.5)
    p1[0], norm[0], n_in[0], n_out[0] = (0.0, 0.0), 0.0, 1.5, 1.0
    p0[0] = (-math.cos(crit), -math.sin(crit))
    p0[1] = p1[1]
    return [p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1], norm, n_in, n_out]


def test_snells_law_2d_matches_jax(rng):
    args = snell_inputs(rng)
    want = j_geo.snells_law_2D(*[jnp.asarray(a) for a in args], 1.0)
    got = t_geo.snells_law_2D(*[t64(a) for a in args], 1.0)
    for t, j in zip(got, want):
        close(t, j)


def test_snells_law_2d_gradient_matches_jax(rng):
    """Finite gradients through the degenerate ray (the atan2(0, 0) guard)
    and the exactly critical one (the arcsin clamp), equal to JAX's."""
    args = snell_inputs(rng)
    w = rng.normal(0, 1, (2, len(args[0])))

    def loss(geo, lib):
        def f(*a):
            _, _, xe, ye = geo.snells_law_2D(*a, 1.0)
            return lib.sum(lib.asarray(w[0]) * xe + lib.asarray(w[1]) * ye)
        return f

    grads_match(loss(j_geo, jnp), loss(t_geo, torch), args)


def test_safe_direction_and_angle_in_interval_match_jax(rng):
    dx, dy = rng.normal(0, 1, (2, 50))
    dx[:3], dy[:3] = 0.0, [0.0, 1e-20, 0.0]
    for t, j in zip(t_geo._safe_direction_2d(t64(dx), t64(dy)),
                    j_geo._safe_direction_2d(jnp.asarray(dx), jnp.asarray(dy))):
        close(t, j)
    angle, start, end = rng.uniform(-PI, PI, (3, 500))
    np.testing.assert_array_equal(
        t_geo.angle_in_interval(t64(angle), t64(start), t64(end)).numpy(),
        np.asarray(j_geo.angle_in_interval(*map(jnp.asarray, (angle, start,
                                                              end)))))


@pytest.mark.parametrize("angle", [0.3, -2.0])
def test_rotate_2d_matches_jax(rng, angle):
    pts = rng.normal(0, 1, (20, 2))
    want = j_quat.rotate_2d(jnp.asarray(pts), jnp.asarray(angle))
    close(t_quat.rotate_2d(t64(pts), angle), want)
    close(t_quat.rotate_2d(t64(pts), torch.tensor(angle, dtype=F64)), want)


# ----------------------------------------------------------------------
# surfaces
# ----------------------------------------------------------------------

def test_segment_and_arc_sets_match_jax(rng):
    p0, p1 = rng.normal(0, 1, (2, 7, 2))
    js = j_surf.SegmentSet.make(p0, p1, mat_in=1, mat_out=0, dtype=jnp.float64)
    ts = segments_from_numpy(p0, p1, mat_in=1, mat_out=0, dtype=F64)
    close(ts.norm_angle, js.norm_angle)
    center = rng.normal(0, 1, (5, 2))
    a1 = rng.uniform(-PI, PI, 5)
    ja = j_surf.ArcSet.make(center, a1, a1 + 1.0, 0.7, mat_in=2,
                            dtype=jnp.float64)
    ta = arcs_from_numpy(center, a1, a1 + 1.0, 0.7, mat_in=2, dtype=F64)
    for name in ("center", "angle_start", "angle_end", "radius", "mat_in"):
        close(getattr(ta, name), getattr(ja, name))
    # a number fills its column on the device
    assert t_surf.ArcSet.make(center, 0.5, 1.0, 2.0, dtype=F64,
                              device="cpu").radius.tolist() == [2.0] * 5

    jscene = j_surf.Scene2D.build(optical_segments=[js], target_segments=[js],
                                  stop_arcs=[ja], optical_arcs=[ja])
    tscene = t_surf.Scene2D.build(optical_segments=[ts], target_segments=[ts],
                                  stop_arcs=[ta], optical_arcs=[ta])
    for kind, names in (("segments", ("p0", "p1", "category", "mat_in",
                                      "mat_out")),
                        ("arcs", ("center", "radius", "category", "mat_in"))):
        for name in names:
            close(getattr(getattr(tscene, kind), name),
                  getattr(getattr(jscene, kind), name))
    assert t_surf.Scene2D.build(optical_segments=[ts]).arcs is None
    with pytest.raises(ValueError, match="material index"):
        segments_from_numpy(p0, p1, mat_in=1024)


# ----------------------------------------------------------------------
# distributions and sources
# ----------------------------------------------------------------------

def j_uniforms(key, n):
    return np.asarray(jax.random.uniform(key, (n,), dtype=jnp.float64))[None]


@pytest.mark.parametrize("name,args", [
    ("StaticUniformAngularDistribution", (-0.7, 1.1, 9)),
    ("StaticUniformAngularDistribution", (0.0, 0.0, 1)),
    ("RandomUniformAngularDistribution", (-0.7, 1.1, 30)),
    ("RandomLambertianAngularDistribution", (-0.4 * PI, 0.4 * PI, 30)),
    ("StaticUniformBeam", (-1.5, 1.5, 10)),
    ("StaticUniformBeam", (-0.3, 0.9, 7, 0.4)),
    ("RandomUniformBeam", (-0.95, 0.95, 30)),
    ("RandomUniformBeam", (0.2, 0.9, 30, -1.0)),
])
def test_2d_distributions_match_jax(name, args):
    key = jax.random.PRNGKey(5)
    jd, td = getattr(j_dist, name)(*args), getattr(t_dist, name)(*args)
    want = jd.sample(key, jnp.float64)
    uniforms = j_uniforms(key, args[2]) if jd.is_random else None
    got = td.sample(dtype=F64, device="cpu", uniforms=uniforms)
    for t, j in zip(got, want):
        close(t, j, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("dense", [True, False])
def test_2d_angular_source_matches_jax(dense):
    n_angle, n_beam, wavelengths = ((3, 4, [575.0, 450.0]) if dense
                                    else (12, 12, [575.0] * 12))

    def source(dist, src):
        return src.AngularSource(
            2, (0.2, -4.001), PI / 2,
            dist.RandomLambertianAngularDistribution(-0.4 * PI, 0.4 * PI,
                                                     n_angle),
            dist.RandomUniformBeam(-0.09, 0.09, n_beam), wavelengths,
            dense=dense)

    key = jax.random.PRNGKey(0)
    ka, kb = jax.random.split(key)
    want = source(j_dist, j_src).sample(key, jnp.float64)
    got = source(t_dist, t_src).sample(
        dtype=F64, device="cpu",
        uniforms={"angle": j_uniforms(ka, n_angle),
                  "base_point": j_uniforms(kb, n_beam)})
    for name in ("p0", "p1", "wavelength"):
        close(getattr(got, name), getattr(want, name))
    close(got.fields["rank"], want.fields["rank"])
