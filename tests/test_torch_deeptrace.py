"""The deep-trace fields of the port's ``TraceConfig`` against the JAX
package, on the CPU: ``remat``, ``early_exit``, the fold helpers and
``TraceConfig.recommended``.

* ``remat``: the light guide of ``scenes2d.guide_design`` (guide-shaped:
  32 wall segments, 8 lenslets, 256 rays, 50 bounces, float64) gives the
  JAX package's ``remat=True`` loss and gradient with respect to the
  lenslets' centres and radii within rtol 1e-9, and the port's
  ``remat=False`` ones bit for bit; the search runs once a bounce in the
  forward pass and never in the backward, counted on the search the engine
  calls and, through the kernels' plain versions, on their wrappers.
* ``early_exit``: examples/light_guide.py's problem (100 rays, up to 50
  bounces, float64) stops at the JAX package's depth with its states, and
  ``p1`` within rtol 1e-9; it raises with ``keep_history`` and when
  autograd would record the trace.
* The four fold helpers equal JAX's in float64.
* ``recommended`` matches JAX's policy off the TPU on the scenes of
  tests/test_engine.py when the port's default device is the CPU, and
  picks its H100 policy when the default is CUDA (set without building a
  tensor, as tests/test_engine.py mocks the TPU platform).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu.models import acceleration as j_acc
from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.models import surfaces as j_surf
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import (
    DEAD, Scene2D, Scene3D, SegmentSet, TraceConfig, TriangleSet, config,
    scenes2d,
)
from tensorflowraytrace_tpu_torch import engine as t_engine
from tensorflowraytrace_tpu_torch.models import distributions as t_dist
from tensorflowraytrace_tpu_torch.models import sources as t_src
from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
from tensorflowraytrace_tpu_torch.ops import intersect as t_isect
from tensorflowraytrace_tpu_torch.ops import materials as t_mats
from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

PI = math.pi
F64 = torch.float64
J_MATS = (j_mats.vacuum, j_mats.acrylic)
T_MATS = (t_mats.vacuum, t_mats.acrylic)
GUIDE = dict(n_wall=16, n_lenslets=8)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def lambertian_uniforms(key, n):
    """The uniforms a JAX ``AngularSource.sample(key)`` of a random angle
    and beam draws, for the port's ``uniforms=``."""
    ka, kb = jax.random.split(key)
    return {k: np.asarray(jax.random.uniform(kk, (n,), jnp.float64))[None]
            for k, kk in (("angle", ka), ("base_point", kb))}


def counting(monkeypatch, module, name, calls):
    """Replace ``module.name`` by a wrapper that appends ``name`` to
    ``calls`` and calls it."""
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: (calls.append(name),
                                                       fn(*a, **k))[1])


# ----------------------------------------------------------------------
# remat
# ----------------------------------------------------------------------

def j_guide_loss(n_rays, key):
    """The JAX package's counterpart of ``scenes2d.guide_design``: the same
    surfaces (``scenes2d.guide_surfaces``), Morton-sorted by JAX, the same
    source sampled from ``key``, and the landing loss as JAX's
    ``landing_sum_fold``.  Returns ``(loss(center, radius, cfg), center,
    radius)``."""
    (p0, p1), target, lenslets = scenes2d.guide_surfaces(**GUIDE)
    f64 = jnp.float64
    scene = JScene2D.build(
        optical_segments=[JSegmentSet.make(p0, p1, mat_in=1, mat_out=0,
                                           dtype=f64)],
        target_segments=[JSegmentSet.make(*target, dtype=f64)],
        optical_arcs=[j_surf.ArcSet.make(*lenslets, mat_in=1, mat_out=0,
                                         dtype=f64)])
    segs = j_acc.morton_sort_segments(scene.segments)[0]
    arcs = j_acc.morton_sort_arcs(scene.arcs)[0]
    rays = j_src.AngularSource(
        2, (-0.001, 0.0), 0.0,
        j_dist.RandomLambertianAngularDistribution(-0.4 * PI, 0.4 * PI, n_rays),
        j_dist.RandomUniformBeam(-0.95, 0.95, n_rays), [575.0] * n_rays,
        dense=False).sample(key, f64)

    def loss(center, radius, cfg):
        designed = JScene2D(segments=segs, arcs=dataclasses.replace(
            arcs, center=center, radius=radius))
        init, fn = j_engine.landing_sum_fold(lambda q: q[:, 1] ** 2, f64)
        return j_engine.trace(rays, designed, J_MATS, cfg, fold_fn=fn,
                              fold_init=init).fold

    return loss, arcs.center, arcs.radius


def test_remat_matches_jax_and_no_remat_f64(monkeypatch):
    n, key = 256, jax.random.PRNGKey(3)
    loss, params, scene = scenes2d.guide_design(
        n, dtype=F64, uniforms=lambertian_uniforms(key, n), device="cpu",
        **GUIDE)
    cfg = TraceConfig.recommended(scene, max_bounces=50, dead_ray_length=10.0)
    assert cfg.remat and not cfg.use_kernel and not cfg.cull

    calls = []
    counting(monkeypatch, t_isect, "nearest_hit_2d", calls)
    got = {}
    for remat in (True, False):
        value = loss(params, dataclasses.replace(cfg, remat=remat))
        assert len(calls) == 50
        got[remat] = (value.detach(), torch.autograd.grad(value, params))
        assert len(calls) == 50  # the backward searched nothing
        calls.clear()
    for a, b in zip((got[True][0],) + got[True][1],
                    (got[False][0],) + got[False][1]):
        assert torch.equal(a, b)

    j_loss, j_center, j_radius = j_guide_loss(n, key)
    np.testing.assert_array_equal(params[0].detach().numpy(),
                                  np.asarray(j_center))
    j_value, j_grads = jax.value_and_grad(j_loss, argnums=(0, 1))(
        j_center, j_radius, JTraceConfig(max_bounces=50, dead_ray_length=10.0,
                                         remat=True))
    value, grads = got[True]
    np.testing.assert_allclose(float(value), float(j_value), rtol=1e-9)
    assert float(value) > 0
    for g, jg in zip(grads, j_grads):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-9,
                                   atol=1e-9 * np.abs(jg).max())


def test_remat_runs_each_search_kernel_once_a_bounce(monkeypatch):
    """Under ``use_kernel`` (the plain versions on the CPU) a forward and
    backward pass with ``remat`` calls the K5 and K6 wrappers once a bounce
    and K2's (the arc table's gather backward) once a bounce."""
    loss, params, _ = scenes2d.guide_design(512, device="cpu", **GUIDE)
    calls = []
    for module, name in ((gk, "nearest_hit_segments_kernel"),
                         (ak, "nearest_hit_arcs_kernel"),
                         (sk, "segment_sum_kernel")):
        counting(monkeypatch, module, name, calls)
    value = loss(params, scenes2d.guide_config(max_bounces=3, use_kernel=True,
                                               remat=True))
    torch.autograd.grad(value, params)
    assert sorted(calls) == sorted(["nearest_hit_segments_kernel",
                                    "nearest_hit_arcs_kernel",
                                    "segment_sum_kernel"] * 3)


# ----------------------------------------------------------------------
# early_exit
# ----------------------------------------------------------------------

def light_guide_example():
    """examples/light_guide.py's problem in both packages, float64: its
    triangular guide and its source, sampled by JAX from PRNGKey(0) and fed
    to the port as the same uniforms."""
    outline = ([[-0.1, -4.0], [0.0, 4.0], [0.1, -4.0]],
               [[0.0, 4.0], [0.1, -4.0], [-0.1, -4.0]])
    j_scene = JScene2D.build(optical_segments=[JSegmentSet.make(
        *outline, mat_in=1, mat_out=0, dtype=jnp.float64)])
    t_scene = Scene2D.build(optical_segments=[SegmentSet.make(
        *outline, mat_in=1, mat_out=0, dtype=F64)])
    n, key = 100, jax.random.PRNGKey(0)

    def source(dist, src):
        return src.AngularSource(
            2, (0.0, -4.001), PI / 2,
            dist.RandomLambertianAngularDistribution(-0.4 * PI, 0.4 * PI, n),
            dist.RandomUniformBeam(-0.09, 0.09, n), [575.0] * n, dense=False)

    j_rays = source(j_dist, j_src).sample(key, jnp.float64)
    t_rays = source(t_dist, t_src).sample(
        dtype=F64, uniforms=lambertian_uniforms(key, n))
    return (j_rays, j_scene), (t_rays, t_scene)


def test_early_exit_matches_jax_f64():
    (jr, js), (tr, ts) = light_guide_example()
    opt = dict(max_bounces=50, dead_ray_length=10.0, early_exit=True)
    j_res = j_engine.trace(jr, js, J_MATS, JTraceConfig(**opt))
    with torch.no_grad():
        t_res = t_engine.trace(tr, ts, T_MATS, TraceConfig(**opt))
        full = t_engine.trace(tr, ts, T_MATS,
                              TraceConfig(**{**opt, "early_exit": False}))
    assert t_res.n_bounces == int(j_res.n_bounces) < 50
    assert full.n_bounces == 50
    np.testing.assert_array_equal(t_res.rays.state.numpy(),
                                  np.asarray(j_res.rays.state))
    assert (t_res.rays.state == DEAD).all()
    np.testing.assert_allclose(t_res.rays.p1.numpy(), np.asarray(j_res.rays.p1),
                               rtol=1e-9, atol=1e-12)
    # the bounces past the exit change nothing: the full trace ends alike
    for name in ("state", "p0", "p1"):
        assert torch.equal(getattr(t_res.rays, name), getattr(full.rays, name))


def test_early_exit_is_forward_only_and_takes_no_history():
    _, (tr, ts) = light_guide_example()
    with pytest.raises(ValueError, match="keep_history"):
        t_engine.trace(tr, ts, T_MATS, TraceConfig(max_bounces=5,
                                                   early_exit=True,
                                                   keep_history=True))
    seg = ts.segments
    p0 = seg.p0.clone().requires_grad_(True)
    scene = Scene2D(segments=dataclasses.replace(seg, p0=p0), arcs=None)
    with pytest.raises(ValueError, match="forward only"):
        t_engine.trace(tr, scene, T_MATS, TraceConfig(max_bounces=5,
                                                      early_exit=True))
    with torch.no_grad():
        t_engine.trace(tr, scene, T_MATS, TraceConfig(max_bounces=5,
                                                      early_exit=True))


# ----------------------------------------------------------------------
# folds
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fold", ["path_length", "bounce_count",
                                  "landing_sum", "newly_terminated"])
def test_folds_match_jax_f64(fold):
    """examples/light_guide.py's problem, 3 bounces, with every third ray
    reversed so that it misses and dies on the first."""
    (jr, js), (tr, ts) = light_guide_example()
    n = tr.n_rays
    away = np.arange(n) % 3 == 0
    p1 = np.where(away[:, None], 2 * np.asarray(jr.p0) - np.asarray(jr.p1),
                  np.asarray(jr.p1))
    jr = dataclasses.replace(jr, p1=jnp.asarray(p1))
    tr = dataclasses.replace(tr, p1=torch.as_tensor(p1))
    if fold == "path_length":
        jf = j_engine.path_length_fold(n, jnp.float64)
        tf = t_engine.path_length_fold(n, F64)
    elif fold == "bounce_count":
        jf, tf = j_engine.bounce_count_fold(n), t_engine.bounce_count_fold(n)
    elif fold == "landing_sum":
        jf = j_engine.landing_sum_fold(lambda q: q[:, 0] ** 2, jnp.float64,
                                       DEAD)
        tf = t_engine.landing_sum_fold(lambda q: q[:, 0] ** 2, F64, DEAD)
    else:  # the slots that died on each bounce, counted
        def counter(module):
            return lambda acc, rec: acc + module.newly_terminated(rec, DEAD)
        jf = (jnp.zeros(n, jnp.int32), counter(j_engine))
        tf = (torch.zeros(n, dtype=torch.int32), counter(t_engine))
    cfg = dict(max_bounces=3, dead_ray_length=10.0)
    want = np.asarray(j_engine.trace(jr, js, J_MATS, JTraceConfig(**cfg),
                                     fold_fn=jf[1], fold_init=jf[0]).fold)
    got = t_engine.trace(tr, ts, T_MATS, TraceConfig(**cfg), fold_fn=tf[1],
                         fold_init=tf[0]).fold.numpy()
    assert got.shape == want.shape and np.any(want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-12)


# ----------------------------------------------------------------------
# recommended
# ----------------------------------------------------------------------

def scenes(n_tris=3000):
    """tests/test_engine.py's scenes of its recommended tests."""
    tri = [np.zeros((n_tris, 3)), np.ones((n_tris, 3)), np.full((n_tris, 3), 2.0)]
    seg = [np.zeros((10, 2)), np.ones((10, 2))]
    return ((JScene3D.build(optical=[JTriangleSet.make(*tri)]),
             Scene3D.build(optical=[TriangleSet.make(*tri)])),
            (JScene2D.build(optical_segments=[JSegmentSet.make(*seg)]),
             Scene2D.build(optical_segments=[SegmentSet.make(*seg)])))


@pytest.mark.parametrize("case", ["3d", "2d"])
def test_recommended_matches_jax_off_the_card(case):
    (j3, t3), (j2, t2) = scenes()
    if case == "3d":
        want = JTraceConfig.recommended(j3, max_bounces=24)
        got = TraceConfig.recommended(t3, max_bounces=24)
        assert got.remat
    else:
        want = JTraceConfig.recommended(j2, max_bounces=3, keep_history=True)
        got = TraceConfig.recommended(t2, max_bounces=3, keep_history=True)
        assert not got.remat and got.keep_history
    for field in dataclasses.fields(want):
        name = "use_kernel" if field.name == "use_pallas" else field.name
        assert getattr(got, name) == getattr(want, field.name), name
    assert not got.use_kernel and not got.cull and not got.resort_rays


def test_recommended_card_policy():
    """The H100 rules (PERF.md): culling and re-sort for 3D scenes of
    CULL_3D_MIN_TRIANGLES triangles or more, the brute searches for smaller
    3D scenes and for 2D scenes; reading the CUDA default builds nothing and
    needs no card."""
    (_, small3), (_, scene2) = scenes()
    (_, large3), _ = scenes(t_engine.CULL_3D_MIN_TRIANGLES)
    config.set_default_device("cuda")  # the fixture restores the CPU
    cfg = TraceConfig.recommended(large3, max_bounces=24)
    assert (cfg.use_kernel, cfg.cull, cfg.resort_rays, cfg.remat) == (
        True, True, True, True)
    for scene in (small3, scene2):
        cfg = TraceConfig.recommended(scene, max_bounces=8)
        assert (cfg.use_kernel, cfg.cull, cfg.resort_rays, cfg.remat) == (
            True, False, False, False)
    cfg = TraceConfig.recommended(scene2, cull="grid", remat=True)
    assert cfg.cull == "grid" and cfg.remat and cfg.use_kernel
