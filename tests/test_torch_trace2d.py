"""The 2D trace and 2D training of the PyTorch port against the JAX package,
on the CPU.

* examples/light_guide.py (100 rays, 50 bounces) and the arc and
  short-segment scenes of examples/engine_internals.py through the XLA path
  in float64: states exactly equal, ``p0``/``p1`` within rtol 1e-9.
* The kernel path (the plain K5 and K6 on the CPU) against JAX's
  ``use_pallas=True`` (the Pallas kernels in interpret mode) in float32:
  states equal, ``p1`` within atol 1e-5.
* A small version of chip_smoke.py's 2D light guide (256 wall segments, 32
  lenslet arcs, 4096 rays, 8 bounces): brute, ``cull=True`` and
  ``cull=True, resort_rays=True`` on the plain kernels equal each other bit
  for bit; the re-sort scatters the hits back to slot order.
* 2D training: the loss of examples/optimize_single_arc.py, its gradient
  and three optimizer steps against JAX in float64, rtol 1e-9; finite
  gradients with dead rays present.
* The index clamp: one ``hit.idx`` gathers both tables, so mixed scenes with
  more segments than arcs and the reverse run through the gather and its
  backward and match JAX (whose gather clamps).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import ArcSet as JArcSet
from tensorflowraytrace_tpu import FINISHED as J_FINISHED
from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu import optim as j_optim
from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import (
    ArcSet, RaySet, Scene2D, SegmentSet, TraceConfig, config, scenes2d,
)
from tensorflowraytrace_tpu_torch import engine as t_engine
from tensorflowraytrace_tpu_torch import optim as t_optim
from tensorflowraytrace_tpu_torch.models import distributions as t_dist
from tensorflowraytrace_tpu_torch.models import sources as t_src
from tensorflowraytrace_tpu_torch.ops import materials as t_mats
from tensorflowraytrace_tpu_torch.utils.convert import (
    arcs_from_numpy, segments_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

PI = math.pi
F64 = torch.float64
J_MATS = (j_mats.vacuum, j_mats.acrylic)
T_MATS = (t_mats.vacuum, t_mats.acrylic)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def rays_match(t_rays, j_rays, rtol=1e-9, atol=1e-12):
    np.testing.assert_array_equal(t_rays.state.numpy(),
                                  np.asarray(j_rays.state))
    for name in ("p0", "p1"):
        np.testing.assert_allclose(getattr(t_rays, name).detach().numpy(),
                                   np.asarray(getattr(j_rays, name)),
                                   rtol=rtol, atol=atol)


# ----------------------------------------------------------------------
# the examples' scenes
# ----------------------------------------------------------------------

def light_guide_example():
    """examples/light_guide.py: its triangular guide, and its source sampled
    by JAX from PRNGKey(0) and fed to the port as the same uniforms."""
    outline = ([[-0.1, -4.0], [0.0, 4.0], [0.1, -4.0]],
               [[0.0, 4.0], [0.1, -4.0], [-0.1, -4.0]])
    j_scene = JScene2D.build(optical_segments=[JSegmentSet.make(
        *outline, mat_in=1, mat_out=0, dtype=jnp.float64)])
    t_scene = Scene2D.build(optical_segments=[SegmentSet.make(
        *outline, mat_in=1, mat_out=0, dtype=F64)])
    n = 100

    def source(dist, src):
        return src.AngularSource(
            2, (0.0, -4.001), PI / 2,
            dist.RandomLambertianAngularDistribution(-0.4 * PI, 0.4 * PI, n),
            dist.RandomUniformBeam(-0.09, 0.09, n), [575.0] * n, dense=False)

    key = jax.random.PRNGKey(0)
    ka, kb = jax.random.split(key)
    j_rays = source(j_dist, j_src).sample(key, jnp.float64)
    t_rays = source(t_dist, t_src).sample(dtype=F64, uniforms={
        k: np.asarray(jax.random.uniform(kk, (n,), jnp.float64))[None]
        for k, kk in (("angle", ka), ("base_point", kb))})
    return (j_rays, j_scene), (t_rays, t_scene)


def test_light_guide_example_matches_jax_f64():
    (jr, js), (tr, ts) = light_guide_example()
    rays_match(tr, jr, rtol=1e-12)
    cfg = dict(max_bounces=50, dead_ray_length=10.0, keep_history=True)
    j_res = j_engine.trace(jr, js, J_MATS, JTraceConfig(**cfg))
    t_res = t_engine.trace(tr, ts, T_MATS, TraceConfig(**cfg))
    rays_match(t_res.rays, j_res.rays)
    np.testing.assert_array_equal(t_res.history_alive.numpy(),
                                  np.asarray(j_res.history_alive))
    assert (t_res.rays.state == 3).any()


def arc_scene(dtype):
    """examples/engine_internals.py's first panel: a 9-point beam at 6
    wavelengths into one arc of radius 5 centred at (5, 0)."""
    beam = ("StaticUniformBeam", (-1.5, 1.5, 9))
    angles = ("StaticUniformAngularDistribution", (0.0, 0.0, 1))
    wl = [680.0, 620.0, 575.0, 510.0, 450.0, 400.0]
    j_rays = j_src.AngularSource(2, (-1.0, 0.0), 0.0,
                                 getattr(j_dist, angles[0])(*angles[1]),
                                 getattr(j_dist, beam[0])(*beam[1]),
                                 wl).sample(dtype=jnp.float64)
    t_rays = t_src.AngularSource(2, (-1.0, 0.0), 0.0,
                                 getattr(t_dist, angles[0])(*angles[1]),
                                 getattr(t_dist, beam[0])(*beam[1]),
                                 wl).sample(dtype=F64)
    arc = ([[5.0, 0.0]], 3 * PI / 4, 5 * PI / 4, 5.0)
    return ((j_rays, JScene2D.build(optical_arcs=[JArcSet.make(
                *arc, mat_in=1, mat_out=0, dtype=jnp.float64)])),
            (t_rays, Scene2D.build(optical_arcs=[ArcSet.make(
                *arc, mat_in=1, mat_out=0, dtype=F64)])))


def short_segment_scene(dtype):
    """examples/engine_internals.py's second panel: 11 beam points x 11
    wavelengths against a short segment that many miss (they die,
    stretched 10x)."""
    jb = j_dist.StaticUniformBeam(-4.0, 4.0, 11)
    tb = t_dist.StaticUniformBeam(-4.0, 4.0, 11)
    ja = j_dist.StaticUniformAngularDistribution(0.0, 0.0, 1)
    ta = t_dist.StaticUniformAngularDistribution(0.0, 0.0, 1)
    j_rays = j_src.AngularSource(2, (-1.0, 0.0), 0.0, ja, jb,
                                 [575.0] * 11).sample(dtype=jnp.float64)
    t_rays = t_src.AngularSource(2, (-1.0, 0.0), 0.0, ta, tb,
                                 [575.0] * 11).sample(dtype=F64)
    seg = ([[3.0, -2.0]], [[3.0, 2.0]])
    return ((j_rays, JScene2D.build(optical_segments=[JSegmentSet.make(
                *seg, mat_in=1, mat_out=0, dtype=jnp.float64)])),
            (t_rays, Scene2D.build(optical_segments=[SegmentSet.make(
                *seg, mat_in=1, mat_out=0, dtype=F64)])))


@pytest.mark.parametrize("make_scene", [arc_scene, short_segment_scene])
def test_engine_internals_single_pass_matches_jax_f64(make_scene):
    (jr, js), (tr, ts) = make_scene(F64)
    rays_match(tr, jr, rtol=1e-13)
    cfg = dict(max_bounces=1, dead_ray_length=10.0)
    j_new, j_rec = j_engine.single_pass(jr, js, J_MATS, JTraceConfig(**cfg))
    t_new, t_rec = t_engine.single_pass(tr, ts, T_MATS, TraceConfig(**cfg))
    rays_match(t_new, j_new)
    for t, j in zip(t_rec, j_rec):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-9, atol=1e-12)
    states = t_rec[2]
    if make_scene is arc_scene:
        assert (states == 0).all()           # every beam ray refracts
    else:
        assert 0 < int((states == 3).sum()) < tr.n_rays


def test_kernel_path_matches_jax_pallas_f32():
    """The single-arc scene through the plain K5 and K6 against JAX's
    Pallas kernels in interpret mode, 2 bounces, float32."""
    wl = [680.0, 620.0, 575.0, 510.0, 450.0, 400.0]
    beam = (-1.5, 1.5, 10)
    j_rays = j_src.AngularSource(
        2, (-1.0, 0.0), 0.0, j_dist.StaticUniformAngularDistribution(0., 0., 1),
        j_dist.StaticUniformBeam(*beam), wl).sample(dtype=jnp.float32)
    t_rays = t_src.AngularSource(
        2, (-1.0, 0.0), 0.0, t_dist.StaticUniformAngularDistribution(0., 0., 1),
        t_dist.StaticUniformBeam(*beam), wl).sample(dtype=torch.float32)
    arc = ([[4.0, 0.0]], 3 * PI / 4, 5 * PI / 4, 4.0)
    target = ([[10.0, -5.0]], [[10.0, 5.0]])
    js = JScene2D.build(
        optical_arcs=[JArcSet.make(*arc, mat_in=1, mat_out=0)],
        target_segments=[JSegmentSet.make(*target)])
    ts = Scene2D.build(
        optical_arcs=[ArcSet.make(*arc, mat_in=1, mat_out=0,
                                  dtype=torch.float32)],
        target_segments=[SegmentSet.make(*target, dtype=torch.float32)])
    j_res = j_engine.trace(j_rays, js, J_MATS,
                           JTraceConfig(max_bounces=2, use_pallas=True))
    t_res = t_engine.trace(t_rays, ts, T_MATS,
                           TraceConfig(max_bounces=2, use_kernel=True))
    np.testing.assert_array_equal(t_res.rays.state.numpy(),
                                  np.asarray(j_res.rays.state))
    np.testing.assert_allclose(t_res.rays.p1.numpy(), np.asarray(j_res.rays.p1),
                               atol=1e-5)
    assert (t_res.rays.state == 1).all()


# ----------------------------------------------------------------------
# the light guide of chip_smoke.py, small
# ----------------------------------------------------------------------

def test_small_guide_accelerated_traces_equal_brute():
    rays, scene, mats = scenes2d.light_guide(4096, n_wall=128, n_lenslets=32,
                                             device="cpu")
    assert (scene.segments.n_surfaces, scene.arcs.n_surfaces) == (258, 32)
    cfgs = [scenes2d.guide_config(scene, max_bounces=8, use_kernel=True,
                                  **kw)
            for kw in ({}, dict(cull=True), dict(cull=True, resort_rays=True))]
    ref = t_engine.trace(rays, scene, mats, cfgs[0]).rays
    counts = torch.bincount(ref.state.long(), minlength=4)
    assert counts[0] > 0 and counts[1] > 0 and counts[3] > 0
    for cfg in cfgs[1:]:
        got = t_engine.trace(rays, scene, mats, cfg).rays
        for name in ("state", "p0", "p1"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), cfg


def test_resort_scatters_the_hits_back():
    """project_2d with the re-sort gives the projection without it, slot by
    slot (parked, terminated rays hit nothing)."""
    rays, scene, mats = scenes2d.light_guide(2000, n_wall=64, n_lenslets=16,
                                             device="cpu")
    state = torch.where(torch.arange(2000) % 4 == 0, 3, 0).to(torch.int32)
    rays = dataclasses.replace(rays, state=state)
    base = dict(max_bounces=1, use_kernel=True, cull=True)
    a = t_engine.project_2d(rays, scene, mats, TraceConfig(**base))
    b = t_engine.project_2d(rays, scene, mats,
                            TraceConfig(resort_rays=True, **base))
    active = state == 0
    for name in ("hit_valid", "surf_idx", "kind", "point", "norm"):
        assert torch.equal(getattr(a, name)[active], getattr(b, name)[active])
    assert not a.hit_valid[~active].any()


# ----------------------------------------------------------------------
# training and the index clamp
# ----------------------------------------------------------------------

def j_single_arc():
    """tests/test_optimize.py's single-arc loss in JAX, float64."""
    wl = [680.0, 620.0, 575.0, 510.0, 450.0, 400.0]
    rays0 = j_src.AngularSource(
        2, (-1.0, 0.0), 0.0, j_dist.StaticUniformAngularDistribution(0., 0., 1),
        j_dist.StaticUniformBeam(-1.5, 1.5, 10), wl).sample(dtype=jnp.float64)
    target = JSegmentSet.make([[10.0, -5.0]], [[10.0, 5.0]], dtype=jnp.float64)
    cfg = JTraceConfig(max_bounces=2)

    def loss(params, key=None):
        p = params[0][0]
        arc = JArcSet.make(jnp.stack([jnp.stack([p, jnp.asarray(0.0)])]),
                           3 * PI / 4, 5 * PI / 4, p, mat_in=1, mat_out=0,
                           dtype=jnp.float64)
        res = j_engine.trace(rays0, JScene2D.build(optical_arcs=[arc],
                                                   target_segments=[target]),
                             J_MATS, cfg)
        finished = res.rays.state == J_FINISHED
        return jnp.sum(jnp.where(finished, res.rays.p1[:, 1] ** 2, 0.0))

    return loss


@pytest.mark.parametrize("use_kernel", [False, True])
def test_single_arc_loss_and_gradient_match_jax_f64(use_kernel):
    j_loss = j_single_arc()
    t_loss, params = scenes2d.single_arc(dtype=F64, device="cpu",
                                         use_kernel=use_kernel)
    for p in (5.0, 4.2, 3.5):
        j_val, j_grad = jax.value_and_grad(j_loss)([jnp.asarray([p])])
        leaf = torch.tensor([p], dtype=F64, requires_grad=True)
        t_val = t_loss([leaf])
        (t_grad,) = torch.autograd.grad(t_val, leaf)
        np.testing.assert_allclose(float(t_val), float(j_val), rtol=1e-9)
        np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad[0]),
                                   rtol=1e-9)
        assert torch.isfinite(t_grad).all() and float(t_grad) != 0.0


def test_single_arc_optimizer_steps_match_jax_f64():
    j_opt = j_optim.Optimizer(j_single_arc(), [jnp.asarray([5.0])],
                              learning_rate=1.0, grad_clip=0.1)
    t_loss, params = scenes2d.single_arc(dtype=F64, device="cpu")
    t_opt = t_optim.Optimizer(t_loss, params, learning_rate=1.0,
                              grad_clip=0.1, pass_key=False)
    for _ in range(3):
        j_err = j_opt.single_step(None, momentum=0.8)
        t_err = t_opt.single_step(momentum=0.8)
        np.testing.assert_allclose(t_err, j_err, rtol=1e-9)
        np.testing.assert_allclose(t_opt.parameters[0].numpy(),
                                   np.asarray(j_opt.parameters[0]), rtol=1e-9)


def mixed_scene(rng, n_seg, n_arc):
    """A ring of ``n_seg`` segments, open over a sixth of its turn, around
    ``n_arc`` small arcs, and rays from the centre: segment and arc indices
    run past the other table's rows, and some rays escape."""
    t = np.linspace(0, 5 * PI / 3, n_seg + 1)
    ring = np.stack([6 * np.cos(t), 6 * np.sin(t)], 1)
    seg = (ring[:-1], ring[1:])
    k = np.arange(n_arc)
    center = np.stack([2.0 * np.cos(2 * PI * k / n_arc),
                       2.0 * np.sin(2 * PI * k / n_arc)], 1)
    arc = (center, np.full(n_arc, -PI), np.full(n_arc, PI - 1e-3),
           np.full(n_arc, 0.25))
    n = 300
    p0 = rng.uniform(-0.5, 0.5, (n, 2))
    th = rng.uniform(0, 2 * PI, n)
    p1 = p0 + np.stack([np.cos(th), np.sin(th)], 1)
    return seg, arc, p0, p1


@pytest.mark.parametrize("n_seg,n_arc", [(40, 3), (3, 24)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_index_clamp_through_gather_and_backward(rng, n_seg, n_arc,
                                                 use_kernel):
    """Rays hit segments and arcs of indices past the other table's rows;
    the trace and the gradient with respect to both tables match JAX's XLA
    path, whose gather clamps, and are finite with dead rays present."""
    seg, arc, p0, p1 = mixed_scene(rng, n_seg, n_arc)
    w = rng.normal(0, 1, p0.shape)
    cfg = dict(max_bounces=3, dead_ray_length=10.0)
    target = ([[-100.0, -100.0]], [[-100.0, -99.0]])

    def j_fn(sp0, sp1, center, radius):
        js = JScene2D.build(
            optical_segments=[JSegmentSet.make(sp0, sp1, mat_in=0, mat_out=1,
                                               dtype=jnp.float64)],
            target_segments=[JSegmentSet.make(*target, dtype=jnp.float64)],
            optical_arcs=[JArcSet.make(center, arc[1], arc[2], radius,
                                       mat_in=1, mat_out=0,
                                       dtype=jnp.float64)])
        res = j_engine.trace(JRaySet.make(p0, p1, 575.0, dtype=jnp.float64),
                             js, J_MATS, JTraceConfig(**cfg))
        return jnp.sum(jnp.asarray(w) * res.rays.p1), res.rays

    def t_fn(sp0, sp1, center, radius):
        ts = Scene2D.build(
            optical_segments=[SegmentSet.make(sp0, sp1, mat_in=0, mat_out=1,
                                              dtype=F64)],
            target_segments=[segments_from_numpy(*target, dtype=F64)],
            optical_arcs=[ArcSet.make(center, arc[1], arc[2], radius,
                                      mat_in=1, mat_out=0, dtype=F64)])
        res = t_engine.trace(RaySet.make(p0, p1, 575.0, dtype=F64), ts,
                             T_MATS, TraceConfig(use_kernel=use_kernel, **cfg))
        return torch.sum(torch.as_tensor(w) * res.rays.p1), res.rays

    inputs = [seg[0], seg[1], arc[0], arc[3]]
    (j_val, j_rays), j_grads = jax.value_and_grad(
        j_fn, argnums=(0, 1, 2, 3), has_aux=True)(*map(jnp.asarray, inputs))
    leaves = [torch.as_tensor(a, dtype=F64).requires_grad_(True)
              for a in inputs]
    t_val, t_rays = t_fn(*leaves)
    t_grads = torch.autograd.grad(t_val, leaves)
    if not use_kernel:
        rays_match(t_rays, j_rays)
        for t, j in zip(t_grads, j_grads):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-9,
                                       atol=1e-9)
    assert all(torch.isfinite(g).all() for g in t_grads)
    assert (t_rays.state == 3).any()
    # indices past the smaller table were gathered and clamped
    proj = t_engine.project_2d(RaySet.make(p0, p1, 575.0, dtype=F64),
                               Scene2D.build(
                                   optical_segments=[segments_from_numpy(
                                       *seg, dtype=F64)],
                                   optical_arcs=[arcs_from_numpy(*arc,
                                                                 dtype=F64)]),
                               T_MATS, TraceConfig(use_kernel=use_kernel))
    assert int(proj.surf_idx[proj.hit_valid].max()) >= min(n_seg, n_arc)
