"""Parity of the PyTorch port's 3D trace engine with the JAX package.

* float64 on the Cramer search path: per bounce, ``state`` and the hit
  surface index are exactly equal, and ``p0``/``p1`` agree within atol 1e-10
  (the same arithmetic in the same order; what is left is the last bit of
  sqrt / rsqrt / pow, amplified by at most a few bounces).
* float32 with ``use_kernel=True`` (K1's plain version on the CPU) against
  JAX ``use_pallas=True`` (the Pallas kernel in interpret mode): ``state``
  equal and ``p1`` within atol 1e-5, as in tests/test_pallas.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch import engine as t_engine
from tensorflowraytrace_tpu_torch import Scene3D, TraceConfig
from tensorflowraytrace_tpu_torch.ops import materials as t_mats
from tensorflowraytrace_tpu_torch.utils.convert import (
    rayset_from_numpy, triangles_from_numpy,
)

J_DT = {np.float32: jnp.float32, np.float64: jnp.float64}
T_DT = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def quad(x, half):
    """Two triangles covering the square x = const, |y|, |z| <= half."""
    return ([[x, -half, -half], [x, half, half]],
            [[x, half, -half], [x, -half, half]],
            [[x, half, half], [x, -half, -half]])


def mirror_case(rng, dt):
    """tests/test_pallas.py's mirror scene: rays along +x hit a mirror at
    x = 1, reflect, and finish on a target at x = -1."""
    optical = [(quad(1.0, 5.0), dict(mat_in=1))]
    targets = [(quad(-1.0, 50.0), {})]
    n = 300
    starts = np.zeros((n, 3))
    starts[:, 1:] = rng.uniform(-1, 1, (n, 2))
    ends = starts + np.asarray([1.0, 0.0, 0.0])
    mats = ("vacuum", "reflective")
    return optical, [], targets, starts.astype(dt), ends.astype(dt), mats


def soup_case(rng, dt):
    """A random soup of refracting and mirror triangles, a stop and a far
    target; rays start inside the soup in random directions."""
    m = 120
    center = rng.uniform(-3, 3, (m, 3))
    tris = [center + rng.normal(0, 0.6, (m, 3)) for _ in range(3)]
    mat_in = rng.integers(1, 3, m)
    optical = [(tris, dict(mat_in=mat_in, mat_out=0))]
    stops = [(quad(-6.0, 2.0), {})]
    targets = [(quad(8.0, 60.0), {})]
    n = 400
    p0 = rng.uniform(-4, 4, (n, 3))
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mats = ("vacuum", "acrylic", "reflective")
    return optical, stops, targets, p0.astype(dt), (p0 + d).astype(dt), mats


def build_both(case, dt, wavelength=575.0):
    optical, stops, targets, p0, p1, mats = case

    def sets(make, groups, **kw):
        return [make(*[np.asarray(v, dt) for v in verts], **opts, **kw)
                for verts, opts in groups]

    j_scene = JScene3D.build(*(sets(JTriangleSet.make, g, dtype=J_DT[dt])
                               for g in (optical, stops, targets)))
    t_scene = Scene3D.build(*(sets(triangles_from_numpy, g, dtype=T_DT[dt])
                              for g in (optical, stops, targets)))
    j_rays = JRaySet.make(jnp.asarray(p0), jnp.asarray(p1), wavelength,
                          dtype=J_DT[dt])
    t_rays = rayset_from_numpy(p0, p1, np.full(len(p0), wavelength),
                               dtype=T_DT[dt])
    j_m = tuple(getattr(j_mats, k) for k in mats)
    t_m = tuple(getattr(t_mats, k) for k in mats)
    return (j_rays, j_scene, j_m), (t_rays, t_scene, t_m)


def assert_rays_equal(t_rays, j_rays, atol):
    np.testing.assert_array_equal(t_rays.state.numpy(), np.asarray(j_rays.state))
    np.testing.assert_allclose(t_rays.p0.numpy(), np.asarray(j_rays.p0), atol=atol)
    np.testing.assert_allclose(t_rays.p1.numpy(), np.asarray(j_rays.p1), atol=atol)


@pytest.mark.parametrize("make_case", [mirror_case, soup_case])
def test_bounces_match_jax_f64(rng, make_case):
    """Bounce by bounce: hit surface, state and endpoints."""
    (jr, js, jm), (tr, ts, tm) = build_both(make_case(rng, np.float64),
                                            np.float64)
    j_cfg, t_cfg = JTraceConfig(max_bounces=3), TraceConfig(max_bounces=3)
    for _ in range(3):
        j_proj = j_engine.project_3d(jr, js, jm, j_cfg)
        t_proj = t_engine.project_3d(tr, ts, tm, t_cfg)
        hit = np.asarray(j_proj.hit_valid)
        np.testing.assert_array_equal(t_proj.hit_valid.numpy(), hit)
        np.testing.assert_array_equal(t_proj.surf_idx.numpy(),
                                      np.asarray(j_proj.surf_idx))
        np.testing.assert_array_equal(t_proj.category.numpy()[hit],
                                      np.asarray(j_proj.category)[hit])
        jr, _ = j_engine.single_pass(jr, js, jm, j_cfg)
        tr, _ = t_engine.single_pass(tr, ts, tm, t_cfg)
        assert_rays_equal(tr, jr, atol=1e-10)
    # the cases exercise every outcome the scene allows
    states = set(tr.state.tolist())
    assert states >= ({1, 3} if make_case is soup_case else {1})


@pytest.mark.parametrize("make_case", [mirror_case, soup_case])
def test_trace_matches_jax_f64(rng, make_case):
    (jr, js, jm), (tr, ts, tm) = build_both(make_case(rng, np.float64),
                                            np.float64)
    j_res = j_engine.trace(jr, js, jm, JTraceConfig(max_bounces=3))
    t_res = t_engine.trace(tr, ts, tm, TraceConfig(max_bounces=3))
    assert_rays_equal(t_res.rays, j_res.rays, atol=1e-10)
    assert t_res.n_bounces == 3


def test_kernel_path_matches_jax_pallas_f32(rng):
    """The whole 3-bounce trace of the mirror scene."""
    (jr, js, jm), (tr, ts, tm) = build_both(mirror_case(rng, np.float32),
                                            np.float32)
    j_res = j_engine.trace(jr, js, jm, JTraceConfig(max_bounces=3,
                                                    use_pallas=True))
    t_res = t_engine.trace(tr, ts, tm, TraceConfig(max_bounces=3,
                                                   use_kernel=True))
    np.testing.assert_array_equal(t_res.rays.state.numpy(),
                                  np.asarray(j_res.rays.state))
    np.testing.assert_allclose(t_res.rays.p1.numpy(), np.asarray(j_res.rays.p1),
                               atol=1e-5)


@pytest.mark.parametrize("make_case", [mirror_case, soup_case])
def test_kernel_path_bounces_match_jax_pallas_f32(rng, make_case):
    """Each of 3 bounces from the same float32 input rays.

    The soup is compared bounce by bounce, every bounce starting from JAX's
    rays: the port's plain K1 rounds every operation on its own (it equals a
    float32 numpy evaluation bit for bit, as the CUDA kernel built with
    --fmad=false does), while XLA's CPU code for the interpreted Pallas
    kernel rounds differently in the last bit.  In a soup of mirrors that
    last bit grows over bounces until a grazing ray falls on the other side
    of an s_eps edge (one ray in 400 by the third bounce); from shared
    inputs each bounce agrees exactly in state.
    """
    (jr, js, jm), (tr, ts, tm) = build_both(make_case(rng, np.float32),
                                            np.float32)
    j_cfg = JTraceConfig(max_bounces=3, use_pallas=True)
    t_cfg = TraceConfig(max_bounces=3, use_kernel=True)
    for _ in range(3):
        jr, _ = j_engine.single_pass(jr, js, jm, j_cfg)
        out, _ = t_engine.single_pass(tr, ts, tm, t_cfg)
        np.testing.assert_array_equal(out.state.numpy(), np.asarray(jr.state))
        np.testing.assert_allclose(out.p1.numpy(), np.asarray(jr.p1), atol=1e-5)
        tr = rayset_from_numpy(jr.p0, jr.p1, jr.wavelength, jr.state,
                               dtype=torch.float32)


@pytest.mark.parametrize("option", [
    dict(keep_history=True), dict(differentiable=False),
    dict(dead_ray_length=3.0), dict(new_ray_length=2.5),
])
def test_trace_options_match_jax_f64(rng, option):
    (jr, js, jm), (tr, ts, tm) = build_both(soup_case(rng, np.float64),
                                            np.float64)
    j_res = j_engine.trace(jr, js, jm, JTraceConfig(max_bounces=3, **option))
    t_res = t_engine.trace(tr, ts, tm, TraceConfig(max_bounces=3, **option))
    assert_rays_equal(t_res.rays, j_res.rays, atol=1e-10)
    if option.get("keep_history"):
        for name in ("history_p0", "history_p1", "history_state",
                     "history_alive"):
            np.testing.assert_allclose(getattr(t_res, name).numpy(),
                                       np.asarray(getattr(j_res, name)),
                                       atol=1e-10)


def test_fold_matches_jax_f64(rng):
    """A per-bounce fold over the record plus the ray fields."""
    (jr, js, jm), (tr, ts, tm) = build_both(soup_case(rng, np.float64),
                                            np.float64)
    w = rng.uniform(0.5, 1.5, tr.n_rays)
    jr = jr.with_field("w", jnp.asarray(w))
    tr = tr.with_field("w", torch.as_tensor(w))

    def j_fold(acc, rec):
        p0, p1, state, alive, fields = rec
        seg = jnp.linalg.norm(p1 - p0, axis=-1) * fields["w"]
        return acc + jnp.sum(jnp.where(alive & (state != 3), seg, 0.0))

    def t_fold(acc, rec):
        p0, p1, state, alive, fields = rec
        seg = torch.linalg.vector_norm(p1 - p0, dim=-1) * fields["w"]
        return acc + torch.sum(torch.where(alive & (state != 3), seg, 0.0))

    j_res = j_engine.trace(jr, js, jm, JTraceConfig(max_bounces=3),
                           fold_fn=j_fold, fold_init=jnp.zeros(()),
                           fold_fields=True)
    t_res = t_engine.trace(tr, ts, tm, TraceConfig(max_bounces=3),
                           fold_fn=t_fold, fold_init=torch.zeros((),
                                                                 dtype=torch.float64),
                           fold_fields=True)
    np.testing.assert_allclose(float(t_res.fold), float(j_res.fold), rtol=1e-12)


def test_value_mode_matches_jax_f64(rng):
    """refractive_index_type="value": per-surface n_in / n_out floats."""
    case = soup_case(rng, np.float64)
    (jr, js, jm), (tr, ts, tm) = build_both(case, np.float64)
    m = ts.triangles.n_surfaces
    n_in = rng.choice([0.0, 1.5, 1.3], m)
    n_out = np.ones(m)
    js = JScene3D(triangles=dataclasses.replace(
        js.triangles, fields={"n_in": jnp.asarray(n_in),
                              "n_out": jnp.asarray(n_out)}))
    ts = Scene3D(triangles=dataclasses.replace(
        ts.triangles, fields={"n_in": torch.as_tensor(n_in),
                              "n_out": torch.as_tensor(n_out)}))
    opt = dict(max_bounces=3, refractive_index_type="value")
    j_res = j_engine.trace(jr, js, None, JTraceConfig(**opt))
    t_res = t_engine.trace(tr, ts, None, TraceConfig(**opt))
    assert_rays_equal(t_res.rays, j_res.rays, atol=1e-10)


def test_out_of_range_material_kills_the_ray(rng):
    """A material id past the list gives NaN n; the finite-child guard
    kills the ray with finite coordinates, as in JAX."""
    case = list(soup_case(rng, np.float64))
    case[5] = ("vacuum", "acrylic")          # mat_in 2 is out of range
    (jr, js, jm), (tr, ts, tm) = build_both(tuple(case), np.float64)
    j_res = j_engine.trace(jr, js, jm, JTraceConfig(max_bounces=3))
    t_res = t_engine.trace(tr, ts, tm, TraceConfig(max_bounces=3))
    assert_rays_equal(t_res.rays, j_res.rays, atol=1e-10)
    assert np.isfinite(t_res.rays.p1.numpy()).all()


def test_trace_is_differentiable(rng):
    """Gradients reach the surface vertices through the refine and the
    gather, and are finite."""
    (_, _, _), (tr, ts, tm) = build_both(soup_case(rng, np.float64), np.float64)
    tri = ts.triangles
    vp = tri.vp.clone().requires_grad_(True)
    scene = Scene3D(triangles=dataclasses.replace(tri, vp=vp))
    res = t_engine.trace(tr, scene, tm, TraceConfig(max_bounces=3))
    res.rays.p1.sum().backward()
    assert vp.grad is not None and torch.isfinite(vp.grad).all()
    assert vp.grad.abs().sum() > 0


@pytest.mark.parametrize("field", ["cull", "resort_rays", "remat", "early_exit"])
def test_unported_config_fields_raise(field):
    """Every field that was once unported is accepted now: cull and
    resort_rays (tests/test_torch_accel.py), remat and early_exit
    (tests/test_torch_deeptrace.py)."""
    assert getattr(TraceConfig(**{field: True}), field) is True
    TraceConfig(**{field: False})  # the default stays accepted


def test_index_mode_needs_materials(rng):
    (_, _, _), (tr, ts, _) = build_both(mirror_case(rng, np.float64), np.float64)
    with pytest.raises(ValueError, match="needs materials"):
        t_engine.trace(tr, ts, None, TraceConfig(max_bounces=1))
