"""The training slice of the PyTorch port against the JAX package, on the
CPU, in float64.

* The pieces' gradients (``snell_3d_vec``, ``refine_triangle_hit_from``,
  ``compute_face_normals``): ``torch.autograd`` against ``jax.grad`` on the
  3D cases of tests/test_geometry.py (the exactly-critical incidence among
  them) and seeded random rays and triangles; rtol 1e-10.
* The flagship loss gradient (6 x 6 rays, 2 mesh rings, 3 bounces, with the
  vertex update map): rtol 1e-9.  Both packages run the plain searches, so
  the hit sets are identical and only the refine carries gradient; the
  rays are the same numbers (the port is fed JAX's own uniforms).
* Three ``Optimizer`` steps of the flagship with the accumulator and the
  smoother, on fixed rays: parameters within rtol 1e-9.
* ``flagship.train`` runs on the CPU when asked, and the port never picks
  the CPU by itself.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import FINISHED as J_FINISHED
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import trace as j_trace
from tensorflowraytrace_tpu import optim as j_optim
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import mesh as j_mesh
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.models import surfaces as j_surf
from tensorflowraytrace_tpu.ops import geometry as j_geo
from tensorflowraytrace_tpu.ops import intersect as j_isect
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch import flagship
from tensorflowraytrace_tpu_torch import optim as t_optim
from tensorflowraytrace_tpu_torch.models import surfaces as t_surf
from tensorflowraytrace_tpu_torch.ops import geometry as t_geo
from tensorflowraytrace_tpu_torch.ops import intersect as t_isect
from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from tensorflowraytrace_tpu_torch.utils.convert import params_from_numpy

BP, RINGS, BOUNCES = 6, 2, 3
F64 = torch.float64


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def t64(a, grad=False):
    return torch.as_tensor(np.asarray(a), dtype=F64).requires_grad_(grad)


def grads_match(j_fn, t_fn, inputs, rtol=1e-10, atol=0.0):
    """jax.grad and torch.autograd of the same scalar function of the same
    numpy inputs, every argument."""
    j_g = jax.grad(j_fn, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(a) for a in inputs])
    t_in = [t64(a, grad=True) for a in inputs]
    t_g = torch.autograd.grad(t_fn(*t_in), t_in)
    for t, j in zip(t_g, j_g):
        assert np.all(np.isfinite(np.asarray(j)))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                                   atol=atol)


# ----------------------------------------------------------------------
# the pieces
# ----------------------------------------------------------------------

def snell_cases(rng):
    """(p0, p1, norm, n_in, n_out): the exactly-critical incidence of
    tests/test_geometry.py (radicand exactly 0), its TIR case, and seeded
    random rays with refraction, TIR and mirrors mixed."""
    t = math.pi / 3
    n = 40
    p0 = rng.uniform(-1, 1, (n, 3))
    p1 = p0 + rng.normal(0, 1, (n, 3))
    norm = rng.normal(0, 1, (n, 3))
    n_in = rng.choice([0.0, 1.0, 1.5, 1.49], n)
    n_out = rng.choice([1.0, 1.3, 2.0], n)
    return [
        ([[0.0, 0.0, 0.0]], [[0.8, 0.0, 0.6]], [[0.0, 0.0, 1.0]], [1.25], [1.0]),
        ([[-math.cos(t), -math.sin(t), 0.0]], [[0.0, 0.0, 0.0]],
         [[1.0, 0.0, 0.0]], [1.5], [1.0]),
        (p0, p1, norm, n_in, n_out),
    ]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_snell_3d_vec_gradient_matches_jax(rng, case):
    p0, p1, norm, n_in, n_out = (np.asarray(a, np.float64)
                                 for a in snell_cases(rng)[case])
    w = rng.normal(0, 1, (2,) + p1.shape)

    def loss(geo, lib):
        def f(p0, p1, norm, n_in, n_out):
            a, b = geo.snell_3d_vec(p0, p1, norm, n_in, n_out, 1.0)
            return lib.sum(lib.asarray(w[0]) * a) + lib.sum(lib.asarray(w[1]) * b)
        return f

    grads_match(loss(j_geo, jnp), loss(t_geo, torch),
                [p0, p1, norm, n_in, n_out], atol=1e-13)


def refine_inputs(rng, n=60):
    p0 = rng.uniform(-2, 2, (n, 3))
    p1 = p0 + rng.normal(0, 1, (n, 3))
    c = rng.uniform(-1, 1, (n, 3))
    vp, v1, v2 = (c + rng.normal(0, 0.8, (n, 3)) for _ in range(3))
    # one triangle parallel to its ray: the masked, safe divide
    d = p1[0] - p0[0]
    v1[0] = vp[0] + d
    v2[0] = vp[0] + np.cross(d, [0.3, -0.2, 0.9])
    return [p0, p1, vp, v1, v2]


def test_refine_gradient_matches_jax(rng):
    inputs = refine_inputs(rng)
    w = rng.normal(0, 1, (6, inputs[0].shape[0]))

    def loss(isect, lib):
        def f(p0, p1, vp, v1, v2):
            point, u, tu, tv = isect.refine_triangle_hit_from(p0, p1, vp, v1,
                                                              v2, 1e-10)
            cols = [point[:, 0], point[:, 1], point[:, 2], u, tu, tv]
            return sum(lib.sum(lib.asarray(w[k]) * c) for k, c in enumerate(cols))
        return f

    grads_match(loss(j_isect, jnp), loss(t_isect, torch), inputs, atol=1e-12)


def test_face_normal_gradient_matches_jax(rng):
    _, _, vp, v1, v2 = refine_inputs(rng)
    w = rng.normal(0, 1, vp.shape)

    def loss(surf, lib):
        return lambda vp, v1, v2: lib.sum(
            lib.asarray(w) * surf.compute_face_normals(vp, v1, v2))

    grads_match(loss(j_surf, jnp), loss(t_surf, torch), [vp, v1, v2],
                atol=1e-13)


# ----------------------------------------------------------------------
# the flagship
# ----------------------------------------------------------------------

def jax_uniforms(key, n):
    """The uniforms JAX's flagship source draws from ``key`` (the same key
    splits and ``jax.random.uniform`` calls), as the port's ``uniforms``."""
    ka, kb = jax.random.split(key)
    kp, kt = jax.random.split(ka)
    kx, ky = jax.random.split(kb)

    def u(k):
        return np.asarray(jax.random.uniform(k, (n,), dtype=jnp.float64))

    return {"angle": np.stack([u(kp), u(kt)]),
            "base_point": np.stack([u(kx), u(ky)])}


def jax_flagship(vertex_update_map):
    """The JAX package's flagship (``__graft_entry__._flagship``) with a
    vertex update map, float64, the plain search; the loss takes rays."""
    n = BP * BP
    source = j_src.AngularSource(
        3, (-4.0, 0.0, 0.0), (1.0, 0.0, 0.0),
        j_dist.RandomUniformSphere(math.pi / 16.0, n),
        j_dist.RandomUniformSquare(0.2, BP), [575.0] * n, dense=False)
    mesh = j_mesh.hexagonal_mesh(1.2, RINGS)
    mesh.points = mesh.points[:, [2, 0, 1]]
    lens = j_bd.ParametricMultiTriangleBoundary(
        mesh, j_bd.FromVectorVG((1.0, 0.0, 0.0)),
        [j_bd.ThicknessConstraint(0.0, "min"),
         j_bd.ThicknessConstraint(0.2, "min")],
        [True, False], vertex_update_map=vertex_update_map,
        material_list=[{"mat_in": 1, "mat_out": 0}] * 2, dtype=jnp.float64)
    target = JTriangleSet.make(
        [[8.0, -50.0, -50.0], [8.0, 50.0, 50.0]],
        [[8.0, 50.0, -50.0], [8.0, -50.0, 50.0]],
        [[8.0, 50.0, 50.0], [8.0, -50.0, -50.0]], dtype=jnp.float64)
    cfg = JTraceConfig(max_bounces=BOUNCES, use_pallas=False)

    def loss(params, rays):
        scene = JScene3D.build(optical=lens.build(params), targets=[target])
        res = j_trace(rays, scene, (j_mats.vacuum, j_mats.acrylic), cfg)
        fin = res.rays.state == J_FINISHED
        per_ray = jnp.sum((res.rays.p1[:, 1:] - res.rays.fields["rank"] * -0.4)
                          ** 2, axis=1)
        return jnp.sum(jnp.where(fin, per_ray, 0.0))

    return lens, source, loss


def flagship_case(rng, use_kernel=False):
    """Both packages' flagship with the same vertex update map, the same
    rays and the same random parameters."""
    vum, acc, smoother = flagship.training_tools(RINGS)
    j_lens, j_source, j_loss = jax_flagship(vum)
    t_lens, t_source, t_loss = flagship._flagship(F64, BP, RINGS, BOUNCES,
                                                  use_kernel, "cpu", vum)
    key = jax.random.PRNGKey(7)
    j_rays = j_source.sample(key, jnp.float64)
    t_rays = t_source.sample(dtype=F64, uniforms=jax_uniforms(key, BP * BP))
    params = [rng.normal(0, 0.05, np.asarray(p).shape)
              for p in j_lens.init_params()]
    return (j_loss, j_rays), (t_loss, t_rays), params, acc, smoother


@pytest.mark.parametrize("use_kernel", [False, True])
def test_flagship_gradient_matches_jax(rng, use_kernel):
    """``use_kernel`` runs K1's and K2's plain versions on the CPU."""
    (j_loss, j_rays), (t_loss, t_rays), params, _, _ = flagship_case(
        rng, use_kernel)
    j_val, j_grad = jax.value_and_grad(j_loss)(
        [jnp.asarray(p) for p in params], j_rays)
    t_params = [p.requires_grad_(True) for p in params_from_numpy(params, F64)]
    t_val = t_loss(t_params, t_rays)
    t_val.backward()
    assert float(j_val) > 0
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-9)
    for t, j in zip(t_params, j_grad):
        j = np.asarray(j)
        assert np.abs(j).max() > 0
        # the vertex update map zeroes some vertices' gradients exactly
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-9,
                                   atol=1e-12 * np.abs(j).max())


def test_flagship_optimizer_steps_match_jax(rng):
    """Three steps of the flagship's training phases (accumulator, smoother,
    lr ramp, momentum, clip 1e-3) on fixed rays."""
    (j_loss, j_rays), (t_loss, t_rays), params, acc, smoother = flagship_case(rng)
    routine = [
        {"steps": 2, "learning_rate": 2e-4, "momentum": 0.8,
         "accumulators": [acc] * 2, "smoothers": [smoother] * 2},
        {"steps": 1, "learning_rate": (1e-4, 5e-5), "momentum": 0.9,
         "accumulators": [acc] * 2},
    ]
    j_opt = j_optim.Optimizer(lambda p: j_loss(p, j_rays),
                              [jnp.asarray(p) for p in params],
                              grad_clip=1e-3, pass_key=False)
    j_err = j_opt.training_routine(routine, report_frequency=0, show_time=False)
    t_opt = t_optim.Optimizer(lambda p: t_loss(p, t_rays),
                              params_from_numpy(params, F64), grad_clip=1e-3,
                              pass_key=False)
    t_err = t_opt.training_routine(routine, report_frequency=0, show_time=False,
                                   chain=True)
    np.testing.assert_allclose(t_err, j_err, rtol=1e-9)
    for t, j in zip(t_opt.parameters, j_opt.parameters):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-9,
                                   atol=1e-15)
    moved = max(float((t - torch.as_tensor(p)).abs().max())
                for t, p in zip(t_opt.parameters, params))
    assert moved > 0


def test_train_runs_on_cpu():
    before = (tk.LAUNCHES, sk.LAUNCHES)
    errors, params = flagship.train(steps=3, bp_count=4, mesh_steps=2,
                                    device="cpu")
    assert len(errors) == 3 and np.all(np.isfinite(errors))
    assert [p.shape for p in params] == [(19,), (19,)]
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in params)
    assert (tk.LAUNCHES, sk.LAUNCHES) == before  # no CUDA kernel on the CPU


def test_no_silent_cpu_fallback(monkeypatch):
    """Without a card, the default device raises instead of giving the
    CPU; the CPU is had by asking."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    previous = config.set_default_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            config.resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            flagship.entry()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            flagship.train(steps=1, bp_count=2, mesh_steps=1)
        assert config.resolve_device("cpu") == torch.device("cpu")
    finally:
        config.set_default_device(previous)
    assert config.resolve_device(None) == torch.device("cpu")
