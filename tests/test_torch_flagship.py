"""Parity of the PyTorch port's flagship problem with the JAX package's
(``__graft_entry__._flagship``) at a small size: 6 x 6 base points, 2 mesh
rings, 4 bounces, float64.

``jax.random`` streams cannot be reproduced in PyTorch, so the JAX side
samples from a key and the port is fed the very uniforms JAX's samplers
drew from that key (the same key splits, the same ``jax.random.uniform``
calls); both must then give the same rays.  Tolerances: rays and lens
vertices within rtol 1e-12 (float64; acos, cos and sin differ in the last
bit between XLA and PyTorch), the loss within rtol 1e-9.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402
from tensorflowraytrace_tpu.models import boundaries as j_bd  # noqa: E402
from tensorflowraytrace_tpu.models import distributions as j_dist  # noqa: E402
from tensorflowraytrace_tpu.models import mesh as j_mesh  # noqa: E402
from tensorflowraytrace_tpu.models import sources as j_src  # noqa: E402
from tensorflowraytrace_tpu_torch import config  # noqa: E402
from tensorflowraytrace_tpu_torch import flagship  # noqa: E402
from tensorflowraytrace_tpu_torch.models import distributions as t_dist  # noqa: E402
from tensorflowraytrace_tpu_torch.models import mesh as t_mesh  # noqa: E402
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk  # noqa: E402
from tensorflowraytrace_tpu_torch.utils.convert import params_from_numpy  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

BP, STEPS, BOUNCES = 6, 2, 4
F64 = torch.float64


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def close(t, j, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def jax_uniforms(key, n, n_base=None, dtype=jnp.float64):
    """The uniforms JAX's AngularSource(RandomUniformSphere of n,
    RandomUniformSquare of n_base points).sample(key) draws, as the port's
    ``uniforms``."""
    ka, kb = jax.random.split(key)
    kp, kt = jax.random.split(ka)
    kx, ky = jax.random.split(kb)

    def u(k, size=n):
        return np.asarray(jax.random.uniform(k, (size,), dtype=dtype))

    n_base = n if n_base is None else n_base
    return {"angle": np.stack([u(kp), u(kt)]),
            "base_point": np.stack([u(kx, n_base), u(ky, n_base)])}


def jax_source(n_side):
    n = n_side * n_side
    return j_src.AngularSource(
        3, (-4.0, 0.0, 0.0), (1.0, 0.0, 0.0),
        j_dist.RandomUniformSphere(math.pi / 16.0, n),
        j_dist.RandomUniformSquare(0.2, n_side), [575.0] * n, dense=False)


def test_square_matches_jax():
    key = jax.random.PRNGKey(3)
    kx, ky = jax.random.split(key)
    u = np.stack([np.asarray(jax.random.uniform(k, (25,), jnp.float64))
                  for k in (kx, ky)])
    j_pts, j_rank = j_dist.RandomUniformSquare(0.3, 5).sample(key, jnp.float64)
    t_pts, t_rank = t_dist.RandomUniformSquare(0.3, 5).sample(
        dtype=F64, uniforms=u)
    close(t_pts, j_pts)
    close(t_rank, j_rank)


def test_sphere_matches_jax():
    key = jax.random.PRNGKey(4)
    kp, kt = jax.random.split(key)
    u = np.stack([np.asarray(jax.random.uniform(k, (40,), jnp.float64))
                  for k in (kp, kt)])
    j_pts, j_rank = j_dist.RandomUniformSphere(0.3, 40).sample(key, jnp.float64)
    t_pts, t_rank = t_dist.RandomUniformSphere(0.3, 40).sample(
        dtype=F64, uniforms=u)
    close(t_pts, j_pts)
    close(t_rank, j_rank)


def test_generator_draws_are_in_range():
    g = torch.Generator().manual_seed(1)
    pts, _ = t_dist.RandomUniformSquare(0.2, 30).sample(g, dtype=F64)
    assert pts.shape == (900, 2) and pts.abs().max() <= 0.2
    dirs, rank = t_dist.RandomUniformSphere(0.25, 500).sample(g, dtype=F64)
    assert torch.allclose(dirs.norm(dim=1), torch.ones(500, dtype=F64))
    assert rank[:, 0].max() <= 0.25 + 1e-12
    with pytest.raises(ValueError):
        t_dist.RandomUniformSquare(0.2, 3).sample(uniforms=np.zeros((2, 5)))


def test_angular_source_matches_jax():
    key = jax.random.PRNGKey(0)
    j_rays = jax_source(BP).sample(key, jnp.float64)
    _, source, _ = flagship._flagship(F64, BP, STEPS, BOUNCES, False, "cpu")
    t_rays = source.sample(dtype=F64, uniforms=jax_uniforms(key, BP * BP))
    close(t_rays.p0, j_rays.p0)
    close(t_rays.p1, j_rays.p1)
    close(t_rays.wavelength, j_rays.wavelength)
    close(t_rays.fields["rank"], j_rays.fields["rank"])
    assert t_rays.state.dtype == torch.int32


@pytest.mark.parametrize("aim", [
    dict(central_angle=(0.3, 1.0, -0.5)),
    dict(central_angle=(0.9, 0.1, 0.3, -0.2), angle_type="quaternion",
         start_on_base=False),
])
def test_dense_aimed_source_matches_jax(aim):
    """The dense product of 5 directions x 9 base points x 2 wavelengths,
    aimed off the x axis, with extra fields on a domain and on the whole."""
    key = jax.random.PRNGKey(11)
    wl = np.array([450.0, 650.0])
    ray_w = np.linspace(0.1, 0.9, 90)

    def make(src, dist_mod):
        return src.AngularSource(
            3, (0.5, -1.0, 2.0), angular_distribution=dist_mod.RandomUniformSphere(
                0.4, 5), base_point_distribution=dist_mod.RandomUniformSquare(
                0.3, 3), wavelengths=wl, dense=True,
            extra_fields={"tag": ("wavelength", np.array([7.0, 8.0])),
                          "w": ("whole", ray_w)}, **aim)

    j_rays = make(j_src, j_dist).sample(key, jnp.float64)
    t_rays = make(flagship.src, t_dist).sample(
        dtype=F64, uniforms=jax_uniforms(key, 5, 9))
    assert t_rays.n_rays == 90
    for name in ("p0", "p1", "wavelength"):
        close(getattr(t_rays, name), getattr(j_rays, name))
    for name in ("rank", "tag", "w"):
        close(t_rays.fields[name], j_rays.fields[name])


def test_point_and_no_constraint_match_jax(rng):
    a, b = rng.normal(0, 1, 8), rng.normal(0, 1, 8)
    cases = [(j_bd.PointConstraint(0.3, 2, 5), flagship.bd.PointConstraint(0.3, 2, 5)),
             (j_bd.NoConstraint(), flagship.bd.NoConstraint()),
             (j_bd.ThicknessConstraint(0.1, "max", parent="zero"),
              flagship.bd.ThicknessConstraint(0.1, "max", parent="zero"))]
    for j_c, t_c in cases:
        close(t_c.apply(1, [torch.as_tensor(a), torch.as_tensor(b)]),
              j_c.apply(1, [jnp.asarray(a), jnp.asarray(b)]))
        close(t_c.apply_literal(torch.as_tensor(b)),
              j_c.apply_literal(jnp.asarray(b)))


def test_as_trimesh_accepts_flat_faces():
    class PolyData:  # pyvista's layout: [3, i, j, k, 3, ...]
        points = np.eye(4)[:, :3]
        faces = np.array([3, 0, 1, 2, 3, 1, 2, 3])

    mesh = t_mesh.as_trimesh(PolyData())
    np.testing.assert_array_equal(mesh.faces, [[0, 1, 2], [1, 2, 3]])
    assert t_mesh.as_trimesh((PolyData.points, mesh.faces)).n_faces == 2
    with pytest.raises(TypeError):
        t_mesh.as_trimesh(3)


def test_hexagonal_mesh_matches_jax():
    for steps in (1, 2, 5):
        t, j = t_mesh.hexagonal_mesh(1.2, steps), j_mesh.hexagonal_mesh(1.2, steps)
        np.testing.assert_array_equal(t.points, j.points)
        np.testing.assert_array_equal(t.faces, j.faces)
        np.testing.assert_array_equal(t.flip_faces().faces, j.flip_faces().faces)


def random_params(rng, lens):
    return [rng.normal(0, 0.05, np.asarray(p).shape) for p in lens.init_params()]


def test_lens_build_matches_jax(rng):
    j_lens, _ = graft._flagship(jnp.float64, BP, STEPS, BOUNCES, False)
    t_lens, _, _ = flagship._flagship(F64, BP, STEPS, BOUNCES, False, "cpu")
    params = random_params(rng, j_lens)
    j_sets = j_lens.build([jnp.asarray(p) for p in params])
    t_sets = t_lens.build(params_from_numpy(params, dtype=F64))
    assert len(t_sets) == len(j_sets) == 2
    for t, j in zip(t_sets, j_sets):
        for name in ("vp", "v1", "v2", "norm"):
            close(getattr(t, name), getattr(j, name))
        np.testing.assert_array_equal(t.mat_in.numpy(), np.asarray(j.mat_in))


def test_thickness_constraint_matches_jax(rng):
    a, b = rng.normal(0, 1, 20), rng.normal(0, 1, 20)
    for mode in ("min", "max"):
        j = j_bd.ThicknessConstraint(0.2, mode).apply(1, [jnp.asarray(a),
                                                          jnp.asarray(b)])
        t = flagship.bd.ThicknessConstraint(0.2, mode).apply(
            1, [torch.as_tensor(a), torch.as_tensor(b)])
        close(t, j)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_loss_matches_jax(rng, use_kernel):
    """Same params, same rays: the loss within rtol 1e-9.  ``use_kernel``
    runs K1's plain version in float64 in place of the Cramer search."""
    key = jax.random.PRNGKey(7)
    j_lens, j_loss = graft._flagship(jnp.float64, BP, STEPS, BOUNCES, False)
    t_lens, source, t_loss = flagship._flagship(F64, BP, STEPS, BOUNCES,
                                                use_kernel, "cpu")
    params = random_params(rng, j_lens)
    j_val = float(j_loss([jnp.asarray(p) for p in params], key))
    rays = source.sample(dtype=F64, uniforms=jax_uniforms(key, BP * BP))
    t_val = t_loss(params_from_numpy(params, dtype=F64), rays)
    assert j_val > 0
    np.testing.assert_allclose(float(t_val), j_val, rtol=1e-9)


def test_loss_from_module_parameters_is_differentiable(rng):
    t_lens, source, t_loss = flagship._flagship(F64, BP, STEPS, BOUNCES,
                                                False, "cpu")
    with torch.no_grad():
        for p in t_lens.param_list():
            p.copy_(torch.as_tensor(rng.normal(0, 0.05, p.shape)))
    val = t_loss(None, source.sample(torch.Generator().manual_seed(0), F64))
    val.backward()
    grads = [p.grad for p in t_lens.param_list()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0


def test_entry_runs_on_cpu():
    forward, (params, generator) = flagship.entry(device="cpu")
    assert [p.shape for p in params] == [(217,), (217,)]
    before = tk.LAUNCHES
    loss = forward(params, generator)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert tk.LAUNCHES == before  # no CUDA kernel on the CPU
    # K1's plain version and the Cramer search agree on the loss
    forward_k, (params_k, gen_k) = flagship.entry(device="cpu", use_kernel=True)
    np.testing.assert_allclose(forward_k(params_k, gen_k).item(), loss.item(),
                               rtol=1e-4)
