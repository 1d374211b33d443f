"""Parity of the reference-style methods of the port's containers with the
JAX package's, on the CPU in float64: ``RaySet.from_dict`` and
``RaySet.keys`` (2D and 3D, with the wavelength and extra fields),
``SourceBase.snapshot`` (static point sources in 2D and 3D and a
``ManualSource``; a random source's snapshot is its sample from the same
generator) and ``TriangleSet.from_vertices_faces`` (the set, its normals,
and the gradient of a loss on them with respect to the vertices against
``jax.grad``).  Tolerance: rtol 1e-12 (atol 1e-14) on every float; keys,
states and integer fields exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.models.rays import RaySet as JRaySet
from tensorflowraytrace_tpu.models.surfaces import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu_torch import RaySet, config
from tensorflowraytrace_tpu_torch.models import distributions as t_dist
from tensorflowraytrace_tpu_torch.models import sources as t_src
from tensorflowraytrace_tpu_torch.models.surfaces import TriangleSet
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

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


def ray_dict(rng, dim, n=9):
    d = {f"{a}_{end}": rng.normal(0, 1, n)
         for end in ("start", "end") for a in "xyz"[:dim]}
    d["wavelength"] = rng.uniform(400, 700, n)
    d["rank"] = np.arange(n, dtype=np.int32)[::-1].copy()
    d["intensity"] = rng.uniform(0, 1, n)
    return d


@pytest.mark.parametrize("dim", [2, 3])
def test_from_dict_and_keys_match_jax(rng, dim):
    d = ray_dict(rng, dim)
    j_rays = JRaySet.from_dict(d, dtype=jnp.float64)
    t_rays = RaySet.from_dict(d, dtype=F64)
    assert t_rays.dim == dim and t_rays.p0.dtype == F64
    for name in ("p0", "p1", "wavelength"):
        close(getattr(t_rays, name), getattr(j_rays, name))
    np.testing.assert_array_equal(t_rays.state.numpy(),
                                  np.asarray(j_rays.state))
    assert sorted(t_rays.fields) == sorted(j_rays.fields) == [
        "intensity", "rank"]
    np.testing.assert_array_equal(t_rays.fields["rank"].numpy(), d["rank"])
    close(t_rays.fields["intensity"], j_rays.fields["intensity"])
    assert t_rays.keys() == j_rays.keys()
    for key in t_rays.keys():
        close(t_rays[key], j_rays[key])
    # a dict of one set's keys builds that set again
    again = RaySet.from_dict({k: t_rays[k] for k in t_rays.keys()}, dtype=F64)
    assert torch.equal(again.p0, t_rays.p0)
    assert torch.equal(again.p1, t_rays.p1)


def test_from_dict_without_wavelength_and_on_tensors(rng):
    d = {k: v for k, v in ray_dict(rng, 2).items() if k != "wavelength"}
    j_rays = JRaySet.from_dict(d, dtype=jnp.float64)
    t_rays = RaySet.from_dict({k: torch.as_tensor(v) for k, v in d.items()},
                              dtype=F64)
    close(t_rays.wavelength, j_rays.wavelength)
    assert t_rays.keys() == j_rays.keys() == [
        "x_start", "y_start", "x_end", "y_end", "wavelength", "rank",
        "intensity"]


def test_snapshot_matches_jax():
    key = jax.random.PRNGKey(0)
    cases = [
        (dict(dimension=2, center=(0.5, -1.0), central_angle=0.3,
              wavelengths=[450.0, 650.0]),
         "StaticUniformAngularDistribution", (-0.4, 0.6, 7)),
        (dict(dimension=3, center=(-3.0, 0.0, 0.0),
              central_angle=(1.0, 0.0, 0.0), wavelengths=[575.0]),
         "StaticUniformSphere", (math.pi / 24, 30)),
    ]
    for case, cls, args in cases:
        j_snap = j_src.PointSource(
            angular_distribution=getattr(j_dist, cls)(*args), **case
        ).snapshot(key, jnp.float64)
        t_snap = t_src.PointSource(
            angular_distribution=getattr(t_dist, cls)(*args), **case
        ).snapshot(dtype=F64)
        assert list(t_snap) == list(j_snap)
        for k in t_snap:
            close(t_snap[k], j_snap[k])
    p0 = np.arange(12.0).reshape(4, 3)
    tag = np.array([3, 1, 4, 1], np.int32)
    j_snap = j_src.ManualSource(3, p0, p0 + 1.5, [600.0], {"tag": tag}
                                ).snapshot(dtype=jnp.float64)
    t_snap = t_src.ManualSource(3, p0, p0 + 1.5, [600.0], {"tag": tag}
                                ).snapshot(dtype=F64)
    assert list(t_snap) == list(j_snap)
    for k in t_snap:
        close(t_snap[k], j_snap[k])


def test_snapshot_of_a_random_source_is_its_sample():
    source = t_src.PointSource(
        3, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0),
        t_dist.RandomLambertianSphere(0.5, 40), wavelengths=[500.0])
    snap = source.snapshot(torch.Generator().manual_seed(3), F64)
    rays = source.sample(torch.Generator().manual_seed(3), F64)
    assert list(snap) == rays.keys()
    for k in snap:
        assert torch.equal(snap[k], rays[k])


def mesh_case(rng):
    """A 4x4 grid of vertices, bent out of its plane, and its 18
    triangles."""
    g = np.stack(np.meshgrid(np.arange(4.0), np.arange(4.0)),
                 -1).reshape(-1, 2)
    vertices = np.column_stack([rng.normal(0, 0.2, 16), g])
    faces = []
    for r in range(3):
        for c in range(3):
            v = 4 * r + c
            faces += [(v, v + 1, v + 5), (v, v + 5, v + 4)]
    return vertices, np.array(faces, np.int32)


def test_from_vertices_faces_matches_jax(rng):
    vertices, faces = mesh_case(rng)
    j_tri = JTriangleSet.from_vertices_faces(jnp.asarray(vertices), faces,
                                             category=2, mat_in=1, mat_out=0,
                                             dtype=jnp.float64)
    t_tri = TriangleSet.from_vertices_faces(torch.as_tensor(vertices), faces,
                                            category=2, mat_in=1, mat_out=0,
                                            dtype=F64)
    assert t_tri.n_surfaces == j_tri.n_surfaces == 18
    for name in ("vp", "v1", "v2", "norm"):
        close(getattr(t_tri, name), getattr(j_tri, name))
    for name in ("category", "mat_in", "mat_out"):
        np.testing.assert_array_equal(getattr(t_tri, name).numpy(),
                                      np.asarray(getattr(j_tri, name)))


def test_from_vertices_faces_gradient_matches_jax(rng):
    """A loss on the corners and the normals: its gradient with respect to
    the shared vertices, by torch.autograd.grad and by jax.grad."""
    vertices, faces = mesh_case(rng)
    w = rng.normal(0, 1, (18, 3))

    def loss(tri, lib):
        return lib.sum(lib.asarray(w) * tri.norm) + lib.sum(tri.v1 ** 2) \
            - lib.sum(tri.vp * tri.v2)

    vt = torch.as_tensor(vertices).requires_grad_(True)
    (g_t,) = torch.autograd.grad(
        loss(TriangleSet.from_vertices_faces(vt, faces, dtype=F64), torch),
        vt)
    g_j = jax.grad(lambda v: loss(JTriangleSet.from_vertices_faces(
        v, faces, dtype=jnp.float64), jnp))(jnp.asarray(vertices))
    close(g_t, g_j)
    # vertices shared by several faces gather the faces' gradients
    assert float(g_t[5].abs().sum()) > 0
