"""Parity of the port's distributions, sources, ``concat_rays`` and
``quat_from_axis_angle`` with the JAX package's, on the CPU in float64.

``jax.random`` streams cannot be reproduced in PyTorch, so every random
sampler of the port is fed, as ``uniforms``, the very draws the JAX sampler
makes from its key (the same key splits, the same ``jax.random`` calls);
both must then give the same values.  Tolerance: rtol 1e-12 (atol 1e-14)
on every float (acos, sqrt, cos and sin may differ in the last bit between
XLA and PyTorch); ray states exact.  The circle's ``polar_ranks`` are held
to the points of the same draw, and ``PrecompiledSource`` files cross
between the packages both ways.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import concat_rays as j_concat_rays
from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import mesh as j_mesh
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.models.rays import RaySet as JRaySet
from tensorflowraytrace_tpu.utils import quaternion as j_quat
from tensorflowraytrace_tpu_torch import RaySet, concat_rays, config, hexalens
from tensorflowraytrace_tpu_torch.models import distributions as t_dist
from tensorflowraytrace_tpu_torch.models import mesh as t_mesh
from tensorflowraytrace_tpu_torch.models import sources as t_src
from tensorflowraytrace_tpu_torch.utils import quaternion as t_quat
from tensorflowraytrace_tpu_torch.utils.convert import precompiled_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

PI = math.pi
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


def uniform(key, n):
    return np.array(jax.random.uniform(key, (n,), jnp.float64))


def split_rows(key, n):
    """The two rows a sampler that splits its key in two draws."""
    return np.stack([uniform(k, n) for k in jax.random.split(key)])


def one_row(key, n):
    return uniform(key, n)[None]


def no_draws(key, n):
    return None


# (name, JAX sampler, port sampler, the draws JAX makes from a key)
SAMPLERS = [
    ("manual_angles", j_dist.ManualAngularDistribution([0.1, -0.4, 0.7], [1, 2, 3]),
     t_dist.ManualAngularDistribution([0.1, -0.4, 0.7], [1, 2, 3]), no_draws),
    ("static_uniform_angles", j_dist.StaticUniformAngularDistribution(-0.3, 0.9, 13),
     t_dist.StaticUniformAngularDistribution(-0.3, 0.9, 13), no_draws),
    ("static_lambertian_angles", j_dist.StaticLambertianAngularDistribution(-0.5, 1.2, 17),
     t_dist.StaticLambertianAngularDistribution(-0.5, 1.2, 17), no_draws),
    ("random_lambertian_angles", j_dist.RandomLambertianAngularDistribution(-0.5, 1.2, 17),
     t_dist.RandomLambertianAngularDistribution(-0.5, 1.2, 17), one_row),
    ("manual_points", j_dist.ManualBasePointDistribution(
        2, [[0.0, 1.0], [2.0, -1.0]], [0.5, 0.25]),
     t_dist.ManualBasePointDistribution(2, [[0.0, 1.0], [2.0, -1.0]], [0.5, 0.25]),
     no_draws),
    ("manual_points_empty", j_dist.ManualBasePointDistribution(3),
     t_dist.ManualBasePointDistribution(3), no_draws),
    ("mesh_points", j_dist.ManualBasePointDistribution(
        3, from_mesh=j_mesh.hexagonal_mesh(1.0, 2)),
     t_dist.ManualBasePointDistribution(3, from_mesh=t_mesh.hexagonal_mesh(1.0, 2)),
     no_draws),
    ("static_aperture", j_dist.StaticUniformAperaturePoints((0.0, -1.0), (0.5, 2.0), 11),
     t_dist.StaticUniformAperaturePoints((0.0, -1.0), (0.5, 2.0), 11), no_draws),
    ("random_aperture", j_dist.RandomUniformAperaturePoints((0.0, -1.0), (0.5, 2.0), 11),
     t_dist.RandomUniformAperaturePoints((0.0, -1.0), (0.5, 2.0), 11), one_row),
    ("static_square", j_dist.StaticUniformSquare(0.3, 4, 0.5, 3),
     t_dist.StaticUniformSquare(0.3, 4, 0.5, 3), no_draws),
    ("static_circle", j_dist.StaticUniformCircle(50, 2.0),
     t_dist.StaticUniformCircle(50, 2.0), no_draws),
    ("static_circle_window", j_dist.StaticUniformCircle(50, 1.0, 0.3, 1.2),
     t_dist.StaticUniformCircle(50, 1.0, 0.3, 1.2), no_draws),
    ("random_circle", j_dist.RandomUniformCircle(40, 0.98, 0.0, PI / 6),
     t_dist.RandomUniformCircle(40, 0.98, 0.0, PI / 6), split_rows),
    ("static_sphere", j_dist.StaticUniformSphere(PI / 24, 30),
     t_dist.StaticUniformSphere(PI / 24, 30), no_draws),
    ("static_sphere_window", j_dist.StaticUniformSphere(0.4, 30, 2.0, 1.0, 2.5),
     t_dist.StaticUniformSphere(0.4, 30, 2.0, 1.0, 2.5), no_draws),
    ("static_lambertian_sphere", j_dist.StaticLambertianSphere(0.5, 30),
     t_dist.StaticLambertianSphere(0.5, 30), no_draws),
    ("random_lambertian_sphere", j_dist.RandomLambertianSphere(0.5, 30, 1.0, 0.5, 2.0),
     t_dist.RandomLambertianSphere(0.5, 30, 1.0, 0.5, 2.0), split_rows),
    ("lift_scale_quaternion_translate", j_dist.BasePointTransformation(
        j_dist.RandomUniformCircle(20, 0.5), scale=(1.0, 2.0, 0.5),
        rotation=(0.9, 0.1, -0.3, 0.2), translation=(1.0, -2.0, 3.0),
        lift_to_3d=True),
     t_dist.BasePointTransformation(
         t_dist.RandomUniformCircle(20, 0.5), scale=(1.0, 2.0, 0.5),
         rotation=(0.9, 0.1, -0.3, 0.2), translation=(1.0, -2.0, 3.0),
         lift_to_3d=True), split_rows),
    ("rotate_2d", j_dist.BasePointTransformation(
        j_dist.StaticUniformSquare(0.3, 3), scale=2.0, rotation=0.7,
        translation=(0.5, 0.25)),
     t_dist.BasePointTransformation(
         t_dist.StaticUniformSquare(0.3, 3), scale=2.0, rotation=0.7,
         translation=(0.5, 0.25)), no_draws),
]


@pytest.mark.parametrize("name,j_d,t_d,draws", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_sampler_matches_jax(name, j_d, t_d, draws):
    key = jax.random.PRNGKey(5)
    inner = getattr(t_d, "distribution", t_d)
    n = getattr(inner, "sample_count", 0)
    j_vals, j_ranks = j_d.sample(key, jnp.float64)
    t_vals, t_ranks = t_d.sample(dtype=F64, uniforms=draws(key, n))
    assert t_vals.dtype == F64 and t_vals.shape == j_vals.shape
    close(t_vals, j_vals)
    if j_ranks is None:
        assert t_ranks is None
    else:
        close(t_ranks, j_ranks)
    assert t_d.is_random == j_d.is_random


def test_update_caches_what_the_properties_read():
    d = t_dist.RandomUniformCircle(64, 2.0)
    points, ranks = d.update(torch.Generator().manual_seed(3), F64)
    assert d.points is points and d.ranks is ranks
    angles = t_dist.StaticLambertianAngularDistribution(-0.2, 0.4, 5)
    close(angles.angles, torch.arcsin(angles.ranks))
    # a sampler never updated samples once on the first read
    fresh = t_dist.StaticUniformSquare(0.3, 4)
    assert fresh.points.shape == (16, 2) and fresh.points is fresh.points


def test_polar_ranks_come_from_the_drawn_points():
    d = t_dist.RandomUniformCircle(300, 0.7, 0.2, 1.1)
    points, ranks = d.sample(torch.Generator().manual_seed(1), F64)
    polar = d.polar_ranks
    close(polar[:, 0] * torch.cos(polar[:, 1]) * 0.7, points[:, 0])
    close(polar[:, 0] * torch.sin(polar[:, 1]) * 0.7, points[:, 1])
    close(d.polar_points[:, 0], 0.7 * polar[:, 0])
    # reading them again draws nothing
    close(d.polar_ranks, polar)
    assert bool((polar[:, 1] >= 0.2).all() and (polar[:, 1] < 1.1).all())
    # and JAX's, from JAX's draw, equal the port's from the same uniforms
    key = jax.random.PRNGKey(9)
    j_d = j_dist.RandomUniformCircle(300, 0.7, 0.2, 1.1)
    j_d.sample(key, jnp.float64)
    d.sample(dtype=F64, uniforms=split_rows(key, 300))
    close(d.polar_ranks, j_d.polar_ranks)
    close(d.polar_points, j_d.polar_points)


def test_static_circle_window_wraps_theta():
    d = t_dist.StaticUniformCircle(200, 1.0, 0.3, 1.2)
    d.sample(dtype=F64)
    theta = d.polar_ranks[:, 1]
    assert bool((theta >= 0.3 - 1e-12).all() and (theta <= 1.2 + 1e-12).all())


def test_hexalens_source_matches_jax_and_carries_its_own_draw():
    """examples/hexalens.py's source: the end points' polar ranks ride as a
    field of the very rays they made, in both packages."""
    n = 64
    key = jax.random.PRNGKey(2)
    start = j_dist.RandomUniformCircle(n, 0.2)
    end = j_dist.RandomUniformCircle(n, 0.98, theta_start=0.0, theta_end=PI / 6)
    j_source = j_src.AperatureSource(
        3, j_dist.BasePointTransformation(start, translation=(-10.0, 0.0, 0.0),
                                          lift_to_3d=True),
        j_dist.BasePointTransformation(end, lift_to_3d=True), [575.0] * n,
        dense=False, rank_domain="start_point",
        extra_fields={"aperature_polar_ranks": ("end_point", end, "polar_ranks")})
    j_rays = j_source.sample(key, jnp.float64)
    ks, ke = jax.random.split(key)
    t_rays = hexalens.make_source(n).sample(
        dtype=F64, uniforms={"start_point": split_rows(ks, n),
                             "end_point": split_rows(ke, n)})
    for name in ("p0", "p1", "wavelength"):
        close(getattr(t_rays, name), getattr(j_rays, name))
    for name in ("rank", "aperature_polar_ranks"):
        close(t_rays.fields[name], j_rays.fields[name])
    np.testing.assert_array_equal(t_rays.state.numpy(), np.asarray(j_rays.state))

    # a generator's draw: the field is the polar form of the end points
    g_rays = hexalens.make_source(n).sample(torch.Generator().manual_seed(4), F64)
    yz = g_rays.p1[:, 1:]
    polar = g_rays.fields["aperature_polar_ranks"]
    close(polar[:, 0] * 0.98, torch.linalg.vector_norm(yz, dim=1))
    close(torch.remainder(torch.atan2(yz[:, 1], yz[:, 0]), 2 * PI), polar[:, 1],
          atol=1e-12)


def test_point_sources_match_jax():
    key = jax.random.PRNGKey(0)
    cases = [
        dict(dimension=2, center=(0.5, -1.0), central_angle=0.3,
             dist=("StaticUniformAngularDistribution", (-0.4, 0.6, 7)),
             wavelengths=[450.0, 650.0]),
        dict(dimension=2, center=(0.0, 0.0), central_angle=-0.2,
             dist=("RandomLambertianAngularDistribution", (-0.4, 0.6, 7)),
             wavelengths=[500.0], start_on_center=False, ray_length=2.0),
        dict(dimension=3, center=(-3.0, 0.0, 0.0), central_angle=(1.0, 0.0, 0.0),
             dist=("StaticUniformSphere", (PI / 24, 30)), wavelengths=[575.0]),
        dict(dimension=3, center=(1.0, 2.0, 3.0), central_angle=(0.2, 1.0, -0.4),
             dist=("RandomLambertianSphere", (0.5, 12)), wavelengths=[450.0, 575.0]),
    ]
    for case in cases:
        cls, args = case.pop("dist")
        j_d, t_d = getattr(j_dist, cls)(*args), getattr(t_dist, cls)(*args)
        j_rays = j_src.PointSource(angular_distribution=j_d, **case).sample(
            key, jnp.float64)
        n = args[-1]
        draws = (one_row if case["dimension"] == 2 else split_rows)(key, n)
        t_rays = t_src.PointSource(angular_distribution=t_d, **case).sample(
            dtype=F64, uniforms={"angle": draws if t_d.is_random else None})
        for name in ("p0", "p1", "wavelength"):
            close(getattr(t_rays, name), getattr(j_rays, name))
        close(t_rays.fields["rank"], j_rays.fields["rank"])


def test_aperture_sources_match_jax():
    """2D dense (every start to every end) and 2D 1:1 with a random end."""
    key = jax.random.PRNGKey(6)
    for dense, j_end, t_end in (
            (True, j_dist.StaticUniformAperaturePoints((1.0, -0.5), (1.0, 0.5), 4),
             t_dist.StaticUniformAperaturePoints((1.0, -0.5), (1.0, 0.5), 4)),
            (False, j_dist.RandomUniformAperaturePoints((1.0, -0.5), (1.0, 0.5), 5),
             t_dist.RandomUniformAperaturePoints((1.0, -0.5), (1.0, 0.5), 5))):
        n_start = 3 if dense else 5
        j_start = j_dist.StaticUniformAperaturePoints((0.0, -0.2), (0.0, 0.2), n_start)
        t_start = t_dist.StaticUniformAperaturePoints((0.0, -0.2), (0.0, 0.2), n_start)
        j_rays = j_src.AperatureSource(2, j_start, j_end, [500.0], dense=dense,
                                       rank_domain="end_point").sample(key, jnp.float64)
        _, ke = jax.random.split(key)
        uniforms = {"end_point": one_row(ke, 5)} if not dense else {}
        t_rays = t_src.AperatureSource(2, t_start, t_end, [500.0], dense=dense,
                                       rank_domain="end_point").sample(
            dtype=F64, uniforms=uniforms)
        assert t_rays.n_rays == (12 if dense else 5)
        close(t_rays.p0, j_rays.p0)
        close(t_rays.p1, j_rays.p1)
        close(t_rays.fields["rank"], j_rays.fields["rank"])


def test_manual_source_matches_jax():
    p0 = np.arange(12.0).reshape(4, 3)
    p1 = p0 + 1.5
    tag = np.array([3, 1, 4, 1], np.int32)
    j_rays = j_src.ManualSource(3, p0, p1, [600.0], {"tag": tag}).sample(
        dtype=jnp.float64)
    t_rays = t_src.ManualSource(3, p0, p1, [600.0], {"tag": tag}).sample(dtype=F64)
    close(t_rays.p0, j_rays.p0)
    close(t_rays.p1, j_rays.p1)
    close(t_rays.wavelength, j_rays.wavelength)
    np.testing.assert_array_equal(t_rays.fields["tag"].numpy(), tag)


def test_concat_rays_keeps_common_fields():
    rng = np.random.default_rng(0)
    sets = []
    for n, fields in ((3, ("a", "b")), (5, ("a", "c")), (0, ("a",))):
        p0, p1 = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
        f = {k: rng.normal(size=n) for k in fields}
        sets.append((p0, p1, rng.normal(size=n), f))
    j = j_concat_rays([None] + [JRaySet.make(p0, p1, wl, fields=f, dtype=jnp.float64)
                                for p0, p1, wl, f in sets])
    t = concat_rays([None] + [RaySet.make(p0, p1, wl, fields=f, dtype=F64)
                              for p0, p1, wl, f in sets])
    assert set(t.fields) == set(j.fields) == {"a"}
    for name in ("p0", "p1", "wavelength"):
        close(getattr(t, name), getattr(j, name))
    close(t.fields["a"], j.fields["a"])
    np.testing.assert_array_equal(t.state.numpy(), np.asarray(j.state))
    with pytest.raises(ValueError):
        concat_rays([None])


def precompiled_rays(rng, n=30):
    p0, p1 = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    fields = {"rank": rng.normal(size=(n, 2)), "id": np.arange(n, dtype=np.int32)}
    return p0, p1, rng.uniform(400, 700, n), fields


def test_precompiled_source_crosses_packages(tmp_path, rng):
    """A file saved by either package loads in the other; sampling with the
    JAX key's indices and normals gives JAX's rays."""
    p0, p1, wl, fields = precompiled_rays(rng)
    opts = dict(sample_count=17, start_perturbation=(0.1, 0.0, 0.2),
                end_perturbation=0.05)
    j_source = j_src.PrecompiledSource(
        3, JRaySet.make(p0, p1, wl, fields=fields, dtype=jnp.float64), **opts)
    j_file = str(tmp_path / "jax.pkl")
    j_source.save(j_file)
    t_source = t_src.PrecompiledSource(3, j_file, **opts)

    key = jax.random.PRNGKey(8)
    k_idx, k_s, k_e = jax.random.split(key, 3)
    idx = np.asarray(jax.random.randint(k_idx, (17,), 0, 30))
    draws = {"index": idx,
             "start": np.asarray(jax.random.normal(k_s, (17, 3), jnp.float64)),
             "end": np.asarray(jax.random.normal(k_e, (17, 3), jnp.float64))}
    j_rays = j_source.sample(key, jnp.float64)
    for source in (t_source, precompiled_from_numpy(j_source._data, **opts)):
        t_rays = source.sample(dtype=F64, uniforms=draws)
        for name in ("p0", "p1", "wavelength"):
            close(getattr(t_rays, name), getattr(j_rays, name))
        close(t_rays.fields["rank"], j_rays.fields["rank"])
        np.testing.assert_array_equal(t_rays.fields["id"].numpy(), idx)

    # the port's file, read by JAX: the same cache, so the same rays
    t_file = str(tmp_path / "port.pkl")
    t_src.PrecompiledSource(
        3, RaySet.make(p0, p1, wl, fields=fields, dtype=F64)).save(t_file)
    j_back = j_src.PrecompiledSource(3, t_file, **opts)
    np.testing.assert_array_equal(j_back._data["p0"], p0)
    np.testing.assert_array_equal(j_back._data["fields"]["id"], fields["id"])
    close(t_src.PrecompiledSource(3, t_file, **opts).sample(
        dtype=F64, uniforms=draws).p1, j_back.sample(key, jnp.float64).p1)


def test_precompiled_source_draws_from_a_generator(rng):
    p0, p1, wl, fields = precompiled_rays(rng)
    source = t_src.PrecompiledSource(
        3, RaySet.make(p0, p1, wl, fields=fields, dtype=F64), sample_count=40,
        start_perturbation=0.01)
    rays = source.sample(torch.Generator().manual_seed(0), F64)
    assert rays.n_rays == 40 and rays.fields["id"].max() < 30
    picked = rays.fields["id"].long()
    close(rays.p1, p1[picked.numpy()])
    assert 0 < float((rays.p0 - torch.as_tensor(p0)[picked]).abs().max()) < 0.1
    # another source is sampled once, in its default dtype (float32)
    whole = t_src.PrecompiledSource(3, t_src.ManualSource(3, p0, p1, wl),
                                    do_downsample=False).sample(dtype=F64)
    close(whole.p0, p0.astype(np.float32))


def test_quat_from_axis_angle_matches_jax():
    axes = np.array([[1.0, 2.0, -0.5], [0.0, 0.0, 3.0]])
    angles = np.array([0.7, -2.1])
    close(t_quat.quat_from_axis_angle(torch.as_tensor(axes), angles),
          j_quat.quat_from_axis_angle(axes, angles))
    q = t_quat.quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0], dtype=F64),
                                    PI / 2)
    close(t_quat.rotate_vector(q, torch.tensor([1.0, 0.0, 0.0], dtype=F64)),
          [0.0, 1.0, 0.0])
