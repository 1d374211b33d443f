"""The goal machinery (``models/goals.py``) against the JAX package's, on the
CPU in float64.

Every class and function of the JAX module, on the cases of the JAX
``tests/test_goals.py`` with their own assertions, and each held against
the JAX function on the same inputs.  The warps, CDFs and matchings are the
same host NumPy on both sides and must agree bit for bit.  The samplers are
fed the JAX draws: the NumPy stream the JAX package seeds from its key
(``_np_rng``), and for ``PrecompiledBasePoints`` the indices and normals
``jax.random`` draws from the split key; their outputs must then agree bit
for bit too.  Also: the port's own generator path (on the device asked for,
reproducible by seed), the pickle files of either package loading in the
other, the ``models.distributions`` re-export, and an image file through
``imageio`` (with ``ImportError`` where it is missing).
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import goals as j_goals
from tensorflowraytrace_tpu.models import sources as j_sources
from tensorflowraytrace_tpu.models.rays import RaySet as JRaySet
from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.models import distributions as t_dist
from tensorflowraytrace_tpu_torch.models import goals as t_goals
from tensorflowraytrace_tpu_torch.models import sources as t_sources
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

PI = math.pi
KEY = jax.random.PRNGKey(11)
F64 = torch.float64


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def jax_uniforms(k, n, key=KEY):
    """The (k, n) uniforms the JAX samplers draw in turn from their key."""
    return j_goals._np_rng(key).random((k, n))


def both_warps(density, limits, n, seed, lo=0.0, hi=1.0):
    """The JAX and the port ArbitraryDistribution applied to the same
    uniform samples, which must agree bit for bit; returns the port's."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(lo, hi, n), rng.uniform(lo, hi, n)
    got = t_goals.ArbitraryDistribution(density, limits)(x, y)
    want = j_goals.ArbitraryDistribution(density, limits)(x, y)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return x, y, got


def test_arbitrary_distribution_uniform_is_identityish():
    """A constant density leaves uniform samples (nearly) alone."""
    x, y, (xo, yo) = both_warps(np.ones((64, 64)), ((0.0, 1.0), (0.0, 1.0)),
                                5000, 0)
    np.testing.assert_allclose(xo, x, atol=1e-6)
    np.testing.assert_allclose(yo, y, atol=1e-6)


def test_arbitrary_distribution_concentrates_mass():
    """A density on the right half puts nearly every sample there."""
    density = np.zeros((32, 32))
    density[:, 16:] = 1.0
    density += 1e-9
    _, _, (xo, yo) = both_warps(density, ((-1.0, 1.0), (-1.0, 1.0)), 4000, 0,
                                -1.0, 1.0)
    assert (xo > -0.01).mean() > 0.999
    assert abs(yo.mean()) < 0.05


def test_arbitrary_distribution_gaussian_shape():
    """Warped uniforms follow a Gaussian density's spread."""
    f = lambda x, y: np.exp(-(x ** 2 + y ** 2) / 0.08)  # noqa: E731
    _, _, (xo, yo) = both_warps(f, ((-1.0, 1.0, 128), (-1.0, 1.0, 128)),
                                40000, 0, -1.0, 1.0)
    assert abs(np.std(xo) - 0.2) < 0.02
    assert abs(np.std(yo) - 0.2) < 0.02


def test_flatten_distribution_inverts_warp():
    """flatten(warp(uniform)) is uniform again, and equals the JAX
    package's flatten."""
    f = lambda x, y: np.exp(-(x ** 2 + 0.5 * y ** 2) / 0.2)  # noqa: E731
    _, _, (xo, yo) = both_warps(f, ((-1.0, 1.0, 64), (-1.0, 1.0, 64)),
                                30000, 1, -1.0, 1.0)
    limits = ((-1, 1, 48), (-1, 1, 48))
    xf, yf = t_goals.flatten_distribution(xo, yo, limits)
    for g, w in zip((xf, yf), j_goals.flatten_distribution(xo, yo, limits)):
        np.testing.assert_array_equal(g, w)
    h, _ = np.histogram(xf, bins=10, range=(0, 1))
    assert h.std() / h.mean() < 0.1


def test_cdf_roundtrip():
    rng = np.random.default_rng(2)
    density = rng.uniform(0.5, 2.0, (16, 16))
    limits = ((-2.0, 2.0), (-1.0, 1.0))
    cdf = t_goals.CumulativeDensityFunction(limits, density)
    ref = j_goals.CumulativeDensityFunction(limits, density)
    pts = rng.uniform(0.05, 0.95, (500, 2))
    mapped = cdf.cdf(pts)
    np.testing.assert_array_equal(mapped, ref.cdf(pts))
    assert mapped[:, 0].min() >= -2.0 and mapped[:, 0].max() <= 2.0
    assert mapped[:, 1].min() >= -1.0 and mapped[:, 1].max() <= 1.0
    back = cdf.icdf(mapped)
    np.testing.assert_array_equal(back, ref.icdf(mapped))
    np.testing.assert_allclose(back, pts, atol=0.02)


def test_cdf_accumulates_and_guards_its_direction():
    """Accumulated batches (cdf_demo's use) equal the JAX CDF's; a CDF
    computed one way refuses the other."""
    rng = np.random.default_rng(3)
    limits = ((-1.0, 1.0), (-1.0, 1.0))
    cdf = t_goals.CumulativeDensityFunction(limits)
    ref = j_goals.CumulativeDensityFunction(limits)
    for _ in range(3):
        h = rng.uniform(0.0, 3.0, (12, 20))
        cdf.accumulate_density(h)
        ref.accumulate_density(h)
    cdf.compute(direction="forward")
    ref.compute(direction="forward")
    pts = rng.uniform(0, 1, (300, 2))
    np.testing.assert_array_equal(cdf(pts), ref(pts))
    with pytest.raises(RuntimeError, match="inverse"):
        cdf.icdf(pts)
    with pytest.raises(ValueError, match="direction"):
        cdf.compute(direction="sideways")
    with pytest.raises(RuntimeError, match="before accumulating"):
        t_goals.CumulativeDensityFunction(limits).compute()


def test_transform_map_hungarian_optimal():
    fixed = np.asarray([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]])
    mutable = np.asarray([[2.1, 0.0], [0.1, 0.0], [1.1, 0.0]])
    out = t_goals.transform_map(fixed, mutable)
    np.testing.assert_allclose(out, [[0.1, 0.0], [1.1, 0.0], [2.1, 0.0]])
    rng = np.random.default_rng(6)
    fixed, mutable = rng.normal(size=(40, 2)), rng.normal(size=(40, 2))
    np.testing.assert_array_equal(t_goals.transform_map(fixed, mutable),
                                  j_goals.transform_map(fixed, mutable))
    with pytest.raises(ValueError, match="same shape"):
        t_goals.transform_map(fixed, mutable[:3])


def test_transform_map_greedy_runs():
    rng = np.random.default_rng(3)
    fixed = rng.normal(size=(20, 2))
    mutable = rng.normal(size=(20, 2))
    out = t_goals.transform_map_greedy(fixed, mutable)
    # a permutation of mutable, the JAX package's
    a = np.asarray(sorted(map(tuple, out)))
    b = np.asarray(sorted(map(tuple, mutable)))
    np.testing.assert_allclose(a, b)
    np.testing.assert_array_equal(
        out, j_goals.transform_map_greedy(fixed, mutable))
    np.testing.assert_array_equal(
        t_goals.transform_map_greedy(fixed, mutable, (0.5, 0.5), False),
        j_goals.transform_map_greedy(fixed, mutable, (0.5, 0.5), False))


def base_points(m, n=2000):
    src_density = lambda x, y: np.exp(-(x ** 2 + y ** 2) / 0.1)  # noqa: E731
    goal_density = lambda x, y: ((np.abs(x) < 0.5)  # noqa: E731
                                 & (np.abs(y) < 0.5)).astype(float) + 1e-9
    return m.ArbitraryBasePoints(
        m.ArbitraryDistribution(src_density, ((-1, 1, 64), (-1, 1, 64))), n,
        rank_distribution=m.ArbitraryDistribution(
            goal_density, ((-1, 1, 64), (-1, 1, 64))))


def test_arbitrary_base_points_with_goal():
    bp = base_points(t_goals)
    ref = base_points(j_goals)
    assert bp.rank_scale_factor == ref.rank_scale_factor
    points, ranks = bp.sample(dtype=F64, uniforms=jax_uniforms(2, 2000))
    assert points.shape == (2000, 2) and ranks.shape == (2000, 2)
    want_points, want_ranks = ref.sample(KEY, dtype=jnp.float64)
    np.testing.assert_array_equal(host(points), np.asarray(want_points))
    np.testing.assert_array_equal(host(ranks), np.asarray(want_ranks))
    # etendue: mean radii match after rescaling
    pr = np.linalg.norm(host(points), axis=1).mean()
    rr = np.linalg.norm(host(ranks), axis=1).mean()
    np.testing.assert_allclose(pr, rr, rtol=0.1)


def test_samplers_draw_from_the_generator():
    """Given a generator, a sampler draws its uniforms from it: the same
    seed gives the same sample, another seed another, on the device asked
    for, in the dtype asked for."""
    bp = base_points(t_goals, 500)

    def draw(seed, dtype=F64):
        return bp.sample(torch.Generator().manual_seed(seed), dtype=dtype,
                         device="cpu")

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert draw(1, torch.float32)[0].dtype == torch.float32
    with pytest.raises(ValueError, match="uniforms"):
        bp.sample(uniforms=np.zeros((2, 3)))


def test_image_base_points_density():
    img = np.zeros((16, 16), dtype=np.uint8)
    img[:, 8:] = 200  # right half bright
    bp = t_goals.ImageBasePoints.from_array(img, x_size=2.0)
    n = int(bp._image.sum())
    points, ranks = bp.sample(dtype=F64, uniforms=jax_uniforms(2, n))
    assert ranks is None
    p = host(points)
    assert p.shape == (n, 2)
    # bright rows are the second image axis: y in this sampler
    assert (p[:, 1] > 0).mean() > 0.95
    want, _ = j_goals.ImageBasePoints.from_array(img, x_size=2.0).sample(
        KEY, dtype=jnp.float64)
    np.testing.assert_array_equal(p, np.asarray(want))


def test_image_base_points_from_a_file(tmp_path, monkeypatch):
    """A file name reads the image with imageio as 32-bit float greyscale
    (what the JAX package's ``as_gray=True`` asked for: that keyword is
    refused by this imageio, so the JAX file path is held through
    ``from_array`` of the same grey levels); without imageio it raises
    ImportError, and arrays need no import."""
    import imageio.v2 as imageio

    img = np.full((8, 12), 5, dtype=np.uint8)
    img[2:6, 3:9] = 120
    img[4, 5] = 250
    path = str(tmp_path / "goal.png")
    imageio.imwrite(path, img)
    bp = t_goals.ImageBasePoints(path, x_size=1.0, y_size=2.0)
    ref = j_goals.ImageBasePoints.from_array(img.astype(np.float32),
                                             x_size=1.0, y_size=2.0)
    np.testing.assert_array_equal(bp._image, ref._image)
    got, _ = bp.sample(dtype=F64, uniforms=jax_uniforms(
        2, int(bp._image.sum())))
    np.testing.assert_array_equal(host(got),
                                  np.asarray(ref.sample(KEY, jnp.float64)[0]))
    dist = t_goals.ArbitraryDistribution(path, ((-1, 1), (-1, 1)))
    np.testing.assert_array_equal(
        dist.density_function,
        j_goals.ArbitraryDistribution(img.astype(np.float64),
                                      ((-1, 1), (-1, 1))).density_function)

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError):
        t_goals.ImageBasePoints(path, x_size=1.0)
    with pytest.raises(ImportError):
        t_goals.ArbitraryDistribution(path, ((-1, 1), (-1, 1)))
    t_goals.ImageBasePoints.from_array(img, x_size=1.0)


def jax_precompiled_draws(key, count, n, shape):
    """The indices and normals the JAX PrecompiledBasePoints draws."""
    k_idx, k_pert = jax.random.split(key)
    idx = jax.random.randint(k_idx, (count,), 0, n)
    noise = jax.random.normal(k_pert, shape, dtype=jnp.float64)
    return {"index": np.asarray(idx), "noise": np.asarray(noise)}


def test_precompiled_base_points_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(500, 2))
    ranks = rng.normal(size=(500, 2))
    bp = t_goals.PrecompiledBasePoints()
    bp.full_points = pts
    bp.full_ranks = ranks
    path = str(tmp_path / "points.pkl")
    bp.save(path)

    loaded = t_goals.PrecompiledBasePoints(path, sample_count=64,
                                           perturbation=(0.01, 0.0))
    ref = j_goals.PrecompiledBasePoints(path, sample_count=64,
                                        perturbation=(0.01, 0.0))
    draws = jax_precompiled_draws(KEY, 64, 500, (64, 2))
    sample, sranks = loaded.sample(dtype=F64, uniforms=draws)
    assert sample.shape == (64, 2) and sranks.shape == (64, 2)
    # y coordinates are unperturbed: every sampled y is in the cache
    assert np.isin(np.round(host(sample)[:, 1], 12),
                   np.round(pts[:, 1], 12)).all()
    want, want_ranks = ref.sample(KEY, dtype=jnp.float64)
    np.testing.assert_array_equal(host(sample), np.asarray(want))
    np.testing.assert_array_equal(host(sranks), np.asarray(want_ranks))

    # the JAX package's file loads in the port and the other way round
    j_path = str(tmp_path / "jax_points.pkl")
    ref.save(j_path)
    np.testing.assert_array_equal(
        t_goals.PrecompiledBasePoints(j_path).full_points, pts)
    np.testing.assert_array_equal(
        j_goals.PrecompiledBasePoints(path).full_ranks, ranks)

    # on the device, from a generator: indices into the cache, noise on x
    s1, r1 = loaded.sample(torch.Generator().manual_seed(3), dtype=F64,
                           device="cpu")
    s2, _ = loaded.sample(torch.Generator().manual_seed(3), dtype=F64,
                          device="cpu")
    assert torch.equal(s1, s2)
    assert np.isin(np.round(host(s1)[:, 1], 12), np.round(pts[:, 1], 12)).all()
    with pytest.raises(ValueError, match="no points"):
        t_goals.PrecompiledBasePoints().sample()


def test_precompiled_base_points_from_a_distribution():
    """Built from a distribution, the cache is that distribution's sample
    from a generator seeded 0."""
    bp = base_points(t_goals, 300)
    cache = t_goals.PrecompiledBasePoints(bp, sample_count=10)
    want = bp.sample(torch.Generator().manual_seed(0), dtype=torch.float32)
    np.testing.assert_array_equal(cache.full_points, host(want[0]))
    np.testing.assert_array_equal(cache.full_ranks, host(want[1]))


def test_square_rank_lambertian_sphere():
    d = t_goals.SquareRankLambertianSphere(5000, angular_cutoff=PI / 2)
    u = j_goals._np_rng(KEY).random((5000, 2))
    points, ranks = d.sample(dtype=F64, uniforms=u.T)
    p = host(points)
    np.testing.assert_allclose(np.linalg.norm(p, axis=1), 1.0, atol=1e-9)
    assert ranks.shape == (5000, 2)
    # Lambertian: the projection along the pole is a uniform disk
    r = np.linalg.norm(p[:, 1:], axis=1)
    np.testing.assert_allclose(r.mean(), 2 / 3, rtol=0.05)
    want_p, want_r = j_goals.SquareRankLambertianSphere(
        5000, angular_cutoff=PI / 2).sample(KEY, dtype=jnp.float64)
    np.testing.assert_array_equal(p, np.asarray(want_p))
    np.testing.assert_array_equal(host(ranks), np.asarray(want_r))
    with pytest.raises(ValueError, match="angular_cutoff"):
        t_goals.SquareRankLambertianSphere(10, angular_cutoff=2.0)


def test_precompiled_source_roundtrip(tmp_path):
    """A ray cache pickled by the JAX PrecompiledSource loads in the port's
    and resamples from it, its fields riding along."""
    rng = np.random.default_rng(5)
    rays = JRaySet.make(rng.normal(size=(200, 3)), rng.normal(size=(200, 3)),
                        wavelength=rng.uniform(400, 700, 200),
                        fields={"rank": jnp.asarray(rng.normal(size=(200, 2)))},
                        dtype=jnp.float64)
    path = str(tmp_path / "source.pkl")
    j_sources.PrecompiledSource(3, rays, sample_count=32,
                                start_perturbation=0.01).save(path)
    loaded = t_sources.PrecompiledSource(3, path, sample_count=32)
    out = loaded.sample(torch.Generator().manual_seed(0), dtype=F64,
                        device="cpu")
    assert out.n_rays == 32
    assert "rank" in out.fields
    # downsampled wavelengths all come from the cache
    assert np.isin(np.round(host(out.wavelength), 10),
                   np.round(np.asarray(rays.wavelength), 10)).all()


def test_distributions_reexport_the_goals():
    """models.distributions re-exports the goal classes, as the JAX
    module does."""
    for name in ("ArbitraryDistribution", "ArbitraryBasePoints",
                 "ImageBasePoints", "PrecompiledBasePoints",
                 "SquareRankLambertianSphere", "CumulativeDensityFunction",
                 "flatten_distribution", "transform_map"):
        assert getattr(t_dist, name) is getattr(t_goals, name)
    with pytest.raises(AttributeError):
        t_dist.NoSuchDistribution
