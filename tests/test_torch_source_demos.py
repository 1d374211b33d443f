"""``source_demos.py`` against examples/source_rotation_roll.py,
cdf_demo.py and source_gallery.py on the CPU.

* The roll test: the example's ``measure_roll`` and ``no_roll_quaternion``
  (its sources sampled in float64) against the port's at every aim,
  within rtol 1e-9 (atol 1e-9 degrees on the zero rolls); the port's
  checks pass in float64 and in float32.
* The CDF demo, NumPy on both sides: the example's steps through the JAX
  package's ``goals`` against the port's function, within rtol 1e-9, and
  its printed numbers.
* The gallery: every panel's samples against the JAX samplers with the
  example's ``PRNGKey(0)`` in float64 (the two random samplers handed the
  draws JAX makes from it), within rtol 1e-9; the printed numbers; the
  figure written at its size.
"""

import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")

import matplotlib.image as mpimg  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tensorflowraytrace_tpu import config as j_config  # noqa: E402
from tensorflowraytrace_tpu.models import distributions as j_dist  # noqa: E402
from tensorflowraytrace_tpu.models import goals as j_goals  # noqa: E402
from tensorflowraytrace_tpu.models import sources as j_src  # noqa: E402
from tensorflowraytrace_tpu_torch import config, source_demos  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (a fixture)

F64 = torch.float64
J64 = jnp.float64
PI = math.pi
RTOL = 1e-9
KEY = jax.random.PRNGKey(0)
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.fixture(autouse=True)
def on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def close(t, j, rtol=RTOL, atol=1e-14):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def test_source_rotation_roll_matches_jax(monkeypatch):
    ex = load("source_rotation_roll")
    # the example samples in the JAX package's default dtype: float64 here
    monkeypatch.setattr(j_config, "DEFAULT_DTYPE", J64)
    out = source_demos.source_rotation_roll(dtype=F64, device="cpu",
                                            verbose=False)
    assert [r[0] for r in out["rolls"]] == list(source_demos.ROLL_AIMS)
    for aim, r_vec, r_quat in out["rolls"]:
        q = ex.no_roll_quaternion(aim)
        close(source_demos.no_roll_quaternion(aim, F64), q)
        close(r_vec, ex.measure_roll(aim, "vector"), atol=1e-9)
        close(r_quat, ex.measure_roll(aim, "quaternion", rotation=q),
              atol=1e-9)
    assert out["worst_quaternion"] < 1e-5 and out["worst_vector"] > 1.0
    out32 = source_demos.source_rotation_roll(device="cpu", verbose=False)
    assert out32["worst_quaternion"] < 1e-5
    close(out32["worst_vector"], out["worst_vector"], rtol=1e-5)


def test_cdf_demo_matches_jax(capsys):
    out = source_demos.cdf_demo(verbose=False)
    # the example's steps, through the JAX package's goals
    rng = np.random.default_rng(0)
    cdf = j_goals.CumulativeDensityFunction(((-1.0, 1.0), (-1.0, 1.0)))
    for _ in range(5):
        pts = rng.normal(0, 0.35, (20000, 2)).clip(-0.999, 0.999)
        h, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=32,
                                 range=((-1, 1), (-1, 1)))
        cdf.accumulate_density(h.T)
    cdf.compute()
    close(out["mapped"], cdf.cdf(rng.uniform(0, 1, (30000, 2))))
    gauss = rng.normal(0, 0.35, (30000, 2)).clip(-0.999, 0.999)
    close(out["flat"], cdf.icdf(gauss))
    close(out["flattened"], np.stack(j_goals.flatten_distribution(
        gauss[:, 0], gauss[:, 1], ((-1, 1, 48), (-1, 1, 48))), 1))
    load("cdf_demo").main()
    printed = capsys.readouterr().out
    assert str(out["mapped_std"].round(3)) in printed
    assert f"cv = {out['icdf_cv']:.3f}" in printed
    assert f"cv = {out['flatten_cv']:.3f}" in printed


def split_rows(key, n):
    """The draws of a sampler that splits its key in two."""
    return np.stack([np.asarray(jax.random.uniform(k, (n,), J64))
                     for k in jax.random.split(key)])


def test_source_gallery_matches_jax(tmp_path):
    draws = {"square": split_rows(KEY, 625),
             "square_rank": j_goals._np_rng(KEY).random((600, 2)).T}
    png = tmp_path / "gallery.png"
    out = source_demos.source_gallery(png=png, uniforms=draws, dtype=F64,
                                      device="cpu", verbose=False)
    panels = out["panels"]
    close(panels["circle"], j_dist.StaticUniformCircle(600).sample(KEY, J64)[0])
    close(panels["square"],
          j_dist.RandomUniformSquare(1.0, 25).sample(KEY, J64)[0])
    close(panels["lambertian"], j_dist.StaticLambertianSphere(
        PI / 3, 600).sample(KEY, J64)[0])
    j_pts, j_ranks = j_goals.SquareRankLambertianSphere(600).sample(KEY, J64)
    close(panels["square_rank"][0], j_pts)
    close(panels["square_rank"][1], j_ranks)
    ring = j_goals.ArbitraryDistribution(
        lambda x, y: np.exp(-((np.hypot(x, y) - 0.6) ** 2) / 0.01) + 1e-6,
        ((-1, 1, 96), (-1, 1, 96)))
    rng = np.random.default_rng(0)
    close(panels["ring"], np.stack(ring(rng.uniform(-1, 1, 3000),
                                        rng.uniform(-1, 1, 3000)), 1))
    j_pts, j_ranks = j_dist.StaticUniformBeam(-1.0, 1.0, 30).sample(KEY, J64)
    close(panels["beam"][0], j_pts)
    close(panels["beam"][1], j_ranks)

    sources = {
        "point_2d": j_src.PointSource(
            2, (0.0, 0.0), PI / 2,
            j_dist.StaticUniformAngularDistribution(-0.6, 0.6, 30), [500.0]),
        "angular_2d": j_src.AngularSource(
            2, (0.0, 0.0), 0.0,
            j_dist.StaticUniformAngularDistribution(-0.3, 0.3, 5),
            j_dist.StaticUniformBeam(-0.5, 0.5, 7), [680.0, 510.0, 400.0]),
        "point_3d": j_src.PointSource(
            3, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
            j_dist.StaticUniformSphere(PI / 8, 80), [575.0]),
        "aperture": j_src.AperatureSource(
            2, j_dist.StaticUniformAperaturePoints((0.0, -1.0), (0.0, 1.0),
                                                   12),
            j_dist.StaticUniformAperaturePoints((1.0, -0.4), (1.0, 0.4), 12),
            [575.0] * 12, dense=False),
        "aimed_3d": j_src.PointSource(
            3, (0.0, 0.0, 0.0), (1.0, 1.0, 0.0),
            j_dist.StaticUniformSphere(PI / 10, 60), [575.0]),
    }
    for name, s in sources.items():
        rays = s.sample(KEY, J64)
        for got, want in zip(panels[name], (rays.p0, rays.p1,
                                            rays.wavelength)):
            close(got, want)
    assert out["angular_rays"] == 105
    pts, _ = j_dist.StaticUniformCircle(20000).sample(KEY, J64)
    h, edges = np.histogram(np.linalg.norm(np.asarray(pts), axis=1), bins=30,
                            range=(0, 1))
    density = h / (PI * (edges[1:] ** 2 - edges[:-1] ** 2))
    close(out["uniformity"], np.std(density) / np.mean(density))
    d3 = np.asarray(sources["aimed_3d"].sample(KEY, J64).p1
                    - sources["aimed_3d"].sample(KEY, J64).p0).mean(axis=0)
    close(out["mean_direction"], d3 / np.linalg.norm(d3))
    # the example's 18 x 14 inch figure at 90 dpi
    assert mpimg.imread(png).shape[:2] == (1260, 1620)


def test_source_gallery_draws_its_own():
    """Without JAX's draws the random panels come from a seeded generator:
    the same seed gives the same samples, in float32 by default."""
    a, b = (source_demos.source_gallery(
        generator=torch.Generator().manual_seed(1), device="cpu",
        verbose=False)["panels"] for _ in range(2))
    assert a["square"].dtype == np.float32 and a["square"].shape == (625, 2)
    np.testing.assert_array_equal(a["square"], b["square"])
    np.testing.assert_array_equal(a["square_rank"][0], b["square_rank"][0])
