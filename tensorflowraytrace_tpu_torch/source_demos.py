"""The source and distribution demos: ``examples/source_rotation_roll.py``,
``cdf_demo.py`` and ``source_gallery.py``.

They sample sources and distributions or run on the host; none traces, so
none launches a kernel.  Each function is the example's ``main`` at its
defaults, raises where one of the example's checks fails, and returns the
numbers the example prints.  The JAX examples draw from
``jax.random.PRNGKey(0)``: here a random sampler draws from a
``torch.Generator`` (seeded 0 unless one is given), or takes the
``uniforms`` it is handed, as the parity tests hand it JAX's draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tensorflowraytrace_tpu_torch import drawing
from tensorflowraytrace_tpu_torch.config import resolve_device
from tensorflowraytrace_tpu_torch.models import distributions as dist
from tensorflowraytrace_tpu_torch.models import goals
from tensorflowraytrace_tpu_torch.models import sources as src
from tensorflowraytrace_tpu_torch.utils import quaternion as quat

PI = math.pi

# ----------------------------------------------------------------------
# examples/source_rotation_roll.py
# ----------------------------------------------------------------------

ROLL_AIMS = ((20.0, 10.0, 0.0), (20.0, 0.0, 10.0), (20.0, 10.0, 10.0),
             (20.0, 10.0, 20.0), (5.0, 10.0, 20.0))


def measure_roll(aim, angle_type="vector", rotation=None, dtype=torch.float32,
                 device=None):
    """The signed roll (degrees) about ``aim`` of a 3-point probe source's
    mapped first grid axis against the horizontal h = z x aim, the source
    aimed by ``aim`` (``"vector"``) or by the quaternion ``rotation``."""
    probe = dist.ManualBasePointDistribution(
        2, points=[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    angles = dist.ManualAngularDistribution([[1.0, 0.0, 0.0]] * 3)
    central = rotation if rotation is not None else tuple(aim)
    source = src.AngularSource(
        3, (0.0, 0.0, 0.0), central, angles, probe, [575.0] * 3,
        angle_type=angle_type, dense=False)
    p = source.sample(dtype=dtype, device=device).p0.cpu().numpy()
    u_img = p[1] - p[0]
    aim = np.asarray(aim) / np.linalg.norm(aim)
    h = np.cross((0.0, 0.0, 1.0), aim)
    h /= np.linalg.norm(h)
    v = np.cross(aim, h)
    return math.degrees(math.atan2(float(u_img @ v), float(u_img @ h)))


def no_roll_quaternion(aim, dtype=torch.float32):
    """Yaw then pitch, no roll by construction."""
    x, y, z = np.asarray(aim) / np.linalg.norm(aim)
    q_yaw = quat.quat_from_axis_angle(
        torch.tensor((0.0, 0.0, 1.0), dtype=dtype), math.atan2(y, x))
    q_pitch = quat.quat_from_axis_angle(
        torch.tensor((0.0, 1.0, 0.0), dtype=dtype), -math.asin(z))
    return quat.quat_multiply(q_yaw, q_pitch).numpy()


def source_rotation_roll(dtype=torch.float32, device=None, verbose=True):
    """``examples/source_rotation_roll.py``: the roll that vector aiming
    gives at each of ``ROLL_AIMS`` and the roll of explicit quaternion
    aiming, and the example's checks (quaternion aiming rolls by under
    1e-5 degrees, vector aiming by more than 1 degree somewhere).
    Returns ``{"rolls": [(aim, vector, quaternion)], "worst_vector",
    "worst_quaternion"}``."""
    device = resolve_device(device)
    rolls = []
    for aim in ROLL_AIMS:
        r_vec = measure_roll(aim, "vector", dtype=dtype, device=device)
        r_quat = measure_roll(aim, "quaternion",
                              rotation=no_roll_quaternion(aim, dtype),
                              dtype=dtype, device=device)
        rolls.append((aim, r_vec, r_quat))
        if verbose:
            print(f"{str(aim):>24} | {r_vec:14.2f}deg | {r_quat:18.2f}deg")
    worst_vec = max(abs(r[1]) for r in rolls)
    worst_quat = max(abs(r[2]) for r in rolls)
    if not worst_quat < 1e-5:
        raise AssertionError(f"quaternion aiming must not roll: {worst_quat}")
    if not worst_vec > 1.0:
        raise AssertionError("vector aiming should exhibit the documented "
                             f"roll: {worst_vec}")
    return {"rolls": rolls, "worst_vector": worst_vec,
            "worst_quaternion": worst_quat}


# ----------------------------------------------------------------------
# examples/cdf_demo.py
# ----------------------------------------------------------------------

def cdf_demo(seed=0, verbose=True):
    """``examples/cdf_demo.py`` on the host: a CDF accumulated from five
    batches of 20000 clipped normal points (sigma 0.35) histogrammed on
    32 x 32 bins, then the forward map of 30000 uniform points, the inverse
    map of 30000 normal points and ``flatten_distribution`` of the same
    points on 48 x 48 bins, all from ``np.random.default_rng(seed)``.
    Returns the mapped and flattened points and the printed numbers: the
    forward map's standard deviations and the coefficients of variation
    of the flattened x histograms."""
    rng = np.random.default_rng(seed)
    cdf = goals.CumulativeDensityFunction(((-1.0, 1.0), (-1.0, 1.0)))
    for _ in range(5):
        pts = rng.normal(0, 0.35, (20000, 2)).clip(-0.999, 0.999)
        h, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=32,
                                 range=((-1, 1), (-1, 1)))
        cdf.accumulate_density(h.T)  # (Y, X)
    cdf.compute()
    mapped = cdf.cdf(rng.uniform(0, 1, (30000, 2)))
    gauss = rng.normal(0, 0.35, (30000, 2)).clip(-0.999, 0.999)
    flat = cdf.icdf(gauss)
    h, _ = np.histogram(flat[:, 0], bins=10, range=(0, 1))
    xf, yf = goals.flatten_distribution(gauss[:, 0], gauss[:, 1],
                                        ((-1, 1, 48), (-1, 1, 48)))
    h2, _ = np.histogram(xf, bins=10, range=(0, 1))
    out = {"mapped": mapped, "flat": flat, "flattened": np.stack([xf, yf], 1),
           "mapped_std": mapped.std(axis=0), "icdf_cv": h.std() / h.mean(),
           "flatten_cv": h2.std() / h2.mean()}
    if verbose:
        print(f"forward CDF: std = {out['mapped_std'].round(3)} (target "
              f"~0.35); inverse CDF cv = {out['icdf_cv']:.3f}; "
              f"flatten_distribution cv = {out['flatten_cv']:.3f}")
    return out


# ----------------------------------------------------------------------
# examples/source_gallery.py
# ----------------------------------------------------------------------

def _host(t):
    return t.detach().cpu().numpy()


def source_gallery(png=None, generator=None, uniforms=None,
                   dtype=torch.float32, device=None, verbose=True):
    """``examples/source_gallery.py``: every distribution family and source
    type sampled, at the example's counts.  ``uniforms`` may hold the
    draws of the two random samplers (``"square"``: (2, 625) for
    ``RandomUniformSquare(1.0, 25)``, ``"square_rank"``: (2, 600) for
    ``goals.SquareRankLambertianSphere(600)``); the rest are drawn from
    ``generator`` (seeded 0 by default).  The 3 x 4 figure is drawn only
    when ``png`` is given (it needs matplotlib).  Returns each panel's
    samples (host arrays) and the example's printed numbers: the rays of
    the dense AngularSource, the radial density uniformity of 20000 circle
    points (std / mean) and the aimed source's mean direction."""
    device = resolve_device(device)
    uniforms = dict(uniforms or {})
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(dtype=dtype, device=device)
    panels = {}

    pts, _ = dist.StaticUniformCircle(600).sample(**kw)
    panels["circle"] = _host(pts)
    pts, _ = dist.RandomUniformSquare(1.0, 25).sample(
        generator, uniforms=uniforms.get("square"), **kw)
    panels["square"] = _host(pts)
    pts, _ = dist.StaticLambertianSphere(PI / 3, 600).sample(**kw)
    panels["lambertian"] = _host(pts)
    pts, ranks = goals.SquareRankLambertianSphere(600).sample(
        generator, uniforms=uniforms.get("square_rank"), **kw)
    panels["square_rank"] = (_host(pts), _host(ranks))
    ring = goals.ArbitraryDistribution(
        lambda x, y: np.exp(-((np.hypot(x, y) - 0.6) ** 2) / 0.01) + 1e-6,
        ((-1, 1, 96), (-1, 1, 96)))
    rng = np.random.default_rng(0)
    panels["ring"] = np.stack(ring(rng.uniform(-1, 1, 3000),
                                   rng.uniform(-1, 1, 3000)), axis=1)
    pts, ranks = dist.StaticUniformBeam(-1.0, 1.0, 30).sample(**kw)
    panels["beam"] = (_host(pts), _host(ranks))

    sources = {
        "point_2d": src.PointSource(
            2, (0.0, 0.0), PI / 2,
            dist.StaticUniformAngularDistribution(-0.6, 0.6, 30), [500.0]),
        "angular_2d": src.AngularSource(
            2, (0.0, 0.0), 0.0,
            dist.StaticUniformAngularDistribution(-0.3, 0.3, 5),
            dist.StaticUniformBeam(-0.5, 0.5, 7), [680.0, 510.0, 400.0]),
        "point_3d": src.PointSource(
            3, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
            dist.StaticUniformSphere(PI / 8, 80), [575.0]),
        "aperture": src.AperatureSource(
            2, dist.StaticUniformAperaturePoints((0.0, -1.0), (0.0, 1.0), 12),
            dist.StaticUniformAperaturePoints((1.0, -0.4), (1.0, 0.4), 12),
            [575.0] * 12, dense=False),
        "aimed_3d": src.PointSource(
            3, (0.0, 0.0, 0.0), (1.0, 1.0, 0.0),
            dist.StaticUniformSphere(PI / 10, 60), [575.0]),
    }
    rays = {name: s.sample(generator, **kw) for name, s in sources.items()}
    for name, r in rays.items():
        panels[name] = (_host(r.p0), _host(r.p1), _host(r.wavelength))

    pts, _ = dist.StaticUniformCircle(20000).sample(**kw)
    r = np.linalg.norm(_host(pts), axis=1)
    h, edges = np.histogram(r, bins=30, range=(0, 1))
    density = h / (PI * (edges[1:] ** 2 - edges[:-1] ** 2))
    d3 = panels["aimed_3d"][1] - panels["aimed_3d"][0]
    mean_dir = d3.mean(axis=0)
    mean_dir /= np.linalg.norm(mean_dir)
    out = {"panels": panels, "angular_rays": rays["angular_2d"].n_rays,
           "uniformity": float(np.std(density) / np.mean(density)),
           "density": density, "edges": edges, "mean_direction": mean_dir}
    if verbose:
        print(f"AngularSource dense product rays: {out['angular_rays']}; "
              f"circle density uniformity (std/mean): {out['uniformity']}; "
              f"aimed mean direction: {np.round(mean_dir, 3)}")
    if png is not None:
        _draw_gallery(png, panels, rays, out)
    return out


def _draw_gallery(png, panels, rays, out):
    """The example's 3 x 4 figure, written to ``png``."""
    fig = drawing.figure(figsize=(18, 14))
    axes = []

    def panel(title, three_d=False):
        kw = {"projection": "3d"} if three_d else {}
        ax = fig.add_subplot(3, 4, len(axes) + 1, **kw)
        ax.set_title(title, fontsize=8)
        if not three_d:
            ax.set_aspect("equal")
        axes.append(ax)
        return ax

    panel("StaticUniformCircle (golden spiral)").scatter(
        *panels["circle"].T, s=2)
    panel("RandomUniformSquare").scatter(*panels["square"].T, s=2)
    p = panels["lambertian"]
    panel("StaticLambertianSphere cap", True).scatter(
        p[:, 0], p[:, 1], p[:, 2], s=2)
    p, ranks = panels["square_rank"]
    panel("SquareRankLambertianSphere", True).scatter(
        p[:, 0], p[:, 1], p[:, 2], s=2, c=ranks[:, 0])
    panel("ArbitraryDistribution (ring)").scatter(*panels["ring"].T, s=1)
    p, ranks = panels["beam"]
    panel("Beam + Lambertian angles (rank colored)").scatter(
        *p.T, s=6, c=ranks)
    for title, name, lim in (
            ("2D PointSource fan", "point_2d", ((-1, 1), (-0.2, 1.2))),
            ("2D AngularSource (beam x angles)", "angular_2d",
             ((-0.2, 1.4), (-1, 1)))):
        ax = panel(title)
        drawing.RayDrawer2D(ax, rays[name]).draw()
        ax.set_xlim(*lim[0])
        ax.set_ylim(*lim[1])
    ax = panel("3D PointSource (sphere cap, aimed +z)", True)
    drawing.RayDrawer3D(ax, rays["point_3d"]).draw()
    ax.set_xlim(-1, 1)
    ax.set_ylim(-1, 1)
    ax.set_zlim(0, 1)
    ax = panel("AperatureSource")
    drawing.RayDrawer2D(ax, rays["aperture"]).draw()
    ax.set_xlim(-0.2, 1.2)
    ax.set_ylim(-1.2, 1.2)
    ax = panel("source_uniformity: circle radial histogram")
    edges = out["edges"]
    ax.bar(edges[:-1], out["density"] / out["density"].mean(),
           width=np.diff(edges))
    ax.set_aspect("auto")
    p0, p1, _ = panels["aimed_3d"]
    panel("rotation/roll test (quaternion aiming)").scatter(
        (p1 - p0)[:, 1], (p1 - p0)[:, 2], s=4)
    fig.tight_layout()
    fig.savefig(png, dpi=90)
