"""Goal-building machinery: arbitrary-density sampling, CDF warps,
distribution matching, image-driven points and precompiled point caches.

Counterpart of ``tensorflowraytrace_tpu/models/goals.py`` (the back half
of the reference's distributions.py): build goal points offline, match
them to source points, cache them to disk, downsample them per step.  The
warps, CDFs and matchings are host-side NumPy/SciPy by design, as in the
reference: they run once, when a problem is set up, and no gradient goes
through them.

The samplers follow the port's convention (``models/distributions.py``)::

    sample(generator=None, dtype=None, device=None, uniforms=None)
        -> (points, ranks)

They draw their uniforms (in float64) from ``generator``, a
``torch.Generator`` (a fresh one on ``device`` seeded 0 when none is
given), or take them ready-made as ``uniforms``: a (k, n) array of draws
in [0, 1) whose rows each class names, so that a test can feed the JAX
package's NumPy draws through both.  The warps run on the host; what
``sample`` returns lies on ``device`` (the card unless the CPU is asked
for) in ``dtype``.  ``PrecompiledBasePoints`` draws its indices and noise
on the device.

Array convention: densities are (Y, X), y on axis 0 (image orientation).
An image file is read with ``imageio``, imported only where a file name is
given; without it such a call raises ``ImportError``.
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.config import resolve_device, resolve_dtype
from tensorflowraytrace_tpu_torch.models.distributions import (
    BasePointDistribution,
)

PI = math.pi


def _host_uniforms(uniforms, k, n, generator, device):
    """(k, n) float64 uniforms in [0, 1) as a NumPy array: the given ones,
    or fresh draws from ``generator`` (on its own device; a generator on
    ``device`` seeded 0 when none is given)."""
    if uniforms is not None:
        u = np.asarray(uniforms.detach().cpu() if isinstance(
            uniforms, torch.Tensor) else uniforms, dtype=np.float64)
        if u.shape != (k, n):
            raise ValueError(f"expected ({k}, {n}) uniforms, got {u.shape}")
        return u
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.rand((k, n), generator=generator, dtype=torch.float64,
                      device=generator.device).cpu().numpy()


def _imread_gray(filename):
    """A greyscale image file as a float array (imageio, imported here
    only).  Mode "F" is the 32-bit float greyscale (ITU-R 601-2 luma) that
    ``as_gray=True`` gave; the JAX package still passes ``as_gray``, which
    imageio's pillow plugin now refuses."""
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(filename, mode="F"))


def _load_density(density_function, evaluation_limits):
    """Resolve the density argument: a (Y, X) array, a callable(x, y) or an
    image file name."""
    if isinstance(density_function, str):
        x_min, x_max = evaluation_limits[0][:2]
        y_min, y_max = evaluation_limits[1][:2]
        density = np.asarray(_imread_gray(density_function), dtype=np.float64)
    elif callable(density_function):
        x_min, x_max, x_count = evaluation_limits[0]
        y_min, y_max, y_count = evaluation_limits[1]
        gx = np.linspace(x_min, x_max, x_count)
        gy = np.linspace(y_min, y_max, y_count)
        gxx, gyy = np.meshgrid(gx, gy)
        density = np.asarray(density_function(gxx, gyy), dtype=np.float64)
    else:
        density = np.asarray(density_function, dtype=np.float64)
        if density.ndim != 2:
            raise ValueError("density function must be 2D")
        x_min, x_max = evaluation_limits[0][:2]
        y_min, y_max = evaluation_limits[1][:2]
    if np.any(density < 0):
        raise ValueError("density function must be non-negative")
    return density, (x_min, x_max), (y_min, y_max)


def _column_cdfs(density, x_min, x_max, y_min, y_max):
    """The marginal CDF in x on the x bin edges and each column's CDF in y
    on the y bin edges, each normalised to end at 1."""
    y_count, x_count = density.shape
    cum_x = np.concatenate([[0.0], np.cumsum(density.sum(axis=0))])
    cum_x /= cum_x[-1]
    cum_y = np.concatenate([np.zeros((1, x_count)), np.cumsum(density, axis=0)],
                           axis=0)
    cum_y /= cum_y[-1:]
    return (cum_x, np.linspace(x_min, x_max, x_count + 1), cum_y,
            np.linspace(y_min, y_max, y_count + 1))


def _bins(values, lo, hi, count):
    return np.clip(np.floor((values - lo) / (hi - lo) * count).astype(int),
                   0, count - 1)


def _interp_per_bin(values, bins, xp_of, fp_of):
    """``np.interp(values, xp_of(j), fp_of(j))`` for the values in each bin
    ``j``."""
    out = np.empty_like(values)
    for j in np.unique(bins):
        mask = bins == j
        out[mask] = np.interp(values[mask], xp_of(j), fp_of(j))
    return out


class ArbitraryDistribution:
    """Warp uniformly sampled points so they follow an arbitrary 2D
    density.

    ``dist(x, y)`` takes uniform samples over the evaluation domain and
    returns samples of the density, of the same shapes: the marginal in x,
    then y conditional on the x column, each by inverse CDF.
    """

    def __init__(self, density_function, evaluation_limits):
        density, (self.x_min, self.x_max), (self.y_min, self.y_max) = \
            _load_density(density_function, evaluation_limits)
        self.density_function = density
        self.y_count, self.x_count = density.shape
        if np.any(density.sum(axis=0) <= 0):
            raise ValueError(
                "Discovered a slice where the density is zero; the quantile "
                "function would need infinite slope.  Restrict the domain or "
                "add a small constant to the density.")
        self._cum_x, self._x_edges, self._cum_y, self._y_edges = _column_cdfs(
            density, self.x_min, self.x_max, self.y_min, self.y_max)

    def __call__(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        u = np.clip((x - self.x_min) / (self.x_max - self.x_min), 0.0, 1.0)
        v = np.clip((y - self.y_min) / (self.y_max - self.y_min), 0.0, 1.0)
        x_out = np.interp(u, self._cum_x, self._x_edges)
        col = _bins(x_out, self.x_min, self.x_max, self.x_count)
        y_out = _interp_per_bin(v, col, lambda j: self._cum_y[:, j],
                                lambda j: self._y_edges)
        return x_out, y_out


def flatten_distribution(x, y, evaluation_limits):
    """Warp an arbitrarily distributed point cloud to uniform: histogram
    the cloud, build its CDF, apply it.  Outputs lie in [0, 1] x [0, 1]."""
    x_min, x_max, x_res = evaluation_limits[0]
    y_min, y_max, y_res = evaluation_limits[1]
    x = np.clip(np.asarray(x, dtype=np.float64), x_min, x_max)
    y = np.clip(np.asarray(y, dtype=np.float64), y_min, y_max)
    density, _, _ = np.histogram2d(
        x, y, bins=(x_res, y_res), range=((x_min, x_max), (y_min, y_max)))
    density = density.T + 1e-12  # (Y, X); keeps every column non-degenerate
    cum_x, x_edges, cum_y, y_edges = _column_cdfs(density, x_min, x_max,
                                                  y_min, y_max)
    x_out = np.interp(x, x_edges, cum_x)
    col = _bins(x, x_min, x_max, x_res)
    y_out = _interp_per_bin(y, col, lambda j: y_edges, lambda j: cum_y[:, j])
    return x_out, y_out


class CumulativeDensityFunction:
    """Accumulating 2D CDF with forward (uniform -> density) and inverse
    (density -> uniform) evaluation.

    Density batches are added with ``accumulate_density`` (e.g. histograms
    of traced rays), ``compute`` builds the interpolants, and ``cdf`` /
    ``icdf`` map (n, 2) point sets: the marginal in y first, then x
    conditional on the y row.
    """

    def __init__(self, eval_limits, density=None, direction="both"):
        self.x_min, self.x_max = eval_limits[0]
        self.y_min, self.y_max = eval_limits[1]
        self.x_res = 10
        self.y_res = 10
        self._density = None
        self._ready_fwd = False
        self._ready_inv = False
        if density is not None:
            self.compute(density, direction)

    def accumulate_density(self, density):
        density = np.asarray(density, dtype=np.float64)
        if self._density is None:
            self._density = density.copy()
            self.y_res, self.x_res = density.shape
        else:
            self._density += density

    def clear_density(self):
        self._density = None

    def compute(self, density=None, direction="both", epsilon=1e-10):
        if density is not None:
            self.clear_density()
            self.accumulate_density(density)
        if self._density is None:
            raise RuntimeError("compute called before accumulating density")
        if direction not in ("forward", "inverse", "both"):
            raise ValueError("direction must be 'forward', 'inverse' or 'both'")
        d = self._density + epsilon  # (Y, X)
        cum_y = np.concatenate([[0.0], np.cumsum(d.sum(axis=1))])
        cum_y /= cum_y[-1]
        cum_x = np.concatenate([np.zeros((self.y_res, 1)),
                                np.cumsum(d, axis=1)], axis=1)  # (Y, X+1)
        cum_x /= cum_x[:, -1:]
        self._cum_y = cum_y
        self._cum_x = cum_x
        self._x_edges = np.linspace(self.x_min, self.x_max, self.x_res + 1)
        self._y_edges = np.linspace(self.y_min, self.y_max, self.y_res + 1)
        self._ready_fwd = direction in ("forward", "both")
        self._ready_inv = direction in ("inverse", "both")

    def _rows_for(self, y):
        return _bins(y, self.y_min, self.y_max, self.y_res)

    def cdf(self, points):
        """Map uniform (0, 1)^2 points onto the density's domain."""
        if not self._ready_fwd:
            raise RuntimeError("compute(direction='forward'|'both') first")
        points = np.asarray(points, dtype=np.float64)
        u = np.clip(points[:, 0], 0.0, 1.0)
        v = np.clip(points[:, 1], 0.0, 1.0)
        y_out = np.interp(v, self._cum_y, self._y_edges)
        x_out = _interp_per_bin(u, self._rows_for(y_out),
                                lambda i: self._cum_x[i],
                                lambda i: self._x_edges)
        return np.column_stack([x_out, y_out])

    def icdf(self, points):
        """Map points on the density's domain onto uniform (0, 1)^2."""
        if not self._ready_inv:
            raise RuntimeError("compute(direction='inverse'|'both') first")
        points = np.asarray(points, dtype=np.float64)
        x = np.clip(points[:, 0], self.x_min, self.x_max)
        y = np.clip(points[:, 1], self.y_min, self.y_max)
        v_out = np.interp(y, self._y_edges, self._cum_y)
        u_out = _interp_per_bin(x, self._rows_for(y),
                                lambda i: self._x_edges,
                                lambda i: self._cum_x[i])
        return np.column_stack([u_out, v_out])

    def __call__(self, points):
        return self.cdf(points)


class ArbitraryBasePoints(BasePointDistribution):
    """Base points from an arbitrary density, with an optional *goal*
    density warped from the same uniforms: the ranks are the goal landing
    points.  ``conserve_etendue`` rescales the ranks so that the goal's
    mean radius about ``etendue_origin`` matches the source's (estimated
    once on a host sample seeded 0, as the JAX package does).

    ``uniforms``: (2, sample_count), the x draws then the y draws.
    """

    is_random = True

    def __init__(self, base_point_distribution: ArbitraryDistribution,
                 sample_count, rank_distribution=None, conserve_etendue=True,
                 etendue_origin=(0.0, 0.0)):
        if sample_count <= 0:
            raise ValueError("sample_count must be > 0")
        self.base_point_distribution = base_point_distribution
        self.rank_distribution = rank_distribution
        self.sample_count = sample_count
        self.rank_scale_factor = 1.0
        if conserve_etendue and rank_distribution is not None:
            self.enforce_etendue(etendue_origin)

    def _raw_sample(self, u):
        b = self.base_point_distribution
        x = b.x_min + (b.x_max - b.x_min) * u[0]
        y = b.y_min + (b.y_max - b.y_min) * u[1]
        points = np.stack(b(x, y), axis=1)
        ranks = None
        if self.rank_distribution is not None:
            ranks = np.stack(self.rank_distribution(x, y), axis=1)
        return points, ranks

    def enforce_etendue(self, origin=(0.0, 0.0)):
        u = np.random.default_rng(0).random((2, self.sample_count))
        points, ranks = self._raw_sample(u)
        origin = np.asarray(origin, dtype=np.float64)
        base_e = np.mean(np.linalg.norm(points - origin, axis=1))
        rank_e = np.mean(np.linalg.norm(ranks - origin, axis=1))
        self.rank_scale_factor = float(base_e / rank_e)

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        points, ranks = self._raw_sample(_host_uniforms(
            uniforms, 2, self.sample_count, generator, device))
        points = torch.as_tensor(points, dtype=dtype, device=device)
        if ranks is not None:
            ranks = torch.as_tensor(ranks * self.rank_scale_factor,
                                    dtype=dtype, device=device)
        return points, ranks


def transform_map(fixed, mutable):
    """Optimal assignment of goal points to source points: ``mutable``
    reordered to minimise the total distance to ``fixed`` (the Hungarian
    method, SciPy's ``linear_sum_assignment``).  O(n^3), offline."""
    from scipy.optimize import linear_sum_assignment

    fixed = np.asarray(fixed)
    mutable = np.asarray(mutable)
    if fixed.shape != mutable.shape:
        raise ValueError("transform_map: inputs must have the same shape")
    distance = np.linalg.norm(fixed[:, None, :] - mutable[None, :, :], axis=2)
    fixed_idx, mutable_idx = linear_sum_assignment(distance)
    out = np.empty_like(mutable)
    out[fixed_idx] = mutable[mutable_idx]
    return out


def transform_map_greedy(fixed, mutable, origin=None, furthest_first=True):
    """The greedy matcher: each fixed point (the farthest from ``origin``
    first) takes its nearest unused mutable point."""
    fixed = np.asarray(fixed)
    mutable = np.asarray(mutable)
    if fixed.shape != mutable.shape:
        raise ValueError("transform_map: inputs must have the same shape")
    if origin is None:
        origin = np.zeros(fixed.shape[1])
    order = np.argsort(np.linalg.norm(fixed - origin, axis=1))
    if furthest_first:
        order = order[::-1]
    out = np.zeros_like(mutable)
    used = np.zeros(mutable.shape[0], dtype=bool)
    for i in order:
        d = np.linalg.norm(fixed[i] - mutable, axis=1)
        d[used] = np.inf
        j = int(np.argmin(d))
        used[j] = True
        out[i] = mutable[j]
    return out


class ImageBasePoints(BasePointDistribution):
    """Random points whose density follows a greyscale image: each pixel
    spawns as many uniform points as its grey level's rank among the
    image's levels.  ``from_array`` takes the image as an array; the
    constructor reads a file.

    ``uniforms``: (2, n), the offsets within their pixels along the first
    and the second image axis, n the total count of points.
    """

    is_random = True

    def __init__(self, filename, x_size, y_size=None):
        if x_size <= 0:
            raise ValueError("x_size must be > 0")
        self.x_size = float(x_size)
        self.y_size = float(y_size or x_size)
        self._init_from_array(_imread_gray(filename))

    @classmethod
    def from_array(cls, image, x_size, y_size=None):
        self = cls.__new__(cls)
        self.x_size = float(x_size)
        self.y_size = float(y_size or x_size)
        self._init_from_array(np.asarray(image))
        return self

    def _init_from_array(self, raw):
        self.x_res, self.y_res = raw.shape
        unique, inverse = np.unique(raw, return_inverse=True)
        self.grey_levels = len(unique)
        self._image = np.arange(self.grey_levels)[inverse].reshape(raw.shape)

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        x_edges = np.linspace(-self.x_size / 2, self.x_size / 2, self.x_res + 1)
        y_edges = np.linspace(-self.y_size / 2, self.y_size / 2, self.y_res + 1)
        counts = self._image
        ii, jj = np.nonzero(counts)
        reps = counts[ii, jj]
        xi = np.repeat(ii, reps)
        yi = np.repeat(jj, reps)
        u, v = _host_uniforms(uniforms, 2, xi.shape[0], generator, device)
        x = x_edges[xi] + u * (x_edges[xi + 1] - x_edges[xi])
        y = y_edges[yi] + v * (y_edges[yi + 1] - y_edges[yi])
        points = torch.as_tensor(np.stack([x, y], axis=1), dtype=dtype,
                                 device=device)
        return points, None


class PrecompiledBasePoints(BasePointDistribution):
    """A cached point set, downsampled at every ``sample`` (``sample_count``
    points drawn with replacement) and optionally perturbed by Gaussian
    noise of the given per-axis deviations.

    Build it from a pickle file (a dict of NumPy arrays ``points`` and
    ``ranks``: the JAX package's layout, so either package loads the
    other's file; load only files this program or a trusted one wrote,
    since unpickling can run code), from a distribution (sampled once with
    a generator seeded 0), or from an object with ``points`` and ``ranks``.

    ``sample`` draws its indices and noise on ``device`` from
    ``generator``; ``uniforms`` may give them instead, a dict with
    ``"index"`` (sample_count integers) and ``"noise"`` (standard normals
    shaped like the sampled points).
    """

    is_random = True

    def __init__(self, arg=None, sample_count=100, do_downsample=True,
                 perturbation=None):
        if isinstance(arg, str):
            with open(arg, "rb") as f:
                data = pickle.load(f)
            self.full_points = (None if data["points"] is None
                                else np.asarray(data["points"]))
            self.full_ranks = (None if data["ranks"] is None
                               else np.asarray(data["ranks"]))
        elif arg is None:
            self.full_points = None
            self.full_ranks = None
        else:
            pts, ranks = (arg.sample() if hasattr(arg, "sample")
                          else (arg.points, arg.ranks))
            self.full_points = _numpy(pts)
            self.full_ranks = None if ranks is None else _numpy(ranks)
        self.sample_count = sample_count
        self.do_downsample = do_downsample
        self.perturbation = perturbation

    def save(self, filename):
        with open(filename, "wb") as f:
            pickle.dump({"points": self.full_points, "ranks": self.full_ranks},
                        f, pickle.HIGHEST_PROTOCOL)

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        if self.full_points is None:
            raise ValueError("PrecompiledBasePoints: no points loaded")
        draws = uniforms or {}
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        points = torch.as_tensor(self.full_points, dtype=dtype, device=device)
        ranks = (None if self.full_ranks is None else
                 torch.as_tensor(self.full_ranks, dtype=dtype, device=device))
        if self.do_downsample:
            idx = draws.get("index")
            idx = (torch.randint(0, points.shape[0], (self.sample_count,),
                                 generator=generator, device=device)
                   if idx is None else
                   torch.as_tensor(np.array(idx), dtype=torch.long,
                                   device=device))
            points = points[idx]
            if ranks is not None:
                ranks = ranks[idx]
        if self.perturbation is not None:
            noise = draws.get("noise")
            noise = (torch.randn(points.shape, generator=generator,
                                 dtype=dtype, device=device)
                     if noise is None else
                     torch.as_tensor(np.array(noise), dtype=dtype,
                                     device=device))
            dev = torch.as_tensor(self.perturbation, dtype=dtype,
                                  device=device).expand(points.shape[1])
            points = points + noise * dev
        return points, ranks


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class SquareRankLambertianSphere(BasePointDistribution):
    """Lambertian-sphere directions with a *square* rank: a uniform square
    seed, warped onto the disk of radius sin(angular_cutoff) (through
    ``ArbitraryDistribution``) and lifted onto the sphere, is Lambertian;
    the pole points along +x.  For LED models with square goals.

    ``uniforms``: (2, sample_count), the rank's x draws then its y draws.
    """

    is_random = True

    def __init__(self, sample_count, angular_cutoff=PI / 2.0,
                 sampling_resolution=256):
        if sample_count <= 0:
            raise ValueError("sample_count must be > 0")
        if not 0 <= angular_cutoff <= PI / 2:
            raise ValueError("angular_cutoff must be in [0, PI/2]")
        self.sample_count = int(sample_count)
        self.angular_cutoff = angular_cutoff
        cutoff = math.sin(angular_cutoff)

        def density(x, y):
            return (np.sqrt(x * x + y * y) < cutoff).astype(np.float64) + 1e-10

        self._circle_maker = ArbitraryDistribution(
            density,
            ((-1.0, 1.0, sampling_resolution), (-1.0, 1.0, sampling_resolution)),
        )

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        u = _host_uniforms(uniforms, 2, self.sample_count, generator, device)
        ranks = -1.0 + 2.0 * u.T
        cx, cy = self._circle_maker(ranks[:, 0], ranks[:, 1])
        theta = np.arctan2(cy, cx)
        rad2 = cx * cx + cy * cy
        z = np.sqrt(np.clip(1.0 - rad2, 0.0, 1.0))
        phi = np.arctan2(np.sqrt(rad2), z)
        points = np.stack(
            [np.cos(phi), np.sin(phi) * np.cos(theta),
             np.sin(phi) * np.sin(theta)], axis=1)
        return (torch.as_tensor(points, dtype=dtype, device=device),
                torch.as_tensor(ranks, dtype=dtype, device=device))
