"""Base-point and angle samplers for building sources.

Counterpart of ``tensorflowraytrace_tpu/models/distributions.py``; the
goal-building distributions live in ``models.goals`` and are re-exported
here, as the JAX module re-exports them.  Each
sampler has one method::

    sample(generator=None, dtype=None, device=None, uniforms=None)
        -> (values, ranks)

A random sampler draws its uniforms from ``generator`` (a
``torch.Generator`` on ``device``; a fresh one seeded 0 when none is given),
or takes them ready-made as ``uniforms``, a (k, n) tensor of draws in
[0, 1) whose rows each class names.  The second path lets tests feed both
packages the same numbers, since ``jax.random`` streams cannot be
reproduced in PyTorch: the rows are the draws JAX makes, in the order in
which it splits its key.

``update()`` samples and caches, for code that reads ``.ranks``,
``.angles`` or ``.points`` after it (the first read of a sampler never
updated samples it once).  The circles also keep the polar coordinates of
their last sample (``polar_ranks``, ``polar_points``), so a source can carry
them as an extra field of the very rays that sample made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.config import resolve_device, resolve_dtype
from tensorflowraytrace_tpu_torch.models import mesh as mt
from tensorflowraytrace_tpu_torch.utils import quaternion as quat

PI = math.pi
GOLDEN_ANGLE = PI * (1 + 5 ** 0.5)


def _uniforms(uniforms, k, n, generator, dtype, device):
    """(k, n) uniforms in [0, 1): the given ones, or fresh draws."""
    if uniforms is not None:
        u = torch.as_tensor(uniforms, dtype=dtype, device=device)
        if u.shape != (k, n):
            raise ValueError(f"expected ({k}, {n}) uniforms, got {tuple(u.shape)}")
        return u
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.rand((k, n), generator=generator, dtype=dtype, device=device)


def _scale(u, lo, hi):
    """Map uniforms in [0, 1) to [lo, hi) the way ``jax.random.uniform``
    does: ``max(lo, u * (hi - lo) + lo)`` in the working dtype.  The bounds
    and their difference are rounded to that dtype on the host and enter as
    Python scalars, so nothing is copied to the device."""
    host = np.float32 if u.dtype == torch.float32 else np.float64
    lo, hi = host(lo), host(hi)
    return torch.clamp(u * float(hi - lo) + float(lo), min=float(lo))


def _linspace(start, stop, n, dtype, device):
    """``jnp.linspace(start, stop, n)`` as JAX computes it: each interior
    point is ``start (1 - s) + stop s`` with ``s = k / (n - 1)`` in
    ``dtype``, and the last point is ``stop``."""
    if n == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    step = torch.arange(n - 1, dtype=dtype, device=device) / (n - 1)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])


class Distribution:
    """Base: ``sample`` returns ``(values, ranks)``; ``update`` samples and
    caches them for ``.ranks`` (and ``.angles`` / ``.points``)."""

    is_random = False

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        raise NotImplementedError

    def update(self, generator=None, dtype=None, device=None, uniforms=None):
        """Sample and cache the result."""
        self._cached = self.sample(generator, dtype, device, uniforms)
        return self._cached

    def _cache(self):
        if not hasattr(self, "_cached"):
            self.update()
        return self._cached

    @property
    def ranks(self):
        return self._cache()[1]


class AngularDistribution(Distribution):
    @property
    def angles(self):
        return self._cache()[0]


class BasePointDistribution(Distribution):
    @property
    def points(self):
        return self._cache()[0]


# ----------------------------------------------------------------------
# 2D angles (scalars)
# ----------------------------------------------------------------------

def _check_angles(min_angle, max_angle, sample_count, limit):
    if not -limit <= min_angle <= max_angle <= limit:
        raise ValueError(f"angles must satisfy {-limit} <= min <= max <= {limit}")
    if sample_count <= 0:
        raise ValueError("sample_count must be > 0")


def _uniform_angle_ranks(angles, min_angle, max_angle):
    """Rank = angle over the larger limit in magnitude."""
    scale = max(abs(min_angle), abs(max_angle))
    return angles / scale if scale > 0 else angles


class ManualAngularDistribution(AngularDistribution):
    """Given angles (and optional ranks)."""

    def __init__(self, angles, ranks=None):
        self._angles = angles
        self._ranks = ranks

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        angles = torch.as_tensor(self._angles, dtype=dtype, device=device)
        ranks = (None if self._ranks is None else
                 torch.as_tensor(self._ranks, dtype=dtype, device=device))
        return angles, ranks


class _AngleRange(AngularDistribution):
    limit = PI

    def __init__(self, min_angle, max_angle, sample_count):
        _check_angles(min_angle, max_angle, sample_count, self.limit)
        self.min_angle = min_angle
        self.max_angle = max_angle
        self.sample_count = sample_count


class StaticUniformAngularDistribution(_AngleRange):
    """``sample_count`` evenly spaced angles in [min_angle, max_angle]."""

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        angles = _linspace(self.min_angle, self.max_angle, self.sample_count,
                           dtype, device)
        return angles, _uniform_angle_ranks(angles, self.min_angle,
                                            self.max_angle)


class RandomUniformAngularDistribution(_AngleRange):
    """Uniform random angles in [min_angle, max_angle); uniforms rows:
    (angle,)."""

    is_random = True

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        u = _uniforms(uniforms, 1, self.sample_count, generator, dtype, device)
        angles = _scale(u[0], self.min_angle, self.max_angle)
        return angles, _uniform_angle_ranks(angles, self.min_angle,
                                            self.max_angle)


class StaticLambertianAngularDistribution(_AngleRange):
    """Cosine-weighted angles: the rank sin(angle) is evenly spaced in
    [sin(min_angle), sin(max_angle)]."""

    limit = PI / 2

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        ranks = _linspace(math.sin(self.min_angle), math.sin(self.max_angle),
                          self.sample_count, dtype, device)
        return torch.arcsin(ranks), ranks


class RandomLambertianAngularDistribution(_AngleRange):
    """Cosine-weighted random angles: the rank sin(angle) is uniform in
    [sin(min_angle), sin(max_angle)); uniforms rows: (rank,)."""

    is_random = True
    limit = PI / 2

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        u = _uniforms(uniforms, 1, self.sample_count, generator, dtype, device)
        ranks = _scale(u[0], math.sin(self.min_angle), math.sin(self.max_angle))
        return torch.arcsin(ranks), ranks


# ----------------------------------------------------------------------
# base points: given, beams, apertures, squares
# ----------------------------------------------------------------------

class ManualBasePointDistribution(BasePointDistribution):
    """Given points (and optional ranks), or with ``from_mesh`` the vertices
    of a mesh (anything ``mesh.as_trimesh`` takes), read anew at every
    sample."""

    def __init__(self, dimension, points=None, ranks=None, from_mesh=None):
        if dimension not in (2, 3):
            raise ValueError("dimension must be 2 or 3")
        self.dimension = dimension
        self._points = points
        self._ranks = ranks
        self.from_mesh = from_mesh

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        if self.from_mesh is not None:
            points = torch.as_tensor(mt.as_trimesh(self.from_mesh).points,
                                     dtype=dtype, device=device)
        elif self._points is None:
            points = torch.zeros((0, self.dimension), dtype=dtype,
                                 device=device)
        else:
            points = torch.as_tensor(self._points, dtype=dtype, device=device)
        ranks = (None if self._ranks is None else
                 torch.as_tensor(self._ranks, dtype=dtype, device=device))
        return points, ranks


class _BeamBase(BasePointDistribution):
    """2D beam: points on a line through the origin perpendicular to
    ``central_angle``, spanning [beam_start, beam_end]; the rank is the
    position over the larger end in magnitude (0 at the origin, +-1 at the
    far end)."""

    def __init__(self, beam_start, beam_end, sample_count, central_angle=0.0):
        if beam_start > beam_end:
            raise ValueError("beam_start must be <= beam_end")
        if sample_count <= 0:
            raise ValueError("sample_count must be > 0")
        self.beam_start = beam_start
        self.beam_end = beam_end
        self.sample_count = sample_count
        self.central_angle = central_angle

    @property
    def _rank_scale(self):
        return max(abs(self.beam_start), abs(self.beam_end))

    def _ranks(self, generator, dtype, device, uniforms):
        raise NotImplementedError

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        ranks = self._ranks(generator, dtype, device, uniforms)
        # the far end at rank +-1, along central_angle - pi/2
        ex = self._rank_scale * math.cos(self.central_angle - PI / 2)
        ey = self._rank_scale * math.sin(self.central_angle - PI / 2)
        sign = -1.0 if self.beam_start < 0 else 1.0
        points = torch.stack([ranks * sign * ex, ranks * sign * ey], dim=1)
        return points, ranks


class StaticUniformBeam(_BeamBase):
    """``sample_count`` evenly spaced points across the beam."""

    def _ranks(self, generator, dtype, device, uniforms):
        scale = self._rank_scale
        return _linspace(self.beam_start / scale, self.beam_end / scale,
                         self.sample_count, dtype, device)


class RandomUniformBeam(_BeamBase):
    """Uniform random points across the beam; uniforms rows: (rank,)."""

    is_random = True

    def _ranks(self, generator, dtype, device, uniforms):
        scale = self._rank_scale
        u = _uniforms(uniforms, 1, self.sample_count, generator, dtype, device)
        return _scale(u[0], self.beam_start / scale, self.beam_end / scale)


class _AperaturePointBase(BasePointDistribution):
    """2D points on the segment between two absolute endpoints; rank 0 at
    ``start_point``, 1 at ``end_point``.  (The reference's spelling.)"""

    def __init__(self, start_point, end_point, sample_count):
        if sample_count <= 0:
            raise ValueError("sample_count must be > 0")
        self.start_point = start_point
        self.end_point = end_point
        self.sample_count = sample_count

    def _ranks(self, generator, dtype, device, uniforms):
        raise NotImplementedError

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        ranks = self._ranks(generator, dtype, device, uniforms)
        s = torch.as_tensor(self.start_point, dtype=dtype,
                            device=device).reshape(1, 2)
        e = torch.as_tensor(self.end_point, dtype=dtype,
                            device=device).reshape(1, 2)
        return s + ranks[:, None] * (e - s), ranks


class StaticUniformAperaturePoints(_AperaturePointBase):
    """``sample_count`` evenly spaced points from start to end."""

    def _ranks(self, generator, dtype, device, uniforms):
        return _linspace(0.0, 1.0, self.sample_count, dtype, device)


class RandomUniformAperaturePoints(_AperaturePointBase):
    """Uniform random points between start and end; uniforms rows:
    (rank,)."""

    is_random = True

    def _ranks(self, generator, dtype, device, uniforms):
        return _uniforms(uniforms, 1, self.sample_count, generator, dtype,
                         device)[0]


class _SquareBase(BasePointDistribution):
    """Points in a centred rectangle; rank = points normalised by the
    longest half-side."""

    def __init__(self, x_size, x_res, y_size=None, y_res=None):
        if x_size <= 0:
            raise ValueError("x_size must be > 0")
        self.x_size = x_size
        self.x_res = x_res
        self.y_size = y_size or x_size
        self.y_res = y_res or x_res

    @property
    def sample_count(self) -> int:
        return self.x_res * self.y_res

    def _points(self, generator, dtype, device, uniforms):
        raise NotImplementedError

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        points = self._points(generator, dtype, device, uniforms)
        ranks = points / max(self.x_size, self.y_size)
        return points, ranks


class StaticUniformSquare(_SquareBase):
    """An x_res by y_res grid, x varying fastest."""

    def _points(self, generator, dtype, device, uniforms):
        x = _linspace(-self.x_size, self.x_size, self.x_res, dtype, device)
        y = _linspace(-self.y_size, self.y_size, self.y_res, dtype, device)
        xg, yg = torch.meshgrid(x, y, indexing="xy")
        return torch.stack([xg.reshape(-1), yg.reshape(-1)], dim=1)


class RandomUniformSquare(_SquareBase):
    """Uniform random points in the square; uniforms rows: (x, y)."""

    is_random = True

    def _points(self, generator, dtype, device, uniforms):
        u = _uniforms(uniforms, 2, self.sample_count, generator, dtype, device)
        x = _scale(u[0], -self.x_size, self.x_size)
        y = _scale(u[1], -self.y_size, self.y_size)
        return torch.stack([x, y], dim=1)


# ----------------------------------------------------------------------
# circles and sphere caps
# ----------------------------------------------------------------------

def _theta_mod(theta, theta_start, theta_end):
    """Wrap golden-spiral angles into the theta window (the static spirals
    only: a random sampler draws within the window, since wrapping would
    double the density of the first wrapped span)."""
    if theta_start == 0 and theta_end == 2 * PI:
        return theta
    return torch.remainder(theta, theta_end - theta_start) + theta_start


class _CircleBase(BasePointDistribution):
    """Points inside a circle of ``radius`` within a theta window.  The ranks
    are the points over the radius; each sample keeps its polar coordinates
    for ``polar_ranks`` (r in [0, 1], theta mod 2 pi) and ``polar_points``
    (r scaled by the radius)."""

    def __init__(self, sample_count, radius=1.0, theta_start=0.0,
                 theta_end=2 * PI):
        if sample_count <= 0:
            raise ValueError("sample_count must be > 0")
        if radius <= 0:
            raise ValueError("radius must be > 0")
        self.sample_count = sample_count
        self.radius = radius
        self.theta_start = theta_start
        self.theta_end = theta_end

    def _polar(self, generator, dtype, device, uniforms):
        raise NotImplementedError

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        r, theta = self._polar(generator, dtype, device, uniforms)
        if not self.is_random:
            theta = _theta_mod(theta, self.theta_start, self.theta_end)
        self._r, self._theta = r, theta
        ranks = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=1)
        return self.radius * ranks, ranks

    def _polar_cache(self):
        # the last sample's coordinates; a fresh sample only when none exists
        if not hasattr(self, "_r"):
            self.update()
        return self._r, torch.remainder(self._theta, 2 * PI)

    @property
    def polar_ranks(self):
        r, theta = self._polar_cache()
        return torch.stack([r, theta], dim=1)

    @property
    def polar_points(self):
        r, theta = self._polar_cache()
        return torch.stack([self.radius * r, theta], dim=1)


class StaticUniformCircle(_CircleBase):
    """A golden-angle spiral of evenly spread points."""

    def _polar(self, generator, dtype, device, uniforms):
        indices = torch.arange(self.sample_count, dtype=dtype,
                               device=device) + 0.5
        return torch.sqrt(indices / self.sample_count), GOLDEN_ANGLE * indices


class RandomUniformCircle(_CircleBase):
    """Uniform random points; uniforms rows: (r^2, theta): r is the square
    root of the first and theta spans the window linearly in the second."""

    is_random = True

    def _polar(self, generator, dtype, device, uniforms):
        u = _uniforms(uniforms, 2, self.sample_count, generator, dtype, device)
        theta = self.theta_start + (self.theta_end - self.theta_start) * u[1]
        return torch.sqrt(u[0]), theta


class _SphereBase(BasePointDistribution):
    """Points on a sphere cap opening toward +x; ranks = (phi, theta mod 2pi)."""

    def __init__(self, angular_size, sample_count, radius=1.0,
                 theta_start=0.0, theta_end=2 * PI):
        if not 0 < angular_size <= PI / 2:
            raise ValueError("angular_size must be in (0, PI/2]")
        if sample_count <= 0:
            raise ValueError("sample_count must be > 0")
        self.angular_size = angular_size
        self.sample_count = sample_count
        self.radius = radius
        self.theta_start = theta_start
        self.theta_end = theta_end

    def _angles(self, generator, dtype, device, uniforms):
        raise NotImplementedError

    def _golden_azimuths(self, dtype, device):
        indices = torch.arange(self.sample_count, dtype=dtype,
                               device=device) + 0.5
        return GOLDEN_ANGLE * indices

    def _window_azimuths(self, u):
        return self.theta_start + (self.theta_end - self.theta_start) * u

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        phi, theta = self._angles(generator, dtype, device, uniforms)
        if not self.is_random:
            theta = _theta_mod(theta, self.theta_start, self.theta_end)
        points = self.radius * torch.stack(
            [torch.cos(phi), torch.sin(phi) * torch.cos(theta),
             torch.sin(phi) * torch.sin(theta)], dim=1)
        ranks = torch.stack([phi, torch.remainder(theta, 2 * PI)], dim=1)
        return points, ranks


class StaticUniformSphere(_SphereBase):
    """Evenly spaced cos(phi) from 1 to cos(angular_size), golden-angle
    azimuths."""

    def _angles(self, generator, dtype, device, uniforms):
        cos_phi = _linspace(1.0, math.cos(self.angular_size),
                            self.sample_count, dtype, device)
        return torch.arccos(cos_phi), self._golden_azimuths(dtype, device)


class RandomUniformSphere(_SphereBase):
    """Uniform random directions on the cap; uniforms rows: (cos phi, theta).
    The azimuth is uniform over the theta window."""

    is_random = True

    def _angles(self, generator, dtype, device, uniforms):
        u = _uniforms(uniforms, 2, self.sample_count, generator, dtype, device)
        cos_phi = _scale(u[0], math.cos(self.angular_size), 1.0)
        return torch.arccos(cos_phi), self._window_azimuths(u[1])


class StaticLambertianSphere(_SphereBase):
    """Cosine-weighted cap: evenly spaced cos^2(phi) from 1 to
    cos^2(angular_size) (the inverse CDF of cos(phi) sin(phi) dphi),
    golden-angle azimuths."""

    def _angles(self, generator, dtype, device, uniforms):
        u = _linspace(1.0, math.cos(self.angular_size) ** 2,
                      self.sample_count, dtype, device)
        return (torch.arccos(torch.sqrt(u)),
                self._golden_azimuths(dtype, device))


class RandomLambertianSphere(_SphereBase):
    """Cosine-weighted random directions on the cap; uniforms rows:
    (cos^2 phi, theta).  The azimuth is uniform over the theta window."""

    is_random = True

    def _angles(self, generator, dtype, device, uniforms):
        u = _uniforms(uniforms, 2, self.sample_count, generator, dtype, device)
        cos2 = _scale(u[0], math.cos(self.angular_size) ** 2, 1.0)
        return torch.arccos(torch.sqrt(cos2)), self._window_azimuths(u[1])


# ----------------------------------------------------------------------
# transformations
# ----------------------------------------------------------------------

def __getattr__(name):
    """Re-export the goal-building distributions (ArbitraryDistribution,
    ArbitraryBasePoints, ImageBasePoints, PrecompiledBasePoints,
    SquareRankLambertianSphere, CumulativeDensityFunction,
    flatten_distribution, transform_map) from ``models.goals``, which
    imports this module: hence the lazy lookup."""
    from tensorflowraytrace_tpu_torch.models import goals

    if hasattr(goals, name):
        return getattr(goals, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class BasePointTransformation(BasePointDistribution):
    """A base-point distribution lifted, then scaled, rotated and translated,
    in that order.  ``lift_to_3d`` places 2D points in the y-z plane;
    ``rotation`` is a quaternion (w, x, y, z) for 3D points and an angle
    for 2D ones.  The ranks are the wrapped distribution's; ``uniforms``
    pass through to it."""

    def __init__(self, distribution, scale=None, rotation=None,
                 translation=None, lift_to_3d=False):
        self.distribution = distribution
        self.scale = scale
        self.rotation = rotation
        self.translation = translation
        self.lift_to_3d = lift_to_3d
        self.is_random = distribution.is_random

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        points, ranks = self.distribution.sample(generator, dtype, device,
                                                 uniforms)
        if self.lift_to_3d and points.shape[-1] == 2:
            zeros = torch.zeros((points.shape[0], 1), dtype=points.dtype,
                                device=device)
            points = torch.cat([zeros, points], dim=1)
        if self.scale is not None:
            points = points * torch.as_tensor(self.scale, dtype=dtype,
                                              device=device)
        if self.rotation is not None:
            rotation = torch.as_tensor(self.rotation, dtype=dtype,
                                       device=device)
            if points.shape[-1] == 3:
                points = quat.rotate_vector(rotation, points)
            else:
                points = quat.rotate_2d(points, rotation)
        if self.translation is not None:
            points = points + torch.as_tensor(self.translation, dtype=dtype,
                                              device=device)
        return points, ranks
