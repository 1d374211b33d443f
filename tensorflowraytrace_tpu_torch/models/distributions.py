"""Base-point and angle samplers for building sources.

Counterpart of the 2D angle and beam samplers and the 3D square and sphere
samplers of ``tensorflowraytrace_tpu/models/distributions.py``.  Each
sampler has one method::

    sample(generator=None, dtype=None, device=None, uniforms=None)
        -> (values, ranks)

A random sampler draws its uniforms from ``generator`` (a
``torch.Generator`` on ``device``; a fresh one seeded 0 when none is given),
or takes them ready-made as ``uniforms``, a (k, n) tensor of draws in
[0, 1).  The second path lets tests feed both packages the same numbers,
since ``jax.random`` streams cannot be reproduced in PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.config import resolve_device, resolve_dtype

PI = math.pi


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
    """Base: ``sample`` returns ``(values, ranks)``."""

    is_random = False

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        raise NotImplementedError


# ----------------------------------------------------------------------
# 2D angles (scalars) and beams
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


class StaticUniformAngularDistribution(Distribution):
    """``sample_count`` evenly spaced angles in [min_angle, max_angle]."""

    def __init__(self, min_angle, max_angle, sample_count):
        _check_angles(min_angle, max_angle, sample_count, PI)
        self.min_angle = min_angle
        self.max_angle = max_angle
        self.sample_count = sample_count

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        angles = _linspace(self.min_angle, self.max_angle, self.sample_count,
                           dtype, device)
        return angles, _uniform_angle_ranks(angles, self.min_angle,
                                            self.max_angle)


class RandomUniformAngularDistribution(StaticUniformAngularDistribution):
    """Uniform random angles in [min_angle, max_angle); uniforms rows:
    (angle,)."""

    is_random = True

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        u = _uniforms(uniforms, 1, self.sample_count, generator, dtype, device)
        angles = _scale(u[0], self.min_angle, self.max_angle)
        return angles, _uniform_angle_ranks(angles, self.min_angle,
                                            self.max_angle)


class RandomLambertianAngularDistribution(Distribution):
    """Cosine-weighted random angles: the rank sin(angle) is uniform in
    [sin(min_angle), sin(max_angle)); uniforms rows: (rank,)."""

    is_random = True

    def __init__(self, min_angle, max_angle, sample_count):
        _check_angles(min_angle, max_angle, sample_count, PI / 2)
        self.min_angle = min_angle
        self.max_angle = max_angle
        self.sample_count = sample_count

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        u = _uniforms(uniforms, 1, self.sample_count, generator, dtype, device)
        ranks = _scale(u[0], math.sin(self.min_angle), math.sin(self.max_angle))
        return torch.arcsin(ranks), ranks


class _BeamBase(Distribution):
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


# ----------------------------------------------------------------------
# 3D squares and spheres
# ----------------------------------------------------------------------


class _SquareBase(Distribution):
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


class RandomUniformSquare(_SquareBase):
    """Uniform random points in the square; uniforms rows: (x, y)."""

    is_random = True

    def _points(self, generator, dtype, device, uniforms):
        u = _uniforms(uniforms, 2, self.sample_count, generator, dtype, device)
        x = _scale(u[0], -self.x_size, self.x_size)
        y = _scale(u[1], -self.y_size, self.y_size)
        return torch.stack([x, y], dim=1)


class _SphereBase(Distribution):
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

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        phi, theta = self._angles(generator, dtype, device, uniforms)
        points = self.radius * torch.stack(
            [torch.cos(phi), torch.sin(phi) * torch.cos(theta),
             torch.sin(phi) * torch.sin(theta)], dim=1)
        ranks = torch.stack([phi, torch.remainder(theta, 2 * PI)], dim=1)
        return points, ranks


class RandomUniformSphere(_SphereBase):
    """Uniform random directions on the cap; uniforms rows: (cos phi, theta).
    The azimuth is uniform over the theta window."""

    is_random = True

    def _angles(self, generator, dtype, device, uniforms):
        u = _uniforms(uniforms, 2, self.sample_count, generator, dtype, device)
        cos_phi = _scale(u[0], math.cos(self.angular_size), 1.0)
        theta = self.theta_start + (self.theta_end - self.theta_start) * u[1]
        return torch.arccos(cos_phi), theta
