"""Base-point and angle samplers for building sources.

Counterpart of the square and sphere samplers of
``tensorflowraytrace_tpu/models/distributions.py``.  Each sampler has one
method::

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
    does: ``max(lo, u * (hi - lo) + lo)`` in the working dtype."""
    lo = torch.tensor(lo, dtype=u.dtype, device=u.device)
    hi = torch.tensor(hi, dtype=u.dtype, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


class Distribution:
    """Base: ``sample`` returns ``(values, ranks)``."""

    is_random = False

    def sample(self, generator=None, dtype=None, device=None, uniforms=None):
        raise NotImplementedError


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
