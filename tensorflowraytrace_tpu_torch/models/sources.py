"""Sources: factories that turn distributions into RaySets.

Counterpart of ``SourceBase``, ``_Aimable`` and ``AngularSource`` in
``tensorflowraytrace_tpu/models/sources.py``.  A source crosses its domains
(angle, base_point, wavelength) into one flat ray batch: a *dense* source
takes every combination (domain order: angle, base_point, wavelength), an
un-dense one matches equally sized domains 1:1.  Each source attaches a
``rank`` field taken from its ``rank_domain``'s distribution.

``sample(generator=None, dtype=None, device=None, uniforms=None)``:
``uniforms`` maps a domain name to the (k, n) uniforms its random
distribution would otherwise draw from ``generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tensorflowraytrace_tpu_torch.config import resolve_device, resolve_dtype
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.utils import quaternion as quat

PI = math.pi
_X_AXIS = (1.0, 0.0, 0.0)


def dense_gathers(sizes, device=None):
    """Gather indices expanding per-domain tensors to their dense product.
    ``sizes``: ordered dict domain -> length.  Returns dict domain ->
    (total,) int64 index tensor."""
    order = list(sizes)
    ranges = [torch.arange(sizes[d], device=device) for d in order]
    grids = torch.meshgrid(*ranges, indexing="ij")
    return {d: g.reshape(-1) for d, g in zip(order, grids)}


def _expand(value, domain, gathers, total):
    """Expand a per-domain tensor (or scalar) to the full ray count."""
    if value.dim() == 0:
        return value.expand(total)
    if gathers is None:  # un-dense: sizes already match (or length 1)
        if value.shape[0] == 1:
            return value.expand((total,) + tuple(value.shape[1:]))
        return value
    return value[gathers[domain]]


class SourceBase:
    """Shared dense-product and extra-fields machinery.

    ``extra_fields``: ``{name: (domain, value_or_callable)}`` or
    ``{name: (domain, object, attribute)}``; domain "whole" means one value
    per ray already.
    """

    rank_domain: Optional[str] = None

    def __init__(self, dimension, wavelengths=None, dense=True, extra_fields=None):
        if dimension not in (2, 3):
            raise ValueError("Source: dimension must be 2 or 3")
        self.dimension = dimension
        self.wavelengths = wavelengths
        self.dense = dense
        self.extra_fields = dict(extra_fields or {})
        for spec in self.extra_fields.values():
            if not (isinstance(spec, tuple) and len(spec) in (2, 3)):
                raise ValueError(
                    "extra_fields entries must be (domain, value) or "
                    "(domain, object, attribute)")

    def _domain_vars(self, generator, dtype, device, uniforms):
        """Ordered ``{domain: (tensor, ranks_or_None)}``."""
        raise NotImplementedError

    def _build_rays(self, expanded, dtype):
        raise NotImplementedError

    @staticmethod
    def _resolve_extra(spec, device):
        if len(spec) == 2:
            domain, raw = spec
        else:
            domain, obj, attr = spec
            try:
                raw = obj[attr]
            except (TypeError, KeyError):
                raw = getattr(obj, attr)
        if callable(raw):
            raw = raw()
        return domain, torch.as_tensor(raw, device=device)

    def sample(self, generator=None, dtype=None, device=None,
               uniforms=None) -> RaySet:
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        if generator is None and uniforms is None:
            generator = torch.Generator(device=device).manual_seed(0)
        domain_vars = self._domain_vars(generator, dtype, device, uniforms or {})

        sizes = {d: int(arr.shape[0]) for d, (arr, _r) in domain_vars.items()}
        wl = None
        if self.wavelengths is not None:
            wl = torch.as_tensor(self.wavelengths, dtype=dtype,
                                 device=device).reshape(-1)
            sizes["wavelength"] = wl.shape[0]

        extra_resolved = {}
        for name, spec in self.extra_fields.items():
            domain, value = self._resolve_extra(spec, device)
            if value.is_floating_point():
                value = value.to(dtype)
            extra_resolved[name] = (domain, value)
            if domain not in sizes and domain != "whole":
                sizes[domain] = int(value.shape[0])

        if self.dense:
            gathers = dense_gathers(sizes, device)
            total = math.prod(sizes.values())
        else:
            gathers = None
            real = [s for s in sizes.values() if s != 1]
            if real and len(set(real)) > 1:
                raise ValueError(
                    f"un-dense source needs equal domain sizes, got {sizes}")
            total = real[0] if real else 1

        expanded = {d: _expand(arr, d, gathers, total)
                    for d, (arr, _r) in domain_vars.items()}
        p0, p1 = self._build_rays(expanded, dtype)

        fields = {}
        if self.rank_domain is not None:
            ranks = domain_vars[self.rank_domain][1]
            if ranks is not None:
                fields["rank"] = _expand(ranks, self.rank_domain, gathers, total)
        for name, (domain, value) in extra_resolved.items():
            if domain == "whole":
                fields[name] = value.expand(total) if value.dim() == 0 else value
            else:
                fields[name] = _expand(value, domain, gathers, total)

        wavelength = (_expand(wl, "wavelength", gathers, total)
                      if wl is not None else None)
        return RaySet.make(p0, p1, wavelength, fields=fields, dtype=dtype,
                           device=device)


class _Aimable(SourceBase):
    """center + central_angle aiming.  In 2D, ``central_angle`` is an angle
    in radians, added to each direction angle and rotating the base points.
    In 3D, it is a direction vector (``angle_type='vector'``, rotated from
    the +x axis) or a quaternion (``angle_type='quaternion'``)."""

    def __init__(self, dimension, center, central_angle, angle_type="vector", **kw):
        super().__init__(dimension, **kw)
        if angle_type not in ("vector", "quaternion"):
            raise ValueError("angle_type must be 'vector' or 'quaternion'")
        self.center = center
        self.angle_type = angle_type
        self.central_angle = central_angle

    def _rotation(self, dtype, device):
        ca = torch.as_tensor(self.central_angle, dtype=dtype, device=device)
        if self.angle_type == "vector":
            if ca.shape != (3,):
                raise ValueError("central_angle vector must have shape (3,)")
            return quat.quat_from_u_to_v(
                torch.tensor(_X_AXIS, dtype=dtype, device=device), ca)
        if ca.shape != (4,):
            raise ValueError("central_angle quaternion must have shape (4,)")
        return ca

    def _rotate_dirs(self, dirs, dtype):
        if self.dimension == 2:  # scalar angles
            return dirs + self.central_angle
        return quat.rotate_vector(self._rotation(dtype, dirs.device), dirs)

    def _rotate_points(self, points, dtype):
        if self.dimension == 2:
            return quat.rotate_2d(points, self.central_angle)
        if points.shape[-1] == 2:  # 2D base points in 3D: lift to the y-z plane
            zeros = torch.zeros((points.shape[0], 1), dtype=points.dtype,
                                device=points.device)
            points = torch.cat([zeros, points], dim=1)
        return quat.rotate_vector(self._rotation(dtype, points.device), points)


class AngularSource(_Aimable):
    """Rays from several base points in several directions."""

    def __init__(self, dimension, center, central_angle, angular_distribution,
                 base_point_distribution, wavelengths, start_on_base=True,
                 ray_length=1.0, angle_type="vector", rank_domain="base_point",
                 **kw):
        super().__init__(dimension, center, central_angle, angle_type,
                         wavelengths=wavelengths, **kw)
        self.angular_distribution = angular_distribution
        self.base_point_distribution = base_point_distribution
        self.start_on_base = start_on_base
        self.ray_length = ray_length
        self.rank_domain = rank_domain

    def _domain_vars(self, generator, dtype, device, uniforms):
        angles, a_ranks = self.angular_distribution.sample(
            generator, dtype, device, uniforms.get("angle"))
        points, p_ranks = self.base_point_distribution.sample(
            generator, dtype, device, uniforms.get("base_point"))
        return {"angle": (angles, a_ranks), "base_point": (points, p_ranks)}

    def _build_rays(self, expanded, dtype):
        angles = self._rotate_dirs(expanded["angle"], dtype)
        base = self._rotate_points(expanded["base_point"], dtype)
        center = torch.as_tensor(self.center, dtype=dtype, device=base.device)
        start = center + base
        if self.dimension == 2:
            direction = torch.stack([torch.cos(angles), torch.sin(angles)], dim=1)
        else:
            direction = angles
        end = start + self.ray_length * direction
        return (start, end) if self.start_on_base else (end, start)
