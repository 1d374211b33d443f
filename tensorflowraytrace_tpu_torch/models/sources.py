"""Sources: factories that turn distributions into RaySets.

Counterpart of ``tensorflowraytrace_tpu/models/sources.py``.  A source
crosses its domains (angle or start_point, base_point or end_point,
wavelength) into one flat ray batch: a *dense* source takes every
combination (in that domain order), an un-dense one matches equally sized
domains 1:1.  Each source attaches a ``rank`` field taken from its
``rank_domain``'s distribution.

``sample(generator=None, dtype=None, device=None, uniforms=None)``:
``uniforms`` maps a domain name to the (k, n) uniforms its random
distribution would otherwise draw from ``generator`` (``PrecompiledSource``
takes its indices and normal draws the same way).  The domains are sampled
before the extra fields are resolved, so an extra field read from a
distribution (a circle's ``polar_ranks``) comes from the same draw as the
rays.
"""

from __future__ import annotations

import math
import pickle
from typing import Optional

import numpy as np
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

    def snapshot(self, generator=None, dtype=None, device=None):
        """A reference-style dict of one sample: ``{key: rays[key]}`` over
        ``RaySet.keys()``."""
        rays = self.sample(generator, dtype, device)
        return {k: rays[k] for k in rays.keys()}


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


class PointSource(_Aimable):
    """Rays from (or, with ``start_on_center=False``, converging to) one
    point.  In 2D the angular distribution gives scalar angles; in 3D unit
    direction vectors (a sphere distribution)."""

    rank_domain = "angle"

    def __init__(self, dimension, center, central_angle, angular_distribution,
                 wavelengths, start_on_center=True, ray_length=1.0,
                 angle_type="vector", **kw):
        super().__init__(dimension, center, central_angle, angle_type,
                         wavelengths=wavelengths, **kw)
        self.angular_distribution = angular_distribution
        self.start_on_center = start_on_center
        self.ray_length = ray_length

    def _domain_vars(self, generator, dtype, device, uniforms):
        angles, ranks = self.angular_distribution.sample(
            generator, dtype, device, uniforms.get("angle"))
        return {"angle": (angles, ranks)}

    def _build_rays(self, expanded, dtype):
        angles = self._rotate_dirs(expanded["angle"], dtype)
        center = torch.as_tensor(self.center, dtype=dtype, device=angles.device)
        start = center.expand(angles.shape[0], self.dimension).contiguous()
        if self.dimension == 2:
            direction = torch.stack([torch.cos(angles), torch.sin(angles)], dim=1)
        else:
            direction = angles
        end = start + self.ray_length * direction
        return (start, end) if self.start_on_center else (end, start)


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


class AperatureSource(SourceBase):
    """Rays from the points of one distribution to those of another, with
    no centre or rotation; 2D points are lifted into the y-z plane for a 3D
    source.  ``uniforms`` is keyed ``"start_point"`` and ``"end_point"``.
    (The reference's spelling.)"""

    def __init__(self, dimension, start_point_distribution,
                 end_point_distribution, wavelengths, rank_domain="start_point",
                 **kw):
        super().__init__(dimension, wavelengths=wavelengths, **kw)
        self.start_point_distribution = start_point_distribution
        self.end_point_distribution = end_point_distribution
        self.rank_domain = rank_domain

    def _lift(self, points):
        if self.dimension == 3 and points.shape[-1] == 2:
            zeros = torch.zeros((points.shape[0], 1), dtype=points.dtype,
                                device=points.device)
            return torch.cat([zeros, points], dim=1)
        return points

    def _domain_vars(self, generator, dtype, device, uniforms):
        s_points, s_ranks = self.start_point_distribution.sample(
            generator, dtype, device, uniforms.get("start_point"))
        e_points, e_ranks = self.end_point_distribution.sample(
            generator, dtype, device, uniforms.get("end_point"))
        return {"start_point": (self._lift(s_points), s_ranks),
                "end_point": (self._lift(e_points), e_ranks)}

    def _build_rays(self, expanded, dtype):
        return expanded["start_point"], expanded["end_point"]


class PrecompiledSource(SourceBase):
    """A cache of annotated rays, resampled at every ``sample``:
    ``sample_count`` rays drawn with replacement (``do_downsample``), their
    start and end points optionally jittered by Gaussian noise of the given
    per-axis deviations.

    Build it from a RaySet, another source (sampled once with a generator
    seeded 0) or a pickle file, which holds a dict of NumPy arrays (``p0``,
    ``p1``, ``wavelength``, ``fields``): the JAX package's layout, so a file
    saved by either package loads in the other.  Load only files this
    program or a trusted one wrote: unpickling can run code.

    ``uniforms``: ready-made draws in place of the generator's, a dict with
    ``"index"`` (``sample_count`` integer indices), ``"start"`` and
    ``"end"`` (standard normals shaped like the sampled p0 and p1).
    """

    def __init__(self, dimension, arg=None, sample_count=100,
                 do_downsample=True, start_perturbation=None,
                 end_perturbation=None):
        super().__init__(dimension, dense=False)
        self.sample_count = sample_count
        self.do_downsample = do_downsample
        self.start_perturbation = start_perturbation
        self.end_perturbation = end_perturbation
        self._data = None
        if isinstance(arg, str):
            with open(arg, "rb") as f:
                self._data = pickle.load(f)
        elif isinstance(arg, RaySet):
            self.from_rays(arg)
        elif arg is not None and hasattr(arg, "sample"):
            self.from_rays(arg.sample())

    def from_rays(self, rays: RaySet):
        """Take ``rays`` (e.g. a trace's output) as the cache."""

        def host(t):
            return t.detach().cpu().numpy()

        self._data = {
            "p0": host(rays.p0), "p1": host(rays.p1),
            "wavelength": host(rays.wavelength),
            "fields": {k: host(v) for k, v in rays.fields.items()},
        }
        return self

    def save(self, filename):
        with open(filename, "wb") as f:
            pickle.dump(self._data, f, pickle.HIGHEST_PROTOCOL)

    def sample(self, generator=None, dtype=None, device=None,
               uniforms=None) -> RaySet:
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        if self._data is None:
            raise ValueError("PrecompiledSource: no ray data loaded")
        draws = uniforms or {}
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)

        def tensor(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        p0, p1 = tensor(self._data["p0"]), tensor(self._data["p1"])
        wl = tensor(self._data["wavelength"])
        fields = {k: tensor(v, None) for k, v in self._data["fields"].items()}
        if self.do_downsample:
            idx = draws.get("index")
            idx = (torch.randint(0, p0.shape[0], (self.sample_count,),
                                 generator=generator, device=device)
                   if idx is None else tensor(idx, torch.long))
            p0, p1, wl = p0[idx], p1[idx], wl[idx]
            fields = {k: v[idx] for k, v in fields.items()}

        def jitter(points, deviation, key):
            if deviation is None:
                return points
            noise = draws.get(key)
            noise = (torch.randn(points.shape, generator=generator, dtype=dtype,
                                 device=device)
                     if noise is None else tensor(noise))
            return points + noise * tensor(deviation).expand(points.shape[1])

        p0 = jitter(p0, self.start_perturbation, "start")
        p1 = jitter(p1, self.end_perturbation, "end")
        return RaySet.make(p0, p1, wl, fields=fields, dtype=dtype, device=device)


class ManualSource(SourceBase):
    """A source of given rays."""

    def __init__(self, dimension, p0, p1, wavelengths=None, fields=None):
        super().__init__(dimension, wavelengths=wavelengths, dense=False)
        self._p0 = p0
        self._p1 = p1
        self._fields = dict(fields or {})

    def sample(self, generator=None, dtype=None, device=None,
               uniforms=None) -> RaySet:
        return RaySet.make(self._p0, self._p1, self.wavelengths,
                           fields=self._fields, dtype=resolve_dtype(dtype),
                           device=resolve_device(device))
