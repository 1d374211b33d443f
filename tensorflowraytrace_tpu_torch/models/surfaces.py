"""Surface sets (2D segments and arcs, 3D triangles) and the merged scenes.

Counterpart of ``tensorflowraytrace_tpu/models/surfaces.py``.  Material
references live in ``mat_in`` / ``mat_out`` (int32 indices into the
engine's material list) or in ``fields['n_in']`` / ``fields['n_out']``
(float, "value" mode).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.config import (
    OPTICAL, STOP, TARGET, resolve_device, resolve_dtype,
)


def _is_scalar(value):
    return isinstance(value, (int, np.integer))


def _as_cat(category, n, device):
    """(n,) int32 column of a scalar or per-surface value.  A scalar is
    filled on the device: a copy from the host would synchronise the stream
    every time a surface is built."""
    if _is_scalar(category):
        return torch.full((n,), int(category), dtype=torch.int32, device=device)
    return torch.as_tensor(category, dtype=torch.int32,
                           device=device).expand(n).clone()


def _as_mat(mat, n, device):
    if mat is None:
        return torch.zeros((n,), dtype=torch.int32, device=device)
    arr = _as_cat(mat, n, device)
    # the engine packs category<<20 | mat_in<<10 | mat_out into one float
    # column, which is exact only for ids in [0, 1024); a scalar id is
    # checked on the host, with no read-back from the device
    if n:
        lo, hi = ((int(mat), int(mat)) if _is_scalar(mat)
                  else (int(arr.min()), int(arr.max())))
        if lo < 0 or hi >= 1024:
            raise ValueError(
                f"material index out of range [0, 1024): got [{lo}, {hi}]; "
                "ids >= 1024 would corrupt the engine's packed surface table")
    return arr


def _device_of(value, device):
    if device is None and isinstance(value, torch.Tensor):
        device = value.device
    return resolve_device(device)


def _fields(fields, device):
    return {k: torch.as_tensor(v, device=device)
            for k, v in (fields or {}).items()}


def _concat_fields(sets):
    common = set(sets[0].fields)
    for s in sets[1:]:
        common &= set(s.fields)
    return {k: torch.cat([s.fields[k] for s in sets]) for k in common}


@dataclass
class SegmentSet:
    """2D line segments: p0/p1 (M, 2) endpoints, per-surface category and
    material ids, and extra per-surface ``fields``.  The normal angle is
    atan2(dy, dx) + pi/2 of the direction p1 - p0."""

    p0: torch.Tensor
    p1: torch.Tensor
    category: torch.Tensor
    mat_in: torch.Tensor
    mat_out: torch.Tensor
    fields: Dict[str, torch.Tensor] = field(default_factory=dict)
    # whether mat_in / mat_out were given (ids default to 0, so the arrays
    # cannot tell): the facade's signature audit reads it
    mats_specified: bool = True

    @staticmethod
    def make(p0, p1, category=OPTICAL, mat_in=None, mat_out=None, fields=None,
             dtype=None, device=None):
        dtype = resolve_dtype(dtype)
        device = _device_of(p0, device)
        p0 = torch.as_tensor(p0, dtype=dtype, device=device)
        p1 = torch.as_tensor(p1, dtype=dtype, device=device)
        m = p0.shape[0]
        return SegmentSet(
            p0=p0, p1=p1, category=_as_cat(category, m, device),
            mat_in=_as_mat(mat_in, m, device),
            mat_out=_as_mat(mat_out, m, device),
            fields=_fields(fields, device),
            mats_specified=mat_in is not None or mat_out is not None)

    @property
    def n_surfaces(self) -> int:
        return self.p0.shape[0]

    @property
    def device(self):
        return self.p0.device

    @property
    def norm_angle(self):
        d = self.p1 - self.p0
        return torch.atan2(d[:, 1], d[:, 0]) + math.pi / 2

    def __getitem__(self, key):
        """Reference-style field access: ``x_start`` ... ``y_end``,
        ``category`` (or ``catagory``), or an extra field."""
        coord = {"x_start": (self.p0, 0), "y_start": (self.p0, 1),
                 "x_end": (self.p1, 0), "y_end": (self.p1, 1)}.get(key)
        if coord is not None:
            return coord[0][:, coord[1]]
        if key in ("category", "catagory"):
            return self.category
        return self.fields[key]


@dataclass
class ArcSet:
    """2D circular arcs: ``center`` (M, 2), ``angle_start``/``angle_end``
    (M,) bounding the counter-clockwise window, ``radius`` (M,).  A negative
    radius flips the normal, not the geometry."""

    center: torch.Tensor
    angle_start: torch.Tensor
    angle_end: torch.Tensor
    radius: torch.Tensor
    category: torch.Tensor
    mat_in: torch.Tensor
    mat_out: torch.Tensor
    fields: Dict[str, torch.Tensor] = field(default_factory=dict)
    mats_specified: bool = True

    @staticmethod
    def make(center, angle_start, angle_end, radius, category=OPTICAL,
             mat_in=None, mat_out=None, fields=None, dtype=None, device=None):
        dtype = resolve_dtype(dtype)
        device = _device_of(center, device)
        center = torch.as_tensor(center, dtype=dtype, device=device)
        m = center.shape[0]

        def column(a):
            # a number is filled on the device, with no copy from the host
            if isinstance(a, (int, float)):
                return torch.full((m,), float(a), dtype=dtype, device=device)
            return torch.as_tensor(a, dtype=dtype,
                                   device=device).expand(m).contiguous()

        return ArcSet(
            center=center, angle_start=column(angle_start),
            angle_end=column(angle_end), radius=column(radius),
            category=_as_cat(category, m, device),
            mat_in=_as_mat(mat_in, m, device),
            mat_out=_as_mat(mat_out, m, device),
            fields=_fields(fields, device),
            mats_specified=mat_in is not None or mat_out is not None)

    @property
    def n_surfaces(self) -> int:
        return self.center.shape[0]

    @property
    def device(self):
        return self.center.device

    def __getitem__(self, key):
        """Reference-style field access: ``x_center``, ``y_center``,
        ``angle_start``, ``angle_end``, ``radius``, ``category`` (or
        ``catagory``), or an extra field."""
        simple = {"angle_start": self.angle_start,
                  "angle_end": self.angle_end, "radius": self.radius,
                  "category": self.category, "catagory": self.category}
        if key == "x_center":
            return self.center[:, 0]
        if key == "y_center":
            return self.center[:, 1]
        if key in simple:
            return simple[key]
        return self.fields[key]


def concat_segments(sets):
    sets = [s for s in sets if s is not None and s.n_surfaces > 0]
    if not sets:
        return None
    return SegmentSet(
        p0=torch.cat([s.p0 for s in sets]),
        p1=torch.cat([s.p1 for s in sets]),
        category=torch.cat([s.category for s in sets]),
        mat_in=torch.cat([s.mat_in for s in sets]),
        mat_out=torch.cat([s.mat_out for s in sets]),
        fields=_concat_fields(sets),
        mats_specified=any(s.mats_specified for s in sets),
    )


def concat_arcs(sets):
    sets = [s for s in sets if s is not None and s.n_surfaces > 0]
    if not sets:
        return None
    return ArcSet(
        center=torch.cat([s.center for s in sets]),
        angle_start=torch.cat([s.angle_start for s in sets]),
        angle_end=torch.cat([s.angle_end for s in sets]),
        radius=torch.cat([s.radius for s in sets]),
        category=torch.cat([s.category for s in sets]),
        mat_in=torch.cat([s.mat_in for s in sets]),
        mat_out=torch.cat([s.mat_out for s in sets]),
        fields=_concat_fields(sets),
        mats_specified=any(s.mats_specified for s in sets),
    )


def _label(sets, cat):
    """Copies of ``sets`` with every surface's category set to ``cat``."""
    return [dataclasses.replace(s, category=_as_cat(cat, s.n_surfaces,
                                                    s.device))
            for s in sets]


@dataclass
class Scene2D:
    """Merged 2D scene: every segment and every arc, each kind in the order
    optical, stops, targets.  A kind the scene lacks is ``None``."""

    segments: Optional[SegmentSet]
    arcs: Optional[ArcSet]

    @staticmethod
    def build(optical_segments=(), stop_segments=(), target_segments=(),
              optical_arcs=(), stop_arcs=(), target_arcs=()):
        segs = (_label(optical_segments, OPTICAL) + _label(stop_segments, STOP)
                + _label(target_segments, TARGET))
        arcs = (_label(optical_arcs, OPTICAL) + _label(stop_arcs, STOP)
                + _label(target_arcs, TARGET))
        return Scene2D(segments=concat_segments(segs), arcs=concat_arcs(arcs))


@dataclass
class TriangleSet:
    """3D triangles: vp/v1/v2 (M, 3) vertices, norm (M, 3) unit face normals
    (normalize(cross(v1 - vp, v2 - v1)) unless given), per-surface category
    and material ids, and extra per-surface ``fields``."""

    vp: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    norm: torch.Tensor
    category: torch.Tensor
    mat_in: torch.Tensor
    mat_out: torch.Tensor
    fields: Dict[str, torch.Tensor] = field(default_factory=dict)
    mats_specified: bool = True

    @staticmethod
    def make(vp, v1, v2, norm=None, category=OPTICAL, mat_in=None, mat_out=None,
             fields=None, dtype=None, device=None):
        dtype = resolve_dtype(dtype)
        device = _device_of(vp, device)
        vp = torch.as_tensor(vp, dtype=dtype, device=device)
        v1 = torch.as_tensor(v1, dtype=dtype, device=device)
        v2 = torch.as_tensor(v2, dtype=dtype, device=device)
        m = vp.shape[0]
        if norm is None:
            norm = compute_face_normals(vp, v1, v2)
        else:
            norm = torch.as_tensor(norm, dtype=dtype, device=device)
        return TriangleSet(
            vp=vp, v1=v1, v2=v2, norm=norm,
            category=_as_cat(category, m, device),
            mat_in=_as_mat(mat_in, m, device),
            mat_out=_as_mat(mat_out, m, device),
            fields=_fields(fields, device),
            mats_specified=mat_in is not None or mat_out is not None,
        )

    @property
    def n_surfaces(self) -> int:
        return self.vp.shape[0]

    @property
    def device(self):
        return self.vp.device

    def __getitem__(self, key):
        """Reference-style field access: ``xp`` ... ``z2`` (the vertices),
        ``norm``, ``category`` (or ``catagory``), or an extra field."""
        corners = {"p": self.vp, "1": self.v1, "2": self.v2}
        if len(key) == 2 and key[0] in "xyz" and key[1] in corners:
            return corners[key[1]][:, "xyz".index(key[0])]
        if key == "norm":
            return self.norm
        if key in ("category", "catagory"):
            return self.category
        return self.fields[key]


def compute_face_normals(vp, v1, v2):
    """Unit face normals with the reference's orientation:
    normalize(cross(v1 - vp, v2 - v1))."""
    n = torch.linalg.cross(v1 - vp, v2 - v1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def concat_triangles(sets):
    sets = [s for s in sets if s is not None and s.n_surfaces > 0]
    if not sets:
        return None
    return TriangleSet(
        vp=torch.cat([s.vp for s in sets]),
        v1=torch.cat([s.v1 for s in sets]),
        v2=torch.cat([s.v2 for s in sets]),
        norm=torch.cat([s.norm for s in sets]),
        category=torch.cat([s.category for s in sets]),
        mat_in=torch.cat([s.mat_in for s in sets]),
        mat_out=torch.cat([s.mat_out for s in sets]),
        fields=_concat_fields(sets),
        mats_specified=any(s.mats_specified for s in sets),
    )


@dataclass
class Scene3D:
    """Merged 3D scene: optical surfaces first, then stops, then targets."""

    triangles: TriangleSet

    @staticmethod
    def build(optical=(), stops=(), targets=()):
        merged = concat_triangles(_label(optical, OPTICAL) + _label(stops, STOP)
                                  + _label(targets, TARGET))
        if merged is None:
            raise ValueError("Scene3D.build: no surfaces")
        return Scene3D(triangles=merged)
