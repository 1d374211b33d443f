"""Parametric triangle boundaries: the trainable surfaces.

Counterpart of the triangle-mesh boundaries of
``tensorflowraytrace_tpu/models/boundaries.py``.  A boundary is an
``nn.Module`` that holds its parameters (one per mesh vertex) and builds its
surface differentiably::

    boundary.build(params=None) -> TriangleSet

``params=None`` uses the module's own ``nn.Parameter``s; passing tensors
builds from those instead.  Constraints are functional parameter
projections applied inside ``build``, so gradients flow through them.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from tensorflowraytrace_tpu_torch.config import (
    OPTICAL, resolve_device, resolve_dtype,
)
from tensorflowraytrace_tpu_torch.models import mesh as mt
from tensorflowraytrace_tpu_torch.models.surfaces import TriangleSet


# ======================================================================
# constraints (functional parameter projections)
# ======================================================================

class Constraint:
    """Base projection.  ``parent`` selects what the constraint is relative
    to: 'prev' (the previous surface of a multi-boundary, zero for the
    first), 'zero', 'literal' (explicit parent params), or an int index into
    the multi-boundary's surfaces."""

    def __init__(self, parent="prev"):
        if isinstance(parent, int):
            if parent < 0:
                raise ValueError("Constraint: integer parent must be >= 0")
        elif parent not in ("prev", "zero", "literal"):
            raise ValueError("Constraint: parent must be 'prev', 'zero', "
                             "'literal', or an int")
        self.parent = parent

    def _parent_params(self, index, params_list, target_params):
        if self.parent == "zero":
            return torch.zeros_like(target_params)
        if self.parent == "prev":
            if index == 0:
                return torch.zeros_like(target_params)
            return params_list[index - 1]
        if self.parent == "literal":
            raise ValueError("'literal' constraints must be applied via "
                             "apply_literal(target, parent)")
        return params_list[self.parent]

    def project(self, target_params, parent_params):
        raise NotImplementedError

    def apply(self, index, params_list):
        """Project surface ``index``'s params within a multi-boundary."""
        target = params_list[index]
        return self.project(target, self._parent_params(index, params_list, target))

    def apply_literal(self, target_params, parent_params=None):
        if parent_params is None:
            parent_params = torch.zeros_like(target_params)
        return self.project(target_params, parent_params)


class NoConstraint(Constraint):
    def project(self, target, parent):
        return target


class PointConstraint(Constraint):
    """Fix the parameter-space distance between one vertex of the target
    and one of the parent."""

    def __init__(self, distance, target_vertex, parent_vertex=None, **kw):
        super().__init__(**kw)
        self.distance = distance
        self.target_vertex = target_vertex
        self.parent_vertex = (target_vertex if parent_vertex is None
                              else parent_vertex)

    def project(self, target, parent):
        diff = parent[self.parent_vertex] - target[self.target_vertex] + self.distance
        return target + diff


class ThicknessConstraint(Constraint):
    """Fix the min ('min' mode) or max distance between the surfaces; 'min'
    keeps the target from clipping through its parent."""

    def __init__(self, distance, mode, **kw):
        super().__init__(**kw)
        if mode not in ("min", "max"):
            raise ValueError("ThicknessConstraint: mode must be 'min' or 'max'")
        self.distance = distance
        self.mode = mode

    def project(self, target, parent):
        reduce_fn = torch.max if self.mode == "min" else torch.min
        diff = reduce_fn(parent - target) + self.distance
        return target + diff


# ======================================================================
# vector generators
# ======================================================================

def _normalize_rows(v, eps=1e-12):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(n > eps, v / torch.clamp(n, min=eps), torch.zeros_like(v))


class FromVectorVG:
    """A constant (or per-vertex) vector field along which parameters move
    vertices."""

    def __init__(self, vector):
        self.vector = vector

    def generate(self, zero):
        v = torch.as_tensor(self.vector, dtype=zero.dtype, device=zero.device)
        return _normalize_rows(v.expand_as(zero))


class FromAxisVG:
    """Vectors radiating perpendicular from an axis line through ``first``
    (towards ``point``, or along ``direction``); zero for points on the
    axis, such as a cylinder's cap centres."""

    def __init__(self, first, point=None, direction=None):
        self.axis_point = np.asarray(first, dtype=np.float64)
        if point is not None:
            axis = np.asarray(point, dtype=np.float64) - self.axis_point
        elif direction is not None:
            axis = np.asarray(direction, dtype=np.float64)
        else:
            raise ValueError("FromAxisVG: provide 'point' or 'direction'")
        self.axis = axis / np.linalg.norm(axis)

    def generate(self, zero):
        ap = torch.as_tensor(self.axis_point, dtype=zero.dtype, device=zero.device)
        ax = torch.as_tensor(self.axis, dtype=zero.dtype, device=zero.device)
        d = torch.sum((zero - ap) * ax, dim=1, keepdim=True)
        return _normalize_rows(zero - (ap + ax * d))


# ======================================================================
# parametric boundaries
# ======================================================================

def _masked_gather(vertices, faces, update_map):
    """Gather face-corner points; corners a face may not move (the vertex
    update map) contribute their value but no gradient."""
    corners = []
    for k in range(3):
        pts = vertices[faces[:, k]]
        if update_map is not None:
            pts = torch.where(update_map[:, k][:, None], pts, pts.detach())
        corners.append(pts)
    return corners


class ParametricTriangleBoundary(nn.Module):
    """A triangle-mesh surface: vertex v = zero_v + param_v * vector_v.
    The optional vertex_update_map limits which faces' gradients reach
    which vertices."""

    def __init__(self, zero_points, vector_generator, flip_norm=False,
                 initial_parameters=0.0, vertex_update_map=None,
                 constraint: Optional[Constraint] = None,
                 mat_in=None, mat_out=None, category=OPTICAL, dtype=None,
                 device=None):
        super().__init__()
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        self.dtype = dtype
        mesh = mt.as_trimesh(zero_points).copy()
        if flip_norm:
            mesh = mesh.flip_faces()
            if vertex_update_map is not None:
                vertex_update_map = np.take(np.asarray(vertex_update_map),
                                            [2, 1, 0], axis=1)
        self.mesh = mesh
        self.register_buffer(
            "zero", torch.as_tensor(mesh.points, dtype=dtype, device=device))
        self.register_buffer(
            "faces", torch.as_tensor(mesh.faces, dtype=torch.long, device=device))
        self.register_buffer(
            "vectors", vector_generator.generate(self.zero).to(dtype))
        self.register_buffer(
            "vertex_update_map",
            None if vertex_update_map is None else
            torch.as_tensor(vertex_update_map, dtype=torch.bool, device=device))
        self.initial_parameters = initial_parameters
        self.constraint = constraint
        self.mat_in = mat_in
        self.mat_out = mat_out
        self.category = category
        self.params = nn.Parameter(self.init_params())

    @property
    def n_params(self) -> int:
        return self.zero.shape[0]

    def init_params(self):
        return torch.as_tensor(self.initial_parameters, dtype=self.dtype,
                               device=self.zero.device).expand(
                                   self.n_params).clone()

    def params_to_vertices(self, params):
        return self.zero + params[:, None] * self.vectors

    def build(self, params=None) -> TriangleSet:
        params = self.params if params is None else params
        if self.constraint is not None:
            params = self.constraint.apply_literal(params)
        vertices = self.params_to_vertices(params)
        vp, v1, v2 = _masked_gather(vertices, self.faces, self.vertex_update_map)
        return TriangleSet.make(vp, v1, v2, category=self.category,
                                mat_in=self.mat_in, mat_out=self.mat_out,
                                dtype=self.dtype, device=vp.device)


class ParametricMultiTriangleBoundary(nn.Module):
    """Several triangle surfaces sharing zero points and vector field, with
    inter-surface constraints applied in order -- the standard way to build
    a lens (front and back surface with thickness constraints)."""

    def __init__(self, zero_points, vector_generator, constraints, flip_norm,
                 initial_parameters=0.0, vertex_update_map=None,
                 material_list=None, category=OPTICAL, dtype=None, device=None):
        super().__init__()
        n = len(constraints)
        if len(flip_norm) != n:
            raise ValueError("constraints and flip_norm must have equal length")
        if not isinstance(initial_parameters, (list, tuple)):
            initial_parameters = [initial_parameters] * n
        material_list = material_list or [{}] * n
        self.constraints = list(constraints)
        self.surfaces = nn.ModuleList([
            ParametricTriangleBoundary(
                zero_points, vector_generator, flip_norm=fn,
                initial_parameters=ip, vertex_update_map=vertex_update_map,
                category=category, dtype=dtype, device=device, **mat,
            )
            for fn, ip, mat in zip(flip_norm, initial_parameters, material_list)
        ])

    @property
    def surface_count(self):
        return len(self.surfaces)

    def init_params(self):
        return [s.init_params() for s in self.surfaces]

    def param_list(self):
        """The module's own parameters, one tensor per surface."""
        return [s.params for s in self.surfaces]

    def constrain(self, params_list):
        out = list(params_list)
        for i, c in enumerate(self.constraints):
            out[i] = c.apply(i, out)
        return out

    def build(self, params_list=None) -> List[TriangleSet]:
        if params_list is None:
            params_list = self.param_list()
        out = self.constrain(params_list)
        return [s.build(p) for s, p in zip(self.surfaces, out)]


class ParametricCylindricalGuide(nn.Module):
    """A closed cylinder-like light guide whose radius profile is trainable.
    Parameters are the radius above ``minimum_radius`` (one per ring with
    ``rotationally_symmetric``, else one per ring point); ``build`` first
    subtracts their minimum, so the narrowest point always sits at the
    minimum radius.  The cap centres get no parameter and stay put.

    It makes its own mesh (``mesh.cylindrical_mesh``), moves vertices along
    ``FromAxisVG`` vectors, and keeps the vertex update map and the
    gradient ``accumulator`` (numpy) of ``mesh_parametrization_tools``
    seeded at the start point.  ``initial_taper=(t0, t1)`` starts the
    parameters on a linear ramp from the first ring to the last."""

    def __init__(self, start, end, minimum_radius, theta_res=6, z_res=8,
                 start_cap=True, end_cap=True, rotationally_symmetric=False,
                 initial_parameters=0.0, initial_taper=None, use_twist=False,
                 use_vertex_update_map=True, mat_in=None, mat_out=None,
                 category=OPTICAL, dtype=None, device=None):
        super().__init__()
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        self.dtype = dtype
        self.mesh = mt.cylindrical_mesh(
            start, end, radius=minimum_radius, theta_res=theta_res,
            z_res=z_res, start_cap=start_cap, end_cap=end_cap,
            use_twist=use_twist)
        self.theta_res = theta_res
        self.z_res = z_res
        self.start_cap = start_cap
        self.end_cap = end_cap
        self.rotationally_symmetric = rotationally_symmetric
        self.register_buffer(
            "zero", torch.as_tensor(self.mesh.points, dtype=dtype, device=device))
        self.register_buffer(
            "faces", torch.as_tensor(self.mesh.faces, dtype=torch.long,
                                     device=device))
        self.register_buffer(
            "vectors", FromAxisVG(start, point=end).generate(self.zero))
        vum, self.accumulator = mt.mesh_parametrization_tools(
            self.mesh, mt.get_closest_point(self.mesh, start))
        self.register_buffer(
            "vertex_update_map",
            torch.as_tensor(vum, dtype=torch.bool, device=device)
            if use_vertex_update_map else None)
        self.mat_in = mat_in
        self.mat_out = mat_out
        self.category = category

        size = z_res if rotationally_symmetric else z_res * theta_res
        if initial_taper is not None:
            try:
                t0, t1 = initial_taper
            except (TypeError, ValueError) as e:
                raise ValueError("initial_taper must be a 2-tuple") from e
            initial = np.linspace(t0, t1, z_res)
            if not rotationally_symmetric:
                initial = np.repeat(initial, theta_res)
        else:
            initial = np.broadcast_to(
                np.asarray(initial_parameters, np.float64), (size,))
        self.register_buffer(
            "_initial", torch.as_tensor(np.array(initial), dtype=dtype,
                                        device=device))
        self.params = nn.Parameter(self.init_params())

    @property
    def n_params(self) -> int:
        return self._initial.shape[0]

    def init_params(self):
        return self._initial.clone()

    def _expand_params(self, params):
        """The min-radius projection, the symmetry expansion and a zero for
        each cap centre."""
        params = params - torch.min(params)
        if self.rotationally_symmetric:
            params = params.repeat_interleave(self.theta_res)
        pads = (1 if self.start_cap else 0, 1 if self.end_cap else 0)
        return torch.nn.functional.pad(params, pads)

    def params_to_vertices(self, params):
        return self.zero + self._expand_params(params)[:, None] * self.vectors

    def build(self, params=None) -> TriangleSet:
        params = self.params if params is None else params
        vertices = self.params_to_vertices(params)
        vp, v1, v2 = _masked_gather(vertices, self.faces, self.vertex_update_map)
        return TriangleSet.make(vp, v1, v2, category=self.category,
                                mat_in=self.mat_in, mat_out=self.mat_out,
                                dtype=self.dtype, device=vp.device)
