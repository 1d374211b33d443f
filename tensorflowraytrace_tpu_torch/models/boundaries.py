"""Parametric boundaries: the trainable surfaces, and static ones.

Counterpart of ``tensorflowraytrace_tpu/models/boundaries.py``.  A
parametric boundary is an ``nn.Module`` that holds its parameters and
builds its surface differentiably::

    boundary.build(params=None) -> SegmentSet / TriangleSet

``params=None`` uses the module's own ``nn.Parameter``s; passing tensors
builds from those instead.  Constraints are functional parameter
projections applied inside ``build`` (``ClipConstraint`` a clamp,
``ThicknessConstraint`` a shift by a reduction), so gradients flow
through them.  The ``manual_*_boundary`` functions build static surface
sets from raw data or an STL file.  The even-asphere surfaces take their
sag from ``ops/asphere.sag``, the model the sequential tracer shares.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from tensorflowraytrace_tpu_torch.config import (
    OPTICAL, resolve_device, resolve_dtype,
)
from tensorflowraytrace_tpu_torch.models import mesh as mt
from tensorflowraytrace_tpu_torch.models.surfaces import (
    ArcSet, SegmentSet, TriangleSet,
)
from tensorflowraytrace_tpu_torch.ops import asphere


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


class ClipConstraint(Constraint):
    """Clamp the parameters into [lower, upper]."""

    def __init__(self, lower, upper):
        super().__init__(parent="zero")
        self.lower = lower
        self.upper = upper

    def project(self, target, parent):
        return torch.clamp(target, self.lower, self.upper)


# ======================================================================
# vector generators
# ======================================================================

def _normalize_rows(v, eps=1e-12):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(n > eps, v / torch.clamp(n, min=eps), torch.zeros_like(v))


class VectorGeneratorBase:
    """The per-vertex direction field along which parameters move vertices:
    ``generate(zero) -> (V, 3)`` unit vectors, zero where undefined (on an
    axis)."""

    def generate(self, zero):
        raise NotImplementedError


class SecondSurfaceVG(VectorGeneratorBase):
    """Vectors from each zero point to the matching vertex of a second
    surface (a mesh with ``points``, an STL file name, or a (V, 3)
    array)."""

    def __init__(self, surface):
        if isinstance(surface, str):
            surface = mt.TriMesh.read(surface)
        self.points = np.asarray(getattr(surface, "points", surface))

    def generate(self, zero):
        points = torch.as_tensor(self.points, dtype=zero.dtype,
                                 device=zero.device)
        return _normalize_rows(points - zero)


class FromPointVG(VectorGeneratorBase):
    """Vectors radiating from one 3D point."""

    def __init__(self, point):
        self.point = np.asarray(point)

    def generate(self, zero):
        point = torch.as_tensor(self.point, dtype=zero.dtype,
                                device=zero.device)
        return _normalize_rows(zero - point)


class FromVectorVG(VectorGeneratorBase):
    """A constant (or per-vertex) vector field along which parameters move
    vertices."""

    def __init__(self, vector):
        self.vector = vector

    def generate(self, zero):
        v = torch.as_tensor(self.vector, dtype=zero.dtype, device=zero.device)
        return _normalize_rows(v.expand_as(zero))


class FromAxisVG(VectorGeneratorBase):
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
# manual boundaries (static geometry)
# ======================================================================

def manual_segment_boundary(segments=None, x_start=None, y_start=None,
                            x_end=None, y_end=None, dtype=None, device=None,
                            **kw) -> SegmentSet:
    """Static 2D segments from raw data: ``segments`` (N, 4) rows of
    (x_start, y_start, x_end, y_end), or the four coordinate arrays."""
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    if segments is not None:
        segments = torch.as_tensor(np.asarray(segments), dtype=dtype,
                                   device=device)
        p0, p1 = segments[:, 0:2], segments[:, 2:4]
    else:
        def col(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        p0 = torch.stack([col(x_start), col(y_start)], dim=1)
        p1 = torch.stack([col(x_end), col(y_end)], dim=1)
    return SegmentSet.make(p0, p1, dtype=dtype, device=device, **kw)


def manual_arc_boundary(x_center, y_center, angle_start, angle_end, radius,
                        dtype=None, device=None, **kw) -> ArcSet:
    """Static 2D arcs from raw data."""
    dtype, device = resolve_dtype(dtype), resolve_device(device)

    def col(a):
        return torch.as_tensor(np.atleast_1d(np.asarray(a)), dtype=dtype,
                               device=device)

    center = torch.stack([col(x_center), col(y_center)], dim=1)
    return ArcSet.make(center, angle_start, angle_end, radius, dtype=dtype,
                       device=device, **kw)


def manual_triangle_boundary(mesh=None, file_name=None, flip_norm=False,
                             dtype=None, device=None, **kw) -> TriangleSet:
    """A static triangle surface from a TriMesh, a mesh-like object
    (``mesh.as_trimesh``) or an STL file (``TriMesh.read``)."""
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    mesh = (mt.TriMesh.read(file_name) if file_name is not None
            else mt.as_trimesh(mesh))
    if flip_norm:
        mesh = mesh.flip_faces()
    vertices = torch.as_tensor(mesh.points, dtype=dtype, device=device)
    faces = torch.as_tensor(mesh.faces, dtype=torch.long, device=device)
    return TriangleSet.make(vertices[faces[:, 0]], vertices[faces[:, 1]],
                            vertices[faces[:, 2]], dtype=dtype,
                            device=device, **kw)


# ======================================================================
# parametric boundaries
# ======================================================================

def _sample_points(distribution, dtype, device):
    """A point distribution's sample (or an array of points) as a tensor."""
    if hasattr(distribution, "sample"):
        return distribution.sample(dtype=dtype, device=device)[0]
    return torch.as_tensor(np.asarray(distribution), dtype=dtype,
                           device=device)


class ParametricSegmentBoundary(nn.Module):
    """A 2D polyline whose vertices slide from the zero points towards the
    one points: vertex = zero + param * (one - zero), so params = 0 puts
    the curve through the zero points.  ``flip_norm`` reverses every
    segment (and so its normal)."""

    def __init__(self, zero_distribution, one_distribution, flip_norm=False,
                 initial_parameters=0.0, constraint: Optional[Constraint] = None,
                 mat_in=None, mat_out=None, category=OPTICAL, dtype=None,
                 device=None):
        super().__init__()
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        self.dtype = dtype
        zero = _sample_points(zero_distribution, dtype, device)
        one = _sample_points(one_distribution, dtype, device)
        if zero.shape != one.shape:
            raise ValueError("zero and one distributions must match in size")
        self.register_buffer("zero", zero)
        self.register_buffer("one", one)
        self.flip_norm = flip_norm
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

    def build(self, params=None) -> SegmentSet:
        params = self.params if params is None else params
        if self.constraint is not None:
            params = self.constraint.apply_literal(params)
        points = self.zero + params[:, None] * (self.one - self.zero)
        if self.flip_norm:
            p0, p1 = points[1:], points[:-1]
        else:
            p0, p1 = points[:-1], points[1:]
        return SegmentSet.make(p0, p1, category=self.category,
                               mat_in=self.mat_in, mat_out=self.mat_out,
                               dtype=self.dtype, device=p0.device)


class _MultiBoundary(nn.Module):
    """Several surfaces with inter-surface constraints applied in order,
    each seeing the already projected parameters of the earlier ones."""

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

    def build(self, params_list=None):
        if params_list is None:
            params_list = self.param_list()
        out = self.constrain(params_list)
        return [s.build(p) for s, p in zip(self.surfaces, out)]


def _multi_args(constraints, flip_norm, initial_parameters, material_list):
    n = len(constraints)
    if len(flip_norm) != n:
        raise ValueError("constraints and flip_norm must have equal length")
    if not isinstance(initial_parameters, (list, tuple)):
        initial_parameters = [initial_parameters] * n
    return (list(constraints), initial_parameters,
            material_list or [{}] * n)


class ParametricMultiSegmentBoundary(_MultiBoundary):
    """Several 2D polylines sharing their zero and one points, with
    inter-surface constraints: ``build(params_list=None)`` returns one
    SegmentSet per surface."""

    def __init__(self, zero_distribution, one_distribution, constraints,
                 flip_norm, initial_parameters=0.0, material_list=None,
                 category=OPTICAL, dtype=None, device=None):
        super().__init__()
        self.constraints, initial_parameters, material_list = _multi_args(
            constraints, flip_norm, initial_parameters, material_list)
        self.surfaces = nn.ModuleList([
            ParametricSegmentBoundary(
                zero_distribution, one_distribution, flip_norm=fn,
                initial_parameters=ip, category=category, dtype=dtype,
                device=device, **mat)
            for fn, ip, mat in zip(flip_norm, initial_parameters, material_list)
        ])

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


def _host_mesh(boundary, params):
    """``boundary``'s vertices at ``params`` (None: its own) and faces as a
    NumPy mesh."""
    params = boundary.params if params is None else params
    vertices = boundary.params_to_vertices(params).detach()
    return mt.TriMesh(vertices.cpu().numpy(), boundary.faces.cpu().numpy())


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
        if isinstance(zero_points, str):
            zero_points = mt.TriMesh.read(zero_points)
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
        self.params = nn.Parameter(self._full_init())

    @property
    def n_params(self) -> int:
        return self.zero.shape[0]

    def _full_init(self):
        """The initial parameters, one per vertex."""
        return torch.as_tensor(self.initial_parameters, dtype=self.dtype,
                               device=self.zero.device).expand(
                                   self.zero.shape[0]).clone()

    def init_params(self):
        return self._full_init()

    def params_to_vertices(self, params):
        return self.zero + params[:, None] * self.vectors

    def updated_mesh(self, params=None) -> mt.TriMesh:
        """The surface at ``params`` (None: the module's own) as a host mesh,
        for STL export and drawing; like ``params_to_vertices`` it applies
        no constraint."""
        return _host_mesh(self, params)

    def build(self, params=None) -> TriangleSet:
        params = self.params if params is None else params
        if self.constraint is not None:
            params = self.constraint.apply_literal(params)
        vertices = self.params_to_vertices(params)
        vp, v1, v2 = _masked_gather(vertices, self.faces, self.vertex_update_map)
        return TriangleSet.make(vp, v1, v2, category=self.category,
                                mat_in=self.mat_in, mat_out=self.mat_out,
                                dtype=self.dtype, device=vp.device)


class MasterSlaveParametricTriangleBoundary(ParametricTriangleBoundary):
    """Parameter sharing for symmetry: a few master parameters move every
    vertex through a gather.  ``filter_masters(vertices)`` (or a list)
    names the master vertices; ``attach_slaves(vertices, master,
    unclaimed)`` returns the unclaimed vertices that follow ``master``.
    The gather is built once on the host from the zero mesh."""

    def __init__(self, filter_masters, attach_slaves, zero_points,
                 vector_generator, **kw):
        super().__init__(zero_points, vector_generator, **kw)
        vertices = self.zero.detach().cpu().numpy()
        masters = list(filter_masters(vertices) if callable(filter_masters)
                       else filter_masters)
        master_index = {m: i for i, m in enumerate(masters)}
        unclaimed = set(range(vertices.shape[0])) - set(masters)
        slave_masters = {}
        for m in masters:
            slaves = attach_slaves(vertices, m, unclaimed)
            unclaimed -= set(slaves)
            for v in slaves:
                slave_masters[v] = master_index[m]
        if unclaimed:
            raise ValueError(
                f"MasterSlave: {len(unclaimed)} vertices were never attached "
                "to a master")
        self.masters = np.asarray(masters, dtype=np.int64)
        self.register_buffer("gather", torch.as_tensor(
            [master_index[i] if i in master_index else slave_masters[i]
             for i in range(vertices.shape[0])],
            dtype=torch.long, device=self.zero.device))
        self.params = nn.Parameter(self.init_params())

    @property
    def n_params(self) -> int:
        return len(self.masters)

    def init_params(self):
        return self._full_init()[torch.as_tensor(self.masters,
                                                 device=self.zero.device)]

    def params_to_vertices(self, params):
        return self.zero + params[self.gather][:, None] * self.vectors


class ParametricMultiTriangleBoundary(_MultiBoundary):
    """Several triangle surfaces sharing zero points and vector field, with
    inter-surface constraints applied in order -- the standard way to build
    a lens (front and back surface with thickness constraints)."""

    def __init__(self, zero_points, vector_generator, constraints, flip_norm,
                 initial_parameters=0.0, vertex_update_map=None,
                 material_list=None, category=OPTICAL, dtype=None, device=None):
        super().__init__()
        self.constraints, initial_parameters, material_list = _multi_args(
            constraints, flip_norm, initial_parameters, material_list)
        self.surfaces = nn.ModuleList([
            ParametricTriangleBoundary(
                zero_points, vector_generator, flip_norm=fn,
                initial_parameters=ip, vertex_update_map=vertex_update_map,
                category=category, dtype=dtype, device=device, **mat,
            )
            for fn, ip, mat in zip(flip_norm, initial_parameters, material_list)
        ])


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

    def updated_mesh(self, params=None) -> mt.TriMesh:
        """The guide at ``params`` (None: the module's own) as a host
        mesh."""
        return _host_mesh(self, params)

    def build(self, params=None) -> TriangleSet:
        params = self.params if params is None else params
        vertices = self.params_to_vertices(params)
        vp, v1, v2 = _masked_gather(vertices, self.faces, self.vertex_update_map)
        return TriangleSet.make(vp, v1, v2, category=self.category,
                                mat_in=self.mat_in, mat_out=self.mat_out,
                                dtype=self.dtype, device=vp.device)


# ======================================================================
# even-asphere surfaces
# ======================================================================

def _asphere_sag(r2, params, n_aspheric):
    """The even-asphere sag at squared radius ``r2`` of ``params = [c, k,
    a4, a6, ...]`` (curvature, conic constant, then ``n_aspheric`` even
    coefficients from r^4 on).  Delegates to ``ops/asphere.sag``, the model
    the sequential tracer intersects, so the two never drift apart."""
    return asphere.sag(r2, params[0], params[1], params[2:2 + n_aspheric])


def _perp_frame(axis):
    """A right-handed orthonormal frame (e1, e2, axis) from an axis."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    helper = np.zeros(3)
    helper[int(np.argmin(np.abs(a)))] = 1.0
    e1 = np.cross(helper, a)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(a, e1)
    return e1, e2, a


class _AsphereParams(nn.Module):
    """The few global parameters of an even asphere, ``[c, k, a4, ...]``
    (2 + n_aspheric), started at the given curvature and conic."""

    def _init_asphere(self, n_aspheric, initial_curvature, initial_conic,
                      dtype):
        self.dtype = dtype
        self.n_aspheric = int(n_aspheric)
        self.initial_curvature = initial_curvature
        self.initial_conic = initial_conic
        self.params = nn.Parameter(self.init_params())

    @property
    def n_params(self) -> int:
        return 2 + self.n_aspheric

    def init_params(self):
        p = np.zeros(self.n_params)
        p[0] = self.initial_curvature
        p[1] = self.initial_conic
        return torch.as_tensor(p, dtype=self.dtype, device=self._r2.device)

    def sag(self, r2, params):
        return _asphere_sag(r2, params, self.n_aspheric)


class ParametricAsphereBoundary(_AsphereParams):
    """A 3D rotationally symmetric even asphere with a few global
    parameters, ``params = [c, k, a4, a6, ...]``:

        sag(r) = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2)) + a4 r^4 + ...

    applied along ``axis`` over a circular mesh of ``aperture_radius``
    centred at ``vertex``.  c = 1/R, k = 0 is a sphere of radius R; k = -1
    a paraboloid, k < -1 a hyperboloid."""

    def __init__(self, vertex, axis, aperture_radius, target_edge_size,
                 n_aspheric=0, initial_curvature=0.0, initial_conic=0.0,
                 flip_norm=False, mat_in=None, mat_out=None,
                 category=OPTICAL, dtype=None, device=None):
        super().__init__()
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        base = mt.circular_mesh(aperture_radius, target_edge_size)
        if flip_norm:
            base = base.flip_faces()
        self.mesh = base
        e1, e2, a = _perp_frame(axis)
        xy = base.points[:, :2]
        self.register_buffer("_r2", torch.as_tensor(
            (xy ** 2).sum(1), dtype=dtype, device=device))
        self.register_buffer("_base", torch.as_tensor(
            np.asarray(vertex, np.float64)[None, :]
            + xy[:, :1] * e1[None, :] + xy[:, 1:2] * e2[None, :],
            dtype=dtype, device=device))
        self.register_buffer("_axis", torch.as_tensor(a, dtype=dtype,
                                                      device=device))
        self.register_buffer("faces", torch.as_tensor(
            base.faces, dtype=torch.long, device=device))
        self.mat_in = mat_in
        self.mat_out = mat_out
        self.category = category
        self._init_asphere(n_aspheric, initial_curvature, initial_conic,
                           dtype)

    def params_to_vertices(self, params):
        s = self.sag(self._r2, params)
        return self._base + s[:, None] * self._axis[None, :]

    def updated_mesh(self, params=None) -> mt.TriMesh:
        """The surface at ``params`` (None: the module's own) as a host
        mesh."""
        return _host_mesh(self, params)

    def build(self, params=None) -> TriangleSet:
        params = self.params if params is None else params
        vertices = self.params_to_vertices(params)
        vp, v1, v2 = _masked_gather(vertices, self.faces, None)
        return TriangleSet.make(vp, v1, v2, category=self.category,
                                mat_in=self.mat_in, mat_out=self.mat_out,
                                dtype=self.dtype, device=vp.device)


class ParametricAsphereSegment(_AsphereParams):
    """The 2D profile of an even asphere: a polyline of ``resolution``
    segments over ``y in [-half_aperture, half_aperture]`` at ``x =
    vertex_x + sag(|y|)``, with :class:`ParametricAsphereBoundary`'s
    parameters.  A segment's normal is its p0 -> p1 direction turned left;
    ``flip_norm`` reverses every segment."""

    def __init__(self, vertex_x, half_aperture, resolution=64, n_aspheric=0,
                 initial_curvature=0.0, initial_conic=0.0, flip_norm=False,
                 mat_in=None, mat_out=None, category=OPTICAL, dtype=None,
                 device=None):
        super().__init__()
        dtype, device = resolve_dtype(dtype), resolve_device(device)
        y = np.linspace(-half_aperture, half_aperture, resolution + 1)
        self.register_buffer("_y", torch.as_tensor(y, dtype=dtype,
                                                   device=device))
        self.register_buffer("_r2", torch.as_tensor(y * y, dtype=dtype,
                                                    device=device))
        self.register_buffer("_vertex_x", torch.as_tensor(
            vertex_x, dtype=dtype, device=device))
        self.flip_norm = flip_norm
        self.mat_in = mat_in
        self.mat_out = mat_out
        self.category = category
        self._init_asphere(n_aspheric, initial_curvature, initial_conic,
                           dtype)

    def build(self, params=None) -> SegmentSet:
        params = self.params if params is None else params
        x = self._vertex_x + self.sag(self._r2, params)
        pts = torch.stack([x, self._y], dim=1)
        p0, p1 = pts[:-1], pts[1:]
        if self.flip_norm:
            p0, p1 = p1, p0
        return SegmentSet.make(p0, p1, category=self.category,
                               mat_in=self.mat_in, mat_out=self.mat_out,
                               dtype=self.dtype, device=p0.device)
