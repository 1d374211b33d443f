"""The stateful facade: OpticalSystem2D / OpticalSystem3D, OpticalEngine
and SGD_Optimizer.

Counterpart of ``tensorflowraytrace_tpu/system.py`` (the reference's
object API, engine.py and optimizer.py).  The trace is functional
(``models/surfaces.py`` + ``engine.py``); this module wraps it in the
reference's stateful idiom, so that its scripts translate almost line for
line::

    system = OpticalSystem2D()          # on the card unless device= says
    system.optical_arcs = [my_parametric_arc_or_ArcSet]
    system.sources = [my_source]
    system.target_segments = [target_set]
    system.materials = [{"n": materials.vacuum}, {"n": materials.acrylic}]

    engine = OpticalEngine(2, simple_ray_inheritance={"wavelength"})
    engine.optical_system = system
    system.update()
    engine.validate_system()
    engine.ray_trace(max_iterations=6)
    engine.finished_rays                # compacted RaySet

Boundary entries may be surface sets (SegmentSet / ArcSet / TriangleSet),
parametric boundaries (objects with ``build`` and ``init_params``) or
callables returning a surface set.  A parametric boundary's current parameters are the
facade's state: a boundary of ``models/boundaries.py`` (an ``nn.Module``)
keeps them in its own ``nn.Parameter``s, any other object in a
``parameters`` attribute, as in the JAX package.

Where the port departs from the JAX facade:

* The system lives on one device, ``config.resolve_device(device)``: the
  card unless the CPU is asked for.  Its surface sets, source samples and
  the rays it is given are moved there.
* The system's key stream becomes one ``torch.Generator`` on that device,
  seeded from ``seed``: ``update()`` re-samples the random sources from
  it, and ``make_loss`` returns ``loss(params, generator)``, the
  convention of ``optim.Optimizer``.
* ``ray_trace`` calls ``engine.trace`` directly, without autograd.  The
  JAX package caches a jitted trace per (materials, config, reaction) to
  spare XLA its recompiles; there is nothing to compile here, so
  ``OpticalEngine(jit=...)`` is accepted for the same signature and
  changes nothing.
* ``trace_config`` starts from ``TraceConfig.recommended`` on the system's
  device, and ``trace_overrides`` take the port's field names
  (``use_kernel``, not ``use_pallas``).  A float64 system keeps the plain
  searches (``use_kernel=False, cull=False, resort_rays=False``): the
  JAX facade keeps float64 systems off its Pallas kernels, and so does
  this one, though K1, K3, K5 and K6 have float64 instances.

Two faults of the JAX facade are not copied:

* its ``make_loss`` rebuilds a parametric boundary without the
  ``mat_in`` / ``mat_out`` overrides and extra fields annotated on its
  entry (``entry["mat_in"] = ...``, ``annotation_helper``), so its loss
  traced another system than ``ray_trace`` does; here both apply them;
* its ``make_loss`` calls ``sample`` on every source object, though a
  source entry may be a callable returning rays (which ``update()``
  accepts): here the loss calls it, as ``update()`` does.
"""

from __future__ import annotations

import collections.abc as _abc
import dataclasses
from typing import List

import torch
from torch import nn

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.config import resolve_dtype
from tensorflowraytrace_tpu_torch.engine import (
    TraceConfig, default_reaction, trace,
)
from tensorflowraytrace_tpu_torch.models.rays import RaySet, concat_rays
from tensorflowraytrace_tpu_torch.models.surfaces import (
    ArcSet, Scene2D, Scene3D, SegmentSet, TriangleSet, _as_mat,
    concat_arcs, concat_segments, concat_triangles,
)
from tensorflowraytrace_tpu_torch.ops import intersect as isect
from tensorflowraytrace_tpu_torch.parallel.sharding import _map_tensors
from tensorflowraytrace_tpu_torch.update import RecursivelyUpdatable


class ReadOnlySet(_abc.Mapping):
    """Immutable mapping view over a field set (iteration, ``len``, ``in``
    and ``items`` work)."""

    def __init__(self, fields):
        self._fields = dict(fields)

    def __getitem__(self, key):
        if key not in self._fields:
            raise KeyError(
                f"{key!r} is not carried by this set (available: "
                f"{sorted(map(str, self._fields))})")
        return self._fields[key]

    def __iter__(self):
        return iter(self._fields)

    def __len__(self):
        return len(self._fields)

    def __bool__(self):
        return bool(self._fields)


def amalgamate(stuff, signature=None):
    """Concatenate field sets along the element axis on their shared (or
    the given) signature; empty sets are skipped, and an all-empty input
    gives ``{}``."""
    nonempty = [s for s in stuff if bool(s)]
    if not nonempty:
        return {}
    if not signature:
        signature = set.intersection(*(set(s.keys()) for s in nonempty))
    return {f: torch.cat([torch.as_tensor(s[f]) for s in nonempty])
            for f in signature}


def recursive_dict_key_print(tree, spacer="", _print=print):
    """Print the key structure of a nested dict, with the shapes of the
    leaves that have one (a debugging aid)."""
    if not isinstance(tree, dict):
        return
    for key, value in tree.items():
        shape = getattr(value, "shape", None)
        _print(spacer, f"{key} : {tuple(shape)}" if shape is not None else key)
        recursive_dict_key_print(value, spacer + "    ", _print)


def annotation_helper(parent, field, value, valid_shape_field, dtype=None):
    """Keep ``parent[field]`` annotated with ``value`` broadcast to the
    shape of ``parent[valid_shape_field]``, re-applied on every update.
    ``parent`` supports item assignment and has a ``post_update_handles``
    list (a boundary entry of a system).  A callable ``value`` is called
    as ``value(shape, dtype)``."""
    if callable(value):
        def f():
            shape = tuple(parent[valid_shape_field].shape)
            parent[field] = value(shape, dtype)
    else:
        def f():
            like = parent[valid_shape_field]
            parent[field] = torch.as_tensor(
                value, dtype=dtype, device=like.device).expand(like.shape)
    parent.post_update_handles.append(f)
    f()


def _on(obj, device):
    """A surface or ray set with every tensor on ``device``."""
    return _map_tensors(lambda t: t.to(device), obj)


def _is_parametric(obj):
    return hasattr(obj, "build") and hasattr(obj, "init_params")


def _current_params(obj):
    """A parametric boundary's current parameters: an ``nn.Module``'s own
    (one tensor, or a list for a multi-boundary), else its ``parameters``
    attribute, set from ``init_params()`` on first use."""
    if isinstance(obj, nn.Module):
        return obj.param_list() if hasattr(obj, "param_list") else obj.params
    if getattr(obj, "parameters", None) is None:
        obj.parameters = obj.init_params()
    return obj.parameters


def _store_params(obj, params):
    """Make ``params`` a parametric boundary's current parameters."""
    if isinstance(obj, nn.Module):
        own = obj.param_list() if hasattr(obj, "param_list") else [obj.params]
        new = params if isinstance(params, (list, tuple)) else [params]
        with torch.no_grad():
            for p, v in zip(own, new):
                p.copy_(v)
    elif isinstance(params, (list, tuple)):
        obj.parameters = [p.detach().clone() for p in params]
    else:
        obj.parameters = params.detach().clone()


def _merge(built):
    """A parametric boundary's result as one surface set (a multi-boundary builds a
    list of them)."""
    if not isinstance(built, list):
        return built
    if isinstance(built[0], SegmentSet):
        return concat_segments(built)
    if isinstance(built[0], ArcSet):
        return concat_arcs(built)
    return concat_triangles(built)


class _BoundaryEntry(RecursivelyUpdatable):
    """One boundary of a system: a surface set, parametric boundary or
    callable, rebuilt on update, with material overrides and extra
    per-surface fields applied on top."""

    def __init__(self, obj, system):
        self._obj = obj
        self._system = system
        self._extra = {}           # extra per-surface fields
        self._mat_overrides = {}   # mat_in / mat_out reassignments
        self._set = None
        super().__init__()
        self._update()

    def _annotated(self, surface):
        """``surface`` with this entry's material overrides and extra
        fields."""
        replacements = {}
        n = surface.n_surfaces
        for key, value in self._mat_overrides.items():
            replacements[key] = _as_mat(value, n, surface.device)
        if self._extra:
            replacements["fields"] = {**surface.fields, **self._extra}
        return dataclasses.replace(surface, **replacements) \
            if replacements else surface

    def _update(self):
        obj = self._obj
        with torch.no_grad():
            if isinstance(obj, (SegmentSet, ArcSet, TriangleSet)):
                built = obj
            elif _is_parametric(obj):
                built = obj.build(_current_params(obj))
            elif callable(obj):
                built = obj()
            else:
                raise TypeError(f"cannot interpret boundary object {obj!r}")
        self._set = self._annotated(_on(_merge(built), self._system.device))

    @property
    def surface_set(self):
        return self._set

    def __getitem__(self, key):
        return self._set[key]

    def feed_segments(self, segments):
        """Re-feed a manual segment boundary with rows of
        ``(x_start, y_start, x_end, y_end)`` (the reference's
        ``ManualSegmentBoundary.feed_segments``).  Material overrides and
        extra fields re-apply; call ``system.update()`` afterwards to
        rebuild the merged scene."""
        system = self._system
        seg = torch.as_tensor(segments, dtype=system.dtype,
                              device=system.device).reshape(-1, 4)
        self._obj = SegmentSet.make(seg[:, :2], seg[:, 2:], dtype=system.dtype,
                                    device=system.device)
        self._update()

    def __setitem__(self, key, value):
        value = torch.as_tensor(value, device=self._system.device)
        if key in ("mat_in", "mat_out"):
            self._mat_overrides[key] = value
        else:
            self._extra[key] = value
        self._set = self._annotated(self._set)


def _sample_source(obj, generator, dtype, device):
    """Rays of one source entry: a RaySet itself, a source's sample from
    ``generator``, or a callable's result."""
    if isinstance(obj, RaySet):
        rays = obj
    elif hasattr(obj, "sample"):
        rays = obj.sample(generator, dtype=dtype, device=device)
    elif callable(obj):
        rays = obj()
    else:
        raise TypeError(f"cannot interpret source object {obj!r}")
    return _on(rays, device)


class _SourceEntry(RecursivelyUpdatable):
    """One source of a system: a source (``sample(generator, ...)``), a
    RaySet or a callable returning one."""

    def __init__(self, obj, system):
        self._obj = obj
        self._system = system
        self._rays = None
        super().__init__()
        self._update()

    def _update(self):
        system = self._system
        self._rays = _sample_source(self._obj, system.generator, system.dtype,
                                    system.device)

    @property
    def rays(self):
        return self._rays


class OpticalSystemBase(RecursivelyUpdatable):
    """Sources, boundaries, materials and the trace epsilons of a system,
    on one device, with the generator its random sources draw from."""

    def __init__(self, intersect_epsilion=None, size_epsilion=None,
                 ray_start_epsilion=None, dtype=None, seed=0, device=None,
                 **kwargs):
        self.dtype = resolve_dtype(dtype)
        self.device = config.resolve_device(device)
        self.intersect_epsilion = intersect_epsilion
        self.size_epsilion = size_epsilion
        self.ray_start_epsilion = ray_start_epsilion
        self.materials = []
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._source_entries: List[_SourceEntry] = []
        super().__init__(**kwargs)

    @property
    def sources(self):
        if not self._source_entries:
            return None
        if len(self._source_entries) == 1:
            return self._source_entries[0].rays
        return concat_rays([e.rays for e in self._source_entries])

    @sources.setter
    def sources(self, new):
        self._source_entries = [_SourceEntry(s, self) for s in new]

    @property
    def materials(self):
        return self._materials

    @materials.setter
    def materials(self, val):
        if not isinstance(val, list):
            raise TypeError("materials must be a list")
        self._materials = val

    def material_callables(self):
        return tuple(m["n"] if isinstance(m, dict) else m
                     for m in self._materials)

    def _entries(self, objs):
        return [_BoundaryEntry(o, self) for o in objs]

    def _intersect_epsilons(self):
        """(intersect, size, ray_start) epsilons with the system's overrides
        applied, defaulting by dtype as the trace does."""
        cfg = TraceConfig(
            intersect_epsilon=self.intersect_epsilion,
            size_epsilon=self.size_epsilion,
            ray_start_epsilon=self.ray_start_epsilion,
        )
        return cfg.epsilons(self.dtype)

    def _intersect_rays(self, rays):
        if rays is None:
            rays = self.sources
        if rays is None:
            raise ValueError("intersect: no rays given and the system has "
                             "no sources")
        return _on(rays, self.device)

    def _update_entries(self):
        for e in self._all_entries():
            e.update()
        for e in self._source_entries:
            e.update()

    def _all_entries(self):
        raise NotImplementedError

    @property
    def scene(self):
        if self._scene is None:
            self.update()
        return self._scene


def _boundary_list_property(name):
    """A boundary-list property (optical_segments, stop_arcs, ...)."""

    def getter(self):
        return getattr(self, "_" + name)

    def setter(self, objs):
        setattr(self, "_" + name, self._entries(objs))

    return property(getter, setter)


_ROLES_2D = ("optical_segments", "stop_segments", "target_segments",
             "optical_arcs", "stop_arcs", "target_arcs")
_ROLES_3D = ("optical", "stops", "targets")


class OpticalSystem2D(OpticalSystemBase):
    """Six boundary lists (optical / stop / target x segments / arcs)
    merged into a Scene2D."""

    optical_segments = _boundary_list_property("optical_segments")
    stop_segments = _boundary_list_property("stop_segments")
    target_segments = _boundary_list_property("target_segments")
    optical_arcs = _boundary_list_property("optical_arcs")
    stop_arcs = _boundary_list_property("stop_arcs")
    target_arcs = _boundary_list_property("target_arcs")

    def __init__(self, **kwargs):
        for name in _ROLES_2D:
            setattr(self, "_" + name, [])
        self._scene = None
        super().__init__(**kwargs)

    @property
    def dimension(self):
        return 2

    def _all_entries(self):
        return [e for name in _ROLES_2D for e in getattr(self, "_" + name)]

    def _update(self):
        self._update_entries()
        self._scene = Scene2D.build(**{
            name: [e.surface_set for e in getattr(self, "_" + name)]
            for name in _ROLES_2D})

    def intersect(self, rays=None):
        """Single-shot intersection of rays with every surface of the
        system.

        Returns ``(segment_intersections, arc_intersections)``: two dicts of
        per-ray tensors (an empty dict where the system has no surfaces of
        that kind), with the reference's fields ``x``, ``y``, ``valid``,
        ``ray_u``, ``segment_u`` / ``arc_u``, ``gather_ray``,
        ``gather_segment`` / ``gather_arc`` and ``norm``.  Entries where
        ``valid`` is False are garbage and must be masked.  ``gather_ray``
        is the identity (rays never compact).  The searches are the plain
        ones, as in the JAX facade.
        """
        rays = self._intersect_rays(rays)
        if not self._all_entries():
            return {}, {}
        scene = self.scene
        i_eps, s_eps, r_eps = self._intersect_epsilons()
        gather_ray = torch.arange(rays.n_rays, device=self.device)

        seg_result = {}
        if scene.segments is not None and scene.segments.n_surfaces:
            hit = isect.nearest_hit_segments(
                rays.p0, rays.p1, scene.segments, i_eps, s_eps, r_eps)
            point, ray_u, seg_u, norm = isect.refine_segment_hit(
                rays.p0, rays.p1, scene.segments, hit.idx, i_eps)
            seg_result = {
                "x": point[:, 0], "y": point[:, 1], "valid": hit.valid,
                "ray_u": ray_u, "segment_u": seg_u,
                "gather_ray": gather_ray, "gather_segment": hit.idx,
                "norm": norm,
            }

        arc_result = {}
        if scene.arcs is not None and scene.arcs.n_surfaces:
            hit = isect.nearest_hit_arcs(
                rays.p0, rays.p1, scene.arcs, i_eps, s_eps, r_eps)
            point, ray_u, arc_u, norm = isect.refine_arc_hit(
                rays.p0, rays.p1, scene.arcs, hit.idx, hit.branch, i_eps)
            arc_result = {
                "x": point[:, 0], "y": point[:, 1], "valid": hit.valid,
                "ray_u": ray_u, "arc_u": arc_u,
                "gather_ray": gather_ray, "gather_arc": hit.idx,
                "norm": norm,
            }
        return seg_result, arc_result


class OpticalSystem3D(OpticalSystemBase):
    """Three triangle lists (optical, stops, targets) merged into a
    Scene3D."""

    optical = _boundary_list_property("optical")
    stops = _boundary_list_property("stops")
    targets = _boundary_list_property("targets")

    def __init__(self, **kwargs):
        for name in _ROLES_3D:
            setattr(self, "_" + name, [])
        self._scene = None
        super().__init__(**kwargs)

    @property
    def dimension(self):
        return 3

    def _all_entries(self):
        return [e for name in _ROLES_3D for e in getattr(self, "_" + name)]

    def _update(self):
        self._update_entries()
        self._scene = Scene3D.build(**{
            name: [e.surface_set for e in getattr(self, "_" + name)]
            for name in _ROLES_3D})

    def intersect(self, rays=None):
        """Single-shot intersection of rays with every triangle of the
        system.

        Returns a dict of per-ray tensors (empty when the system has no
        triangles): ``x``, ``y``, ``z``, ``valid``, ``ray_u``, ``trig_u``,
        ``trig_v``, ``gather_ray``, ``gather_trig`` and ``norm`` (the (N, 3)
        normal of the triangle hit).  Entries where ``valid`` is False are
        garbage and must be masked.
        """
        rays = self._intersect_rays(rays)
        if not self._all_entries():
            return {}
        tri = self.scene.triangles
        if tri is None or not tri.n_surfaces:
            return {}
        i_eps, s_eps, r_eps = self._intersect_epsilons()
        hit = isect.nearest_hit_triangles(
            rays.p0, rays.p1, tri, i_eps, s_eps, r_eps)
        point, ray_u, trig_u, trig_v = isect.refine_triangle_hit(
            rays.p0, rays.p1, tri, hit.idx, i_eps)
        return {
            "x": point[:, 0], "y": point[:, 1], "z": point[:, 2],
            "valid": hit.valid, "ray_u": ray_u,
            "trig_u": trig_u, "trig_v": trig_v,
            "gather_ray": torch.arange(rays.n_rays, device=self.device),
            "gather_trig": hit.idx,
            "norm": tri.norm[hit.idx],
        }


class OpticalEngine:
    """The stateful front end of the functional trace.

    ``keep_history`` (opt-in: it costs O(max_iterations x rays) memory)
    is needed by ``all_rays`` only.  ``trace_overrides`` are TraceConfig
    fields applied over ``TraceConfig.recommended`` in
    :meth:`trace_config`.  ``jit`` is accepted for the JAX facade's
    signature and changes nothing: the port has no compiled trace to
    cache.
    """

    def __init__(self, dimension, operations=(), optical_system=None,
                 compile_stopped_rays=True, compile_dead_rays=True,
                 compile_finished_rays=True, compile_active_rays=True,
                 dead_ray_length=None, new_ray_length=1.0,
                 simple_ray_inheritance=("wavelength",), reaction=None,
                 keep_history=False, trace_overrides=None, jit=True):
        if dimension not in (2, 3):
            raise ValueError(
                f"OpticalEngine: dimension must be 2 or 3, got {dimension}")
        self.dimension = dimension
        self.operations = list(operations)
        # the exclusive-operation audit
        used = {type(op) for op in self.operations}
        excluded = set()
        for op in self.operations:
            excluded |= set(getattr(op, "exclusions", ()))
        clash = used & excluded
        if clash:
            raise RuntimeError(
                f"OpticalEngine: discovered exclusive operations: {clash}")
        self.optical_system = optical_system
        self.dead_ray_length = dead_ray_length
        self.new_ray_length = new_ray_length
        # rays keep their slots, so inheritance is automatic; kept for the
        # reference's signature
        self.simple_ray_inheritance = set(simple_ray_inheritance)
        self.compile_stopped_rays = compile_stopped_rays
        self.compile_dead_rays = compile_dead_rays
        self.compile_finished_rays = compile_finished_rays
        self.compile_active_rays = compile_active_rays
        self._reaction = reaction
        self.keep_history = keep_history
        self.trace_overrides = dict(trace_overrides or {})
        self.jit = jit
        self._result = None

    @property
    def optical_system(self):
        return self._optical_system

    @optical_system.setter
    def optical_system(self, val):
        if val is not None and val.dimension != self.dimension:
            raise ValueError(
                f"OpticalEngine: optical system dimension {val.dimension} != "
                f"engine dimension {self.dimension}")
        self._optical_system = val

    def update(self):
        if self.optical_system is not None:
            self.optical_system.update()

    def annotate(self, op_list=None):
        """Run the operations' annotations: those with an
        ``annotate(engine)`` method (``operations.OldestAncestor``)."""
        for op in (op_list if op_list is not None else self.operations):
            annotate = getattr(op, "annotate", None)
            if annotate is not None:
                annotate(self)

    def _effective_operations(self):
        """The operations the trace runs: the user's, plus the standard
        reaction when nothing supplies a reaction."""
        ops = list(self.operations)
        has_reaction = self._reaction is not None or any(
            getattr(op, "reaction", None) is not None
            and getattr(op, "active", True) for op in ops)
        if not has_reaction:
            from tensorflowraytrace_tpu_torch.operations import StandardReaction

            try:
                mode = ("index" if self.optical_system is not None
                        and self.optical_system.material_callables()
                        else "value")
            except KeyError:
                # a malformed material dict; the materials audit reports it
                mode = "index"
            ops.append(StandardReaction(refractive_index_type=mode))
        return ops

    def signature_union(self, name):
        """Union of one signature set over the effective operations."""
        out = set()
        for op in self._effective_operations():
            out |= set(getattr(op, name, ()))
        return out

    @staticmethod
    def _surface_signature(surf, entry=None):
        """The fields a surface set carries.  The geometric keys are there
        by construction; mat_in / mat_out count only where they were given
        or annotated (ids default to 0, so the arrays cannot tell)."""
        if isinstance(surf, SegmentSet):
            geo = {"x_start", "y_start", "x_end", "y_end"}
        elif isinstance(surf, ArcSet):
            geo = {"x_center", "y_center", "angle_start", "angle_end", "radius"}
        else:
            geo = {"xp", "yp", "zp", "x1", "y1", "z1",
                   "x2", "y2", "z2", "norm"}
        sig = geo | {"category", "catagory"} | set(surf.fields)
        annotated = surf.mats_specified
        if entry is not None and {"mat_in", "mat_out"} & set(entry._mat_overrides):
            annotated = True
        if annotated:
            sig |= {"mat_in", "mat_out"}
        return sig

    def _role_entries(self, system):
        """(role, kind, entries) triples for the signature audit."""
        if self.dimension == 2:
            return [
                ("optical", "segments", system._optical_segments),
                ("optical", "arcs", system._optical_arcs),
                ("stop", "segments", system._stop_segments),
                ("stop", "arcs", system._stop_arcs),
                ("target", "segments", system._target_segments),
                ("target", "arcs", system._target_arcs),
            ]
        return [
            ("optical", "triangles", system._optical),
            ("stop", "triangles", system._stops),
            ("target", "triangles", system._targets),
        ]

    def validate_system(self):
        """The signature audit: every material, source and boundary set
        against the union of the effective operations' signatures, with
        messages naming what is missing and where; then every material id
        against the material list."""
        system = self.optical_system
        if system is None:
            raise RuntimeError("validate_system: no optical system attached")
        system.scene  # builds the entries if they never were

        material_sig = self.signature_union("material_signature")
        input_sig = self.signature_union("input_signature")
        role_sigs = {
            "optical": self.signature_union("optical_signature"),
            "stop": self.signature_union("stop_signature"),
            "target": self.signature_union("target_signature"),
        }

        for i, m in enumerate(system.materials):
            if isinstance(m, dict):
                missing = material_sig - set(m.keys())
            elif callable(m):
                missing = material_sig - {"n"}
            else:
                raise RuntimeError(
                    f"validate_system: material {i} ({m!r}) is neither a "
                    f"dict with an 'n' entry nor a callable n(wavelength)")
            if missing:
                raise RuntimeError(
                    f"validate_system: material {i} failed the materials "
                    f"signature check: missing {sorted(missing)} "
                    f"(required {sorted(material_sig)})")

        rays = system.sources
        if rays is None:
            raise RuntimeError("validate_system: system has no sources")
        geo = ({"x_start", "y_start", "z_start", "x_end", "y_end", "z_end"}
               if self.dimension == 3
               else {"x_start", "y_start", "x_end", "y_end"})
        present = set(geo) | set(rays.fields)
        # rays built without a wavelength carry the all-zero default: that
        # counts as absent (index-mode dispersion at 0 nm means nothing)
        if bool(torch.any(rays.wavelength != 0)):
            present.add("wavelength")
        missing = (geo | input_sig) - present
        if missing:
            hint = ("; rays were built without wavelengths (all zero), but "
                    "index-mode material dispersion needs them"
                    if "wavelength" in missing else "")
            raise RuntimeError(
                f"validate_system: sources failed the signature check: "
                f"missing fields {sorted(missing)}{hint}")

        for role, kind, entries in self._role_entries(system):
            required = role_sigs[role]
            for j, entry in enumerate(entries):
                surf = entry.surface_set
                if surf is None or surf.n_surfaces == 0:
                    continue
                missing = required - self._surface_signature(surf, entry)
                if missing:
                    raise RuntimeError(
                        f"validate_system: {role} {kind}[{j}] failed the "
                        f"signature check: missing fields {sorted(missing)} "
                        f"(required {sorted(required)}); annotate the "
                        f"boundary (e.g. entry['mat_in'] = ... or a "
                        f"material_list) before tracing")

        mats = system.material_callables()
        scene = system.scene
        sets = ([scene.triangles] if isinstance(scene, Scene3D)
                else [s for s in (scene.segments, scene.arcs) if s is not None])
        for s in sets:
            if mats and s.n_surfaces:
                hi = max(int(s.mat_in.max()), int(s.mat_out.max()))
                if hi >= len(mats):
                    raise ValueError(
                        f"validate_system: material index {hi} out of range "
                        f"for {len(mats)} materials")

    def _op_reaction(self):
        """The reaction: the explicit one, else the first active operation
        that provides one, else Snell's law."""
        if self._reaction is not None:
            return self._reaction
        for op in self.operations:
            r = getattr(op, "reaction", None)
            if r is not None and getattr(op, "active", True):
                return r
        return default_reaction

    def trace_config(self, max_iterations):
        """The TraceConfig of a trace of ``max_iterations`` bounces:
        ``TraceConfig.recommended`` for the system's scene on its device,
        the facade's own settings, the float64 rule (no CUDA search, no
        culling, no re-sort), then ``trace_overrides``, which win."""
        sys_ = self.optical_system
        mode = "index" if sys_.material_callables() else "value"
        for op in self.operations:
            m = getattr(op, "refractive_index_type", None)
            if m is not None:
                mode = m
        epsilons = {"intersect_epsilon": sys_.intersect_epsilion,
                    "size_epsilon": sys_.size_epsilion,
                    "ray_start_epsilon": sys_.ray_start_epsilion}
        return TraceConfig.recommended(
            sys_.scene,
            max_bounces=max_iterations,
            device=sys_.device,
            new_ray_length=self.new_ray_length,
            dead_ray_length=self.dead_ray_length,
            keep_history=self.keep_history,
            refractive_index_type=mode,
            # a system's epsilon replaces the dtype's default (and, for a
            # float32 scene on the card, recommended's start epsilon) only
            # where the system sets one
            **{k: v for k, v in epsilons.items() if v is not None},
            # the JAX facade's rule: a float64 system on the plain searches
            **({} if sys_.dtype == torch.float32 else
               {"use_kernel": False, "cull": False, "resort_rays": False}),
            **self.trace_overrides,
        )

    def ray_trace(self, max_iterations=25):
        """Trace the system's sources through its scene, without autograd;
        stores and returns the TraceResult (None when there is no system or
        no source)."""
        system = self.optical_system
        if system is None:
            return None
        rays = system.sources
        if rays is None:
            return None
        cfg = self.trace_config(max_iterations)
        with torch.no_grad():
            self._result = trace(rays, system.scene,
                                 system.material_callables(), cfg,
                                 self._op_reaction())
        return self._result

    def clear_ray_history(self):
        self._result = None

    @property
    def result(self):
        return self._result

    # ---- the ray views of the last trace ----

    def _require_result(self):
        if self._result is None:
            raise RuntimeError("no trace has been run yet")
        return self._result

    @property
    def finished_rays(self):
        return self._require_result().rays.finished

    @property
    def stopped_rays(self):
        return self._require_result().rays.stopped

    @property
    def dead_rays(self):
        return self._require_result().rays.dead

    @property
    def active_rays(self):
        return self._require_result().rays.active

    @property
    def all_rays(self):
        """Every ray segment traced, flattened from the per-bounce history
        (``drawing.history_rays``).  Needs
        ``OpticalEngine(..., keep_history=True)``."""
        from tensorflowraytrace_tpu_torch.drawing import history_rays

        res = self._require_result()
        if res.history_p0 is None:
            raise RuntimeError(
                "all_rays needs per-bounce history; construct the engine "
                "with OpticalEngine(..., keep_history=True) (it is opt-in "
                "because history costs O(max_iterations * n_rays) memory)")
        return history_rays(res)

    @property
    def unfinished_rays(self):
        return self._require_result().rays.active

    # ---- the functional bridge for optimization ----

    def parametric_entries(self):
        """The boundary entries holding parametric boundaries, in system
        order."""
        return [e for e in self.optical_system._all_entries()
                if _is_parametric(e._obj)]

    def make_loss(self, error_function, trace_depth):
        """A pure ``loss(params, generator, *args, **kwargs) -> scalar``
        over this engine's system, and the matching initial parameters.

        ``params`` is a flat list: one tensor per parametric boundary (a
        multi-boundary contributes one per surface).  The loss rebuilds the
        parametric surfaces from ``params`` (with their entries'
        annotations), samples every source from ``generator`` in order,
        traces ``trace_depth`` bounces without history and returns
        ``error_function(result, *args, **kwargs)``.  ``error_function``
        should weigh by state masks (``result.rays.state == FINISHED``)
        rather than compact.
        """
        system = self.optical_system
        cfg = dataclasses.replace(self.trace_config(trace_depth),
                                  keep_history=False)
        reaction = self._op_reaction()
        materials = system.material_callables()
        sources = [e._obj for e in system._source_entries]

        init_params = []
        slots = []  # (entry, count, whether its build takes a list)
        for e in self.parametric_entries():
            p = _current_params(e._obj)
            if isinstance(p, (list, tuple)):
                init_params.extend(x.detach().clone() for x in p)
                slots.append((e, len(p), True))
            else:
                init_params.append(torch.as_tensor(p).detach().clone())
                slots.append((e, 1, isinstance(e._obj.init_params(), list)))

        roles = _ROLES_2D if system.dimension == 2 else _ROLES_3D
        scene_type = Scene2D if system.dimension == 2 else Scene3D

        def build_scene(params):
            rebuilt = {}
            i = 0
            for e, count, takes_list in slots:
                built = e._obj.build(list(params[i:i + count]) if takes_list
                                     else params[i])
                rebuilt[id(e)] = e._annotated(_on(_merge(built),
                                                  system.device))
                i += count
            return scene_type.build(**{
                name: [rebuilt.get(id(e), e.surface_set)
                       for e in getattr(system, "_" + name)]
                for name in roles})

        def loss(params, generator, *args, **kwargs):
            rays = concat_rays([
                _sample_source(s, generator, system.dtype, system.device)
                for s in sources])
            result = trace(rays, build_scene(params), materials, cfg, reaction)
            return error_function(result, *args, **kwargs)

        return loss, init_params

    def write_back(self, params):
        """Store optimized flat ``params`` back into the parametric
        boundaries and update the system, so that later ``ray_trace`` calls
        use them."""
        i = 0
        for e in self.parametric_entries():
            obj = e._obj
            if isinstance(obj.init_params(), list):
                n = len(obj.init_params())
                _store_params(obj, list(params[i:i + n]))
                i += n
            else:
                _store_params(obj, params[i])
                i += 1
        self.update()


class SGD_Optimizer:
    """The reference's top-level optimizer: an OpticalEngine, an error
    function and a trace depth around the functional ``optim.Optimizer``.

    ``error_function(result, *args, **kwargs) -> scalar`` receives the
    TraceResult (weigh by state masks).  After every step the parameters
    are written back into the engine's parametric boundaries, and the
    system updates.  ``generator`` is the optimizer's sampling generator
    (``optim.Optimizer``'s default when None).

    With ``mesh=`` (a ``parallel.sharding.RayMesh``) the same schedule runs
    data-parallel: every rank samples the engine's full source set from
    its own generator and the MEAN loss over the ranks is optimized, so
    errors and step sizes stay at the single-process scale while each step
    sees world_size times the rays.
    """

    def __init__(self, engine: OpticalEngine, parameters=None,
                 error_function=None, trace_depth=25, momentum=0.0,
                 learning_rate=1.0, individual_lr=None, grad_clip="default",
                 clip_mode="common", clip_scale=10.0, generator=None,
                 mesh=None):
        from tensorflowraytrace_tpu_torch.optim import Optimizer

        if error_function is None:
            raise ValueError("SGD_Optimizer: error_function is required")
        self.engine = engine
        self.trace_depth = trace_depth
        loss, init_params = engine.make_loss(error_function, trace_depth)
        if mesh is not None:
            # each rank traces the FULL source set with its own generator,
            # so the all-reduced sum would be world_size x the single
            # process's loss: average it instead
            n_ranks = mesh.world_size
            base_loss = loss

            def loss(params, generator, *args, **kwargs):
                return base_loss(params, generator, *args, **kwargs) / n_ranks
        if parameters is not None:
            init_params = [torch.as_tensor(p) for p in parameters]
        self._opt = Optimizer(
            loss, init_params, learning_rate=learning_rate, momentum=momentum,
            individual_lr=individual_lr, grad_clip=grad_clip,
            clip_mode=clip_mode, clip_scale=clip_scale, generator=generator,
            mesh=mesh,
        )

    @property
    def parameters(self):
        return self._opt.parameters

    @property
    def iterations(self):
        return self._opt.iterations

    def process_gradient(self, *a, **kw):
        raise NotImplementedError(
            "gradient processing happens inside the optimizer's step; use "
            "single_step/training_routine")

    def single_step(self, *args, **kwargs):
        err = self._opt.single_step(*args, **kwargs)
        self.engine.write_back(self._opt.parameters)
        return err

    def run_phase(self, *args, **kwargs):
        errors = self._opt.run_phase(*args, **kwargs)
        self.engine.write_back(self._opt.parameters)
        return errors

    def training_routine(self, *args, **kwargs):
        errors = self._opt.training_routine(*args, **kwargs)
        self.engine.write_back(self._opt.parameters)
        return errors

    @staticmethod
    def smooth(parameters, smoother):
        from tensorflowraytrace_tpu_torch.optim import Optimizer

        return Optimizer.smooth(parameters, smoother)
