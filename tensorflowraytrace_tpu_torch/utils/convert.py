"""Carry state across packages as NumPy arrays.

The JAX package and this port share no objects; these helpers turn arrays
taken from the JAX side (``np.asarray`` of its parameters, rays, segments,
arcs or triangles) into the port's tensors, so both packages compute the
same thing.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.config import (
    OPTICAL, resolve_device, resolve_dtype,
)
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import (
    ArcSet, SegmentSet, TriangleSet,
)


def params_from_numpy(arrays, dtype=None, device=None):
    """Lens parameters (a list of per-surface arrays, as from the JAX
    ``lens.init_params()`` or any trained list) as a list of tensors, ready
    for ``ParametricMultiTriangleBoundary.build``."""
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    return [torch.as_tensor(np.array(a), dtype=dtype, device=device)
            for a in arrays]


def rayset_from_numpy(p0, p1, wavelength=None, state=None, fields=None,
                      dtype=None, device=None) -> RaySet:
    """A RaySet from arrays; float fields take ``dtype``, others keep theirs."""
    dtype, device = resolve_dtype(dtype), resolve_device(device)

    def field_tensor(v):
        t = torch.as_tensor(np.array(v), device=device)
        return t.to(dtype) if t.is_floating_point() else t

    return RaySet.make(
        np.array(p0), np.array(p1),
        None if wavelength is None else np.array(wavelength),
        None if state is None else np.array(state),
        {k: field_tensor(v) for k, v in (fields or {}).items()},
        dtype=dtype, device=device)


def _arr(a):
    """A NumPy copy of ``a`` (a number, list or array), ``None`` kept."""
    return None if a is None else np.array(a)


def segments_from_numpy(p0, p1, category=OPTICAL, mat_in=None, mat_out=None,
                        fields=None, dtype=None, device=None) -> SegmentSet:
    """A SegmentSet from (M, 2) endpoint arrays (and optional per-surface
    ids and fields)."""
    return SegmentSet.make(
        _arr(p0), _arr(p1), category=_arr(category), mat_in=_arr(mat_in),
        mat_out=_arr(mat_out),
        fields={k: _arr(v) for k, v in (fields or {}).items()},
        dtype=resolve_dtype(dtype), device=resolve_device(device))


def arcs_from_numpy(center, angle_start, angle_end, radius, category=OPTICAL,
                    mat_in=None, mat_out=None, fields=None, dtype=None,
                    device=None) -> ArcSet:
    """An ArcSet from a (M, 2) centre array and (M,) or scalar angles and
    radii (and optional per-surface ids and fields)."""
    return ArcSet.make(
        _arr(center), _arr(angle_start), _arr(angle_end), _arr(radius),
        category=_arr(category), mat_in=_arr(mat_in), mat_out=_arr(mat_out),
        fields={k: _arr(v) for k, v in (fields or {}).items()},
        dtype=resolve_dtype(dtype), device=resolve_device(device))


def triangles_from_numpy(vp, v1, v2, norm=None, category=OPTICAL, mat_in=None,
                         mat_out=None, dtype=None, device=None) -> TriangleSet:
    """A TriangleSet from (M, 3) vertex arrays (and optional normals and
    per-surface ids)."""
    return TriangleSet.make(
        _arr(vp), _arr(v1), _arr(v2), _arr(norm), category=_arr(category),
        mat_in=_arr(mat_in), mat_out=_arr(mat_out), dtype=resolve_dtype(dtype),
        device=resolve_device(device))


def optimizer_state_from_numpy(optimizer, parameters, velocity):
    """Load an optimizer's state from arrays: ``parameters`` and ``velocity``
    are per-surface lists, as ``np.asarray`` of a JAX ``Optimizer``'s
    ``parameters`` and ``_velocity``.  They take the dtype and device of the
    port ``optimizer``'s own parameters, so its next step continues the JAX
    run's Nesterov momentum.  Returns the optimizer."""
    n = len(optimizer.parameters)
    if len(parameters) != n or len(velocity) != n:
        raise ValueError(f"the optimizer has {n} parameters; got "
                         f"{len(parameters)} parameters and {len(velocity)} "
                         "velocities")

    def like(arrays):
        return [torch.as_tensor(np.array(a), dtype=p.dtype, device=p.device)
                for a, p in zip(arrays, optimizer.parameters)]

    optimizer.parameters, optimizer._velocity = like(parameters), like(velocity)
    return optimizer


def guide_params_from_numpy(guide, params):
    """Load a ``ParametricCylindricalGuide``'s parameters from an array (as
    ``np.asarray`` of the JAX guide's ``init_params()`` or of trained
    parameters), in the guide's dtype and on its device, so both packages
    build the same guide.  Returns the guide."""
    params = np.array(params)
    if params.shape != (guide.n_params,):
        raise ValueError(f"the guide has {guide.n_params} parameters; got an "
                         f"array of shape {params.shape}")
    with torch.no_grad():
        guide.params.copy_(torch.as_tensor(params, dtype=guide.params.dtype))
    return guide
