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
from tensorflowraytrace_tpu_torch.models.sources import PrecompiledSource
from tensorflowraytrace_tpu_torch.models.surfaces import (
    ArcSet, SegmentSet, TriangleSet,
)
from tensorflowraytrace_tpu_torch.sequential import AsphereStack


def params_from_numpy(arrays, dtype=None, device=None):
    """Lens parameters (a list of per-surface arrays, as from the JAX
    ``lens.init_params()`` or any trained list) as a list of tensors, ready
    for ``ParametricMultiTriangleBoundary.build``."""
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    return [torch.as_tensor(np.array(a), dtype=dtype, device=device)
            for a in arrays]


def asphere_stack_from_numpy(vertex_z, c, k=None, coeffs=None, aperture=None,
                             mat_after=None, mirror=None, dtype=None,
                             device=None) -> AsphereStack:
    """An ``AsphereStack`` from the arrays of a JAX ``AsphereStack`` (as
    ``np.asarray`` of its seven fields) or any per-surface values: the
    float fields in ``dtype``, ``mat_after`` as int32 and ``mirror`` as
    bool, on ``device``."""
    return AsphereStack.make(
        _arr(vertex_z), _arr(c), k=_arr(k), coeffs=_arr(coeffs),
        aperture=_arr(aperture), mat_after=_arr(mat_after),
        mirror=_arr(mirror), dtype=resolve_dtype(dtype),
        device=resolve_device(device))


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
    if getattr(optimizer, "_tx", None) is not None:
        raise ValueError("optimizer_state_from_numpy loads the Nesterov "
                         "stage's state; this optimizer runs optax_tx")
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


def hexalens_params_from_numpy(lens, params):
    """Load a ``ParametricMultiTriangleBoundary``'s per-surface parameters
    (as ``hexalens.problem`` builds it) from a list of arrays (as
    ``np.asarray`` of the JAX lens's ``init_params()`` or of trained
    parameters), in each surface's dtype and on its device.  Returns the
    lens."""
    surfaces = lens.param_list()
    if len(params) != len(surfaces):
        raise ValueError(f"the lens has {len(surfaces)} surfaces; got "
                         f"{len(params)} parameter arrays")
    with torch.no_grad():
        for p, a in zip(surfaces, params):
            a = np.array(a)
            if a.shape != tuple(p.shape):
                raise ValueError(f"a surface has {p.shape[0]} parameters; "
                                 f"got an array of shape {a.shape}")
            p.copy_(torch.as_tensor(a, dtype=p.dtype))
    return lens


def precompiled_from_numpy(data, dimension=3, **kw):
    """A ``PrecompiledSource`` over ``data``, the dict of NumPy arrays a JAX
    ``PrecompiledSource`` holds (``p0``, ``p1``, ``wavelength``,
    ``fields``); ``kw`` are the source's options (``sample_count``,
    ``do_downsample``, ``start_perturbation``, ``end_perturbation``)."""
    source = PrecompiledSource(dimension, **kw)
    source._data = {
        "p0": np.array(data["p0"]), "p1": np.array(data["p1"]),
        "wavelength": np.array(data["wavelength"]),
        "fields": {k: np.array(v) for k, v in data["fields"].items()},
    }
    return source


def surface_tables_from_numpy(tables, dtype=torch.int32, device=None):
    """Per-surface tables of a reaction (``{"triangles": arr}`` or
    ``{"segments": arr, "arcs": arr}``: coating, grating, metasurface,
    roughness or roulette ids, absorptivities, or ``(alpha_in,
    alpha_out)`` pairs) as tensors of ``dtype`` on ``device``, so that no
    bounce copies them to the device again."""
    device = resolve_device(device)

    def tensor(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return {kind: (tuple(tensor(a) for a in arr)
                   if isinstance(arr, (tuple, list)) else tensor(arr))
            for kind, arr in tables.items()}


def _number_or_tensor(v, dtype, device):
    """A Python number for a scalar, a tensor for an array; callables (a
    dispersive index ``n(wavelength)``) stay as they are."""
    if callable(v) or isinstance(v, torch.Tensor):
        return v
    a = np.array(v)
    if a.ndim == 0:
        return a.item()
    return torch.as_tensor(a, dtype=dtype, device=device)


def stacks_from_numpy(stacks, dtype=None, device=None):
    """Thin-film stacks (sequences of ``(n, d)`` layers, as the JAX
    ``thin_film_*_reaction`` takes them) for the port's reactions: scalars
    become Python numbers, arrays tensors on ``device``."""
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    return [[(_number_or_tensor(n, dtype, device),
              _number_or_tensor(d, dtype, device)) for n, d in stack]
            for stack in stacks]


def gratings_from_numpy(gratings, dtype=None, device=None):
    """Grating specs ``(spacing, order, kind[, groove])`` for the port's
    ``grating_reaction``: the spacing a number (or a tensor for an array),
    the groove vector a tensor on ``device``."""
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    out = []
    for spec in gratings:
        spacing, order, kind = spec[:3]
        row = (_number_or_tensor(spacing, dtype, device), int(order), kind)
        if len(spec) > 3:
            row += (torch.as_tensor(np.array(spec[3]), dtype=dtype,
                                    device=device),)
        out.append(row)
    return out


def seed_from_jax_key(key) -> int:
    """The port's integer stream seed for a JAX PRNG key given as NumPy
    words (``np.asarray(jax.random.PRNGKey(s))``: two uint32): the words
    high first.  The stochastic reactions' draws at this seed are the
    port's own; a test that substitutes JAX's draws recovers the key from
    it."""
    words = np.asarray(key, dtype=np.uint64).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"a JAX key is two uint32 words; got {words}")
    return (int(words[0]) << 32) | int(words[1])


def checkpoint_state_from_numpy(state, generator_seed, device=None):
    """The port's checkpoint state (``utils.checkpoint.state_dict``'s
    layout) from the JAX package's ``checkpoint.state_dict(optimizer)`` of
    an optimizer on its built-in Nesterov stage: its parameters and
    velocity (lists of arrays) and its iteration count, so that
    ``checkpoint.restore_into`` resumes the JAX run in the port.

    A JAX threefry key has no ``torch.Generator`` counterpart, so the
    state's key is not carried: the port's generator starts afresh from
    ``generator_seed``, a generator on ``device`` (the device of the
    optimizer's own generator; the default device when None).  A loss that
    draws random rays therefore draws other rays after the resume than the
    JAX run would have."""
    parameters = [np.array(p) for p in state["parameters"]]
    velocity = [np.array(v) for v in state["velocity"]]
    if len(velocity) != len(parameters) or any(
            v.shape != p.shape for v, p in zip(velocity, parameters)):
        raise ValueError(
            "checkpoint_state_from_numpy carries the Nesterov stage's state "
            "(one velocity per parameter); this state's velocity leaves "
            f"{[v.shape for v in velocity]} belong to an optax transform")
    generator = torch.Generator(resolve_device(device))
    generator.manual_seed(int(generator_seed))
    return {"parameters": [torch.as_tensor(p) for p in parameters],
            "velocity": [torch.as_tensor(v) for v in velocity],
            "generator": generator.get_state(),
            "iterations": int(np.asarray(state["iterations"]))}
