"""Ray operations: pluggable per-bounce reactions and trackers.

Counterpart of ``tensorflowraytrace_tpu/operations.py``, with its names.  A
*reaction* is a function ``reaction(projection, rays, cfg)`` returning the
child rays' endpoints ``(p0, p1)`` for every slot, or ``(p0, p1,
field_updates)``; the engine keeps the children and the updates of the
slots that react (``engine._bounce_rest``) and drops the reserved keys that
start with ``__``.  Trackers wrap a base reaction and carry per-ray fields:
radiant intensity through Fresnel interfaces, thin-film coatings, surface
absorbers and bulk absorption, Jones amplitudes, optical path length.
Direction-changing reactions (gratings, metasurfaces, rough surfaces,
forced and sampled branches) report the branch their child took in
``__reflects__``, a power factor in ``__efficiency__`` (applied once, by
the innermost intensity tracker) and a metasurface's phase as optical path
in ``__opl_add__``.

The two stochastic reactions (rough surfaces, Russian roulette) draw from a
counter-based stream: ``key`` is an integer seed, and ray ``slot``'s draw
at its interaction ``ctr`` is an integer hash of ``(key, mix)`` with
``mix = slot + ctr * 0x9E3779B9`` modulo 2^32, computed in int64 tensor
arithmetic on the rays' device (:func:`ray_uniform`, :func:`ray_normal`).
The same key gives the same trace, on the CPU and on the card alike.

A trace that launches CUDA kernels cannot be vmapped, so where the JAX
package vmaps one trace over keys or branch schedules, the port loops.
"""

from __future__ import annotations

import math
import numbers

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.config import resolve_device
from tensorflowraytrace_tpu_torch.engine import (
    Projection, TraceConfig, default_reaction,
)
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.ops import geometry
from tensorflowraytrace_tpu_torch.ops import intersect as isect
from tensorflowraytrace_tpu_torch.ops import thinfilm

# StandardReaction is the engine default.
standard_reaction = default_reaction


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _unit(v):
    return v / torch.clamp(_norm(v), min=torch.finfo(v.dtype).tiny)


def _const(v, like):
    """``v`` for arithmetic with ``like``: a Python number stays one (no
    host-to-device copy), a tensor takes ``like``'s dtype and device (and
    keeps its graph), anything else becomes such a tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    if isinstance(v, numbers.Real):
        return float(v)
    return torch.as_tensor(np.asarray(v), dtype=like.dtype,
                           device=like.device)


def _per_ray(v, like):
    """``v`` (a number or tensor) broadcast to one value a ray of ``like``
    (N,)."""
    v = _const(v, like)
    if isinstance(v, float):
        return torch.full_like(like, v)
    return torch.broadcast_to(v, like.shape)


def ghost_through(proj: Projection, rays: RaySet, cfg: TraceConfig):
    """Rays pass straight through optical surfaces unchanged in
    direction."""
    return rays.p1, 2 * rays.p1 - rays.p0


def annotate_oldest_ancestor(rays: RaySet, start: int = 0) -> RaySet:
    """Tag each source ray with its index so descendants can be traced
    back; the tag rides in the slot."""
    idx = torch.arange(start, start + rays.n_rays, dtype=torch.int32,
                       device=rays.p0.device)
    return rays.with_field("oldest_ancestor", idx)


# ======================================================================
# class-based operation API (signature sets + annotate/reaction hooks)
# ======================================================================

class RayOperation:
    """Base class for pluggable ray operations.

    The per-bounce compute hook is one ``reaction`` function;
    ``annotate(engine)`` remains for setup-time source annotation.  The
    signature sets are kept so that system audits and user subclasses carry
    over.
    """

    def __init__(self, active=True):
        self.active = active

    input_signature = frozenset()
    output_signature = frozenset()
    optical_signature = frozenset()
    stop_signature = frozenset()
    target_signature = frozenset()
    material_signature = frozenset()
    simple_ray_inheritance = frozenset()
    exclusions = frozenset()

    # reaction(projection, rays, cfg) -> (child_p0, child_p1), or None if
    # this operation does not generate rays
    reaction = None

    def annotate(self, engine):
        pass


class StandardReaction(RayOperation):
    """Snell's-law refraction / reflection.

    ``refractive_index_type``: 'index' (per-surface mat_in/mat_out indices
    into the material list, dispersion evaluated per-ray wavelength) or
    'value' (per-surface n_in/n_out floats).
    """

    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})

    def __init__(self, refractive_index_type="index", **kw):
        super().__init__(**kw)
        if refractive_index_type not in ("index", "value"):
            raise ValueError(
                "StandardReaction: refractive_index_type must be 'index' or "
                "'value'")
        self.refractive_index_type = refractive_index_type
        if refractive_index_type == "index":
            self.input_signature = frozenset({"wavelength"})
            self.simple_ray_inheritance = frozenset({"wavelength"})
        else:
            self.optical_signature = frozenset({"n_in", "n_out"})

    reaction = staticmethod(standard_reaction)


class GhostThrough(RayOperation):
    """Pass-through test operation."""

    reaction = staticmethod(ghost_through)


def _fresnel_prelude(proj, rays):
    """Shared geometry and branch set-up of the Fresnel reactions: unit ray
    direction, unit surface normal, signed normal projection ``nu``,
    incidence cosine, sanitized refractive indices, the Snell ratio
    ``eta = n1/n2`` (``geometry.select_eta``: internal hits see n_in/n_out,
    external the inverse; mirror sentinels give 0), the TIR radicand, and
    the branches the geometry REFLECTS.

    The reflect predicate follows each dimension's geometric branch:

    * 2D reflects on TIR and on eta == 0: its refract test is
      ``|theta2| <= 1 and eta != 0``, so an n_in == 0 mirror hit from the
      INTERNAL side (eta = 1/n_out) refracts through (a one-sided mirror).
    * 3D reflects on TIR and on n_in == 0 from EITHER side, plus eta == 0
      (a mat_out mirror seen from an internal hit).

    Non-reacting slots can carry non-finite indices (an out-of-range
    material id gives NaN n so the ray dies at the finite-child guard); the
    engine masks forward values, but a product's backward multiplies the
    zeroed cotangent by the raw factor and 0 * NaN = NaN, so the indices
    are sanitized here with a double where.
    """
    d = _unit(rays.p1 - rays.p0)
    if proj.dim == 3:
        n = _unit(proj.norm)
    else:
        n = torch.stack([torch.cos(proj.norm), torch.sin(proj.norm)], dim=1)
    nu = torch.sum(n * d, dim=-1)
    cos_i = torch.abs(nu)

    n_in = torch.where(torch.isfinite(proj.n_in), proj.n_in,
                       torch.ones_like(proj.n_in))
    n_out = torch.where(torch.isfinite(proj.n_out), proj.n_out,
                        torch.ones_like(proj.n_out))
    eta = geometry.select_eta(n_in, n_out, nu > 0)

    radicand = 1 - eta * eta * (1 - cos_i * cos_i)
    tir = radicand < 0
    if proj.dim == 3:
        reflects = tir | (n_in == 0) | (eta == 0.0)
    else:
        reflects = tir | (eta == 0.0)
    return d, n, nu, cos_i, n_in, n_out, eta, radicand, tir, reflects


def _run_base(base_reaction, proj, rays, cfg):
    """Call a wrapped base reaction, accepting both the 2-tuple and the
    field-updating 3-tuple protocol, so the trackers compose with each
    other.  Returns ``(child_p0, child_p1, field_updates)``."""
    out = base_reaction(proj, rays, cfg)
    if len(out) == 2:
        p0, p1 = out
        return p0, p1, {}
    p0, p1, updates = out
    return p0, p1, dict(updates)


def _merge_updates(inner, outer):
    """Merge an outer wrapper's field updates over its base reaction's,
    failing if both write the same field (two trackers of one field have no
    defined order).  Multiplicative intensity trackers avoid the clash by
    popping the base's update of their field (:func:`_chain_field`)."""
    clash = set(inner) & set(outer)
    if clash:
        raise ValueError(
            f"composed reactions both update field(s) {sorted(clash)}; "
            "wrap distinct fields or merge them by hand")
    inner.update(outer)
    return inner


def _effective_reflects(base_updates, prelude_reflects):
    """The branch predicate a field tracker follows: a direction-changing
    base reaction's ``__reflects__`` report if there is one (read, not
    popped: every tracker of a stack needs it, and the engine drops it),
    else the Snell prelude's."""
    return base_updates.get("__reflects__", prelude_reflects)


def _chain_field(base_updates, rays, field, who):
    """Starting value of a multiplicative field tracker: the base
    reaction's update of the same field if it made one, else the ray's
    current value.  A missing seed fails."""
    old = base_updates.pop(field, rays.fields.get(field))
    if old is None:
        raise KeyError(
            f"{who}: rays carry no {field!r} field; seed it on the source "
            "rays")
    return old


def _per_surface_table(proj, tables, n_rays, default, dtype=torch.int32,
                       pick=None):
    """Gather a per-surface table to per-ray values: ``tables`` maps a
    surface kind ("triangles" in 3D; "segments", "arcs" in 2D) to an array
    aligned with the scene's merged surface set of that kind (``pick``
    selects it from the entry); absent kinds give ``default``.  Indices are
    clamped before the gather (the kind mask makes out-of-range slots
    irrelevant, but the gather must stay in bounds)."""
    device = proj.surf_idx.device
    out = torch.full((n_rays,), default, dtype=dtype, device=device)
    surf_idx = proj.surf_idx.long()
    kinds = ((("triangles", None),) if proj.dim == 3 else
             (("segments", isect.KIND_SEGMENT), ("arcs", isect.KIND_ARC)))
    for key, kind in kinds:
        table = tables.get(key)
        if table is None:
            continue
        if pick is not None:
            table = pick(table)
        table = torch.as_tensor(table, dtype=dtype, device=device)
        vals = table[torch.clamp(surf_idx, 0, table.shape[0] - 1)]
        out = vals if kind is None else torch.where(proj.kind == kind, vals,
                                                    out)
    return out


def _tangential_child(rays, cfg, d, n, nu, n1, n2, is_refl, t_kick,
                      child_p0, child_p1, marked):
    """Shared tangential-momentum child of the grating and metasurface
    reactions: ``u_out_t = (n1/n2) u_in_t + t_kick``, the normal component
    rebuilt by a clamped sqrt (transmission keeps the incident normal sign,
    reflection flips it), evanescent kicks and unmarked surfaces falling
    back to the base child.  Returns ``(p0, p1, use_mask)``."""
    eps = torch.finfo(rays.p0.dtype).eps
    n2_safe = torch.where(n2 != 0, n2, torch.ones_like(n2))
    d_t = d - nu[:, None] * n
    out_t = (n1 / n2_safe)[:, None] * d_t + t_kick
    s2 = torch.sum(out_t * out_t, dim=-1)
    evan = s2 >= 1.0
    # clamped sqrt: grazing emergence (s2 == 1 exactly) would put an
    # infinite derivative on the selected branch
    c = torch.sqrt(torch.clamp(1.0 - s2, eps * eps, 1.0))
    sign = torch.sign(torch.where(nu == 0, torch.ones_like(nu), nu))
    sign = torch.where(is_refl, -sign, sign)
    out = out_t + (sign * c)[:, None] * n

    use = marked & ~evan & (n2 != 0)
    use_c = use[:, None]
    p0 = torch.where(use_c, rays.p1, child_p0)
    p1 = torch.where(use_c, rays.p1 + cfg.new_ray_length * out, child_p1)
    return p0, p1, use


def _fresnel_R(eta, cos_i, radicand, eps):
    """The unpolarized bare-Fresnel reflectance, clamped into [0, 1]."""
    cos_t = torch.sqrt(torch.clamp(radicand, min=eps ** 2))
    # rs/rp with n1/n2 expressed through eta = n1/n2
    rs_d = torch.clamp(eta * cos_i + cos_t, min=eps)
    rp_d = torch.clamp(eta * cos_t + cos_i, min=eps)
    rs = (eta * cos_i - cos_t) / rs_d
    rp = (eta * cos_t - cos_i) / rp_d
    return torch.clamp(0.5 * (rs * rs + rp * rp), 0.0, 1.0)


def fresnel_intensity_reaction(base_reaction=default_reaction,
                               field="intensity"):
    """Wrap a reaction with per-ray radiant-intensity tracking.

    At each optical interaction the continuing ray's ``fields[field]`` is
    multiplied by the unpolarized Fresnel power coefficient of the branch
    it took: transmittance T = 1 - (rs^2 + rp^2)/2 on refraction, 1 on
    total internal reflection and on mirror surfaces (the n_in == 0
    sentinel).  Differentiable, so intensity-weighted losses can drive
    optimization.  Seed the field on the source rays; a missing field fails
    at trace time.
    """

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        eps = torch.finfo(rays.p0.dtype).eps
        d, n, nu, cos_i, n_in, _n_out, eta, radicand, tir, reflects = (
            _fresnel_prelude(proj, rays))
        reflectance = _fresnel_R(eta, cos_i, radicand, eps)

        # the effective reflectance of THIS interface: exactly 1 wherever
        # the Snell geometry itself reflects (TIR, mirror sentinel), else
        # the Fresnel R.  The branch the child took (the prelude's, or a
        # base reaction's __reflects__ report) then selects R or 1 - R, so
        # a FORCED reflection at a partial interface carries R and a forced
        # transmission under TIR carries exactly 0
        R_eff = torch.where(reflects, torch.ones_like(reflectance),
                            reflectance)
        eff_reflects = _effective_reflects(base_updates, reflects)
        factor = torch.where(eff_reflects, R_eff, 1.0 - R_eff)
        # a diffraction-efficiency report of a base reaction, applied once
        # (popped) by the innermost intensity tracker of a stack
        efficiency = base_updates.pop("__efficiency__", None)
        if efficiency is not None:
            factor = factor * efficiency
        old = _chain_field(base_updates, rays, field,
                           "fresnel_intensity_reaction")
        return child_p0, child_p1, _merge_updates(
            base_updates, {field: old * factor.to(old.dtype)})

    return reaction


class FresnelIntensity(RayOperation):
    """Class-op wrapper for :func:`fresnel_intensity_reaction`: standard
    Snell children plus per-ray intensity attenuation by the Fresnel power
    transmittance of the taken branch."""

    input_signature = frozenset({"intensity", "wavelength"})
    output_signature = frozenset({"intensity"})
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset({"intensity", "wavelength"})

    def __init__(self, base_reaction=default_reaction, field="intensity",
                 **kw):
        super().__init__(**kw)
        self.reaction = fresnel_intensity_reaction(base_reaction, field)


# ======================================================================
# polarization ray tracing (Jones amplitudes with s/p basis transport)
# ======================================================================

POL_FIELDS_2D = ("es_re", "es_im", "ep_re", "ep_im")
POL_FIELDS_3D = POL_FIELDS_2D + ("pol_sx", "pol_sy", "pol_sz")


def _cdiv(nr, ni, dr, di, eps):
    """Complex division (nr + i ni) / (dr + i di) in explicit real and
    imaginary parts."""
    den = torch.clamp(dr * dr + di * di, min=eps)
    return (nr * dr + ni * di) / den, (ni * dr - nr * di) / den


def _pol_basis_rotation(proj, rays, d, n, dtype):
    """Shared plane-of-incidence basis transport of the Jones reactions:
    reads the ray's (Es, Ep) fields (failing if unseeded), rotates them
    into the new plane of incidence (3D; s_new = d x n, kept at normal
    incidence), and returns ``(es_re, es_im, ep_re, ep_im, updates)`` with
    ``updates`` the child's new s-axis fields (3D) or empty (2D: s is the
    out-of-plane axis and the rotation the identity)."""
    for f in (POL_FIELDS_3D if proj.dim == 3 else POL_FIELDS_2D):
        if f not in rays.fields:
            raise KeyError(
                f"jones polarization transport: rays carry no {f!r} "
                "field; seed the source rays with seed_polarization()")
    es_re, es_im = rays.fields["es_re"], rays.fields["es_im"]
    ep_re, ep_im = rays.fields["ep_re"], rays.fields["ep_im"]

    updates = {}
    if proj.dim == 3:
        # rotate (Es, Ep) from the ray's stored basis into the plane of
        # incidence: s_new = d x n (kept at normal incidence); with
        # p = d x s the rotation is [[c, s], [-s, c]]
        s_old = torch.stack([rays.fields["pol_sx"], rays.fields["pol_sy"],
                             rays.fields["pol_sz"]], dim=1)
        p_old = torch.linalg.cross(d, s_old, dim=-1)
        dxn = torch.linalg.cross(d, n, dim=-1)
        c_len = _norm(dxn)
        finfo = torch.finfo(dtype)
        s_new = torch.where(c_len > finfo.eps ** 0.5,
                            dxn / torch.clamp(c_len, min=finfo.tiny), s_old)
        cr = torch.sum(s_old * s_new, dim=-1)
        sr = torch.sum(p_old * s_new, dim=-1)
        es_re, ep_re = cr * es_re + sr * ep_re, -sr * es_re + cr * ep_re
        es_im, ep_im = cr * es_im + sr * ep_im, -sr * es_im + cr * ep_im
        # the new s axis is normal to the plane of incidence, so
        # perpendicular to both child directions: the child's basis as is
        updates.update(pol_sx=s_new[:, 0], pol_sy=s_new[:, 1],
                       pol_sz=s_new[:, 2])
    return es_re, es_im, ep_re, ep_im, updates


def _bare_jones_coefs(dtype, cos_i, eta, radicand, tir, reflects):
    """Bare-Fresnel complex amplitude coefficients of the taken branch:
    complex (rs, rp) with the TIR continuation ``cos_t -> i b``, the
    ideal-mirror ``r = -1`` on non-TIR reflections, and the
    power-normalized real transmissions ``sqrt(1 - |r|^2)``.  Returns
    ``(rs_re, rs_im, rp_re, rp_im, ts, tp)``."""
    eps = torch.finfo(dtype).eps
    # cos_t continued to the upper complex half-plane under TIR.  A double
    # where around each sqrt (a masked branch's infinite derivative times
    # its zeroed cotangent is NaN), plus an eps**2 clamp on the SELECTED
    # branch: radicand == 0 exactly (critical incidence escapes the strict
    # < 0 TIR test) would feed sqrt'(0) = inf into the backward pass
    eps2 = eps * eps
    one = torch.ones_like(radicand)
    zero = torch.zeros_like(radicand)
    a = torch.where(tir, zero, torch.sqrt(torch.where(
        tir, one, torch.clamp(radicand, min=eps2))))
    b = torch.where(tir, torch.sqrt(torch.where(
        tir, torch.clamp(-radicand, min=eps2), one)), zero)
    rs_re, rs_im = _cdiv(eta * cos_i - a, -b, eta * cos_i + a, b, eps)
    rp_re, rp_im = _cdiv(cos_i - eta * a, -eta * b,
                         cos_i + eta * a, eta * b, eps)
    # ideal mirror (n == 0 sentinel): r = -1 for both components
    mirror = reflects & ~tir
    rs_re = torch.where(mirror, -torch.ones_like(rs_re), rs_re)
    rs_im = torch.where(mirror, torch.zeros_like(rs_im), rs_im)
    rp_re = torch.where(mirror, -torch.ones_like(rp_re), rp_re)
    rp_im = torch.where(mirror, torch.zeros_like(rp_im), rp_im)

    # transmissions matter only on the refract branch; under reflection
    # |r| = 1 makes the radicand 0 and sqrt's derivative infinite, so the
    # sqrt gets a safe value there and is masked after.  The refract branch
    # needs the eps**2 clamp too: grazing refraction drives |r| -> 1
    ts_rad = torch.clamp(1.0 - (rs_re * rs_re + rs_im * rs_im), 0.0, 1.0)
    tp_rad = torch.clamp(1.0 - (rp_re * rp_re + rp_im * rp_im), 0.0, 1.0)
    ts = torch.sqrt(torch.where(reflects, one, torch.clamp(ts_rad, min=eps2)))
    tp = torch.sqrt(torch.where(reflects, one, torch.clamp(tp_rad, min=eps2)))
    return rs_re, rs_im, rp_re, rp_im, ts, tp


def _apply_jones(updates, es_re, es_im, ep_re, ep_im, cs_re, cs_im, cp_re,
                 cp_im, dtype):
    updates.update(
        es_re=(cs_re * es_re - cs_im * es_im).to(dtype),
        es_im=(cs_re * es_im + cs_im * es_re).to(dtype),
        ep_re=(cp_re * ep_re - cp_im * ep_im).to(dtype),
        ep_im=(cp_re * ep_im + cp_im * ep_re).to(dtype),
    )
    return updates


def jones_polarization_reaction(base_reaction=default_reaction):
    """Wrap a reaction with full polarization ray tracing.

    Each ray carries a complex Jones vector ``(Es, Ep)`` in a ray-attached
    s/p basis, stored as the real fields ``es_re, es_im, ep_re, ep_im`` plus
    (3D) the s-axis unit vector ``pol_sx, pol_sy, pol_sz``.  At every
    optical interaction:

    * the amplitudes are rotated into the new plane of incidence (s-axis =
      d x n; at normal incidence the old basis is kept),
    * the Fresnel *amplitude* coefficients of the taken branch are applied:
      complex ``rs = (eta cos_i - cos_t)/(eta cos_i + cos_t)`` and
      ``rp = (cos_i - eta cos_t)/(cos_i + eta cos_t)`` with
      ``cos_t = sqrt(1 - eta^2 sin_i^2)`` continued to ``i b`` under TIR
      (so TIR applies the textbook phase shifts); ideal mirrors (n == 0
      sentinel) reflect both components with ``r = -1``,
    * on refraction the power-normalized real transmissions
      ``sqrt(1 - |rs|^2)`` / ``sqrt(1 - |rp|^2)`` are applied, so
      ``|Es|^2 + |Ep|^2`` stays the ray's radiant power.

    In 2D the plane of incidence is the plane: s is the out-of-plane axis,
    no basis fields are needed and the rotation is the identity.
    Differentiable.  Seed with :func:`seed_polarization`; read back with
    :func:`stokes_parameters`.
    """

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        dtype = rays.p0.dtype
        d, n, nu, cos_i, n_in, _n_out, eta, radicand, tir, reflects = (
            _fresnel_prelude(proj, rays))
        reflects = _effective_reflects(base_updates, reflects)

        es_re, es_im, ep_re, ep_im, updates = _pol_basis_rotation(
            proj, rays, d, n, dtype)
        rs_re, rs_im, rp_re, rp_im, ts, tp = _bare_jones_coefs(
            dtype, cos_i, eta, radicand, tir, reflects)

        cs_re = torch.where(reflects, rs_re, ts)
        cs_im = torch.where(reflects, rs_im, torch.zeros_like(ts))
        cp_re = torch.where(reflects, rp_re, tp)
        cp_im = torch.where(reflects, rp_im, torch.zeros_like(tp))
        _apply_jones(updates, es_re, es_im, ep_re, ep_im, cs_re, cs_im,
                     cp_re, cp_im, dtype)
        return child_p0, child_p1, _merge_updates(base_updates, updates)

    return reaction


def _jones_parts(v, like):
    """The real and imaginary parts of a Jones amplitude (a number or an
    array, complex or real) as per-ray tensors of ``like`` (N,)."""
    if isinstance(v, numbers.Number) and not isinstance(v, torch.Tensor):
        v = complex(v)
        return torch.full_like(like, v.real), torch.full_like(like, v.imag)
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    t = torch.broadcast_to(t.to(like.device), like.shape)
    if t.is_complex():
        return t.real.to(like.dtype), t.imag.to(like.dtype)
    return t.to(like.dtype), torch.zeros_like(like)


def seed_polarization(rays: RaySet, jones=(1.0, 0.0), s_axis=None) -> RaySet:
    """Attach the polarization fields to source rays.

    ``jones``: the complex (Es, Ep) amplitudes, numbers or per-ray arrays
    (``|Es|^2 + |Ep|^2`` is the ray's radiant power).  ``s_axis``: the
    initial s basis vector; in 3D by default the normalized cross product
    of the ray direction with its least-aligned coordinate axis (any
    transverse axis is a valid basis: the first interaction rotates into
    its plane of incidence).  2D rays need no basis.
    """
    dtype = rays.p0.dtype
    n = rays.n_rays
    like = torch.zeros((n,), dtype=dtype, device=rays.p0.device)
    es, ep = jones
    es_re, es_im = _jones_parts(es, like)
    ep_re, ep_im = _jones_parts(ep, like)
    out = rays
    for name, v in (("es_re", es_re), ("es_im", es_im), ("ep_re", ep_re),
                    ("ep_im", ep_im)):
        out = out.with_field(name, v)
    if rays.p0.shape[1] == 2:
        return out
    d = _unit(rays.p1 - rays.p0)
    if s_axis is None:
        s = geometry.transverse_basis(d)[0]
    else:
        s = torch.broadcast_to(
            torch.as_tensor(s_axis, dtype=dtype, device=rays.p0.device),
            (n, 3))
        s = s - d * torch.sum(s * d, dim=-1, keepdim=True)  # transverse part
    s = _unit(s)
    return (out.with_field("pol_sx", s[:, 0])
               .with_field("pol_sy", s[:, 1])
               .with_field("pol_sz", s[:, 2]))


def stokes_parameters(rays: RaySet):
    """Per-ray Stokes parameters from the polarization fields:
    ``S0 = |Es|^2 + |Ep|^2`` (power), ``S1 = |Es|^2 - |Ep|^2``,
    ``S2 = 2 Re(Es conj(Ep))``, ``S3 = -2 Im(Es conj(Ep))`` (S3 = +S0 is
    right-circular in this convention).  Returns a dict of (N,) tensors."""
    es_re, es_im = rays.fields["es_re"], rays.fields["es_im"]
    ep_re, ep_im = rays.fields["ep_re"], rays.fields["ep_im"]
    i_s = es_re * es_re + es_im * es_im
    i_p = ep_re * ep_re + ep_im * ep_im
    return {
        "S0": i_s + i_p,
        "S1": i_s - i_p,
        "S2": 2.0 * (es_re * ep_re + es_im * ep_im),
        "S3": -2.0 * (es_im * ep_re - es_re * ep_im),
    }


class JonesPolarization(RayOperation):
    """Class-op wrapper for :func:`jones_polarization_reaction`: standard
    Snell children plus complex s/p Jones amplitude transport (Fresnel
    amplitude coefficients, TIR phase shifts, basis rotation)."""

    input_signature = frozenset(POL_FIELDS_2D) | {"wavelength"}
    output_signature = frozenset(POL_FIELDS_2D)
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset(POL_FIELDS_2D) | {"wavelength"}

    def __init__(self, base_reaction=default_reaction, **kw):
        super().__init__(**kw)
        self.reaction = jones_polarization_reaction(base_reaction)


# ======================================================================
# optical path length (wavefront / OPD objectives)
# ======================================================================

def _leg(rays):
    return torch.linalg.vector_norm(rays.p1 - rays.p0, dim=-1)


def optical_path_reaction(base_reaction=default_reaction):
    """Wrap a reaction with differentiable optical path length tracking.

    Each ray carries

    * ``opl``: the accumulated optical path length ``sum(n_i * d_i)`` over
      its completed legs, and
    * ``cur_n``: the refractive index of the medium it travels in now
      (the transmitted side's on refraction, unchanged on reflection, TIR
      and mirrors).

    At every optical interaction the finished leg (ray start to the
    projected hit point) adds ``cur_n * |leg|`` to ``opl``.  The last leg
    of a finished or stopped ray is not folded in (target hits do not
    react); :func:`total_optical_path` closes it with the carried
    ``cur_n``.  Seed with :func:`seed_optical_path`.  ``variance(
    total_optical_path)`` over a bundle is the squared RMS wavefront error,
    a differentiable design objective.
    """

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        for f in ("opl", "cur_n"):
            if f not in rays.fields:
                raise KeyError(
                    f"optical_path_reaction: rays carry no {f!r} field; "
                    "seed the source rays with seed_optical_path()")
        d, n, nu, cos_i, n_in, n_out, eta, radicand, tir, reflects = (
            _fresnel_prelude(proj, rays))
        reflects = _effective_reflects(base_updates, reflects)
        # rays.p1 is the projected hit point here (the engine substitutes
        # it before calling the reaction), so this is the finished leg.  A
        # metasurface base reaction reports its imparted phase as optical
        # path in the reserved __opl_add__ update
        opl = (rays.fields["opl"] + rays.fields["cur_n"] * _leg(rays)
               + base_updates.pop("__opl_add__", 0.0))
        # the transmitted side's index: select_eta's eta = n1/n2 has
        # n1 = n_in on internal hits (nu > 0), so the far side is n_out
        # there and n_in otherwise
        n2 = torch.where(nu > 0, n_out, n_in)
        cur_n = torch.where(reflects, rays.fields["cur_n"], n2)
        return child_p0, child_p1, _merge_updates(
            base_updates, {"opl": opl, "cur_n": cur_n})

    return reaction


def seed_optical_path(rays: RaySet, n0=1.0) -> RaySet:
    """Attach the ``opl`` (= 0) and ``cur_n`` (= ``n0``, the index of the
    launch medium; a number or per-ray) fields for
    :func:`optical_path_reaction`."""
    like = torch.zeros((rays.n_rays,), dtype=rays.p0.dtype,
                       device=rays.p0.device)
    return (rays.with_field("opl", like)
                .with_field("cur_n", _per_ray(n0, like)))


def total_optical_path(rays: RaySet):
    """Per-ray total OPL including the last (un-reacted) leg, the slot's
    current segment, travelled in the ``cur_n`` medium."""
    return rays.fields["opl"] + rays.fields["cur_n"] * _leg(rays)


class OpticalPath(RayOperation):
    """Class-op wrapper for :func:`optical_path_reaction`: standard Snell
    children plus per-ray optical path length accumulation."""

    input_signature = frozenset({"opl", "cur_n", "wavelength"})
    output_signature = frozenset({"opl", "cur_n"})
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset({"opl", "cur_n", "wavelength"})

    def __init__(self, base_reaction=default_reaction, **kw):
        super().__init__(**kw)
        self.reaction = optical_path_reaction(base_reaction)


class OldestAncestor(RayOperation):
    """Tags source rays with their index at annotate time."""

    input_signature = frozenset({"oldest_ancestor"})
    output_signature = frozenset({"oldest_ancestor"})
    simple_ray_inheritance = frozenset({"oldest_ancestor"})

    def annotate(self, engine):
        system = engine.optical_system
        start = 0
        for entry in system._source_entries:
            entry._rays = annotate_oldest_ancestor(entry.rays, start)
            start += entry.rays.n_rays


# ======================================================================
# thin-film coated surfaces (multilayer AR / HR stacks)
# ======================================================================

def _coating_inputs(proj, rays, reflects, n_in, n_out, nu,
                    stacks, lens, lmax, coat_ids, dtype):
    """Per-ray characteristic-matrix inputs of the thin-film reactions: the
    coating id (-1 = bare), the sanitized incident and substrate indices of
    the hit side, and the (L, N) layer index and thickness tables in
    TRAVERSAL order (stacks are given outer (mat_out) -> inner (mat_in);
    internal hits see them reversed within the valid prefix).  Returns
    ``(coat, n_inc, n_sub, layer_n, layer_d, layer_valid)``."""
    internal = nu > 0
    n_inc = torch.where(internal, n_in, n_out)
    # the 2D one-sided mirror REFRACTS n_in == 0 internal hits with
    # eta = 1/n_out; the stack must see the same sanitized incident index
    # on refracting branches, while reflecting branches keep the 0
    # sentinel so eta0 = 0 -> r = -1 -> R = 1 (ideal mirror)
    n_inc = torch.where(~reflects & (n_inc == 0), torch.ones_like(n_inc),
                        n_inc)
    n_sub = torch.where(internal, n_out, n_in)
    wl = rays.wavelength
    n_rays = rays.n_rays
    device = rays.p0.device

    coat = _per_surface_table(proj, coat_ids, n_rays, -1)

    if lmax == 0:
        layer_n = torch.ones((0, n_rays), dtype=dtype, device=device)
        layer_d = torch.zeros((0, n_rays), dtype=dtype, device=device)
        return coat, n_inc, n_sub, layer_n, layer_d, None

    # select-chain the per-stack layer tables into per-ray rows
    ray_len = torch.zeros((n_rays,), dtype=torch.int64, device=device)
    for s, length in enumerate(lens):
        ray_len = torch.where(coat == s, length, ray_len)
    rows_n, rows_d = [], []
    for j in range(lmax):
        nj = torch.ones((n_rays,), dtype=dtype, device=device)
        dj = torch.zeros((n_rays,), dtype=dtype, device=device)
        for s, stack in enumerate(stacks):
            if j >= len(stack):
                continue
            n_s, d_s = stack[j]
            n_val = n_s(wl) if callable(n_s) else n_s
            sel = coat == s
            nj = torch.where(sel, _const(n_val, nj), nj)
            dj = torch.where(sel, _const(d_s, dj), dj)
        rows_n.append(nj)
        rows_d.append(dj)
    layer_n = torch.stack(rows_n)          # (L, N)
    layer_d = torch.stack(rows_d)
    jidx = torch.arange(lmax, dtype=torch.int64, device=device)[:, None]
    # internal hits traverse the stack in reverse, within the valid prefix
    ridx = torch.clamp(ray_len[None, :] - 1 - jidx, 0, lmax - 1)
    eff = torch.where(internal[None, :], ridx, jidx)
    layer_n = torch.gather(layer_n, 0, eff)
    layer_d = torch.gather(layer_d, 0, eff)
    layer_valid = jidx < ray_len[None, :]
    layer_n = torch.where(layer_valid, layer_n, torch.ones_like(layer_n))
    layer_d = torch.where(layer_valid, layer_d, torch.zeros_like(layer_d))
    return coat, n_inc, n_sub, layer_n, layer_d, layer_valid


def thin_film_intensity_reaction(stacks, coat_ids,
                                 base_reaction=default_reaction,
                                 field="intensity"):
    """Per-ray intensity transport through thin-film COATED surfaces.

    Surfaces may carry dielectric multilayer stacks (anti-reflection,
    high-reflection, beam-splitter coatings) whose power coefficients come
    from the characteristic-matrix method (:mod:`ops.thinfilm`).  The
    continuing ray's ``fields[field]`` is multiplied by the power fraction
    of the branch it took: ``1 - R`` on refraction, ``R`` on reflection.
    An UNCOATED surface (coat id -1, or a kind with no table) is the bare
    interface: the empty stack's R is the Fresnel reflectance, and TIR and
    the n == 0 mirror give R == 1.

    Parameters
    ----------
    stacks : sequence of coating stacks
        Each a sequence of ``(n, d)`` layers ordered from the mat_OUT side
        toward the mat_IN side; rays arriving from the mat_in side see the
        stack reversed.  ``n``: a number, array or callable
        ``n(wavelength)``.  ``d``: physical thickness in the units of the
        ray wavelengths (nm by convention); it may be a tensor that
        requires grad, to co-optimize coatings with the lens (build the
        reaction inside the loss).
    coat_ids : dict of per-surface coating indices
        ``{"triangles": arr}`` (3D) or ``{"segments": arr, "arcs": arr}``
        (2D), aligned with the scene's merged surface sets (an index into
        ``stacks``; -1 = bare).

    Differentiable; composes with the other trackers via ``base_reaction``.
    """
    stacks = [list(s) for s in stacks]
    lmax = max((len(s) for s in stacks), default=0)
    lens = [len(s) for s in stacks]

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        dtype = rays.p0.dtype
        eps = torch.finfo(dtype).eps
        d, n, nu, cos_i, n_in, n_out, eta, radicand, tir, reflects = (
            _fresnel_prelude(proj, rays))
        reflects = _effective_reflects(base_updates, reflects)
        old = _chain_field(base_updates, rays, field,
                           "thin_film_intensity_reaction")
        coat, n_inc, n_sub, layer_n, layer_d, layer_valid = _coating_inputs(
            proj, rays, reflects, n_in, n_out, nu,
            stacks, lens, lmax, coat_ids, dtype)

        cos_inc = torch.clamp(cos_i, eps, 1.0)
        rs, rp = thinfilm.stack_r(n_inc, n_sub, cos_inc, rays.wavelength,
                                  layer_n, layer_d, layer_valid)
        R = torch.clamp(0.5 * (torch.abs(rs) ** 2 + torch.abs(rp) ** 2),
                        0.0, 1.0).to(dtype)
        factor = torch.where(reflects, R, 1.0 - R)
        efficiency = base_updates.pop("__efficiency__", None)
        if efficiency is not None:
            factor = factor * efficiency
        return child_p0, child_p1, _merge_updates(
            base_updates, {field: old * factor.to(old.dtype)})

    return reaction


class ThinFilmIntensity(RayOperation):
    """Class-op wrapper for :func:`thin_film_intensity_reaction`: standard
    Snell children plus coated-surface power transport."""

    input_signature = frozenset({"intensity", "wavelength"})
    output_signature = frozenset({"intensity"})
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset({"intensity", "wavelength"})

    def __init__(self, stacks, coat_ids, base_reaction=default_reaction,
                 field="intensity", **kw):
        super().__init__(**kw)
        self.reaction = thin_film_intensity_reaction(stacks, coat_ids,
                                                     base_reaction, field)


def thin_film_jones_reaction(stacks, coat_ids,
                             base_reaction=default_reaction):
    """Full polarization transport through thin-film COATED surfaces.

    On COATED surfaces (coat id >= 0) the ray's Jones vector is multiplied
    by the stack's COMPLEX amplitude coefficients of
    :func:`ops.thinfilm.stack_rt`: ``(rs, rp)`` on the reflect branch, the
    power-normalized ``(ts, tp)`` on the refract branch, so coatings
    diattenuate and retard.  BARE surfaces (coat id -1) take exactly the
    bare-Fresnel path of :func:`jones_polarization_reaction`, and a coated
    surface whose layers have zero thickness degenerates to it.

    Conventions:

    * The characteristic-matrix rp has the opposite sign of the engine's
      Fresnel-convention rp (Verdet vs Fresnel reflected-p basis); the
      reflected rp is sign-flipped here (tp needs none), so the empty stack
      matches :func:`jones_polarization_reaction` on every branch.
    * Mirror-substrate rows (n == 0 sentinel) take the perfect-conductor
      limit (``pec_substrate`` of ``stack_rt``): the bare mirror reflects
      with r = -1 for both components and a coating adds its round-trip
      phase; these rows keep the matrix-convention rp sign.
    * ``|Es|^2 + |Ep|^2`` tracks radiant power on every branch.

    Parameters are those of :func:`thin_film_intensity_reaction`; seed rays
    with :func:`seed_polarization`, read back with
    :func:`stokes_parameters`.  Differentiable in layer thicknesses and
    indices.
    """
    stacks = [list(s) for s in stacks]
    lmax = max((len(s) for s in stacks), default=0)
    lens = [len(s) for s in stacks]

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        dtype = rays.p0.dtype
        eps = torch.finfo(dtype).eps
        d, n, nu, cos_i, n_in, n_out, eta, radicand, tir, reflects = (
            _fresnel_prelude(proj, rays))
        reflects = _effective_reflects(base_updates, reflects)

        es_re, es_im, ep_re, ep_im, updates = _pol_basis_rotation(
            proj, rays, d, n, dtype)

        # bare-Fresnel path: jones_polarization_reaction's amplitudes
        brs_re, brs_im, brp_re, brp_im, bts, btp = _bare_jones_coefs(
            dtype, cos_i, eta, radicand, tir, reflects)

        # stack path: complex amplitudes of the characteristic matrix
        coat, n_inc, n_sub, layer_n, layer_d, layer_valid = _coating_inputs(
            proj, rays, reflects, n_in, n_out, nu,
            stacks, lens, lmax, coat_ids, dtype)
        cos_inc = torch.clamp(cos_i, eps, 1.0)
        pec = n_sub == 0
        srs, srp, sts, stp = thinfilm.stack_rt(
            n_inc, n_sub, cos_inc, rays.wavelength,
            layer_n, layer_d, layer_valid, pec_substrate=pec)
        # Verdet -> Fresnel p-sign flip of the REFLECTED p amplitude on
        # dielectric rows; PEC rows keep the matrix sign so the bare mirror
        # gives rp = -1
        p_sign = torch.where(pec, torch.ones_like(cos_i),
                             -torch.ones_like(cos_i))
        srp = srp * p_sign.to(srp.dtype)

        coated = coat >= 0
        zero = torch.zeros_like(bts)
        rs_re = torch.where(coated, srs.real.to(dtype), brs_re)
        rs_im = torch.where(coated, srs.imag.to(dtype), brs_im)
        rp_re = torch.where(coated, srp.real.to(dtype), brp_re)
        rp_im = torch.where(coated, srp.imag.to(dtype), brp_im)
        ts_re = torch.where(coated, sts.real.to(dtype), bts)
        ts_im = torch.where(coated, sts.imag.to(dtype), zero)
        tp_re = torch.where(coated, stp.real.to(dtype), btp)
        tp_im = torch.where(coated, stp.imag.to(dtype), zero)

        cs_re = torch.where(reflects, rs_re, ts_re)
        cs_im = torch.where(reflects, rs_im, ts_im)
        cp_re = torch.where(reflects, rp_re, tp_re)
        cp_im = torch.where(reflects, rp_im, tp_im)
        _apply_jones(updates, es_re, es_im, ep_re, ep_im, cs_re, cs_im,
                     cp_re, cp_im, dtype)
        return child_p0, child_p1, _merge_updates(base_updates, updates)

    return reaction


class ThinFilmJones(RayOperation):
    """Class-op wrapper for :func:`thin_film_jones_reaction`: standard
    Snell children plus complex s/p Jones transport, coated surfaces
    applying their multilayer amplitude coefficients; bare surfaces as in
    :class:`JonesPolarization`."""

    input_signature = frozenset(POL_FIELDS_2D) | {"wavelength"}
    output_signature = frozenset(POL_FIELDS_2D)
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset(POL_FIELDS_2D) | {"wavelength"}

    def __init__(self, stacks, coat_ids, base_reaction=default_reaction,
                 **kw):
        super().__init__(**kw)
        self.reaction = thin_film_jones_reaction(stacks, coat_ids,
                                                 base_reaction)


# ======================================================================
# diffraction gratings
# ======================================================================

def _check_kind(what, kind):
    if kind not in ("transmission", "reflection"):
        raise ValueError(f"{what} kind must be 'transmission' or "
                         f"'reflection', got {kind!r}")


def _efficiency_update(base_updates, efficiencies, ids, use, like, value):
    """Chain the per-profile efficiency of the rays that took a kick into
    the reserved ``__efficiency__`` update (``value(s, e)`` evaluates
    profile ``s``'s entry ``e``)."""
    eff = torch.ones_like(like)
    for s, e in enumerate(efficiencies):
        if e is None:
            continue
        val = _per_ray(value(s, e) if callable(e) else e, like)
        eff = torch.where(ids == s, val, eff)
    base_updates["__efficiency__"] = (
        base_updates.get("__efficiency__", 1.0)
        * torch.where(use, eff, torch.ones_like(eff)))


def grating_reaction(gratings, grating_ids, base_reaction=default_reaction,
                     efficiencies=None):
    """Diffraction-grating surfaces: the vector grating equation as a
    reaction.  For rays hitting a grating surface the child direction is

        u_out_t = (n1 / n2) u_in_t  +  (m lambda / (n2 a)) g_t
        u_out   = u_out_t + sign(u_in . n) sqrt(1 - |u_out_t|^2) n   (transmission)
                = u_out_t - sign(u_in . n) sqrt(1 - |u_out_t|^2) n   (reflection)

    with ``u_t`` the tangential component, ``a`` the groove spacing, ``m``
    the order, ``g_t`` the unit in-plane grating vector, ``n1``/``n2`` the
    incident / far-side indices (``n2 = n1`` for reflection gratings) and
    ``lambda`` the vacuum wavelength in the units of ``a``.  Order 0
    transmission is Snell refraction.  Evanescent orders (|u_out_t| > 1)
    and non-grating surfaces keep the base reaction's child.  The POWER
    into the order comes from ``efficiencies``.

    Parameters
    ----------
    gratings : sequence of (spacing, order, kind[, groove])
        ``spacing``: groove period (a number or a tensor).  ``order``: int.
        ``kind``: "transmission" or "reflection".  ``groove`` (3D only): a
        3-vector whose tangent-plane projection is the grating vector; in
        2D the grating vector is the in-plane tangent ``rot90(normal)``.
    grating_ids : dict of per-surface tables (an index into ``gratings``,
        -1 = ordinary surface).
    efficiencies : optional sequence aligned with ``gratings``
        ``None`` (unit power), a number, or a callable
        ``eta(order, wavelength, cos_i) -> (N,)``.  Emitted as the reserved
        ``__efficiency__`` update, which the intensity trackers multiply
        into the branch's power once.

    Field trackers compose as OUTER wrappers and follow the diffracted
    child's branch through the reserved ``__reflects__`` update.
    """
    gratings = list(gratings)

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        if not gratings:
            return (child_p0, child_p1, base_updates) if base_updates else (
                child_p0, child_p1)
        dtype = rays.p0.dtype
        n_rays = rays.n_rays
        device = rays.p0.device
        d, n, nu, cos_i, n_in, n_out, eta, radicand, tir, reflects = (
            _fresnel_prelude(proj, rays))
        internal = nu > 0
        n1 = torch.where(internal, n_in, n_out)
        n2_far = torch.where(internal, n_out, n_in)

        grat = _per_surface_table(proj, grating_ids, n_rays, -1)

        spacing = torch.ones((n_rays,), dtype=dtype, device=device)
        order = torch.zeros((n_rays,), dtype=dtype, device=device)
        is_refl = torch.zeros((n_rays,), dtype=torch.bool, device=device)
        if proj.dim == 3:
            groove = torch.zeros((n_rays, 3), dtype=dtype, device=device)
        for s, spec in enumerate(gratings):
            a_s, m_s, kind_s = spec[0], spec[1], spec[2]
            sel = grat == s
            spacing = torch.where(sel, _const(a_s, spacing), spacing)
            order = torch.where(sel, float(m_s), order)
            _check_kind("grating", kind_s)
            is_refl = (is_refl | sel) if kind_s == "reflection" else (
                is_refl & ~sel)
            if proj.dim == 3:
                if len(spec) < 4:
                    raise ValueError(
                        "3D gratings need a groove vector: "
                        "(spacing, order, kind, groove)")
                g = torch.as_tensor(spec[3], dtype=dtype, device=device)
                groove = torch.where(sel[:, None], g[None, :], groove)

        tiny = torch.finfo(dtype).tiny
        if proj.dim == 3:
            g_t = groove - torch.sum(groove * n, dim=-1, keepdim=True) * n
            g_t = g_t / torch.clamp(_norm(g_t), min=tiny)
        else:
            g_t = torch.stack([-n[:, 1], n[:, 0]], dim=1)

        n2 = torch.where(is_refl, n1, n2_far)
        n2_safe = torch.where(n2 != 0, n2, torch.ones_like(n2))
        a_safe = torch.clamp(spacing, min=tiny)
        shift = order * rays.wavelength / (n2_safe * a_safe)
        p0, p1, use = _tangential_child(
            rays, cfg, d, n, nu, n1, n2, is_refl, shift[:, None] * g_t,
            child_p0, child_p1, grat >= 0)
        # the branch the child took, for outer field trackers
        base_updates["__reflects__"] = torch.where(use, is_refl, reflects)
        if efficiencies is not None:
            _efficiency_update(
                base_updates, efficiencies, grat, use, order,
                lambda s, e: e(gratings[s][1], rays.wavelength, cos_i))
        return p0, p1, base_updates

    return reaction


class Grating(RayOperation):
    """Class-op wrapper for :func:`grating_reaction`: Snell children except
    on grating-marked surfaces, which diffract per the grating equation."""

    input_signature = frozenset({"wavelength"})
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset({"wavelength"})

    def __init__(self, gratings, grating_ids,
                 base_reaction=default_reaction, efficiencies=None, **kw):
        super().__init__(**kw)
        self.reaction = grating_reaction(gratings, grating_ids,
                                         base_reaction,
                                         efficiencies=efficiencies)


# ======================================================================
# absorbing media (Beer-Lambert bulk attenuation)
# ======================================================================

def absorption_reaction(alpha_tables, base_reaction=default_reaction,
                        field="intensity"):
    """Beer-Lambert bulk absorption: each finished leg multiplies the ray's
    ``fields[field]`` by ``exp(-alpha * leg_length)``, ``alpha`` the
    absorption coefficient (1/length, scene units) of the medium travelled.

    The current medium's coefficient rides in a ``cur_alpha`` field (seed
    with :func:`seed_absorption`), updated on refraction to the far side's
    coefficient as :func:`optical_path_reaction` updates ``cur_n``.  The
    last leg of a finished ray is closed by :func:`final_intensity`.

    ``alpha_tables``: ``{"triangles": (alpha_in, alpha_out)}`` or
    ``{"segments": (...), "arcs": (...)}``, per-surface arrays aligned
    with the scene's merged surface sets giving the coefficient of the
    mat_in and mat_out media (tensors may require grad).  Kinds with no
    table are lossless.  Composes via ``base_reaction``.
    """

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        if "cur_alpha" not in rays.fields:
            raise KeyError(
                "absorption_reaction: rays carry no 'cur_alpha' field; seed "
                "the source rays with seed_absorption()")
        dtype = rays.p0.dtype
        d, n, nu, cos_i, n_in, n_out, eta, radicand, tir, reflects = (
            _fresnel_prelude(proj, rays))
        reflects = _effective_reflects(base_updates, reflects)
        internal = nu > 0
        a_in = _per_surface_table(proj, alpha_tables, rays.n_rays, 0.0,
                                  dtype, pick=lambda tab: tab[0])
        a_out = _per_surface_table(proj, alpha_tables, rays.n_rays, 0.0,
                                   dtype, pick=lambda tab: tab[1])

        old = _chain_field(base_updates, rays, field, "absorption_reaction")
        attenuated = old * torch.exp(
            -rays.fields["cur_alpha"] * _leg(rays)).to(old.dtype)
        # the far side's medium on refraction (internal hits transmit into
        # the mat_out side)
        a_far = torch.where(internal, a_out, a_in)
        cur = torch.where(reflects, rays.fields["cur_alpha"], a_far)
        return child_p0, child_p1, _merge_updates(
            base_updates, {field: attenuated, "cur_alpha": cur})

    return reaction


def seed_absorption(rays: RaySet, alpha0=0.0, field="intensity",
                    seed_field=True) -> RaySet:
    """Attach ``cur_alpha`` (= the launch medium's absorption coefficient)
    and, unless the intensity field is already seeded, ``fields[field] =
    1``."""
    like = torch.zeros((rays.n_rays,), dtype=rays.p0.dtype,
                       device=rays.p0.device)
    out = rays.with_field("cur_alpha", _per_ray(alpha0, like))
    if seed_field and field not in rays.fields:
        out = out.with_field(field, torch.ones_like(like))
    return out


def final_intensity(rays: RaySet, field="intensity"):
    """Close the last (non-reacting) leg of finished rays: the tracked
    intensity times the absorption of the final stretch ``p0 -> p1``."""
    return rays.fields[field] * torch.exp(-rays.fields["cur_alpha"]
                                          * _leg(rays))


class Absorption(RayOperation):
    """Class-op wrapper for :func:`absorption_reaction`."""

    input_signature = frozenset({"intensity", "cur_alpha", "wavelength"})
    output_signature = frozenset({"intensity", "cur_alpha"})
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset({"intensity", "cur_alpha",
                                        "wavelength"})

    def __init__(self, alpha_tables, base_reaction=default_reaction,
                 field="intensity", **kw):
        super().__init__(**kw)
        self.reaction = absorption_reaction(alpha_tables, base_reaction,
                                            field)


# ======================================================================
# metasurfaces (generalized law of refraction)
# ======================================================================

def metasurface_reaction(phases, meta_ids, base_reaction=default_reaction,
                         efficiencies=None):
    """Metasurface / phase-profile surfaces: the generalized law of
    refraction [Yu et al., Science 334, 333 (2011)] as a reaction.

    A surface marked in ``meta_ids`` imparts the tangential momentum of its
    phase profile ``phi(point, wavelength)``:

        k_out_t = k_in_t + grad_t(phi)
        u_out_t = (n1/n2) u_in_t + (lambda / (2 pi n2)) grad_t(phi)

    with the normal component rebuilt by a clamped sqrt (transmission or
    reflection kinds, as in :func:`grating_reaction`).  The phase profile is
    a torch function of one hit point ``(dim,)`` and a scalar vacuum
    wavelength returning a scalar; its spatial gradient is taken with
    ``torch.func.vmap(torch.func.grad_and_value(phase_fn))`` and projected
    into the tangent plane.  Tensors the profile closes over that require
    grad get their gradient through the trace's backward (co-design of
    phase profiles and glass: build the reaction inside the loss).

    Parameters
    ----------
    phases : sequence of (phase_fn, kind)
        ``phase_fn(point, wavelength) -> phase`` in radians; ``kind``:
        "transmission" or "reflection".
    meta_ids : dict of per-surface tables (an index into ``phases``, -1 =
        ordinary surface).
    efficiencies : optional sequence aligned with ``phases``
        ``None``, a number, or ``eta(wavelength, cos_i) -> (N,)``; the
        reserved ``__efficiency__`` update, as in :func:`grating_reaction`.

    Evanescent kicks (|u_out_t| >= 1) keep the base reaction's child.  The
    imparted phase is reported as optical path (``__opl_add__``) to a
    composed :func:`optical_path_reaction`.
    """
    phases = list(phases)

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        if not phases:
            return (child_p0, child_p1, base_updates) if base_updates else (
                child_p0, child_p1)
        dtype = rays.p0.dtype
        d, n, nu, cos_i, n_in, n_out, eta, radicand, tir, reflects = (
            _fresnel_prelude(proj, rays))
        internal = nu > 0
        n1 = torch.where(internal, n_in, n_out)
        n2_far = torch.where(internal, n_out, n_in)

        meta = _per_surface_table(proj, meta_ids, rays.n_rays, -1)

        # phase gradient and value of every profile at every hit point,
        # selected by the per-ray id (the profile count is small)
        point = rays.p1  # the engine substitutes the projected hit point
        grad_phi = torch.zeros_like(point)
        phi = torch.zeros_like(point[:, 0])
        is_refl = torch.zeros_like(meta, dtype=torch.bool)
        for s, (phase_fn, kind_s) in enumerate(phases):
            _check_kind("metasurface", kind_s)
            gv = torch.func.vmap(torch.func.grad_and_value(phase_fn,
                                                           argnums=0))
            g, val = gv(point, rays.wavelength)
            sel = meta == s
            grad_phi = torch.where(sel[:, None], g.to(dtype), grad_phi)
            phi = torch.where(sel, val.to(dtype), phi)
            is_refl = (is_refl | sel) if kind_s == "reflection" else (
                is_refl & ~sel)

        g_t = grad_phi - torch.sum(grad_phi * n, dim=-1, keepdim=True) * n
        n2 = torch.where(is_refl, n1, n2_far)
        n2_safe = torch.where(n2 != 0, n2, torch.ones_like(n2))
        kick = rays.wavelength / (2.0 * math.pi * n2_safe)
        p0, p1, use = _tangential_child(
            rays, cfg, d, n, nu, n1, n2, is_refl, kick[:, None] * g_t,
            child_p0, child_p1, meta >= 0)
        base_updates["__reflects__"] = torch.where(use, is_refl, reflects)
        # the imparted phase is optical path (phi lambda / 2 pi), reported
        # for a composed OPL tracker
        base_updates["__opl_add__"] = torch.where(
            use, phi * rays.wavelength / (2.0 * math.pi),
            torch.zeros_like(phi))
        if efficiencies is not None:
            _efficiency_update(
                base_updates, efficiencies, meta, use, phi,
                lambda s, e: e(rays.wavelength, cos_i))
        return p0, p1, base_updates

    return reaction


def hyperbolic_metalens_phase(focal_length, design_wavelength, axis=0,
                              center=None):
    """The ideal metalens profile ``phi(p) = -(2 pi / lambda_0)
    (sqrt(r^2 + f^2) - f)``, ``r`` the in-plane distance from the lens
    centre: it focuses a collimated design-wavelength beam to a point at
    distance f [Khorasaninejad et al., Science 352, 1190 (2016)].
    ``axis``: the optical-axis coordinate index (excluded from r)."""

    def phase(point, wavelength):
        del wavelength  # static structure: the kick is fixed at design
        rel = point if center is None else point - torch.as_tensor(
            center, dtype=point.dtype, device=point.device)
        r2 = torch.sum(rel * rel) - rel[axis] * rel[axis]
        f = _const(focal_length, point)
        return -2.0 * math.pi / design_wavelength * (
            torch.sqrt(r2 + f * f) - f)

    return phase


class Metasurface(RayOperation):
    """Class-op wrapper for :func:`metasurface_reaction`."""

    input_signature = frozenset({"wavelength"})
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset({"wavelength"})

    def __init__(self, phases, meta_ids, base_reaction=default_reaction,
                 efficiencies=None, **kw):
        super().__init__(**kw)
        self.reaction = metasurface_reaction(phases, meta_ids, base_reaction,
                                             efficiencies=efficiencies)


# ======================================================================
# the counter-based random stream of the stochastic reactions
# ======================================================================

_M32 = 0xFFFFFFFF
MIX_STRIDE = 0x9E3779B9


def _mul32(x, c):
    """``x * c`` modulo 2^32 for int64 tensors ``x`` in [0, 2^32) and a
    32-bit constant ``c``, by 16-bit halves of ``c``: no partial product
    reaches 2^49, so nothing overflows int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """A 32-bit integer hash (Wellons' lowbias32) of int64 tensors holding
    32-bit words."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _words(key, mix, first, count):
    """Words ``first .. first + count - 1`` of the draw of ``(key, mix)``:
    32-bit hashes of the key's two halves, ``mix`` and the word's index."""
    key = int(key) & ((1 << 64) - 1)
    base = _hash32(_hash32((mix & _M32) ^ (key & _M32)) ^ (key >> 32))
    return [_hash32(base ^ (((j + 1) * MIX_STRIDE) & _M32))
            for j in range(first, first + count)]


def _uniform53(w0, w1):
    """Float64 uniforms in (0, 1) from 53 random bits of two words (an
    all-zero draw gives 2^-54)."""
    bits = ((w0 >> 11) << 32) | w1
    u = bits.to(torch.float64)
    return torch.where(bits == 0, torch.full_like(u, 0.5), u) * 2.0 ** -53


def ray_mix(ctr):
    """The stream position of every slot at its interaction counter ``ctr``
    (N,): ``slot + ctr * 0x9E3779B9`` modulo 2^32, as int64."""
    slot = torch.arange(ctr.shape[0], dtype=torch.int64, device=ctr.device)
    return (slot + ctr.to(torch.int64) * MIX_STRIDE) & _M32


def ray_uniform(key, mix, dtype):
    """One uniform in (0, 1) a ray: 24 random bits in float32, 53 in
    float64 (an all-zero draw gives half the smallest step, never 0).
    ``key``: an integer seed; ``mix``: (N,) int64 stream positions
    (:func:`ray_mix`).  Integer arithmetic only, so the bits are the same
    on every device."""
    if dtype == torch.float64:
        return _uniform53(*_words(key, mix, 0, 2))
    bits = _words(key, mix, 0, 1)[0] >> 8
    u = bits.to(dtype)
    return torch.where(bits == 0, torch.full_like(u, 0.5), u) * 2.0 ** -24


def ray_normal(key, mix, dim, dtype):
    """``dim`` standard normals a ray, (N, dim): Box-Muller on float64
    uniforms of 53 bits (finite: no uniform is 0), rounded to ``dtype``.
    Same arguments as :func:`ray_uniform`; the words differ from its."""
    pairs = (dim + 1) // 2
    words = _words(key, mix, 2, 4 * pairs)
    z = []
    for p in range(pairs):
        u1 = _uniform53(words[4 * p], words[4 * p + 1])
        u2 = _uniform53(words[4 * p + 2], words[4 * p + 3])
        r = torch.sqrt(-2.0 * torch.log(u1))
        a = (2.0 * math.pi) * u2
        z += [r * torch.cos(a), r * torch.sin(a)]
    return torch.stack(z[:dim], dim=1).to(dtype)


# ======================================================================
# rough surfaces (Gaussian micro-facet scattering lobe)
# ======================================================================

def rough_surface_reaction(sigmas, rough_ids, key,
                           base_reaction=default_reaction):
    """Monte-Carlo surface roughness: children of marked surfaces are
    scattered in a Gaussian lobe around the specular / refracted direction
    (the small-slope micro-facet limit), for stray-light and diffuser
    models.

    The randomness is stateless and reproducible: each ray carries a
    ``scatter_ctr`` interaction counter (seed with :func:`seed_scatter`)
    and draws :func:`ray_normal` at ``ray_mix(scatter_ctr)`` of ``key``, so
    the same key gives the same trace and a new key resamples the
    roughness.  An ensemble over keys is a loop of traces.

    Parameters
    ----------
    sigmas : sequence of numbers or tensors
        RMS scattering angle (radians) per roughness class; differentiable
        through the reparameterized Gaussian perturbation.
    rough_ids : dict of per-surface tables (an index into ``sigmas``, -1 =
        smooth).
    key : int
        Seed of the scatter stream.

    An unmarked surface keeps the base child exactly; sigma == 0 on a
    marked surface keeps it to rounding (the scattered branch stays
    selected, so d(child)/d(sigma) is the true linearization there).
    Below-horizon draws of wide lobes at grazing incidence are folded back
    into the child's hemisphere.
    """
    sigmas = list(sigmas)

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        if "scatter_ctr" not in rays.fields:
            raise KeyError(
                "rough_surface_reaction: rays carry no 'scatter_ctr' "
                "field; seed the source rays with seed_scatter()")
        if not sigmas:
            return child_p0, child_p1, base_updates
        dtype = rays.p0.dtype
        n_rays = rays.n_rays
        rough = _per_surface_table(proj, rough_ids, n_rays, -1)
        sigma = torch.zeros((n_rays,), dtype=dtype, device=rays.p0.device)
        for s, sg in enumerate(sigmas):
            sigma = torch.where(rough == s, _const(sg, sigma), sigma)

        ctr = rays.fields["scatter_ctr"]
        dim = child_p0.shape[-1]
        g = ray_normal(key, ray_mix(ctr), dim, dtype)

        u = _unit(child_p1 - child_p0)
        if dim == 2:
            # rotate the child direction by a Gaussian angle
            ang = sigma * g[:, 0]
            ca, sa = torch.cos(ang), torch.sin(ang)
            scattered = torch.stack([ca * u[:, 0] - sa * u[:, 1],
                                     sa * u[:, 0] + ca * u[:, 1]], dim=1)
        else:
            # two Gaussian components in the transverse frame of u
            t1, t2 = geometry.transverse_basis(u)
            scattered = _unit(u + (sigma * g[:, 0])[:, None] * t1
                              + (sigma * g[:, 1])[:, None] * t2)

        # fold below-horizon draws back into the child's hemisphere: near
        # grazing a wide lobe would otherwise send reflected rays through
        # the surface
        n_surf = _fresnel_prelude(proj, rays)[1]
        s_dot = torch.sum(scattered * n_surf, dim=-1)
        u_dot = torch.sum(u * n_surf, dim=-1)
        crossed = (s_dot * u_dot) < 0
        scattered = torch.where(crossed[:, None],
                                scattered - 2.0 * s_dot[:, None] * n_surf,
                                scattered)

        # no sigma != 0 gate: the scattered branch stays selected at
        # sigma == 0, so d(child)/d(sigma) is the true linearization there
        use = rough >= 0
        p1 = torch.where(use[:, None],
                         child_p0 + cfg.new_ray_length * scattered, child_p1)
        return child_p0, p1, _merge_updates(
            base_updates, {"scatter_ctr": ctr + 1})

    return reaction


def seed_scatter(rays: RaySet) -> RaySet:
    """Attach the ``scatter_ctr`` interaction counter for
    :func:`rough_surface_reaction`."""
    return rays.with_field("scatter_ctr", torch.zeros(
        (rays.n_rays,), dtype=torch.int32, device=rays.p0.device))


class RoughSurface(RayOperation):
    """Class-op wrapper for :func:`rough_surface_reaction`."""

    input_signature = frozenset({"scatter_ctr", "wavelength"})
    output_signature = frozenset({"scatter_ctr"})
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset({"scatter_ctr", "wavelength"})

    def __init__(self, sigmas, rough_ids, key,
                 base_reaction=default_reaction, **kw):
        super().__init__(**kw)
        self.reaction = rough_surface_reaction(sigmas, rough_ids, key,
                                               base_reaction)


# ======================================================================
# surface absorbers (baffles, vanes, housing walls)
# ======================================================================

def surface_absorber_reaction(absorptivity_tables,
                              base_reaction=default_reaction,
                              field="intensity"):
    """Per-SURFACE absorptivity: each interaction with a marked surface
    multiplies the ray's ``fields[field]`` by ``1 - A`` (A the surface's
    absorptivity), for black paint, baffles and housing walls in
    stray-light analyses.  Unmarked kinds lose nothing.

    ``absorptivity_tables``: ``{"triangles": arr}`` / ``{"segments": arr,
    "arcs": arr}`` per-surface absorptivity in [0, 1] (tensors may require
    grad).  Composes via ``base_reaction`` (multiplicative chaining on the
    shared field).
    """

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        a = _per_surface_table(proj, absorptivity_tables, rays.n_rays, 0.0,
                               rays.p0.dtype)
        old = _chain_field(base_updates, rays, field,
                           "surface_absorber_reaction")
        factor = torch.clamp(1.0 - a, 0.0, 1.0)
        return child_p0, child_p1, _merge_updates(
            base_updates, {field: old * factor.to(old.dtype)})

    return reaction


class SurfaceAbsorber(RayOperation):
    """Class-op wrapper for :func:`surface_absorber_reaction`."""

    input_signature = frozenset({"intensity", "wavelength"})
    output_signature = frozenset({"intensity"})
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset({"intensity", "wavelength"})

    def __init__(self, absorptivity_tables, base_reaction=default_reaction,
                 field="intensity", **kw):
        super().__init__(**kw)
        self.reaction = surface_absorber_reaction(absorptivity_tables,
                                                  base_reaction, field)


# ======================================================================
# ghost-path (multi-branch) tracing for coated optics
# ======================================================================

def _forced_directions(d, n, nu, cos_i, eta, radicand, eps):
    """The specular and the (clamped) Snell-refracted directions of every
    ray, the transmitted one through a mirror sentinel straight on:
    ``(refl_dir, trans_dir)``."""
    # oriented normal m faces the incoming ray (m . d = -cos_i); at
    # grazing nu == 0 pick +n (the sign is irrelevant: cos_i == 0)
    sgn = torch.where(nu >= 0, torch.ones_like(nu), -torch.ones_like(nu))
    m = -sgn[:, None] * n
    refl_dir = d - 2.0 * nu[:, None] * n
    # forced transmit: vector Snell with the engine's clamped radicand (TIR
    # slots get the near-tangential limit: zero power via the trackers,
    # finite gradients via the eps^2 floor)
    cos_t = torch.sqrt(torch.clamp(radicand, min=eps * eps))
    trans_dir = eta[:, None] * d + (eta * cos_i - cos_t)[:, None] * m
    # through a mirror sentinel (eta == 0) the transmitted direction
    # degenerates to ~0; continue straight instead
    trans_dir = torch.where((eta == 0.0)[:, None], d, trans_dir)
    return refl_dir, trans_dir


def branch_override_reaction(schedule, base_reaction=default_reaction):
    """Deterministic ghost-path tracing: force the reflect / transmit
    branch per optical interaction.

    The fixed-slot engine follows ONE child per interaction, so a partially
    reflective surface can weight both branches but never follow both.  A
    *branch schedule* assigns each interaction index a forced branch, and
    re-tracing the same rays under different schedules enumerates the
    ghost tree (double-bounce lens ghosts are schedule ``[0, 1, 1, 0]``:
    transmit, reflect, reflect, transmit).

    Parameters
    ----------
    schedule : (K,) int sequence or tensor
        Per-interaction branch codes, indexed by the ray's own interaction
        counter (the ``branch_ctr`` field, seeded with
        :func:`seed_branch_counter`):

        * ``-1``: follow physics (the base reaction's child),
        * ``0``: force TRANSMIT, the Snell-refracted direction (under TIR
          the clamped near-tangential limit, through an n == 0 mirror
          straight on; both carry zero power through the intensity
          trackers),
        * ``1``: force REFLECT, the specular direction.

        Interactions past ``len(schedule)`` follow physics.  The JAX
        package vmaps one trace over a (P, K) batch of schedules; a trace
        that launches CUDA kernels cannot be vmapped, so the port traces
        the schedules one after another (:func:`all_branch_schedules`
        gives the rows).

    Composes as a BASE reaction under the field trackers, which follow the
    forced branch through the reserved ``__reflects__`` update, so
    ``thin_film_intensity_reaction(..., base_reaction=
    branch_override_reaction(sched))`` multiplies exactly the R's and T's
    of the forced path.
    """

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        if "branch_ctr" not in rays.fields:
            raise KeyError(
                "branch_override_reaction: rays carry no 'branch_ctr' "
                "field; seed the source rays with seed_branch_counter()")
        eps = torch.finfo(rays.p0.dtype).eps
        ctr = rays.fields["branch_ctr"]

        sched = torch.as_tensor(schedule, dtype=torch.int32,
                                device=rays.p0.device).reshape(-1)
        # a follow-physics sentinel past the schedule's end (the clamp keeps
        # the gather in bounds)
        sched = torch.cat([sched, sched.new_full((1,), -1)])
        force = sched[torch.clamp(ctr.long(), 0, sched.shape[0] - 1)]

        d, n, nu, cos_i, n_in, n_out, eta, radicand, tir, reflects = (
            _fresnel_prelude(proj, rays))
        refl_dir, trans_dir = _forced_directions(d, n, nu, cos_i, eta,
                                                 radicand, eps)
        forced_dir = torch.where((force == 1)[:, None], refl_dir, trans_dir)
        use = force >= 0
        p0 = torch.where(use[:, None], rays.p1, child_p0)
        p1 = torch.where(use[:, None],
                         rays.p1 + cfg.new_ray_length * forced_dir, child_p1)

        base_reflects = _effective_reflects(base_updates, reflects)
        base_updates["__reflects__"] = torch.where(use, force == 1,
                                                   base_reflects)
        return p0, p1, _merge_updates(base_updates, {"branch_ctr": ctr + 1})

    return reaction


def seed_branch_counter(rays: RaySet) -> RaySet:
    """Attach the ``branch_ctr`` interaction counter for
    :func:`branch_override_reaction` (one a optical interaction, so
    schedules index surface encounters, not bounces)."""
    return rays.with_field("branch_ctr", torch.zeros(
        (rays.n_rays,), dtype=torch.int32, device=rays.p0.device))


def all_branch_schedules(depth: int, device=None):
    """The (2**depth, depth) int32 tensor of every forced branch schedule of
    the given depth, the full binary ghost tree.  Row bit j is the branch
    at interaction j (0 transmit, 1 reflect); trace the rows one by one
    with :func:`branch_override_reaction`.

    Leaves that exit after j < depth interactions are shared by
    ``2**(depth - j)`` rows; divide such a leaf's power by that
    multiplicity when summing the tree (or sum ``power / 2**(depth -
    branch_ctr)``)."""
    device = resolve_device(device)
    idx = torch.arange(1 << depth, dtype=torch.int64, device=device)
    shifts = torch.arange(depth, dtype=torch.int64, device=device)
    return ((idx[:, None] >> shifts) & 1).to(torch.int32)


class BranchOverride(RayOperation):
    """Class-op wrapper for :func:`branch_override_reaction`: children
    follow a forced reflect / transmit schedule for ghost-path
    enumeration."""

    input_signature = frozenset({"branch_ctr", "wavelength"})
    output_signature = frozenset({"branch_ctr"})
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset({"branch_ctr", "wavelength"})

    def __init__(self, schedule, base_reaction=default_reaction, **kw):
        super().__init__(**kw)
        self.reaction = branch_override_reaction(schedule, base_reaction)


def russian_roulette_reaction(key, base_reaction=default_reaction,
                              roulette_ids=None, defensive_floor=0.0):
    """Stochastic multi-branch tracing: sample reflect or transmit with
    probability proportional to the branch's Fresnel power, compensating
    the weight so that intensity estimates stay UNBIASED: the Monte-Carlo
    complement of :func:`branch_override_reaction`'s exact enumeration.

    At each sampled interface the reaction draws u in (0, 1) with
    :func:`ray_uniform` at ``ray_mix(rr_ctr)`` of ``key`` (``rr_ctr``
    seeded with :func:`seed_roulette`) and reflects iff ``u < p`` with
    ``p = R_eff`` (exactly 1 under TIR and mirrors, so those stay
    deterministic).  It reports the sampled branch in ``__reflects__`` and
    the compensation ``1/p`` (reflect) or ``1/(1-p)`` (transmit) in
    ``__efficiency__``, so the intensity tracker multiplies ``R_eff / p``
    or ``(1 - R_eff)/(1 - p)``: 1 when sampling is power-proportional.
    ``defensive_floor`` > 0 clamps p into [floor, 1 - floor] on partial
    interfaces (bounded weights; the estimator stays unbiased).

    ``roulette_ids``: optional per-surface tables; surfaces marked -1
    follow the base reaction.  Omit to sample every optical interface.
    Bare-Fresnel reflectance only: for coated surfaces enumerate with
    :func:`branch_override_reaction`.
    """

    def reaction(proj, rays, cfg):
        child_p0, child_p1, base_updates = _run_base(
            base_reaction, proj, rays, cfg)
        if "rr_ctr" not in rays.fields:
            raise KeyError(
                "russian_roulette_reaction: rays carry no 'rr_ctr' field; "
                "seed the source rays with seed_roulette()")
        dtype = rays.p0.dtype
        finfo = torch.finfo(dtype)
        n_rays = rays.n_rays
        ctr = rays.fields["rr_ctr"]

        d, n, nu, cos_i, n_in, n_out, eta, radicand, tir, reflects = (
            _fresnel_prelude(proj, rays))
        # the effective reflectance, the intensity tracker's clamps (R == 1
        # exactly under TIR and on mirrors)
        R = _fresnel_R(eta, cos_i, radicand, finfo.eps)
        R_eff = torch.where(reflects, torch.ones_like(R), R)

        partial = (R_eff > 0.0) & (R_eff < 1.0)
        if defensive_floor:
            f = _const(defensive_floor, R_eff)
            p = torch.where(partial, torch.clamp(R_eff, f, 1.0 - f), R_eff)
        else:
            p = R_eff

        u = ray_uniform(key, ray_mix(ctr), dtype)
        take_reflect = u < p

        refl_dir, trans_dir = _forced_directions(d, n, nu, cos_i, eta,
                                                 radicand, finfo.eps)
        chosen = torch.where(take_reflect[:, None], refl_dir, trans_dir)

        if roulette_ids is None:
            marked = torch.ones((n_rays,), dtype=torch.bool,
                                device=rays.p0.device)
        else:
            marked = _per_surface_table(proj, roulette_ids, n_rays, -1) >= 0
        p0 = torch.where(marked[:, None], rays.p1, child_p0)
        p1 = torch.where(marked[:, None],
                         rays.p1 + cfg.new_ray_length * chosen, child_p1)

        base_reflects = _effective_reflects(base_updates, reflects)
        base_updates["__reflects__"] = torch.where(marked, take_reflect,
                                                   base_reflects)
        comp = torch.where(take_reflect,
                           1.0 / torch.clamp(p, min=finfo.tiny),
                           1.0 / torch.clamp(1.0 - p, min=finfo.tiny))
        base_updates["__efficiency__"] = (
            base_updates.get("__efficiency__", 1.0)
            * torch.where(marked, comp, torch.ones_like(comp)))
        return p0, p1, _merge_updates(base_updates, {"rr_ctr": ctr + 1})

    return reaction


def seed_roulette(rays: RaySet) -> RaySet:
    """Attach the ``rr_ctr`` interaction counter for
    :func:`russian_roulette_reaction`."""
    return rays.with_field("rr_ctr", torch.zeros(
        (rays.n_rays,), dtype=torch.int32, device=rays.p0.device))


class RussianRoulette(RayOperation):
    """Class-op wrapper for :func:`russian_roulette_reaction`: stochastic
    power-proportional branch sampling for Monte-Carlo stray light."""

    input_signature = frozenset({"rr_ctr", "wavelength"})
    output_signature = frozenset({"rr_ctr"})
    optical_signature = frozenset({"mat_in", "mat_out"})
    material_signature = frozenset({"n"})
    simple_ray_inheritance = frozenset({"rr_ctr", "wavelength"})

    def __init__(self, key, base_reaction=default_reaction,
                 roulette_ids=None, defensive_floor=0.0, **kw):
        super().__init__(**kw)
        self.reaction = russian_roulette_reaction(
            key, base_reaction, roulette_ids, defensive_floor)
