"""The trace engine: the multi-bounce trace in 2D and 3D, and the fold
helpers that reduce it bounce by bounce.

Counterpart of ``tensorflowraytrace_tpu/engine.py`` (without
``trace_streamed``).  Rays never compact: each keeps its slot and a
``state`` code (ACTIVE, FINISHED on a target, STOPPED on a stop, DEAD on a
miss).  When an ACTIVE ray reacts with an OPTICAL surface its child replaces
it in its slot.  The bounce loop is a Python loop over ``max_bounces``, or,
with ``early_exit``, until no ray is ACTIVE.

One bounce (``single_pass``) runs the nearest-hit search (``search_bounce``:
no gradient; with ``cull``, terminated rays are parked outside every box
and, with ``resort_rays``, the rays are searched in Morton order), then the
rest of the bounce: one gather of per-surface rows per surface kind (whose
backward is a segment sum) and the differentiable refine of the winning hit
(``project_3d`` for a ``Scene3D``, ``project_2d`` for a ``Scene2D``),
classification and the reaction (Snell's law: the vector form in 3D, the
angle form in 2D).  With ``remat`` the rest of the bounce is recomputed in
the backward pass; the search is not.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.config import (
    ACTIVE, DEAD, FINISHED, OPTICAL, STOP, STOPPED, default_epsilon,
    resolve_device,
)
from tensorflowraytrace_tpu_torch.models.acceleration import morton_codes_device
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import Scene2D, Scene3D
from tensorflowraytrace_tpu_torch.ops import intersect as isect
from tensorflowraytrace_tpu_torch.ops import segsum_kernels as segsum
from tensorflowraytrace_tpu_torch.ops.geometry import snell_3d_vec, snells_law_2D
from tensorflowraytrace_tpu_torch.ops.materials import material_index_lookup

# TraceConfig.recommended on the card: 3D scenes of at least this many
# triangles are traced with cull=True and resort_rays=True.  PERF.md, the
# table of recommended's rules: chip_smoke.py's sorted soup (4096
# triangles) and structured guide (16386) both run fastest that way on the
# H100; no smaller 3D scene was measured culled, and the flagship's
# 770-triangle traces are launch-bound.
CULL_3D_MIN_TRIANGLES = 4096


@dataclass(frozen=True)
class TraceConfig:
    """Trace configuration; the same fields as the JAX ``TraceConfig`` with
    ``use_pallas`` renamed ``use_kernel`` (the CUDA searches, and the CUDA
    segment sum as the gather's backward)."""

    max_bounces: int = 25
    new_ray_length: float = 1.0
    # None -> dead rays keep their direction-vector length; otherwise the
    # reference's dead_ray_length stretch factor
    dead_ray_length: Optional[float] = None
    keep_history: bool = False
    # "index": per-surface int indices into the material list;
    # "value": per-surface n_in / n_out floats in surface.fields
    refractive_index_type: str = "index"
    use_kernel: bool = False
    # conservative chunk culling (exact) under use_kernel: True -> K3 in 3D,
    # K7 and K8 in 2D; "grid" -> the two-level K4 in 3D, K9 and K10 in 2D;
    # inactive rays are parked outside every chunk box
    cull: object = False
    surf_chunk: int = 128
    ray_block: int = 32768
    # None -> derived from dtype (config.default_epsilon)
    intersect_epsilon: Optional[float] = None
    size_epsilon: Optional[float] = None
    ray_start_epsilon: Optional[float] = None
    # recompute each bounce but its search in the backward pass
    # (torch.utils.checkpoint): the backward keeps each bounce's rays and
    # hits, not the intermediates of its refine and reaction
    remat: bool = False
    # False -> hit points come from the search's ray parameter and no
    # gradient reaches the surface geometry
    differentiable: bool = True
    # with cull: sort the rays by the Morton code of their start before each
    # search, so ray blocks stay coherent; results are scattered back
    resort_rays: bool = False
    # stop bouncing once no ray is ACTIVE; forward only (it raises when
    # autograd would record the trace) and not with keep_history.  Each
    # bounce then reads one bool back from the device.
    early_exit: bool = False

    def epsilons(self, dtype):
        e = default_epsilon(dtype)
        return (
            e if self.intersect_epsilon is None else self.intersect_epsilon,
            e if self.size_epsilon is None else self.size_epsilon,
            e if self.ray_start_epsilon is None else self.ray_start_epsilon,
        )

    @staticmethod
    def recommended(scene, max_bounces=25, **overrides):
        """A TraceConfig for ``scene`` where the port would run: on its
        default device (``config.default_device()``, as the JAX package
        reads its first device).

        * Off the card, the JAX package's policy off the TPU: no kernels,
          no culling, no re-sort.
        * On the card (a CUDA default), the CUDA searches
          (``use_kernel``), with ``cull=True`` and ``resort_rays`` for 3D
          scenes of ``CULL_3D_MIN_TRIANGLES`` triangles or more, and the
          brute searches otherwise: the H100 measurements in PERF.md's
          table of these rules (not the TPU's, which pick ``"grid"``).
        * ``remat`` for deep traces (bounce budget > 16), so the backward
          pass keeps each bounce's rays and hits but not every
          intermediate of every bounce.

        Morton-sort the scene once at build time so culling has compact
        chunks to skip.  Any field can be overridden by keyword.
        """
        on_card = config.default_device().type == "cuda"
        if isinstance(scene, Scene3D):
            culled = on_card and (scene.triangles.n_surfaces
                                  >= CULL_3D_MIN_TRIANGLES)
        else:
            culled = False
        cfg = dict(max_bounces=max_bounces, use_kernel=on_card, cull=culled,
                   resort_rays=culled, remat=max_bounces > 16)
        cfg.update(overrides)
        return TraceConfig(**cfg)


@dataclass
class Projection:
    """Per-ray gathered hit data handed to reactions."""

    hit_valid: torch.Tensor          # (N,) bool
    point: torch.Tensor              # (N, dim) hit point (= projected ray end)
    norm: torch.Tensor               # (N, 3) normal in 3D; (N,) its angle in 2D
    n_in: torch.Tensor               # (N,)
    n_out: torch.Tensor              # (N,)
    category: torch.Tensor           # (N,) OPTICAL / STOP / TARGET
    surf_idx: torch.Tensor           # (N,) index into the merged surface set
    kind: torch.Tensor               # (N,) 2D: KIND_SEGMENT or KIND_ARC
    extras: Dict[str, torch.Tensor]  # ray_u, and trig_u / trig_v or seg_u / arc_u
    dim: int = 3


@dataclass
class TraceResult:
    """Final ray slots plus optional per-bounce history (leading axis =
    bounce; ``history_alive`` marks slots still bouncing when the entry was
    recorded) and the fold accumulator."""

    rays: RaySet
    history_p0: Optional[torch.Tensor]
    history_p1: Optional[torch.Tensor]
    history_state: Optional[torch.Tensor]
    history_alive: Optional[torch.Tensor]
    fold: object = None
    n_bounces: int = 0

    @property
    def finished_rays(self):
        return self.rays.finished

    @property
    def active_rays(self):
        return self.rays.active

    @property
    def stopped_rays(self):
        return self.rays.stopped

    @property
    def dead_rays(self):
        return self.rays.dead


def _annotation_cols(surface, dtype, value_mode):
    """Annotation columns of the per-bounce surface table: per-surface
    (category, n_in, n_out) floats in "value" mode, otherwise ONE column
    with category<<20 | mat_in<<10 | mat_out stored in a float (exact below
    2^24; ids are range-checked when the surfaces are built)."""
    if value_mode:
        return [surface.category.to(dtype)[:, None],
                surface.fields["n_in"][:, None],
                surface.fields["n_out"][:, None]]
    packed = (surface.category.to(torch.int32) * (1 << 20)
              + surface.mat_in * (1 << 10) + surface.mat_out)
    return [packed.to(dtype)[:, None]]


def _unpack_annotation(rows, o, value_mode, materials, wavelength):
    """Inverse of :func:`_annotation_cols` on the transposed (k, N) gathered
    rows; returns per-ray ``(category, n_in, n_out)``."""
    if value_mode:
        return rows[o].to(torch.int32), rows[o + 1], rows[o + 2]
    code = rows[o].to(torch.int32)
    category = code >> 20
    n_in = material_index_lookup(materials, wavelength, (code >> 10) & 0x3FF)
    n_out = material_index_lookup(materials, wavelength, code & 0x3FF)
    return category, n_in, n_out


class _GatherRowsT(torch.autograd.Function):
    """``table[idx].T``: one gather of every per-surface column per bounce,
    transposed so each column is an (N,) tensor.  Its backward sums the
    (k, N) cotangent into the (M, k) table gradient: K2
    (``ops/segsum_kernels.py``) when ``use_kernel`` and the cotangent lies
    on CUDA, the plain ``index_add_`` otherwise.  ``idx`` gets no
    gradient."""

    @staticmethod
    def forward(ctx, table, idx, use_kernel):
        ctx.save_for_backward(idx)
        ctx.m = table.shape[0]
        ctx.use_kernel = use_kernel
        return table[idx.long()].T

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        # the kernel's wrapper runs the plain version on CPU tensors
        segment_sum = (segsum.segment_sum_kernel if ctx.use_kernel
                       else segsum.segment_sum_plain)
        return segment_sum(ct, idx, ctx.m), None, None


def _gather_rows_t(table, idx, use_kernel=False):
    return _GatherRowsT.apply(table, idx, use_kernel)


def _search(rays, cfg, box, search):
    """The bounce's nearest-hit search, ``search(p0, p1) -> HitRecord`` on
    the rays' detached endpoints.  Under ``cfg.cull`` terminated rays are
    parked far outside every chunk box (p0 = 1e30) so their slab tests
    fail, and a ray block whose rays have all terminated skips every chunk;
    with ``cfg.resort_rays`` and a ``box`` (lo, hi), the rays are searched in
    the Morton order of their starts in that box (parked rays sort last),
    so ray blocks stay coherent after the first bounce, and the hits are
    scattered back to slot order.  Nothing reads back from the device: the
    parking values enter as Python scalars."""
    search_p0, search_p1 = rays.p0.detach(), rays.p1.detach()
    if cfg.cull:
        inactive = (rays.state != ACTIVE)[:, None]
        search_p0 = torch.where(inactive, torch.full_like(search_p0, 1e30),
                                search_p0)
        search_p1 = torch.where(
            inactive, torch.full_like(search_p1, 1e30 * (1 + 1e-6)), search_p1)
    if not (cfg.cull and cfg.resort_rays and box is not None):
        return search(search_p0, search_p1)

    # (a profiler range, so a trace's profile can read its device time)
    with torch.profiler.record_function("resort_rays"):
        order = torch.argsort(morton_codes_device(search_p0, *box),
                              stable=True)
        search_p0, search_p1 = search_p0[order], search_p1[order]
    hit = search(search_p0, search_p1)

    def unsort(x):
        out = torch.empty_like(x)
        out[order] = x
        return out

    with torch.profiler.record_function("resort_rays"):
        return isect.HitRecord(valid=unsort(hit.valid), idx=unsort(hit.idx),
                               ray_u=unsort(hit.ray_u), kind=unsort(hit.kind),
                               branch=unsort(hit.branch))


def _value_mode(cfg, materials):
    value_mode = cfg.refractive_index_type == "value"
    if not value_mode and not materials:
        raise ValueError("trace: refractive_index_type='index' needs materials")
    return value_mode


def search_bounce(rays: RaySet, scene, cfg: TraceConfig) -> isect.HitRecord:
    """The bounce's nearest-hit search over a ``Scene3D`` or ``Scene2D``
    (:func:`_search`, on detached endpoints: it has no gradient).  With
    ``resort_rays`` the re-sort's box is that of the triangles' ``vp`` and
    ``v2`` in 3D and of the segments alone in 2D (a 2D scene without
    segments is not re-sorted), as in the JAX package."""
    i_eps, s_eps, r_eps = cfg.epsilons(rays.p0.dtype)
    kw = dict(surf_chunk=cfg.surf_chunk, ray_block=cfg.ray_block,
              use_kernel=cfg.use_kernel, cull=cfg.cull)
    if isinstance(scene, Scene3D):
        a, b = scene.triangles.vp, scene.triangles.v2

        def search(p0, p1):
            return isect.nearest_hit_triangles(p0, p1, scene.triangles, i_eps,
                                               s_eps, r_eps, **kw)
    else:
        a = b = None
        if scene.segments is not None:
            a, b = scene.segments.p0, scene.segments.p1

        def search(p0, p1):
            return isect.nearest_hit_2d(p0, p1, scene, i_eps, s_eps, r_eps,
                                        **kw)
    box = None
    if cfg.cull and cfg.resort_rays and a is not None:
        a, b = a.detach(), b.detach()
        box = (torch.minimum(a.amin(dim=0), b.amin(dim=0)),
               torch.maximum(a.amax(dim=0), b.amax(dim=0)))
    return _search(rays, cfg, box, search)


def project_3d(rays: RaySet, scene: Scene3D, materials, cfg: TraceConfig,
               hit: Optional[isect.HitRecord] = None) -> Projection:
    """One intersection + gather pass: the search (or its result ``hit``),
    then the gather of the winning surface's row of the (M, k) table
    [vp v1 v2 norm annotation] and the refine."""
    if hit is None:
        hit = search_bounce(rays, scene, cfg)
    i_eps = cfg.epsilons(rays.p0.dtype)[0]
    tri = scene.triangles
    dtype = rays.p0.dtype
    value_mode = _value_mode(cfg, materials)
    cols = [tri.vp, tri.v1, tri.v2] if cfg.differentiable else []
    cols += [tri.norm] + _annotation_cols(tri, dtype, value_mode)
    rows = _gather_rows_t(torch.cat(cols, dim=1), hit.idx, cfg.use_kernel)

    o = 9 if cfg.differentiable else 0
    norm = rows[o:o + 3].T
    category, n_in, n_out = _unpack_annotation(rows, o + 3, value_mode,
                                               materials, rays.wavelength)
    if cfg.differentiable:
        point, ray_u, tu, tv = isect.refine_triangle_hit_from(
            rays.p0, rays.p1, rows[0:3].T, rows[3:6].T, rows[6:9].T, i_eps)
        extras = {"ray_u": ray_u, "trig_u": tu, "trig_v": tv}
    else:
        # the search's ray parameter is the refine's (same algebra)
        point = rays.p0 + hit.ray_u[:, None] * (rays.p1 - rays.p0)
        extras = {"ray_u": hit.ray_u}
    return Projection(
        hit_valid=hit.valid, point=point, norm=norm, n_in=n_in, n_out=n_out,
        category=category, surf_idx=hit.idx, kind=hit.kind, extras=extras,
        dim=3,
    )


def project_2d(rays: RaySet, scene: Scene2D, materials, cfg: TraceConfig,
               hit: Optional[isect.HitRecord] = None) -> Projection:
    """One 2D intersection + gather pass: the search over segments and arcs
    (``isect.nearest_hit_2d`` picks the nearer kind; or its result ``hit``),
    then one gather per surface kind of its (M, k) table [geometry
    annotation] and its refine; each ray keeps the kind it hit (``where``
    on ``hit.kind``).

    Both gathers use the one ``hit.idx``, which indexes the kind the ray
    hit: a ray that hit arc 400 also gathers segment row 400, discarded by
    the ``where``.  The index is clamped to each table's last row first
    (JAX's gather clamps; torch's would fault)."""
    if hit is None:
        hit = search_bounce(rays, scene, cfg)
    i_eps = cfg.epsilons(rays.p0.dtype)[0]
    n = rays.n_rays
    dtype = rays.p0.dtype
    point = rays.p1
    norm = rays.p0.new_zeros((n,))
    n_in = rays.p0.new_zeros((n,))
    n_out = rays.p0.new_ones((n,))
    category = torch.zeros((n,), dtype=torch.int32, device=rays.p0.device)
    extras = {"ray_u": hit.ray_u}
    value_mode = _value_mode(cfg, materials)

    def gather(surface, geometry):
        table = torch.cat(geometry + _annotation_cols(surface, dtype,
                                                      value_mode), dim=1)
        idx = torch.clamp(hit.idx, max=surface.n_surfaces - 1)
        return _gather_rows_t(table, idx, cfg.use_kernel)

    def take(is_kind, k_point, k_norm, rows, o):
        nonlocal point, norm, n_in, n_out, category
        k_cat, k_nin, k_nout = _unpack_annotation(rows, o, value_mode,
                                                  materials, rays.wavelength)
        point = torch.where(is_kind[:, None], k_point, point)
        norm = torch.where(is_kind, k_norm, norm)
        n_in = torch.where(is_kind, k_nin, n_in)
        n_out = torch.where(is_kind, k_nout, n_out)
        category = torch.where(is_kind, k_cat, category)

    if scene.segments is not None:
        seg = scene.segments
        rows = gather(seg, [seg.p0, seg.p1])
        s_point, _, seg_u, s_norm = isect.refine_segment_hit_from(
            rays.p0, rays.p1, rows[0:2].T, rows[2:4].T, i_eps)
        take(hit.kind == isect.KIND_SEGMENT, s_point, s_norm, rows, 4)
        extras["seg_u"] = seg_u

    if scene.arcs is not None:
        arc = scene.arcs
        rows = gather(arc, [arc.center, arc.radius[:, None]])
        a_point, _, arc_u, a_norm = isect.refine_arc_hit_from(
            rays.p0, rays.p1, rows[0:2].T, rows[2], hit.branch, i_eps)
        take(hit.kind == isect.KIND_ARC, a_point, a_norm, rows, 3)
        extras["arc_u"] = arc_u

    return Projection(
        hit_valid=hit.valid, point=point, norm=norm, n_in=n_in, n_out=n_out,
        category=category, surf_idx=hit.idx, kind=hit.kind, extras=extras,
        dim=2,
    )


def default_reaction(proj: Projection, rays: RaySet, cfg: TraceConfig):
    """Snell's law refraction / reflection / TIR: the vector form in 3D, the
    angle form in 2D."""
    if proj.dim == 3:
        return snell_3d_vec(rays.p0, proj.point, proj.norm, proj.n_in,
                            proj.n_out, cfg.new_ray_length)
    xs, ys, xe, ye = snells_law_2D(
        rays.p0[:, 0], rays.p0[:, 1], proj.point[:, 0], proj.point[:, 1],
        proj.norm, proj.n_in, proj.n_out, cfg.new_ray_length)
    return torch.stack([xs, ys], dim=1), torch.stack([xe, ye], dim=1)


def single_pass(rays: RaySet, scene, materials, cfg: TraceConfig,
                reaction: Callable = default_reaction):
    """One bounce: search, project, classify, react.  Returns
    ``(new_rays, record)`` where record = (p0, p1_projected, state, alive)
    describes the parent rays as they ended this pass.

    With ``cfg.remat`` everything after the search runs under
    ``torch.utils.checkpoint`` with the search's per-ray hits as inputs
    (the counterpart of the JAX package's ``save_only_these_names`` policy
    on ``_tag_hit``): the backward recomputes the O(N) gathers, refine and
    reaction, and never the N x M search.  The bounce draws no random
    numbers, so no RNG state is kept."""
    hit = search_bounce(rays, scene, cfg)
    if cfg.remat:
        return checkpoint(_bounce_rest, rays, scene, materials, cfg, reaction,
                          hit, use_reentrant=False, preserve_rng_state=False)
    return _bounce_rest(rays, scene, materials, cfg, reaction, hit)


def _bounce_rest(rays, scene, materials, cfg, reaction, hit):
    """The bounce after its search: :func:`single_pass`'s result."""
    if isinstance(scene, Scene3D):
        proj = project_3d(rays, scene, materials, cfg, hit)
    else:
        proj = project_2d(rays, scene, materials, cfg, hit)

    active = rays.state == ACTIVE
    # finite-hit guard: a grazing hit with |det| barely over epsilon can put
    # the refined point at u ~ 1e30+, which overflows float32 on the next
    # bounce; such hits count as misses and the ray dies with finite
    # coordinates
    finite_hit = torch.all(torch.isfinite(proj.point), dim=-1)
    hit_ok = proj.hit_valid & finite_hit
    valid_hit = active & hit_ok

    p1 = torch.where(valid_hit[:, None], proj.point, rays.p1)

    # state codes enter as Python scalars: a scalar tensor built on the
    # device would be a host-to-device copy, which synchronises the stream
    hit_state = torch.full_like(proj.category, FINISHED)
    hit_state = torch.where(proj.category == STOP, STOPPED, hit_state)
    hit_state = torch.where(proj.category == OPTICAL, ACTIVE, hit_state)
    new_state = torch.where(active, torch.where(hit_ok, hit_state, DEAD),
                            rays.state)

    if cfg.dead_ray_length is not None:
        became_dead = active & ~hit_ok
        stretch = rays.p0 + cfg.dead_ray_length * (p1 - rays.p0)
        p1 = torch.where(became_dead[:, None], stretch, p1)

    # reaction: the child replaces the parent in its slot.  A reaction
    # returns (p0, p1) or (p0, p1, field_updates); the updates are merged
    # into rays.fields for reacting slots only.
    out = reaction(proj, dataclasses.replace(rays, p1=p1), cfg)
    if len(out) == 3:
        child_p0, child_p1, field_updates = out
    else:
        child_p0, child_p1 = out
        field_updates = None
    reacts = valid_hit & (proj.category == OPTICAL)
    # finite-child guard: a degenerate reaction that produced non-finite
    # child coordinates kills the ray instead of propagating NaN / inf
    child_ok = (torch.all(torch.isfinite(child_p0), dim=-1)
                & torch.all(torch.isfinite(child_p1), dim=-1))
    new_state = torch.where(reacts & ~child_ok, DEAD, new_state)
    reacts = reacts & child_ok
    out_p0 = torch.where(reacts[:, None], child_p0, rays.p0)
    out_p1 = torch.where(reacts[:, None], child_p1, p1)

    new_fields = rays.fields
    if field_updates:
        new_fields = dict(rays.fields)
        for k, v in field_updates.items():
            if k.startswith("__"):
                # reserved reaction-protocol metadata, never a ray field
                continue
            old = new_fields.get(k)
            if old is None:
                raise KeyError(
                    f"reaction updates ray field {k!r} but the rays do not "
                    "carry it; seed it via RaySet.make(fields={...})")
            mask = reacts.reshape(reacts.shape + (1,) * (v.dim() - 1))
            new_fields[k] = torch.where(mask, v.to(old.dtype), old)

    new_rays = dataclasses.replace(rays, p0=out_p0, p1=out_p1,
                                   state=new_state, fields=new_fields)
    record = (rays.p0, p1, new_state, active)
    return new_rays, record


def trace(rays: RaySet, scene, materials=None, cfg: TraceConfig = TraceConfig(),
          reaction: Callable = default_reaction,
          fold_fn: Optional[Callable] = None,
          fold_init=None, fold_fields: bool = False) -> TraceResult:
    """Multi-bounce trace: ``cfg.max_bounces`` calls of :func:`single_pass`.
    Differentiable end to end with respect to scene geometry and ray
    starts.

    ``fold_fn(acc, record) -> acc`` (starting from ``fold_init``) runs once
    per bounce on the ``(p0, p1_projected, state, was_active)`` record, plus
    the post-bounce ray ``fields`` as a fifth element when ``fold_fields``;
    the final accumulator lands in ``TraceResult.fold`` (see
    :func:`path_length_fold`, :func:`bounce_count_fold`,
    :func:`landing_sum_fold`).  Folds compose with ``cfg.remat`` and are
    differentiable.  ``keep_history`` stacks the records along a leading
    bounce axis.

    ``cfg.early_exit`` stops once no ray is ACTIVE and reports the depth
    reached in ``TraceResult.n_bounces``, as the JAX package's
    ``while_loop`` does.  It is forward only: it raises when autograd
    records the trace (run it under ``torch.no_grad()``) and with
    ``keep_history``.  Its test of whether any ray is still ACTIVE reads
    one bool back from the device before each bounce, a host
    synchronisation per bounce that the other traces do not make.
    """
    materials = tuple(materials or ())
    if cfg.keep_history:
        itemsize = rays.p0.element_size()
        hist_bytes = (cfg.max_bounces * rays.n_rays
                      * (2 * rays.dim * itemsize + 5))
        if hist_bytes > 16 << 30:
            raise ValueError(
                f"keep_history at {rays.n_rays} rays x {cfg.max_bounces} "
                f"bounces would stack ~{hist_bytes / 2 ** 30:.0f} GiB of "
                "per-bounce history; use a fold (fold_fn/fold_init) instead")

    if cfg.early_exit and cfg.keep_history:
        raise ValueError("early_exit is incompatible with keep_history (the "
                         "JAX package's while_loop has no stacked outputs)")

    acc = fold_init
    records = []
    n_done = 0
    while n_done < cfg.max_bounces:
        if cfg.early_exit and not bool(torch.any(rays.state == ACTIVE)):
            break
        new_rays, record = single_pass(rays, scene, materials, cfg, reaction)
        if (cfg.early_exit and torch.is_grad_enabled()
                and (new_rays.p0.requires_grad or new_rays.p1.requires_grad)):
            raise ValueError(
                "early_exit is forward only (the JAX package's while_loop is "
                "not differentiable): trace under torch.no_grad(), or without "
                "early_exit for gradients")
        if fold_fn is not None:
            acc = fold_fn(acc, record + (new_rays.fields,) if fold_fields
                          else record)
        if cfg.keep_history:
            records.append(record)
        rays = new_rays
        n_done += 1

    if cfg.keep_history:
        h_p0, h_p1, h_state, h_alive = (torch.stack(col) for col in zip(*records))
    else:
        h_p0 = h_p1 = h_state = h_alive = None
    return TraceResult(
        rays=rays, history_p0=h_p0, history_p1=h_p1, history_state=h_state,
        history_alive=h_alive, fold=acc, n_bounces=n_done,
    )


# ======================================================================
# fold helpers: reductions of a deep trace without its history
# ======================================================================

def newly_terminated(record, state_code):
    """Mask of the slots whose ray reached ``state_code`` on this bounce;
    takes either record arity (4, or 5 with ``fold_fields``)."""
    _, _, state, alive = record[:4]
    return alive & (state == state_code)


def path_length_fold(n_rays, dtype, device=None):
    """``(init, fn)``: per-slot total path length, the sum of segment
    lengths over every bounce the ray was alive (each bounce overwrites the
    final slots, so without the fold this needs the history)."""
    init = torch.zeros((n_rays,), dtype=dtype, device=resolve_device(device))

    def fn(acc, record):
        p0, p1, _, alive = record[:4]
        seg = torch.linalg.vector_norm(p1 - p0, dim=-1)
        return acc + torch.where(alive, seg, 0.0)

    return init, fn


def bounce_count_fold(n_rays, device=None):
    """``(init, fn)``: per-slot number of bounces each ray was alive for."""
    init = torch.zeros((n_rays,), dtype=torch.int32,
                       device=resolve_device(device))

    def fn(acc, record):
        return acc + record[3].to(torch.int32)

    return init, fn


def landing_sum_fold(value_fn, dtype, state_code=FINISHED, device=None):
    """``(init, fn)``: running scalar sum of ``value_fn(p1) -> (N,)`` over
    the rays at the bounce they terminate with ``state_code``, e.g. a
    squared landing error summed over finished rays, so that a deep trace's
    loss needs neither its history nor a gather of the final slots."""
    init = torch.zeros((), dtype=dtype, device=resolve_device(device))

    def fn(acc, record):
        _, p1, state, alive = record[:4]
        mask = alive & (state == state_code)
        return acc + torch.sum(torch.where(mask, value_fn(p1), 0.0))

    return init, fn
