"""The trace engine: the multi-bounce forward trace in 2D and 3D.

Counterpart of the forward path of ``tensorflowraytrace_tpu/engine.py``.
Rays never compact: each keeps its slot and a ``state`` code (ACTIVE,
FINISHED on a target, STOPPED on a stop, DEAD on a miss).  When an ACTIVE
ray reacts with an OPTICAL surface its child replaces it in its slot.  The
bounce loop is a Python loop over ``max_bounces``.

One bounce (``project_3d`` for a ``Scene3D``, ``project_2d`` for a
``Scene2D``) runs: the nearest-hit search (no gradient; with ``cull``,
terminated rays are parked outside every box and, with ``resort_rays``,
the rays are searched in Morton order), one gather of per-surface rows per
surface kind (whose backward is a segment sum), the differentiable refine
of the winning hit, then (``single_pass``) classification and the reaction
(Snell's law: the vector form in 3D, the angle form in 2D).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from tensorflowraytrace_tpu_torch.config import (
    ACTIVE, DEAD, FINISHED, OPTICAL, STOP, STOPPED, default_epsilon,
)
from tensorflowraytrace_tpu_torch.models.acceleration import morton_codes_device
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import Scene2D, Scene3D
from tensorflowraytrace_tpu_torch.ops import intersect as isect
from tensorflowraytrace_tpu_torch.ops import segsum_kernels as segsum
from tensorflowraytrace_tpu_torch.ops.geometry import snell_3d_vec, snells_law_2D
from tensorflowraytrace_tpu_torch.ops.materials import material_index_lookup

# TraceConfig fields of the JAX engine that this port does not implement yet;
# setting one raises rather than being ignored.
_NOT_IMPLEMENTED = ("remat", "early_exit")


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
    # K7 and K8 in 2D; "grid" -> K4 in 3D (2D raises: K9 and K10 are not
    # ported); inactive rays are parked outside every chunk box
    cull: object = False
    surf_chunk: int = 128
    ray_block: int = 32768
    # None -> derived from dtype (config.default_epsilon)
    intersect_epsilon: Optional[float] = None
    size_epsilon: Optional[float] = None
    ray_start_epsilon: Optional[float] = None
    remat: bool = False
    # False -> hit points come from the search's ray parameter and no
    # gradient reaches the surface geometry
    differentiable: bool = True
    # with cull: sort the rays by the Morton code of their start before each
    # search, so ray blocks stay coherent; results are scattered back
    resort_rays: bool = False
    early_exit: bool = False

    def __post_init__(self):
        for name in _NOT_IMPLEMENTED:
            if getattr(self, name):
                raise NotImplementedError(
                    f"TraceConfig.{name} is not implemented in the PyTorch "
                    "port yet")

    def epsilons(self, dtype):
        e = default_epsilon(dtype)
        return (
            e if self.intersect_epsilon is None else self.intersect_epsilon,
            e if self.size_epsilon is None else self.size_epsilon,
            e if self.ray_start_epsilon is None else self.ray_start_epsilon,
        )


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


def project_3d(rays: RaySet, scene: Scene3D, materials,
               cfg: TraceConfig) -> Projection:
    """One intersection + gather pass: search, gather the winning surface's
    row of the (M, k) table [vp v1 v2 norm annotation], refine."""
    i_eps, s_eps, r_eps = cfg.epsilons(rays.p0.dtype)
    tri = scene.triangles
    box = None
    if cfg.cull and cfg.resort_rays:
        # the re-sort's box is that of tri.vp and tri.v2, as in the JAX
        # package
        vp, v2 = tri.vp.detach(), tri.v2.detach()
        box = (torch.minimum(vp.amin(dim=0), v2.amin(dim=0)),
               torch.maximum(vp.amax(dim=0), v2.amax(dim=0)))
    hit = _search(rays, cfg, box, lambda p0, p1: isect.nearest_hit_triangles(
        p0, p1, tri, i_eps, s_eps, r_eps, surf_chunk=cfg.surf_chunk,
        ray_block=cfg.ray_block, use_kernel=cfg.use_kernel, cull=cfg.cull))

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


def project_2d(rays: RaySet, scene: Scene2D, materials,
               cfg: TraceConfig) -> Projection:
    """One 2D intersection + gather pass: the search over segments and arcs
    (``isect.nearest_hit_2d`` picks the nearer kind), then one gather per
    surface kind of its (M, k) table [geometry annotation] and its refine;
    each ray keeps the kind it hit (``where`` on ``hit.kind``).

    Both gathers use the one ``hit.idx``, which indexes the kind the ray
    hit: a ray that hit arc 400 also gathers segment row 400, discarded by
    the ``where``.  The index is clamped to each table's last row first
    (JAX's gather clamps; torch's would fault)."""
    i_eps, s_eps, r_eps = cfg.epsilons(rays.p0.dtype)
    box = None
    if cfg.cull and cfg.resort_rays and scene.segments is not None:
        # the re-sort's box is that of the segments alone, and a scene
        # without segments is not re-sorted, as in the JAX package
        sp0, sp1 = scene.segments.p0.detach(), scene.segments.p1.detach()
        box = (torch.minimum(sp0.amin(dim=0), sp1.amin(dim=0)),
               torch.maximum(sp0.amax(dim=0), sp1.amax(dim=0)))
    hit = _search(rays, cfg, box, lambda p0, p1: isect.nearest_hit_2d(
        p0, p1, scene, i_eps, s_eps, r_eps, surf_chunk=cfg.surf_chunk,
        ray_block=cfg.ray_block, use_kernel=cfg.use_kernel, cull=cfg.cull))

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
    """One bounce: project, classify, react.  Returns ``(new_rays, record)``
    where record = (p0, p1_projected, state, alive) describes the parent
    rays as they ended this pass."""
    if isinstance(scene, Scene3D):
        proj = project_3d(rays, scene, materials, cfg)
    else:
        proj = project_2d(rays, scene, materials, cfg)

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
    the final accumulator lands in ``TraceResult.fold``.  ``keep_history``
    stacks the records along a leading bounce axis.
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

    acc = fold_init
    records = []
    for _ in range(cfg.max_bounces):
        new_rays, record = single_pass(rays, scene, materials, cfg, reaction)
        if fold_fn is not None:
            acc = fold_fn(acc, record + (new_rays.fields,) if fold_fields
                          else record)
        if cfg.keep_history:
            records.append(record)
        rays = new_rays

    if cfg.keep_history:
        h_p0, h_p1, h_state, h_alive = (torch.stack(col) for col in zip(*records))
    else:
        h_p0 = h_p1 = h_state = h_alive = None
    return TraceResult(
        rays=rays, history_p0=h_p0, history_p1=h_p1, history_state=h_state,
        history_alive=h_alive, fold=acc, n_bounces=cfg.max_bounces,
    )
