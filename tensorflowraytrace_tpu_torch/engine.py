"""The trace engine: the multi-bounce trace in 2D and 3D, and the fold
helpers that reduce it bounce by bounce.

Counterpart of ``tensorflowraytrace_tpu/engine.py``.  Rays never compact: each keeps its slot and a
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

Past what one trace's memory holds, :func:`trace_streamed` traces the rays
block by block and merges the blocks' folds, and
:func:`streamed_value_and_grad` sums the gradients of a loss that is a sum
over blocks.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.analysis import histogram2d
from tensorflowraytrace_tpu_torch.config import (
    ACTIVE, DEAD, FINISHED, OPTICAL, STOP, STOPPED, default_epsilon,
    resolve_device,
)
from tensorflowraytrace_tpu_torch.models.acceleration import morton_codes_device
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import Scene2D, Scene3D
from tensorflowraytrace_tpu_torch.ops import custom_ops
from tensorflowraytrace_tpu_torch.ops import intersect as isect
from tensorflowraytrace_tpu_torch.ops.geometry import snell_3d_vec, snells_law_2D
from tensorflowraytrace_tpu_torch.ops.materials import material_index_lookup

# TraceConfig.recommended on the card: 3D scenes of at least this many
# triangles are traced with cull=True and resort_rays=True.  PERF.md, the
# table of recommended's rules: chip_smoke.py's sorted soup (4096
# triangles) and structured guide (16386) both run fastest that way on the
# H100; no smaller 3D scene was measured culled, and the flagship's
# 770-triangle traces are launch-bound.
CULL_3D_MIN_TRIANGLES = 4096
# TraceConfig.recommended on the card: in float32 a child ray starts this
# many float32 spacings of the scene's largest coordinate magnitude past its
# surface (ray_start_epsilon).  The float32 default of 1e-6 is below one
# spacing from 16 units on (3.8e-6 at 40), so a child could start just
# behind its surface and hit it again; PERF.md, the table of recommended's
# rules.
START_SPACINGS = 4


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
    def recommended(scene, max_bounces=25, device=None, **overrides):
        """A TraceConfig for ``scene`` where the port would run: on
        ``device``, by default the port's default device
        (``config.default_device()``, as the JAX package reads its first
        device).

        * Off the card, the JAX package's policy off the TPU: no kernels,
          no culling, no re-sort.
        * On the card (a CUDA default), the CUDA searches
          (``use_kernel``), with ``cull=True`` and ``resort_rays`` for 3D
          scenes of ``CULL_3D_MIN_TRIANGLES`` triangles or more, and the
          brute searches otherwise: the H100 measurements in PERF.md's
          table of these rules (not the TPU's, which pick ``"grid"``).
        * ``ray_start_epsilon`` by :func:`start_epsilon`: from the scene's
          extent for a float32 scene on the card.
        * ``remat`` for deep traces (bounce budget > 16), so the backward
          pass keeps each bounce's rays and hits but not every
          intermediate of every bounce.

        Morton-sort the scene once at build time so culling has compact
        chunks to skip.  Any field can be overridden by keyword.
        """
        device = (config.default_device() if device is None
                  else torch.device(device))
        on_card = device.type == "cuda"
        if isinstance(scene, Scene3D):
            culled = on_card and (scene.triangles.n_surfaces
                                  >= CULL_3D_MIN_TRIANGLES)
        else:
            culled = False
        cfg = dict(max_bounces=max_bounces, use_kernel=on_card, cull=culled,
                   resort_rays=culled, remat=max_bounces > 16,
                   ray_start_epsilon=start_epsilon(scene, device))
        cfg.update(overrides)
        return TraceConfig(**cfg)


def float32_start_epsilon(extent) -> float:
    """The card's float32 ``ray_start_epsilon`` for coordinates up to
    ``extent`` in magnitude: ``START_SPACINGS`` float32 spacings of it
    (1.5e-5 at 40 units), never below the float32 default."""
    # the float32 spacing of x in [2^(e-1), 2^e) is 2^(e-24)
    spacing = math.ldexp(1.0, math.frexp(float(extent))[1] - 24)
    return max(default_epsilon(torch.float32), START_SPACINGS * spacing)


def start_epsilon(scene, device=None) -> Optional[float]:
    """The ``ray_start_epsilon`` of tracing ``scene`` on ``device`` (by
    default the device its surfaces lie on), the one rule every caller
    takes: on the card, for a float32 scene, :func:`float32_start_epsilon`
    of the largest coordinate magnitude of its surfaces (an arc reaches its
    centre plus its radius), read back from the device; None (the dtype's
    default) otherwise."""
    if isinstance(scene, Scene3D):
        t = scene.triangles
        parts = [t.vp, t.v1, t.v2]
    else:
        parts = []
        if scene.segments is not None:
            parts += [scene.segments.p0, scene.segments.p1]
        if scene.arcs is not None:
            parts.append(scene.arcs.center.abs()
                         + scene.arcs.radius.abs()[:, None])
    device = parts[0].device if device is None else torch.device(device)
    if device.type != "cuda" or parts[0].dtype != torch.float32:
        return None
    return float32_start_epsilon(
        torch.stack([p.detach().abs().max() for p in parts]).max())


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


def _gather_rows_t(table, idx, use_kernel=False):
    """``table[idx].T``: one gather of every per-surface column per bounce,
    transposed so each column is an (N,) tensor.  Its backward sums the
    (k, N) cotangent into the (M, k) table gradient: K2
    (``ops/segsum_kernels.py``, the ``tfrt_torch::segment_sum`` operator)
    when ``use_kernel`` and the cotangent lies on CUDA, its plain version
    otherwise, both adding in one fixed order, so that a training repeats
    its bits; ``idx`` gets no gradient, and the backward is not
    differentiable.  The ``tfrt_torch::gather_rows_t`` operator
    (``ops/custom_ops.py``), so that ``torch.func.grad`` and
    ``grad_and_value`` pass through a trace and an exported gradient
    program launches K2."""
    return custom_ops.gather_rows_t(table, idx, use_kernel)


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
    :func:`landing_sum_fold`, :func:`landing_histogram_fold`).  Folds
    compose with ``cfg.remat`` and are differentiable.  ``keep_history``
    stacks the records along a leading bounce axis.

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
                "per-bounce history.  Use a fold (fold_fn/fold_init, e.g. "
                "landing_sum_fold) for the reduction you need, and "
                "trace_streamed to trace the rays block by block past what "
                "one trace's memory holds")

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


def landing_histogram_fold(value_range, x_bins, y_bins=None,
                           dtype=torch.float32, axes=(0, 1),
                           state_code=FINISHED, weight_field=None,
                           device=None):
    """``(init, fn)``: a (y_bins, x_bins) histogram of where rays land,
    accumulated bounce by bounce: every ray counts once, at the bounce it
    reaches ``state_code``, in O(bins) memory whatever the ray count or
    depth.  Binned by :func:`analysis.histogram2d` (y on axis 0,
    out-of-range landings clamped into the edge bins).

    ``axes`` picks the two components of the landing point binned as
    (x, y).  ``weight_field`` names a ray field that weights each landing;
    it needs ``trace(..., fold_fields=True)`` so that the record carries
    the fields."""
    y_bins = y_bins or x_bins
    init = torch.zeros((y_bins, x_bins), dtype=dtype,
                       device=resolve_device(device))
    ax, ay = axes

    def fn(acc, record):
        _, p1, state, alive = record[:4]
        mask = alive & (state == state_code)
        if weight_field is not None:
            if len(record) < 5:
                raise KeyError(
                    "landing_histogram_fold(weight_field=...) reads a ray "
                    "field, so the fold record must include the fields: pass "
                    "fold_fields=True to trace()")
            w = record[4][weight_field].to(acc.dtype)
        else:
            w = torch.ones(p1.shape[:-1], dtype=acc.dtype, device=acc.device)
        return acc + histogram2d(p1[..., ax], p1[..., ay], value_range,
                                 x_bins, y_bins, dtype=acc.dtype,
                                 weights=torch.where(mask, w, 0.0))

    return init, fn


# ======================================================================
# streaming: rays traced block by block, past one trace's memory
# ======================================================================

@dataclass
class StreamedResult:
    """Result of :func:`trace_streamed`: the merged fold and the ray counts
    by state.  It holds no per-ray tensor unless the fold is per-ray and
    merged with ``merge="concat"``.

    ``state_counts``: (4,) int64 ray counts indexed by the state codes
    [ACTIVE, FINISHED, STOPPED, DEAD], the padding slots already taken out.
    """

    fold: object
    state_counts: torch.Tensor
    n_blocks: int = 1
    block_size: int = 0
    n_rays: int = 0

    @property
    def counts_by_name(self):
        c = self.state_counts
        return {"active": c[ACTIVE], "finished": c[FINISHED],
                "stopped": c[STOPPED], "dead": c[DEAD]}


def _state_counts(state):
    """(4,) counts of ``state`` by code; the codes ACTIVE, FINISHED, STOPPED
    and DEAD are 0-3 in that order."""
    codes = torch.arange(4, dtype=state.dtype, device=state.device)
    return (state[None, :] == codes[:, None]).sum(dim=1)


def _pad_rays_dead(rays: RaySet, pad: int) -> RaySet:
    """Grow the ray axis by ``pad`` DEAD slots: edge-replicated coordinates
    keep every normalisation downstream finite, and the DEAD state keeps
    them out of every fold, reaction and classification."""

    def edge_pad(a):
        return torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])])

    return RaySet(p0=edge_pad(rays.p0), p1=edge_pad(rays.p1),
                  wavelength=edge_pad(rays.wavelength),
                  state=torch.cat([rays.state,
                                   rays.state.new_full((pad,), DEAD)]),
                  fields={k: edge_pad(v) for k, v in rays.fields.items()})


def _ray_slice(rays: RaySet, start: int, stop: int) -> RaySet:
    return RaySet(p0=rays.p0[start:stop], p1=rays.p1[start:stop],
                  wavelength=rays.wavelength[start:stop],
                  state=rays.state[start:stop],
                  fields={k: v[start:stop] for k, v in rays.fields.items()})


def _merge_stacked(fn, folds):
    """``fn(leaves)`` for each leaf position of the (equally structured)
    ``folds``, rebuilt into their structure."""
    flat = [pytree.tree_flatten(f) for f in folds]
    spec = flat[0][1]
    return pytree.tree_unflatten([fn(list(leaves))
                                  for leaves in zip(*(f[0] for f in flat))],
                                 spec)


def trace_streamed(rays, scene, materials=None,
                   cfg: TraceConfig = TraceConfig(),
                   reaction: Callable = default_reaction,
                   fold_fn: Callable = None, fold_init=None,
                   block_size: int = 1 << 20, n_blocks: Optional[int] = None,
                   merge="sum", remat_blocks: bool = True,
                   fold_fields: bool = False) -> StreamedResult:
    """Trace any number of rays in blocks of ``block_size``, one
    :func:`trace` after the other, and merge the blocks' folds: the device
    holds one block's trace at a time, so the ray count is bounded by time,
    not by memory.

    The stream is a host loop that launches block after block.  The JAX
    package's ``blocks_per_dispatch`` has no counterpart: it splits one
    ``lax.map`` program into several so that no program outruns the TPU
    runtime's watchdog, and here every block is already its own launches.

    Parameters
    ----------
    rays : RaySet | Callable[[int], RaySet]
        A ray set, traced in ``ceil(N / block_size)`` blocks (a short last
        block is padded with DEAD slots that no fold or count sees), or a
        block generator ``rays(i) -> RaySet`` of exactly ``block_size`` rays,
        so that the stream's rays never exist at once; it needs
        ``n_blocks``.  A generated block is drawn outside the checkpoint of
        ``remat_blocks``, so the backward traces the very rays the forward
        traced, whatever generator drew them.
    fold_fn, fold_init : the fold of each block's trace (required)
        Streaming returns reductions only.  ``fold_init`` is sized for one
        block (e.g. ``path_length_fold(block_size, dtype)``).
    merge : "sum" | "concat" | callable
        ``"sum"`` keeps a running sum of the blocks' folds (memory O(fold)
        whatever the number of blocks; right for scalar losses, counts and
        histograms); ``"concat"`` concatenates per-ray folds along their
        first axis and trims the padding, giving (N, ...) leaves; a callable
        gets the folds stacked along a new first axis of length n_blocks.
    remat_blocks : bool
        When autograd records the stream, trace each block under
        ``torch.utils.checkpoint``: the backward holds one block's trace at a
        time (and every block's rays) instead of every block's trace, for
        one more forward a block.  Under ``torch.no_grad()`` it adds
        nothing.

    For several devices see ``parallel.sharding.parallel_trace_streamed``.
    """
    if fold_fn is None:
        raise ValueError(
            "trace_streamed needs a fold (fold_fn/fold_init): streaming "
            "returns reductions only, since per-ray results of the full "
            "stream are what does not fit.  See landing_sum_fold / "
            "path_length_fold, or use trace() for sizes that fit.")
    if merge not in ("sum", "concat") and not callable(merge):
        raise ValueError(f"merge must be 'sum', 'concat' or a callable, "
                         f"got {merge!r}")
    materials = tuple(materials or ())

    if callable(rays):
        if n_blocks is None:
            raise ValueError("trace_streamed(rays=<callable>) needs n_blocks")
        n_rays, pad = n_blocks * block_size, 0
        get_block = rays
    else:
        n_rays = rays.n_rays
        n_blocks = -(-n_rays // block_size)
        pad = n_blocks * block_size - n_rays

        def get_block(i):
            blk = _ray_slice(rays, i * block_size, (i + 1) * block_size)
            return _pad_rays_dead(blk, pad) if blk.n_rays < block_size else blk

    def body(blk):
        res = trace(blk, scene, materials, cfg, reaction, fold_fn=fold_fn,
                    fold_init=fold_init, fold_fields=fold_fields)
        return res.fold, _state_counts(res.rays.state)

    remat = remat_blocks and torch.is_grad_enabled()
    fold = counts = None
    folds = []
    for i in range(n_blocks):
        if remat:
            block_fold, block_counts = checkpoint(
                body, get_block(i), use_reentrant=False,
                preserve_rng_state=False)
        else:
            block_fold, block_counts = body(get_block(i))
        counts = block_counts if counts is None else counts + block_counts
        if merge == "sum":
            fold = (block_fold if fold is None else
                    pytree.tree_map(torch.add, fold, block_fold))
        else:
            folds.append(block_fold)
        del block_fold, block_counts

    if merge == "concat":
        fold = _merge_stacked(lambda a: torch.cat(a)[:n_rays], folds)
    elif merge != "sum":
        fold = merge(_merge_stacked(torch.stack, folds))
    if pad:
        # the padding slots are DEAD by construction; take them back out
        counts = counts.clone()
        counts[DEAD] -= pad
    return StreamedResult(fold=fold, state_counts=counts,
                          n_blocks=int(n_blocks), block_size=int(block_size),
                          n_rays=int(n_rays))


def _blocks_value_and_grad(block_loss, blocks, params, aux):
    """The summed value of ``block_loss(params, i, *aux)`` over the block
    indices ``blocks`` and its summed gradient with respect to ``params``
    (zeros where no block reaches a parameter), one block's forward and
    backward at a time.  The value is None when ``blocks`` is empty."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    grads = [torch.zeros_like(p) for p in leaves]
    value = None
    with torch.enable_grad():
        for i in blocks:
            loss = block_loss(leaves, i, *aux)
            block_grads = torch.autograd.grad(loss, leaves,
                                              allow_unused=True)
            value = loss.detach() if value is None else value + loss.detach()
            for acc, g in zip(grads, block_grads):
                if g is not None:
                    acc += g
            del loss, block_grads
    return value, grads


def streamed_value_and_grad(block_loss: Callable, n_blocks: int) -> Callable:
    """The value and gradient of a loss that is a sum over ``n_blocks``
    blocks, accumulated block by block: its gradient is the sum of the
    blocks' gradients, so each block's forward and backward run before the
    next block starts and no block's graph outlives its backward.

    Parameters
    ----------
    block_loss : callable ``(params, i, *aux) -> scalar``
        The loss of block ``i`` (a Python int), typically: draw or slice the
        block's rays from ``i``, trace with a fold, return the folded scalar.
        ``params`` is a list of tensors.  A block whose rays come from a
        generator makes that generator from ``i``
        (``torch.Generator(device).manual_seed(f(seed, i))``), so that the
        stream does not depend on the order of its blocks.  ``aux`` are
        arguments passed through undifferentiated (the step's seed, say).
    n_blocks : the number of blocks in the stream.

    The JAX package's ``remat_blocks`` and ``blocks_per_dispatch`` have no
    counterpart: both shape its one ``lax.map`` program, whereas here each
    block's backward runs right after its forward, so the peak memory is
    one block's already and a checkpoint would only trace each block twice.

    Returns ``fn(params, *aux) -> (value, grads)``: the summed loss and a
    list of gradients, equal to autograd of the fused sum up to the order
    of summation.  For several devices see
    ``parallel.sharding.parallel_streamed_value_and_grad``.
    """
    if n_blocks <= 0:
        raise ValueError(
            f"streamed_value_and_grad: n_blocks must be positive, got "
            f"{n_blocks} (a rays // block computation may have rounded "
            "to zero -- clamp with max(1, ...))")

    def run(params, *aux):
        return _blocks_value_and_grad(block_loss, range(n_blocks), params,
                                      aux)

    return run
