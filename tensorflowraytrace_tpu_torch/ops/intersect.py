"""Nearest-hit ray/surface search and the differentiable refine, in 2D
(segments, arcs) and 3D (triangles).

Counterpart of ``tensorflowraytrace_tpu/ops/intersect.py``.  The hot loop
is split in two phases:

1. **Search** (``nearest_hit_triangles``, ``nearest_hit_segments``,
   ``nearest_hit_arcs``, ``nearest_hit_2d``): the index of the nearest
   valid surface per ray, without gradient (an argmin index is discrete).
   Tiled over surface chunks and ray blocks so the N x M intersection matrix
   is never materialised.  ``use_kernel=True`` hands the search to a CUDA
   kernel: K1 (brute force), K3 (``cull=True``) or K4 (``cull="grid"``) for
   triangles (``ops/triangle_kernels.py``); K5, K7 (``cull=True``) or K9
   (``cull="grid"``) for segments (``ops/segment_kernels.py``); K6, K8 or
   K10 for arcs (``ops/arc_kernels.py``).
2. **Refine** (``refine_*_hit_from`` on rows the engine has gathered,
   ``refine_*_hit`` on a surface set and the search's indices): the one
   chosen intersection recomputed per ray -- O(N) and fully
   differentiable.

Validity pruning:
  segments:  seg_u in [-size_eps, 1 + size_eps], ray_u >= ray_start_eps
  arcs:      ray_u >= ray_start_eps, hit angle inside [angle_start,
             angle_end]; of the two quadratic branches the nearer wins
  triangles: trig_u >= -size_eps, trig_v >= -size_eps,
             trig_u + trig_v <= 1 + size_eps, ray_u >= ray_start_eps
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tensorflowraytrace_tpu_torch.models.surfaces import (
    ArcSet, Scene2D, SegmentSet, TriangleSet,
)
from tensorflowraytrace_tpu_torch.ops import arc_kernels, geometry
from tensorflowraytrace_tpu_torch.ops import segment_kernels, triangle_kernels

# surface-kind codes of the combined 2D hit record
KIND_SEGMENT = 0
KIND_ARC = 1

_DEF_SURF_CHUNK = 128
_DEF_RAY_BLOCK = 32768


@dataclass
class HitRecord:
    """Per-ray nearest-hit search result (every tensor has shape (N,)).

    valid  : found any valid intersection
    idx    : index of the winning surface in the merged set (0 if ~valid)
    ray_u  : ray parameter of the winning hit (for comparisons only)
    kind   : KIND_SEGMENT or KIND_ARC in 2D; zeros in 3D
    branch : True where an arc's quadratic minus branch won; False for
             segments and in 3D
    """

    valid: torch.Tensor
    idx: torch.Tensor
    ray_u: torch.Tensor
    kind: torch.Tensor
    branch: torch.Tensor


@torch.no_grad()
def _chunked_search(p0, p1, surf_arrays, chunk_fn, n_surf, surf_chunk,
                    ray_block):
    """Tiled nearest-hit search.

    ``chunk_fn(p0, p1, chunk) -> (u, valid, extra)`` gives, for a ray block
    (B, dim) against a chunk of surface tensors, the (B, C) ray parameter,
    validity and an optional (B, C) boolean payload of each pair (the arc
    branch; ``None`` for none).  Surfaces are zero-padded to whole chunks; a
    chunk's minimum replaces the running best only under strict <,
    ``argmin`` takes the first index inside a chunk, the winner's payload
    rides along, and ``valid`` is ``any(valid)`` over all chunks.  Rays are
    padded to whole blocks when there is more than one block.  Returns
    per-ray ``(valid, idx, u, extra)``; ``u`` is ``inf`` where nothing hit
    and ``extra`` is False where no payload was given.
    """
    n_rays = p0.shape[0]
    # a set smaller than one chunk is one chunk of its own size: the
    # result does not depend on the chunking, and padding a handful of
    # surfaces to a whole chunk multiplies the work
    surf_chunk = max(1, min(surf_chunk, n_surf))
    n_chunks = -(-n_surf // surf_chunk)
    pad_surf = n_chunks * surf_chunk - n_surf

    def pad0(a, pad):
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]) if pad else a

    surf_arrays = [pad0(a, pad_surf) for a in surf_arrays]

    def per_block(bp0, bp1):
        b = bp0.shape[0]
        best_u = torch.full((b,), float("inf"), dtype=bp0.dtype,
                            device=bp0.device)
        best_idx = torch.zeros((b,), dtype=torch.int32, device=bp0.device)
        best_extra = torch.zeros((b,), dtype=torch.bool, device=bp0.device)
        any_valid = torch.zeros((b,), dtype=torch.bool, device=bp0.device)
        for ci in range(n_chunks):
            chunk = [a[ci * surf_chunk:(ci + 1) * surf_chunk]
                     for a in surf_arrays]
            u, valid, extra = chunk_fn(bp0, bp1, chunk)       # (B, C)
            u = torch.where(valid, u, float("inf"))
            c_arg = torch.argmin(u, dim=1)
            c_u = u.gather(1, c_arg[:, None])[:, 0]
            c_idx = (ci * surf_chunk + c_arg).to(torch.int32)
            better = c_u < best_u
            best_u = torch.where(better, c_u, best_u)
            best_idx = torch.where(better, c_idx, best_idx)
            if extra is not None:
                c_extra = extra.gather(1, c_arg[:, None])[:, 0]
                best_extra = torch.where(better, c_extra, best_extra)
            any_valid = any_valid | torch.any(valid, dim=1)
        return any_valid, best_idx, best_u, best_extra

    if n_rays > ray_block:
        nb = -(-n_rays // ray_block)
        pad_rays = nb * ray_block - n_rays
        p0 = pad0(p0, pad_rays)
        p1 = pad0(p1, pad_rays)
        parts = [per_block(p0[i * ray_block:(i + 1) * ray_block],
                           p1[i * ray_block:(i + 1) * ray_block])
                 for i in range(nb)]
        return tuple(torch.cat(col)[:n_rays] for col in zip(*parts))
    return per_block(p0, p1)


def nearest_hit_triangles(
    p0, p1, tri: TriangleSet, intersect_eps, size_eps, ray_start_eps,
    surf_chunk=_DEF_SURF_CHUNK, ray_block=_DEF_RAY_BLOCK, use_kernel=False,
    cull=False,
) -> HitRecord:
    """Per-ray nearest triangle (search phase; no gradient).

    ``use_kernel=False`` runs the Cramer search of the JAX package's XLA
    path; ``use_kernel=True`` runs the Moller-Trumbore search of K1 (the CUDA
    kernel on the card, its plain version on the CPU), whose ``ray_u`` is
    ``BIG`` rather than ``inf`` on a miss.  Under ``use_kernel`` the search
    is chosen as ``nearest_hit_triangles_pallas`` chooses it: ``cull="grid"``
    runs the two-level K4, any other true ``cull`` the culled K3, and
    ``cull=False`` K1; all three return the same hits.  Without
    ``use_kernel``, ``cull`` changes nothing here.
    """
    p0, p1 = p0.detach(), p1.detach()
    vp, v1, v2 = tri.vp.detach(), tri.v1.detach(), tri.v2.detach()
    if use_kernel:
        if cull == "grid":
            search = triangle_kernels.nearest_hit_triangles_twolevel_kernel
        elif cull:
            search = triangle_kernels.nearest_hit_triangles_culled_kernel
        else:
            search = triangle_kernels.nearest_hit_triangles_kernel
        valid, idx, ray_u = search(
            p0.contiguous(), p1.contiguous(), vp.contiguous(),
            v1.contiguous(), v2.contiguous(),
            intersect_eps, size_eps, ray_start_eps)
    else:
        def chunk_fn(bp0, bp1, chunk):
            cvp, cv1, cv2 = chunk
            r = [bp0[:, None, k] for k in range(3)] \
                + [bp1[:, None, k] for k in range(3)]            # (B, 1)
            s = [a[None, :, k] for a in (cvp, cv1, cv2) for k in range(3)]
            _, _, _, valid, ray_u, tu, tv = \
                geometry.raw_line_triangle_intersect(*r, *s, intersect_eps)
            valid = valid & (tu >= -size_eps) & (tv >= -size_eps)
            valid = valid & (tu + tv <= 1 + size_eps) & (ray_u >= ray_start_eps)
            return ray_u, valid, None

        valid, idx, ray_u, _ = _chunked_search(
            p0, p1, (vp, v1, v2), chunk_fn, tri.n_surfaces, surf_chunk,
            ray_block)
    return HitRecord(valid=valid, idx=idx, ray_u=ray_u,
                     kind=torch.zeros_like(idx),
                     branch=torch.zeros_like(valid))


def refine_triangle_hit(p0, p1, tri: TriangleSet, idx, intersect_eps):
    """Differentiable recompute of each ray's chosen intersection with the
    triangles ``idx`` of ``tri``: their rows gathered, then
    :func:`refine_triangle_hit_from`.  Gradients reach the gathered
    vertices and the ray endpoints, not the (discrete) index.  Returns
    ``(point (N, 3), ray_u, trig_u, trig_v)``."""
    idx = idx.detach()
    return refine_triangle_hit_from(p0, p1, tri.vp[idx], tri.v1[idx],
                                    tri.v2[idx], intersect_eps)


def refine_triangle_hit_from(p0, p1, vp, v1, v2, intersect_eps):
    """Differentiable recompute of each ray's chosen intersection against
    already-gathered per-ray triangle vertices.  Returns
    ``(point (N, 3), ray_u, trig_u, trig_v)``."""
    x, y, z, _, ray_u, tu, tv = geometry.raw_line_triangle_intersect(
        p0[:, 0], p0[:, 1], p0[:, 2], p1[:, 0], p1[:, 1], p1[:, 2],
        vp[:, 0], vp[:, 1], vp[:, 2], v1[:, 0], v1[:, 1], v1[:, 2],
        v2[:, 0], v2[:, 1], v2[:, 2], intersect_eps,
    )
    return torch.stack([x, y, z], dim=1), ray_u, tu, tv


# ======================================================================
# Segments and arcs (2D)
# ======================================================================

def nearest_hit_segments(
    p0, p1, seg: SegmentSet, intersect_eps, size_eps, ray_start_eps,
    surf_chunk=_DEF_SURF_CHUNK, ray_block=_DEF_RAY_BLOCK, use_kernel=False,
    cull=False,
) -> HitRecord:
    """Per-ray nearest segment (search phase; no gradient).

    ``use_kernel=False`` runs the line/line solve of the JAX package's XLA
    path; ``use_kernel=True`` runs (the CUDA kernel on the card, its plain
    version on the CPU) the search ``nearest_hit_segments_pallas`` chooses:
    the two-level K9 for ``cull="grid"``, the culled K7 for any other true
    ``cull``, K5 for ``cull=False``.  All three return the same hits, with
    ``ray_u`` ``BIG`` rather than ``inf`` on a miss."""
    p0, p1 = p0.detach(), p1.detach()
    sp0, sp1 = seg.p0.detach(), seg.p1.detach()
    if use_kernel:
        if cull == "grid":
            search = segment_kernels.nearest_hit_segments_twolevel_kernel
        elif cull:
            search = segment_kernels.nearest_hit_segments_culled_kernel
        else:
            search = segment_kernels.nearest_hit_segments_kernel
        valid, idx, ray_u = search(p0.contiguous(), p1.contiguous(),
                                   sp0.contiguous(), sp1.contiguous(),
                                   intersect_eps, size_eps, ray_start_eps)
    else:
        def chunk_fn(bp0, bp1, chunk):
            cp0, cp1 = chunk
            _, _, valid, ray_u, seg_u = geometry.raw_line_intersect(
                bp0[:, None, 0], bp0[:, None, 1], bp1[:, None, 0],
                bp1[:, None, 1], cp0[None, :, 0], cp0[None, :, 1],
                cp1[None, :, 0], cp1[None, :, 1], intersect_eps)
            valid = valid & (seg_u >= -size_eps) & (seg_u <= 1 + size_eps)
            return ray_u, valid & (ray_u >= ray_start_eps), None

        valid, idx, ray_u, _ = _chunked_search(
            p0, p1, (sp0, sp1), chunk_fn, seg.n_surfaces, surf_chunk,
            ray_block)
    return HitRecord(valid=valid, idx=idx, ray_u=ray_u,
                     kind=torch.full_like(idx, KIND_SEGMENT),
                     branch=torch.zeros_like(valid))


def refine_segment_hit(p0, p1, seg: SegmentSet, idx, intersect_eps):
    """Differentiable recompute of each ray's chosen intersection with the
    segments ``idx`` of ``seg``: their endpoints gathered, then
    :func:`refine_segment_hit_from`.  Returns ``(point (N, 2), ray_u,
    seg_u, norm_angle)``."""
    idx = idx.detach()
    return refine_segment_hit_from(p0, p1, seg.p0[idx], seg.p1[idx],
                                   intersect_eps)


def refine_segment_hit_from(p0, p1, sp0, sp1, intersect_eps):
    """Differentiable recompute of each ray's chosen intersection against
    already-gathered per-ray segment endpoints.  Returns ``(point (N, 2),
    ray_u, seg_u, norm_angle)``."""
    x, y, _, ray_u, seg_u = geometry.raw_line_intersect(
        p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1],
        sp0[:, 0], sp0[:, 1], sp1[:, 0], sp1[:, 1], intersect_eps)
    d = sp1 - sp0
    norm = torch.atan2(d[:, 1], d[:, 0]) + geometry.PI / 2
    return torch.stack([x, y], dim=1), ray_u, seg_u, norm


def nearest_hit_arcs(
    p0, p1, arc: ArcSet, intersect_eps, size_eps, ray_start_eps,
    surf_chunk=_DEF_SURF_CHUNK, ray_block=_DEF_RAY_BLOCK, use_kernel=False,
    cull=False,
) -> HitRecord:
    """Per-ray nearest arc (search phase; no gradient); ``branch`` is True
    where the quadratic's minus branch won.

    ``use_kernel=False`` runs the JAX package's XLA path: the line/circle
    solve and the ``atan2`` window test (``geometry.angle_in_interval``).
    ``use_kernel=True`` runs K6 (``cull=False``), K8 (``cull=True``) or K10
    (``cull="grid"``), chosen as ``nearest_hit_arcs_pallas`` chooses; their
    window test is the TPU kernels' cross-product form (it can disagree with
    ``atan2`` at a window's edge) and their ``ray_u`` is ``BIG`` on a miss.
    Arcs take no ``size_eps``."""
    p0, p1 = p0.detach(), p1.detach()
    center, a1 = arc.center.detach(), arc.angle_start.detach()
    a2, radius = arc.angle_end.detach(), arc.radius.detach()
    if use_kernel:
        if cull == "grid":
            search = arc_kernels.nearest_hit_arcs_twolevel_kernel
        elif cull:
            search = arc_kernels.nearest_hit_arcs_culled_kernel
        else:
            search = arc_kernels.nearest_hit_arcs_kernel
        valid, idx, ray_u, branch = search(
            p0.contiguous(), p1.contiguous(), center.contiguous(),
            a1.contiguous(), a2.contiguous(), radius.contiguous(),
            intersect_eps, ray_start_eps)
    else:
        def chunk_fn(bp0, bp1, chunk):
            c_center, c_a1, c_a2, c_r = chunk
            plus, minus = geometry.raw_line_circle_intersect(
                bp0[:, None, 0], bp0[:, None, 1], bp1[:, None, 0],
                bp1[:, None, 1], c_center[None, :, 0], c_center[None, :, 1],
                c_r[None, :], intersect_eps)
            pv = plus["valid"] & (plus["u"] >= ray_start_eps)
            mv = minus["valid"] & (minus["u"] >= ray_start_eps)
            pv = pv & geometry.angle_in_interval(plus["v"], c_a1[None, :],
                                                 c_a2[None, :])
            mv = mv & geometry.angle_in_interval(minus["v"], c_a1[None, :],
                                                 c_a2[None, :])
            pu = torch.where(pv, plus["u"], float("inf"))
            mu = torch.where(mv, minus["u"], float("inf"))
            choose_minus = mu < pu
            return torch.where(choose_minus, mu, pu), pv | mv, choose_minus

        valid, idx, ray_u, branch = _chunked_search(
            p0, p1, (center, a1, a2, radius), chunk_fn, arc.n_surfaces,
            surf_chunk, ray_block)
    return HitRecord(valid=valid, idx=idx, ray_u=ray_u,
                     kind=torch.full_like(idx, KIND_ARC), branch=branch)


def refine_arc_hit(p0, p1, arc: ArcSet, idx, branch, intersect_eps):
    """Differentiable recompute of each ray's chosen hit with the arcs
    ``idx`` of ``arc`` on the quadratic branch ``branch``: their centres
    and radii gathered, then :func:`refine_arc_hit_from` (whose radicand
    is 4(a - (x_r x d_r)^2)).  Returns ``(point (N, 2), ray_u, arc_u,
    norm_angle)``."""
    idx = idx.detach()
    return refine_arc_hit_from(p0, p1, arc.center[idx], arc.radius[idx],
                               branch.detach(), intersect_eps)


def refine_arc_hit_from(p0, p1, center, radius, branch, intersect_eps):
    """Differentiable recompute of each ray's chosen arc hit on its branch,
    against already-gathered per-ray centre and radius.  Returns
    ``(point (N, 2), ray_u, arc_u, norm_angle)``; the normal is the hit's
    polar angle, + pi for a negative radius, wrapped to [-pi, pi)."""
    plus, minus = geometry.raw_line_circle_intersect(
        p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1],
        center[:, 0], center[:, 1], radius, intersect_eps)

    def pick(key):
        return torch.where(branch, minus[key], plus[key])

    arc_u = pick("v")
    norm = torch.where(radius < 0, arc_u + geometry.PI, arc_u)
    norm = torch.remainder(norm + geometry.PI, 2 * geometry.PI) - geometry.PI
    return (torch.stack([pick("x"), pick("y")], dim=1), pick("u"), arc_u,
            norm)


def nearest_hit_2d(p0, p1, scene: Scene2D, intersect_eps, size_eps,
                   ray_start_eps, **kw) -> HitRecord:
    """Nearest hit across the scene's segments and arcs: the smaller ray
    parameter wins, a tie goes to the arc.  A search's ray parameter counts
    only where it is valid (the kernels return ``BIG``, not ``inf``, on a
    miss)."""
    seg_rec = arc_rec = None
    if scene.segments is not None:
        seg_rec = nearest_hit_segments(p0, p1, scene.segments, intersect_eps,
                                       size_eps, ray_start_eps, **kw)
    if scene.arcs is not None:
        arc_rec = nearest_hit_arcs(p0, p1, scene.arcs, intersect_eps,
                                   size_eps, ray_start_eps, **kw)
    if arc_rec is None:
        return seg_rec
    if seg_rec is None:
        return arc_rec

    su = torch.where(seg_rec.valid, seg_rec.ray_u, float("inf"))
    au = torch.where(arc_rec.valid, arc_rec.ray_u, float("inf"))
    choose_seg = su < au
    return HitRecord(
        valid=seg_rec.valid | arc_rec.valid,
        idx=torch.where(choose_seg, seg_rec.idx, arc_rec.idx),
        ray_u=torch.where(choose_seg, su, au),
        kind=torch.where(choose_seg, KIND_SEGMENT, KIND_ARC).to(torch.int32),
        branch=arc_rec.branch,
    )
