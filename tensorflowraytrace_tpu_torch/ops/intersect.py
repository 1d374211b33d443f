"""Nearest-hit ray/triangle search and the differentiable refine.

Counterpart of the 3D half of ``tensorflowraytrace_tpu/ops/intersect.py``.
The hot loop is split in two phases:

1. **Search** (``nearest_hit_triangles``): the index of the nearest valid
   triangle per ray, without gradient (an argmin index is discrete).  Tiled
   over triangle chunks and ray blocks so the N x M intersection matrix is
   never materialised.  ``use_kernel=True`` hands the search to a CUDA
   kernel (``ops/triangle_kernels.py``): K1 (brute force), K3 (``cull=True``)
   or K4 (``cull="grid"``).
2. **Refine** (``refine_triangle_hit_from``): the one chosen ray/triangle
   intersection recomputed per ray -- O(N) and fully differentiable.

Validity pruning: trig_u >= -size_eps, trig_v >= -size_eps,
trig_u + trig_v <= 1 + size_eps, ray_u >= ray_start_eps.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tensorflowraytrace_tpu_torch.models.surfaces import TriangleSet
from tensorflowraytrace_tpu_torch.ops import geometry
from tensorflowraytrace_tpu_torch.ops import triangle_kernels

_DEF_SURF_CHUNK = 128
_DEF_RAY_BLOCK = 32768


@dataclass
class HitRecord:
    """Per-ray nearest-hit search result (every tensor has shape (N,)).

    valid  : found any valid intersection
    idx    : index of the winning surface in the merged set (0 if ~valid)
    ray_u  : ray parameter of the winning hit (for comparisons only)
    kind   : 2D only; zeros in 3D
    branch : 2D arcs only; False in 3D
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

    ``chunk_fn(p0, p1, chunk) -> (u, valid)`` gives, for a ray block (B, dim)
    against a chunk of surface tensors, the (B, C) ray parameter and
    validity.  Surfaces are zero-padded to whole chunks; a chunk's minimum
    replaces the running best only under strict <, ``argmin`` takes the first
    index inside a chunk, and ``valid`` is ``any(valid)`` over all chunks.
    Rays are padded to whole blocks when there is more than one block.
    Returns per-ray ``(valid, idx, u)``; ``u`` is ``inf`` where nothing hit.
    """
    n_rays = p0.shape[0]
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
        any_valid = torch.zeros((b,), dtype=torch.bool, device=bp0.device)
        for ci in range(n_chunks):
            chunk = [a[ci * surf_chunk:(ci + 1) * surf_chunk]
                     for a in surf_arrays]
            u, valid = chunk_fn(bp0, bp1, chunk)              # (B, C)
            u = torch.where(valid, u, float("inf"))
            c_arg = torch.argmin(u, dim=1)
            c_u = u.gather(1, c_arg[:, None])[:, 0]
            c_idx = (ci * surf_chunk + c_arg).to(torch.int32)
            better = c_u < best_u
            best_u = torch.where(better, c_u, best_u)
            best_idx = torch.where(better, c_idx, best_idx)
            any_valid = any_valid | torch.any(valid, dim=1)
        return any_valid, best_idx, best_u

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
            return ray_u, valid

        valid, idx, ray_u = _chunked_search(
            p0, p1, (vp, v1, v2), chunk_fn, tri.n_surfaces, surf_chunk,
            ray_block)
    return HitRecord(valid=valid, idx=idx, ray_u=ray_u,
                     kind=torch.zeros_like(idx),
                     branch=torch.zeros_like(valid))


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
