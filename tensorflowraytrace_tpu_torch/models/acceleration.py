"""Spatial acceleration for the nearest-hit search, in 2D and 3D.

Counterpart of ``tensorflowraytrace_tpu/models/acceleration.py``; like the
rest of the port it imports nothing of JAX or of the JAX package.
Culling is exactly conservative: a culled search returns the brute-force
search's hits bit for bit, it only skips work that cannot give a nearer hit.

1. ``morton_sort_triangles`` (centroids), ``morton_sort_segments``
   (midpoints) and ``morton_sort_arcs`` (centres of their window-aware
   boxes) reorder a surface set by Morton code, so that consecutive kernel
   chunks are spatially compact.
2. ``chunk_aabbs`` (C, 6), ``chunk_aabbs_2d`` and ``chunk_aabbs_arcs``
   (C, 4) give one axis-aligned box per kernel chunk; ``arc_aabbs`` the
   box of each arc.
3. The culled searches slab-test rays against those boxes and skip the
   chunks no ray can improve on: ``ops/triangle_kernels.py`` (K3 for
   ``cull=True``, K4 for ``cull="grid"``), ``ops/segment_kernels.py`` (K7,
   K9) and ``ops/arc_kernels.py`` (K8, K10).
4. ``morton_codes_device`` orders the rays on the device for the engine's
   per-bounce re-sort (``TraceConfig.resort_rays``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.models.surfaces import (
    ArcSet, SegmentSet, TriangleSet,
)

MORTON_BITS = 10      # per axis in 3D (30-bit codes)
MORTON_BITS_2D = 16   # per axis in 2D (32-bit codes)


def _spread3(x, mask):
    """Spread 10 bits of ``x`` to every third bit position (any integer
    array type with ``<<``, ``|`` and ``&``)."""
    x = (x | (x << 16)) & mask(0x030000FF)
    x = (x | (x << 8)) & mask(0x0300F00F)
    x = (x | (x << 4)) & mask(0x030C30C3)
    x = (x | (x << 2)) & mask(0x09249249)
    return x


def _spread2(x, mask):
    """Spread 16 bits of ``x`` to every second bit position."""
    x = (x | (x << 8)) & mask(0x00FF00FF)
    x = (x | (x << 4)) & mask(0x0F0F0F0F)
    x = (x | (x << 2)) & mask(0x33333333)
    x = (x | (x << 1)) & mask(0x55555555)
    return x


def _interleave(q, mask):
    """Morton code of the integer grid coordinates ``q`` (N, 2) or (N, 3)."""
    if q.shape[1] == 2:
        return _spread2(q[:, 0], mask) | (_spread2(q[:, 1], mask) << mask(1))
    s = [_spread3(q[:, k], mask) for k in range(3)]
    return s[0] | (s[1] << mask(1)) | (s[2] << mask(2))


def _morton_codes(points: np.ndarray) -> np.ndarray:
    """Interleaved-bit Morton codes (uint64) of (N, 2) or (N, 3) host
    points, normalised to their bounding box."""
    bits = MORTON_BITS_2D if points.shape[1] == 2 else MORTON_BITS
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = np.maximum(hi - lo, 1e-30)
    q = np.clip(((points - lo) / span * ((1 << bits) - 1)).astype(np.uint64),
                0, (1 << bits) - 1)
    return _interleave(q, np.uint64)


def morton_codes_device(points, lo, hi):
    """Morton codes (int64) of (N, 2) or (N, 3) device points in the box
    [lo, hi], 16 bits per axis in 2D and 10 in 3D.

    torch has no usable uint32 shifts, so the codes are int64 (32 or 30
    bits used).  The grid coordinate is clamped to [0, 2^bits - 1] in
    floating point before the cast: casting 1e30 (a parked ray) or a
    negative float to an integer is undefined.  Points outside the box take
    the nearest edge's code, so parked rays (p0 = 1e30) get the largest
    code and sort last."""
    bits = MORTON_BITS_2D if points.shape[1] == 2 else MORTON_BITS
    span = torch.clamp(hi - lo, min=1e-30)
    top = float((1 << bits) - 1)
    q = torch.clamp((points - lo) / span * top, 0.0, top).to(torch.int64)
    return _interleave(q, int)


def _permuted(surface, perm, names):
    """``surface`` with the columns ``names``, its category, material ids
    and fields taken in the order ``perm`` (a numpy array)."""
    index = torch.as_tensor(perm, device=surface.device)

    def take(a):
        return a.index_select(0, index)

    columns = {name: take(getattr(surface, name))
               for name in names + ("category", "mat_in", "mat_out")}
    return dataclasses.replace(
        surface, fields={k: take(v) for k, v in surface.fields.items()},
        **columns)


def morton_sort_triangles(tri: TriangleSet):
    """Reorder a TriangleSet by centroid Morton code.

    Returns ``(sorted_set, perm)`` with ``sorted[i] == original[perm[i]]``
    (``perm`` a numpy int64 array); ``fields`` are permuted too.  Hit
    indices of a trace over the sorted set refer to the sorted order.  The
    centroid is ``((vp + v1) + v2) / 3`` in the set's dtype and the sort is
    stable, so the permutation is the JAX package's."""
    centroids = ((tri.vp + tri.v1 + tri.v2) / 3.0).detach().cpu().numpy()
    perm = np.argsort(_morton_codes(centroids), kind="stable")
    return _permuted(tri, perm, ("vp", "v1", "v2", "norm")), perm


def morton_sort_segments(seg: SegmentSet):
    """Reorder a SegmentSet by the Morton code of the segment midpoints
    ``(p0 + p1) / 2``; returns ``(sorted_set, perm)`` as
    :func:`morton_sort_triangles` does, with the JAX package's
    permutation."""
    mid = ((seg.p0 + seg.p1) / 2.0).detach().cpu().numpy()
    perm = np.argsort(_morton_codes(mid), kind="stable")
    return _permuted(seg, perm, ("p0", "p1")), perm


def arc_aabbs(center, angle_start, angle_end, radius):
    """Tight per-arc boxes, window-aware: the two endpoints plus each axis
    extreme (+x, +y, -x, -y) whose angle lies in the counter-clockwise
    window, at |radius| (a negative radius flips only the normal).  Returns
    ``(lo (M, 2), hi (M, 2))``.  The extremes enter as Python scalars, so
    nothing is copied to the device."""
    center, a1, a2 = center.detach(), angle_start.detach(), angle_end.detach()
    r = torch.abs(radius.detach())
    sweep = a2 - a1
    sweep = torch.where(sweep < 0, sweep + 2 * math.pi, sweep)

    def point(theta):
        return center + r[:, None] * torch.stack([torch.cos(theta),
                                                  torch.sin(theta)], dim=-1)

    p_start, p_end = point(a1), point(a2)
    lo = torch.minimum(p_start, p_end)
    hi = torch.maximum(p_start, p_end)
    for e, (dx, dy) in ((0.0, (1.0, 0.0)), (math.pi / 2, (0.0, 1.0)),
                        (math.pi, (-1.0, 0.0)), (3 * math.pi / 2, (0.0, -1.0))):
        in_window = (torch.remainder(e - a1, 2 * math.pi) <= sweep)[:, None]
        ext = center + torch.stack([r * dx, r * dy], dim=-1)
        lo = torch.where(in_window, torch.minimum(lo, ext), lo)
        hi = torch.where(in_window, torch.maximum(hi, ext), hi)
    return lo, hi


def morton_sort_arcs(arc: ArcSet):
    """Reorder an ArcSet by the Morton code of the centres of the arcs'
    boxes (:func:`arc_aabbs`); returns ``(sorted_set, perm)`` with the JAX
    package's permutation."""
    lo, hi = arc_aabbs(arc.center, arc.angle_start, arc.angle_end, arc.radius)
    mid = ((lo + hi) / 2.0).cpu().numpy()
    perm = np.argsort(_morton_codes(mid), kind="stable")
    return _permuted(arc, perm, ("center", "angle_start", "angle_end",
                                 "radius")), perm


def chunk_aabbs(vp, v1, v2, chunk_size: int):
    """Per-chunk boxes of a triangle table cut into chunks of
    ``chunk_size`` rows: a (C, 6) tensor, columns 0-2 the box minimum and
    3-5 the maximum, C = ceil(M / chunk_size).  The last chunk is padded by
    repeating its last triangle, so its box is that of its real triangles.
    (The JAX package's (8, C) sublane-padded layout is a TPU tiling.)"""
    m = vp.shape[0]
    c = -(-m // chunk_size)
    pad = c * chunk_size - m

    def prep(a):
        a = a.detach()
        if pad:
            a = torch.cat([a, a[-1:].expand(pad, 3)])
        return a.reshape(c, chunk_size, 3)

    pts = torch.cat([prep(vp), prep(v1), prep(v2)], dim=1)  # (C, 3B, 3)
    return torch.cat([pts.amin(dim=1), pts.amax(dim=1)], dim=1)


def _chunk_boxes_2d(lo, hi, chunk_size):
    """(C, 4) boxes, columns min xy then max xy, of the (M, 2) point sets
    ``lo`` and ``hi`` cut into chunks of ``chunk_size`` rows; the last chunk
    is padded by repeating its last row."""
    m = lo.shape[0]
    c = -(-m // chunk_size)
    pad = c * chunk_size - m

    def prep(a):
        a = a.detach()
        if pad:
            a = torch.cat([a, a[-1:].expand(pad, 2)])
        return a.reshape(c, chunk_size, 2)

    return torch.cat([prep(lo).amin(dim=1), prep(hi).amax(dim=1)], dim=1)


def chunk_aabbs_2d(p0, p1, chunk_size: int):
    """Per-chunk boxes of a segment table cut into chunks of ``chunk_size``
    rows: a (C, 4) tensor, columns 0-1 the minimum and 2-3 the maximum.
    (The JAX package's (8, C) layout is a TPU tiling.)"""
    return _chunk_boxes_2d(torch.minimum(p0, p1), torch.maximum(p0, p1),
                           chunk_size)


def chunk_aabbs_arcs(center, angle_start, angle_end, radius, chunk_size: int):
    """Per-chunk boxes over the arcs' window-aware boxes (:func:`arc_aabbs`),
    laid out as :func:`chunk_aabbs_2d`'s."""
    lo, hi = arc_aabbs(center, angle_start, angle_end, radius)
    return _chunk_boxes_2d(lo, hi, chunk_size)
