"""Spatial acceleration for the nearest-hit search (3D).

Counterpart of the 3D half of ``tensorflowraytrace_tpu/models/acceleration.py``;
like the rest of the port it imports nothing of JAX or of the JAX package.
Culling is exactly conservative: a culled search returns the brute-force
search's hits bit for bit, it only skips work that cannot give a nearer hit.

1. ``morton_sort_triangles`` reorders a TriangleSet by the Morton code of the
   triangle centroids, so that consecutive kernel chunks are spatially
   compact.
2. ``chunk_aabbs`` gives one axis-aligned box per kernel chunk.
3. The culled searches (``ops/triangle_kernels.py``: K3 for ``cull=True``,
   K4 for ``cull="grid"``) slab-test rays against those boxes and skip the
   chunks no ray can improve on.
4. ``morton_codes_device`` orders the rays on the device for the engine's
   per-bounce re-sort (``TraceConfig.resort_rays``).

The 2D helpers of the JAX module (segments and arcs) belong to the 2D slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.models.surfaces import TriangleSet

MORTON_BITS = 10


def _spread3(x, mask):
    """Spread 10 bits of ``x`` to every third bit position (any integer
    array type with ``<<``, ``|`` and ``&``)."""
    x = (x | (x << 16)) & mask(0x030000FF)
    x = (x | (x << 8)) & mask(0x0300F00F)
    x = (x | (x << 4)) & mask(0x030C30C3)
    x = (x | (x << 2)) & mask(0x09249249)
    return x


def _morton_codes(points: np.ndarray, bits: int = MORTON_BITS) -> np.ndarray:
    """Interleaved-bit Morton codes (uint64) of (N, 3) host points,
    normalised to their bounding box."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = np.maximum(hi - lo, 1e-30)
    q = np.clip(((points - lo) / span * ((1 << bits) - 1)).astype(np.uint64),
                0, (1 << bits) - 1)
    s = [_spread3(q[:, k], np.uint64) for k in range(3)]
    return s[0] | (s[1] << np.uint64(1)) | (s[2] << np.uint64(2))


def morton_codes_device(points, lo, hi, bits: int = MORTON_BITS):
    """Morton codes (int64) of (N, 3) device points in the box [lo, hi].

    torch has no usable uint32 shifts, so the codes are int64 (30 bits
    used).  The grid coordinate is clamped to [0, 2^bits - 1] in floating
    point before the cast: casting 1e30 (a parked ray) or a negative float
    to an integer is undefined.  Points outside the box take the nearest
    face's code, so parked rays (p0 = 1e30) get the largest code and sort
    last."""
    span = torch.clamp(hi - lo, min=1e-30)
    top = float((1 << bits) - 1)
    q = torch.clamp((points - lo) / span * top, 0.0, top).to(torch.int64)
    s = [_spread3(q[:, k], int) for k in range(3)]
    return s[0] | (s[1] << 1) | (s[2] << 2)


def morton_sort_triangles(tri: TriangleSet):
    """Reorder a TriangleSet by centroid Morton code.

    Returns ``(sorted_set, perm)`` with ``sorted[i] == original[perm[i]]``
    (``perm`` a numpy int64 array); ``fields`` are permuted too.  Hit
    indices of a trace over the sorted set refer to the sorted order.  The
    centroid is ``((vp + v1) + v2) / 3`` in the set's dtype and the sort is
    stable, so the permutation is the JAX package's."""
    centroids = ((tri.vp + tri.v1 + tri.v2) / 3.0).detach().cpu().numpy()
    perm = np.argsort(_morton_codes(centroids), kind="stable")
    index = torch.as_tensor(perm, device=tri.vp.device)

    def take(a):
        return a.index_select(0, index)

    sorted_set = dataclasses.replace(
        tri, vp=take(tri.vp), v1=take(tri.v1), v2=take(tri.v2),
        norm=take(tri.norm), category=take(tri.category),
        mat_in=take(tri.mat_in), mat_out=take(tri.mat_out),
        fields={k: take(v) for k, v in tri.fields.items()},
    )
    return sorted_set, perm


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
