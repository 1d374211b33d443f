"""The nearest ray-segment searches on Hopper: brute force (K5), culled
(K7) and two-level (K9).

Each search has a wrapper the engine calls with ``use_kernel=True``.  On CUDA
tensors the wrapper launches its hand-written kernel or raises; it never
falls back.  On CPU tensors it runs the plain PyTorch version beside it, the
same arithmetic written line by line in PyTorch.

- K5 ``nearest_hit_segments_kernel`` (``csrc/segment_search.cu``, port of
  ``_segment_kernel`` in ``tensorflowraytrace_tpu/ops/pallas_kernels.py``):
  every ray against every segment.
- K7 ``nearest_hit_segments_culled_kernel``
  (``csrc/segment_search_culled.cu``, port of ``_segment_kernel_culled``):
  K5 plus a slab test of each ray against the box of each 256-segment chunk
  (``models/acceleration.chunk_aabbs_2d``, widened to hold every point the
  pair test accepts: ``twolevel_boxes``); ``cull=True``.  Each block of
  ``CULLED_RAY_BLOCK`` rays sweeps every chunk in order, and a chunk is
  computed only for the rays that can hit its box no farther than their
  own current best, so K7 returns K5's hits bit for bit.
- K9 ``nearest_hit_segments_twolevel_kernel``
  (``csrc/segment_search_twolevel.cu``, port of
  ``_twolevel_segment_kernel``): K7's walk and gate over a precomputed,
  capped list of candidate chunks of each block of ``TWOLEVEL_RAY_BLOCK``
  rays (``triangle_kernels.twolevel_candidates`` on ``twolevel_boxes``), or
  every chunk when its list overflows; ``cull="grid"``.  K9 returns K5's
  hits bit for bit.

Contract (shared with every search kernel of the JAX package): per ray
``(valid, idx int32, ray_u)``; ``ray_u`` is ``BIG = 3e38`` where nothing is
hit and ``valid`` is ``ray_u < BIG / 2``; the nearest hit wins and a tie
goes to the first segment; there is no gradient.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/`` and loaded with ``ctypes`` (``ops/cuda_build.py``); the two
share ``csrc/search2d_common.cuh`` with the arc searches.  Nothing here
imports JAX or the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from tensorflowraytrace_tpu_torch.models.acceleration import chunk_aabbs_2d
from tensorflowraytrace_tpu_torch.ops import cuda_build
from tensorflowraytrace_tpu_torch.ops.triangle_kernels import (
    _SLACK, BIG, _inverse_direction, _merge, _raise_on, _selected,
    _slab_gate, _thresholds, chunk_major, plain_or_cuda,
    twolevel_candidates, twolevel_walk, widen_boxes,
)

# Launches of each CUDA kernel in this process.  A wrapper adds one where it
# launches and nowhere else; callers reset them to 0 to count a run.
LAUNCHES = 0            # K5
LAUNCHES_CULLED = 0     # K7
LAUNCHES_TWOLEVEL = 0   # K9

SOURCE = "segment_search.cu"
SOURCE_CULLED = "segment_search_culled.cu"
SOURCE_TWOLEVEL = "segment_search_twolevel.cu"

# the culling chunk of K7 and K8 and the fine chunk of K9 and K10 is the 2D
# kernels' shared-memory tile (kTile in csrc/search2d_common.cuh; the
# launches refuse another value); read at call time
CULL_CHUNK = 256
# K7 and K8: rays per block (one thread each; a multiple of 32 in
# [128, 1024]).
# Chosen on the H100 by `chip_smoke.py --tune`: see PERF.md.  Read at call
# time.
CULLED_RAY_BLOCK = 1024
# K9 and K10: rays per block (one thread each; a multiple of 32 up to the
# kernels' launch bound of 512) and the cap of each block's candidate list;
# a block with more candidates sweeps every chunk.  Chosen on the H100 by
# `chip_smoke.py --tune`: see PERF.md.  Read at call time, so a test can
# lower the cap.
TWOLEVEL_RAY_BLOCK = 256
TWOLEVEL_MAX_CAND = 32


def load_library():
    """The K5 library, built at first use, with its C signature declared."""
    lib = cuda_build.load(SOURCE)
    fn = lib.segment_search_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return lib


def load_culled_library():
    """The K7 library, built at first use, with its C signature declared."""
    lib = cuda_build.load(SOURCE_CULLED)
    fn = lib.segment_search_culled_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 7 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return lib


def load_twolevel_library():
    """The K9 library, built at first use, with its C signature declared."""
    lib = cuda_build.load(SOURCE_TWOLEVEL)
    fn = lib.segment_search_twolevel_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] * 7 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return lib


def check_cuda_inputs(what, p0, p1, **surfaces):
    """What a 2D kernel takes: (N, 2) rays ``p0``/``p1`` and the per-surface
    tensors ``surfaces`` (each with M rows), all float32, contiguous,
    detached and on one device, with 1 <= N and N, M < 2^31 / 8."""
    device = p0.device
    m = None
    for name, t in {"p0": p0, "p1": p1, **surfaces}.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, p0 on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA {what} search takes float32 only; "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad:
            raise ValueError(f"{name} must be detached: the search has no "
                             "gradient")
        if name in surfaces:
            if m is not None and t.shape[0] != m:
                raise ValueError(f"the {what} tensors differ in length")
            m = t.shape[0]
    if p0.dim() != 2 or p0.shape[1] != 2 or p1.shape != p0.shape:
        raise ValueError(f"p0 and p1 must be (rays, 2), got {tuple(p0.shape)} "
                         f"and {tuple(p1.shape)}")
    if p0.shape[0] < 1:
        raise ValueError(f"the CUDA {what} search needs at least one ray")
    if max(p0.shape[0], m) >= 2 ** 31 // 8:
        raise ValueError(f"too many rays or {what}s for 32-bit indexing")


def _check_segments(p0, p1, sp0, sp1):
    check_cuda_inputs("segment", p0, p1, sp0=sp0, sp1=sp1)
    if sp0.dim() != 2 or sp0.shape[1] != 2 or sp1.shape != sp0.shape:
        raise ValueError("sp0 and sp1 must be (segments, 2) and equal in shape")


def nearest_hit_segments_kernel(p0, p1, sp0, sp1, intersect_eps, size_eps,
                                ray_start_eps):
    """K5: nearest hit of each ray (p0 -> p1, (N, 2)) among segments
    (sp0 -> sp1, (M, 2)).  Returns ``(valid, idx, ray_u)``.

    CPU tensors go to the plain version.  CUDA tensors launch the kernel,
    which takes contiguous, detached float32 tensors on one device and raises
    on anything else.
    """
    global LAUNCHES
    if plain_or_cuda(p0, "segment"):
        return nearest_hit_segments_plain(p0, p1, sp0, sp1, intersect_eps,
                                          size_eps, ray_start_eps)
    _check_segments(p0, p1, sp0, sp1)
    fn = load_library().segment_search_launch
    n, m = p0.shape[0], sp0.shape[0]
    u = torch.empty((n,), dtype=torch.float32, device=p0.device)
    idx = torch.empty((n,), dtype=torch.int32, device=p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        err = fn(p0.data_ptr(), p1.data_ptr(), sp0.data_ptr(), sp1.data_ptr(),
                 n, m, *_thresholds(intersect_eps, size_eps, ray_start_eps),
                 u.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "segment_search")
    LAUNCHES += 1
    return u < BIG * 0.5, idx, u


def nearest_hit_segments_culled_kernel(p0, p1, sp0, sp1, intersect_eps,
                                       size_eps, ray_start_eps):
    """K7: K5's search with each ray's slab gate over chunks of
    ``CULL_CHUNK`` segments, ``CULLED_RAY_BLOCK`` rays a block.  Same
    arguments, result and device rules as
    :func:`nearest_hit_segments_kernel`."""
    if plain_or_cuda(p0, "segment"):
        return nearest_hit_segments_culled_plain(
            p0, p1, sp0, sp1, intersect_eps, size_eps, ray_start_eps)
    _check_segments(p0, p1, sp0, sp1)
    check_culled_ray_block()
    return culled_launch(p0, p1, culled_prepare(sp0, sp1, size_eps),
                         intersect_eps, size_eps, ray_start_eps)


def culled_prepare(sp0, sp1, size_eps):
    """K7's inputs made on the segments' device: ``(sp0, sp1, boxes)``, the
    segments as they are (the kernel stages them itself) and the
    ``twolevel_boxes`` of their chunks of ``CULL_CHUNK``."""
    return sp0, sp1, twolevel_boxes(sp0, sp1, size_eps).contiguous()


def culled_launch(p0, p1, prepared, intersect_eps, size_eps, ray_start_eps):
    """Launch K7 on checked CUDA inputs and :func:`culled_prepare`'s
    output; the wrapper's second half."""
    global LAUNCHES_CULLED
    sp0, sp1, boxes = prepared
    fn = load_culled_library().segment_search_culled_launch
    n, m = p0.shape[0], sp0.shape[0]
    u = torch.empty((n,), dtype=torch.float32, device=p0.device)
    idx = torch.empty((n,), dtype=torch.int32, device=p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        err = fn(p0.data_ptr(), p1.data_ptr(), sp0.data_ptr(), sp1.data_ptr(),
                 boxes.data_ptr(), n, m, CULL_CHUNK, CULLED_RAY_BLOCK,
                 *_thresholds(intersect_eps, size_eps, ray_start_eps),
                 1.0 + _SLACK, 1.0 - _SLACK, _SLACK,
                 u.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "segment_search_culled")
    LAUNCHES_CULLED += 1
    return u < BIG * 0.5, idx, u


def check_culled_ray_block():
    """Raise unless ``CULLED_RAY_BLOCK`` is a block K7 and K8 launch."""
    rb = CULLED_RAY_BLOCK
    if rb % 32 or not 128 <= rb <= 1024:
        raise ValueError(f"CULLED_RAY_BLOCK {rb} must be a multiple of 32 "
                         "in [128, 1024]")


def check_twolevel_ray_block():
    """Raise unless ``TWOLEVEL_RAY_BLOCK`` is a block K9 and K10 launch."""
    rb = TWOLEVEL_RAY_BLOCK
    if rb % 32 or not 32 <= rb <= 512:
        raise ValueError(f"TWOLEVEL_RAY_BLOCK {rb} must be a multiple of 32 "
                         "in [32, 512]")


def twolevel_lists(p0, p1, boxes, ray_start_eps):
    """The candidate lists of K9 and K10 on the (C, 4) ``boxes``:
    ``(counts, cand, cap)`` of :func:`twolevel_candidates` at
    ``TWOLEVEL_RAY_BLOCK`` rays a block, the cap lowered to the chunk
    count."""
    cap = min(TWOLEVEL_MAX_CAND, boxes.shape[0])
    counts, cand = twolevel_candidates(p0, p1, boxes, float(ray_start_eps),
                                       TWOLEVEL_RAY_BLOCK, cap)
    return counts, cand, cap


def segment_chunk_table(sp0, sp1, chunk):
    """K9's segment table: (C, chunk, 4), chunk-major, one float4 a segment:
    start x, start y, direction x, direction y (``sp1 - sp0``); zero past
    M."""
    return chunk_major(torch.cat([sp0, sp1 - sp0], dim=1), chunk) \
        .transpose(1, 2).contiguous()


def twolevel_boxes(sp0, sp1, size_eps):
    """K7's and K9's boxes, for their gates and K9's candidate lists: the
    boxes of chunks of ``CULL_CHUNK`` segments widened
    (``triangle_kernels.widen_boxes``) by ``size_eps`` of the widest side.
    A segment accepts seg_u down to -size_eps and up to 1 + size_eps, so an
    accepted point lies within size_eps of the segment's extent along each
    axis outside its box; K7 and K9 gate each ray on its own, so a box must
    hold every point the pair test accepts (boxes with the rounding margin
    alone lose hits past a segment's ends at size_eps 1e-2)."""
    return widen_boxes(chunk_aabbs_2d(sp0, sp1, CULL_CHUNK), float(size_eps))


def nearest_hit_segments_twolevel_kernel(p0, p1, sp0, sp1, intersect_eps,
                                         size_eps, ray_start_eps):
    """K9: the two-level search over chunks of ``CULL_CHUNK`` segments,
    ``TWOLEVEL_RAY_BLOCK`` rays a block, lists capped at
    ``TWOLEVEL_MAX_CAND``.  Same arguments, result and device rules as
    :func:`nearest_hit_segments_kernel`."""
    if plain_or_cuda(p0, "segment"):
        return nearest_hit_segments_twolevel_plain(
            p0, p1, sp0, sp1, intersect_eps, size_eps, ray_start_eps)
    _check_segments(p0, p1, sp0, sp1)
    check_twolevel_ray_block()
    return twolevel_launch(p0, p1, sp0.shape[0],
                           twolevel_prepare(p0, p1, sp0, sp1, size_eps,
                                            ray_start_eps),
                           intersect_eps, size_eps, ray_start_eps)


def twolevel_prepare(p0, p1, sp0, sp1, size_eps, ray_start_eps):
    """K9's inputs, made on the rays' device: ``(table, boxes, counts,
    cand, cap)``, the chunk-major segment table, the boxes of its chunks
    (``twolevel_boxes``) and each ray block's candidate list on them."""
    boxes = twolevel_boxes(sp0, sp1, size_eps).contiguous()
    return (segment_chunk_table(sp0, sp1, CULL_CHUNK), boxes,
            *twolevel_lists(p0, p1, boxes, ray_start_eps))


def twolevel_launch(p0, p1, m, prepared, intersect_eps, size_eps,
                    ray_start_eps):
    """Launch K9 on checked CUDA inputs and :func:`twolevel_prepare`'s
    output for ``m`` segments; the wrapper's second half."""
    global LAUNCHES_TWOLEVEL
    table, boxes, counts, cand, cap = prepared
    fn = load_twolevel_library().segment_search_twolevel_launch
    n = p0.shape[0]
    u = torch.empty((n,), dtype=torch.float32, device=p0.device)
    idx = torch.empty((n,), dtype=torch.int32, device=p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        err = fn(p0.data_ptr(), p1.data_ptr(), table.data_ptr(),
                 boxes.data_ptr(), counts.data_ptr(), cand.data_ptr(), n, m,
                 boxes.shape[0], CULL_CHUNK, TWOLEVEL_RAY_BLOCK, cap,
                 *_thresholds(intersect_eps, size_eps, ray_start_eps),
                 1.0 + _SLACK, 1.0 - _SLACK, _SLACK,
                 u.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "segment_search_twolevel")
    LAUNCHES_TWOLEVEL += 1
    return u < BIG * 0.5, idx, u


# ======================================================================
# plain PyTorch versions
# ======================================================================

def _segment_pairs(ox, oy, dx, dy, x2, y2, dx2, dy2, i_eps, s_lo, s_hi,
                   r_eps):
    """Ray parameter of every ray-segment pair, ``BIG`` where the pair is not
    a valid hit: the kernels' float32 operations in their order.  Ray
    components (origin, direction) and segment components (start,
    direction) broadcast against each other."""
    den = dx * dy2 - dy * dx2
    ok = torch.abs(den) >= i_eps
    inv = 1.0 / torch.where(ok, den, torch.ones_like(den))
    ray_u = (dx2 * (oy - y2) - dy2 * (ox - x2)) * inv
    seg_u = (dy * (x2 - ox) - dx * (y2 - oy)) * inv
    ok = ok & (seg_u >= s_lo) & (seg_u <= s_hi) & (ray_u >= r_eps)
    return torch.where(ok, ray_u, BIG)


def _segment_columns(sp0, sp1, s0, s1):
    """Start and direction of segments s0 .. s1 - 1 as four (1, C) rows."""
    start = sp0[s0:s1].T[:, None]
    d = sp1[s0:s1].T[:, None] - start
    return start[0], start[1], d[0], d[1]


@torch.no_grad()
def nearest_hit_segments_plain(p0, p1, sp0, sp1, intersect_eps, size_eps,
                               ray_start_eps, ray_block=32768, chunk=256):
    """Plain PyTorch version of K5: the same arithmetic in the same order,
    over (ray_block, chunk) tiles with a running minimum merged under strict
    < (ties keep the earlier chunk; ``argmin`` takes the first index inside
    a chunk)."""
    n, m = p0.shape[0], sp0.shape[0]
    best_u = torch.full((n,), BIG, dtype=p0.dtype, device=p0.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=p0.device)
    eps = _thresholds(intersect_eps, size_eps, ray_start_eps)
    for r0 in range(0, n, ray_block):
        rows = slice(r0, r0 + ray_block)
        o = p0[rows, :, None]                                # (B, 2, 1)
        d = p1[rows, :, None] - o
        for s0 in range(0, m, chunk):
            u = _segment_pairs(*o.unbind(1), *d.unbind(1),
                               *_segment_columns(sp0, sp1, s0, s0 + chunk),
                               *eps)
            _merge(best_u, best_idx, rows, u, s0)
    return best_u < BIG * 0.5, best_idx, best_u


def culled_walk(p0, p1, boxes, r_eps, best_u):
    """The chunks and rays the culled kernels K7 and K8 compute, as their
    plain versions walk them: for each chunk ``c`` of ``boxes`` ((C, 4)) in
    order, after the earlier chunks have been merged into ``best_u``,
    yields ``(c, rows)`` for each piece of the rays that pass the slab gate
    against their own running best."""
    o2, inv2 = p0.unbind(1), _inverse_direction(p1 - p0).unbind(1)
    for c in range(boxes.shape[0]):
        box = boxes[c]
        need = _slab_gate(o2, inv2, box[:2], box[2:], r_eps, best_u)
        for rows in _selected(need):
            yield c, rows


@torch.no_grad()
def nearest_hit_segments_culled_plain(p0, p1, sp0, sp1, intersect_eps,
                                      size_eps, ray_start_eps):
    """Plain PyTorch version of K7: the chunks of ``CULL_CHUNK`` segments in
    order; a chunk is computed for the rays that pass the slab gate against
    their own running best on its ``twolevel_boxes`` box, with K5's
    arithmetic and merge."""
    n, chunk = p0.shape[0], CULL_CHUNK
    best_u = torch.full((n,), BIG, dtype=p0.dtype, device=p0.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=p0.device)
    eps = _thresholds(intersect_eps, size_eps, ray_start_eps)
    d = p1 - p0
    boxes = twolevel_boxes(sp0, sp1, size_eps)
    for c, rows in culled_walk(p0, p1, boxes, eps[3], best_u):
        s0 = c * chunk
        u = _segment_pairs(*(x[rows, None] for x in p0.unbind(1) + d.unbind(1)),
                           *_segment_columns(sp0, sp1, s0, s0 + chunk), *eps)
        _merge(best_u, best_idx, rows, u, s0)
    return best_u < BIG * 0.5, best_idx, best_u


@torch.no_grad()
def nearest_hit_segments_twolevel_plain(p0, p1, sp0, sp1, intersect_eps,
                                        size_eps, ray_start_eps):
    """Plain PyTorch version of K9: each block of ``TWOLEVEL_RAY_BLOCK``
    rays walks its candidate list (or every chunk on overflow) in order
    (``triangle_kernels.twolevel_walk``); at each step the chunk of
    ``CULL_CHUNK`` segments is computed for the rays that pass the slab
    gate against their own running best on its ``twolevel_boxes`` box,
    with K5's arithmetic and merge."""
    n = p0.shape[0]
    best_u = torch.full((n,), BIG, dtype=p0.dtype, device=p0.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=p0.device)
    eps = _thresholds(intersect_eps, size_eps, ray_start_eps)
    d = p1 - p0
    table, boxes, counts, cand, cap = twolevel_prepare(
        p0, p1, sp0, sp1, size_eps, eps[3])                  # (C, F, 4)
    for c, rows in twolevel_walk(p0, p1, boxes, counts, cand, cap,
                                 TWOLEVEL_RAY_BLOCK, eps[3], best_u):
        t = table[c]                                         # (R, F, 4)
        u = _segment_pairs(*(x[rows, None] for x in p0.unbind(1) + d.unbind(1)),
                           *t.unbind(2), *eps)
        _merge(best_u, best_idx, rows, u, c * CULL_CHUNK)
    return best_u < BIG * 0.5, best_idx, best_u
