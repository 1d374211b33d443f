"""The nearest ray-arc searches on Hopper: brute force (K6), culled (K8) and
two-level (K10).

Each search has a wrapper the engine calls with ``use_kernel=True``: a
call of its ``tfrt_torch`` operator (``ops/custom_ops.py``), which
dispatches on the tensors' device.  On CUDA tensors it launches the
hand-written kernel (``*_cuda`` here) or raises; it never falls back.  On
CPU tensors it runs the plain PyTorch version beside it, the same
arithmetic written line by line in PyTorch.  Any other device raises in the
wrapper.

- K6 ``nearest_hit_arcs_kernel`` (``csrc/arc_search.cu``, port of
  ``_arc_kernel`` in ``tensorflowraytrace_tpu/ops/pallas_kernels.py``):
  every ray against both quadratic branches of every arc.
- K8 ``nearest_hit_arcs_culled_kernel`` (``csrc/arc_search_culled.cu``,
  port of ``_arc_kernel_culled``): K6 behind a slab gate on the boxes of
  256-arc chunks (``models/acceleration.chunk_aabbs_arcs``, window-aware,
  widened to hold every point the pair test accepts: :func:`twolevel_boxes`).
  K7's walk (``segment_kernels.py``) with K10's arc fold: each block of
  ``segment_kernels.CULLED_RAY_BLOCK`` rays sweeps every chunk in order,
  and a chunk is computed only for the rays that can hit its box no
  farther than their own current best; ``cull=True``.  K8 returns K6's
  hits bit for bit.
- K10 ``nearest_hit_arcs_twolevel_kernel`` (``csrc/arc_search_twolevel.cu``,
  port of ``_twolevel_arc_kernel``): K9's two-level walk
  (``segment_kernels.py``) over chunks of 256 arcs, each ray gated on its
  own on boxes that hold every point the pair test accepts
  (:func:`twolevel_boxes`); ``cull="grid"``.  K10 returns K6's hits bit for
  bit (not the TPU kernel's: it keeps K6's discriminant and branch
  rule).

All three take the arc table of :func:`arc_table`, built in torch on the rays'
device as ``nearest_hit_arcs_pallas`` builds it: the window's edge vectors
(cos, sin of its start and end) and whether it spans more than pi or the
full circle.  The window test is the TPU kernels' cross-product form, not
the XLA path's ``atan2`` (``ops/intersect.nearest_hit_arcs``); the two can
disagree at a window's edge.  Arcs take no ``size_eps``.  The quadratic's
discriminant is the TPU kernels' b^2 - 4 a c rewritten as
4 (a - (x_r x d_r)^2), which float32 keeps accurate for rays that start
thousands of radii from an arc (the note in csrc/search2d_common.cuh).

The kernels skip, exactly, every pair whose discriminant is negative (after
the snap to 0 below ``intersect_eps``) or whose |a| is below
``intersect_eps``: such a pair has no valid branch.  :func:`arc_pair_admits`
is that predicate in PyTorch; :func:`admitted_arc_pairs` counts the pairs
it admits, the work a kernel's bound is charged for.

Each wrapper is two halves, a preparation (the arc table, the gate boxes,
the candidate lists) and the launch, so that the launch can be timed alone.

K6, K8 and K10 each have a float32 and a float64 instance (``LAUNCH``,
``LAUNCH_CULLED``, ``LAUNCH_TWOLEVEL``), launched by the rays' dtype, each
reading its table in its dtype: K6's and K8's the (M, 8) table of
:func:`arc_table` (the flags as float values, which the kernels turn into
ints as they stage a chunk), K10's the chunk-major table of
:func:`twolevel_table` (the flags as the integer bits of the table's
width: int32 in a float32 slot, int64 in a float64 one).

Contract: per ray ``(valid, idx int32, ray_u, branch)``, ``ray_u`` in the
rays' dtype; ``ray_u`` is ``BIG = 3e38`` where nothing is hit, ``valid``
is ``ray_u < BIG / 2`` and ``branch`` is True where the winning arc's minus
branch gave the hit.  The
nearest hit wins and a tie goes to the first arc, which carries its own
branch choice (minus iff its minus root is strictly nearer).  The TPU
kernel instead takes the branch of the tile's minima, which differs only
when two arcs tie exactly.

Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tensorflowraytrace_tpu_torch.models.acceleration import chunk_aabbs_arcs
from tensorflowraytrace_tpu_torch.ops import cuda_build
from tensorflowraytrace_tpu_torch.ops import segment_kernels
from tensorflowraytrace_tpu_torch.ops.segment_kernels import (
    check_cuda_inputs, check_culled_ray_block, check_twolevel_ray_block,
    culled_walk, twolevel_lists,
)
from tensorflowraytrace_tpu_torch.ops.triangle_kernels import (
    _SLACK, BIG, _raise_on, check_device, chunk_major, twolevel_walk,
    widen_boxes,
)

# Launches of each CUDA kernel in this process.  A wrapper adds one where it
# launches and nowhere else; callers reset them to 0 to count a run.
LAUNCHES = 0            # K6
LAUNCHES_CULLED = 0     # K8
LAUNCHES_TWOLEVEL = 0   # K10

SOURCE = "arc_search.cu"
SOURCE_CULLED = "arc_search_culled.cu"
SOURCE_TWOLEVEL = "arc_search_twolevel.cu"

# K6's instances by the rays' dtype: the C symbol and the ctypes type of its
# thresholds
LAUNCH = {torch.float32: ("arc_search_launch", ctypes.c_float),
          torch.float64: ("arc_search_launch_f64", ctypes.c_double)}
LAUNCH_CULLED = {
    torch.float32: ("arc_search_culled_launch", ctypes.c_float),
    torch.float64: ("arc_search_culled_launch_f64", ctypes.c_double)}
LAUNCH_TWOLEVEL = {
    torch.float32: ("arc_search_twolevel_launch", ctypes.c_float),
    torch.float64: ("arc_search_twolevel_launch_f64", ctypes.c_double)}
# the integer whose bits K10's table holds its flags in, by the table's dtype
FLAG_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}

# the table's flag bits
_BIG_WINDOW = 1     # the window spans more than pi
_FULL_CIRCLE = 2    # the window is the whole circle

# How far outside its arc's window-aware box, as a share of |radius|, the
# pair test can accept a point: the tangent snap takes a discriminant below
# intersect_eps as 0 for pairs with a >= intersect_eps, which puts the
# accepted point between sqrt(3 / 4) and sqrt(5 / 4) radii from the centre
# (the derivation is in csrc/arc_search_twolevel.cu), so up to
# 1 - sqrt(3 / 4) = 0.134 |r| off the circle; rounded up.
SNAP_REACH = 0.14


def load_library():
    """The K6 library, built at first use, with the C signatures of its
    float32 and float64 launches declared."""
    lib = cuda_build.load(SOURCE)
    for name, real in LAUNCH.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [real] * 2 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return lib


def load_culled_library():
    """The K8 library, built at first use, with the C signatures of its
    float32 and float64 launches declared."""
    lib = cuda_build.load(SOURCE_CULLED)
    for name, real in LAUNCH_CULLED.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [real] * 5 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return lib


def load_twolevel_library():
    """The K10 library, built at first use, with the C signatures of its
    float32 and float64 launches declared."""
    lib = cuda_build.load(SOURCE_TWOLEVEL)
    for name, real in LAUNCH_TWOLEVEL.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [real] * 5 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return lib


def arc_table(center, angle_start, angle_end, radius):
    """The (M, 8) table the arc searches read, in the arcs' dtype and on
    their device: centre x, centre y, radius, cos and sin of the window's
    start, cos and sin of its end, and flags (1: sweep > pi, 2: sweep >=
    2 pi - 1e-6), with the sweep ``angle_end - angle_start`` taken in
    [0, 2 pi)."""
    sweep = angle_end - angle_start
    sweep = torch.where(sweep < 0, sweep + 2 * math.pi, sweep)
    flags = ((sweep > math.pi).to(center.dtype) * _BIG_WINDOW
             + (sweep >= 2 * math.pi - 1e-6).to(center.dtype) * _FULL_CIRCLE)
    return torch.stack([center[:, 0], center[:, 1], radius,
                        torch.cos(angle_start), torch.sin(angle_start),
                        torch.cos(angle_end), torch.sin(angle_end), flags],
                       dim=1).contiguous()


def arc_chunk_table(center, angle_start, angle_end, radius, chunk):
    """K10's arc table: (C, 2, chunk, 4), chunk-major, one
    ``search2d::ArcTile`` per chunk: ``chunk`` rows of (centre x, centre y,
    1 / radius, flags) -- the radius replaced by the reciprocal K6 computes
    when it stages a tile -- then ``chunk`` rows of (cos, sin of the
    window's start, cos, sin of its end); zero past M.  The flags stay
    float here (the plain version reads them so); :func:`twolevel_prepare`
    turns them into the integer bits the kernels read."""
    t = arc_table(center, angle_start, angle_end, radius)
    cols = torch.cat([t[:, :2], 1.0 / t[:, 2:3], t[:, 7:8], t[:, 3:7]], dim=1)
    return chunk_major(cols, chunk).view(-1, 2, 4, chunk).transpose(2, 3) \
        .contiguous()


def _check_arcs(p0, p1, center, angle_start, angle_end, radius,
                kernel=None):
    """The inputs of an arc search (float32 or float64); ``kernel`` ("K8",
    "K10") names it in a refusal."""
    check_cuda_inputs("arc", p0, p1, kernel=kernel, center=center,
                      angle_start=angle_start, angle_end=angle_end,
                      radius=radius)
    m = center.shape[0]
    if center.shape != (m, 2) or not (angle_start.shape == angle_end.shape
                                      == radius.shape == (m,)):
        raise ValueError("center must be (arcs, 2) and angle_start, angle_end "
                         "and radius (arcs,)")


def _launch(fn, name, p0, args):
    """Outputs for ``p0``'s rays, the launch of ``fn(p0, p1, *args, u, idx,
    branch, stream)``, and the error check."""
    n = p0.shape[0]
    u = torch.empty((n,), dtype=p0.dtype, device=p0.device)
    idx = torch.empty((n,), dtype=torch.int32, device=p0.device)
    branch = torch.empty((n,), dtype=torch.bool, device=p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        err = fn(*args, u.data_ptr(), idx.data_ptr(), branch.data_ptr(),
                 stream)
    _raise_on(err, name)
    return u < BIG * 0.5, idx, u, branch


def nearest_hit_arcs_kernel(p0, p1, center, angle_start, angle_end, radius,
                            intersect_eps, ray_start_eps):
    """K6: nearest hit of each ray (p0 -> p1, (N, 2)) among arcs (``center``
    (M, 2); ``angle_start``, ``angle_end``, ``radius`` (M,)).  Returns
    ``(valid, idx, ray_u, branch)``.

    The ``tfrt_torch::arc_search`` operator: CPU tensors go to the plain
    version.  CUDA tensors launch the kernel (:func:`arc_search_cuda`),
    which takes contiguous, detached tensors of one dtype, float32 or
    float64, on one device and raises on anything else.
    """
    check_device(p0, "arc")
    return torch.ops.tfrt_torch.arc_search(
        p0, p1, center, angle_start, angle_end, radius, float(intersect_eps),
        float(ray_start_eps))


def arc_search_cuda(p0, p1, center, angle_start, angle_end, radius,
                    intersect_eps, ray_start_eps):
    """K6's operator on CUDA tensors: the input checks, the arc table
    (:func:`prepare`) and the launch."""
    _check_arcs(p0, p1, center, angle_start, angle_end, radius)
    return launch(p0, p1, prepare(center, angle_start, angle_end, radius),
                  intersect_eps, ray_start_eps)


def prepare(center, angle_start, angle_end, radius):
    """K6's input made on the arcs' device: the table of :func:`arc_table`."""
    return arc_table(center, angle_start, angle_end, radius)


def launch(p0, p1, table, intersect_eps, ray_start_eps):
    """Launch K6's instance of ``p0``'s dtype on checked CUDA inputs and
    :func:`prepare`'s table; the wrapper's second half."""
    global LAUNCHES
    out = _launch(getattr(load_library(), LAUNCH[p0.dtype][0]), "arc_search",
                  p0,
                  (p0.data_ptr(), p1.data_ptr(), table.data_ptr(),
                   p0.shape[0], table.shape[0], float(intersect_eps),
                   float(ray_start_eps)))
    LAUNCHES += 1
    return out


def nearest_hit_arcs_culled_kernel(p0, p1, center, angle_start, angle_end,
                                   radius, intersect_eps, ray_start_eps):
    """K8: K6's search with each ray's slab gate over chunks of
    ``segment_kernels.CULL_CHUNK`` arcs, ``segment_kernels.CULLED_RAY_BLOCK``
    rays a block (K7's).  Same arguments, result and device rules as
    :func:`nearest_hit_arcs_kernel` (``tfrt_torch::arc_search_culled``)."""
    check_device(p0, "arc")
    return torch.ops.tfrt_torch.arc_search_culled(
        p0, p1, center, angle_start, angle_end, radius, float(intersect_eps),
        float(ray_start_eps))


def arc_search_culled_cuda(p0, p1, center, angle_start, angle_end, radius,
                           intersect_eps, ray_start_eps):
    """K8's operator on CUDA tensors: the input checks, the table and gate
    boxes (:func:`culled_prepare`) and the launch."""
    _check_arcs(p0, p1, center, angle_start, angle_end, radius, kernel="K8")
    check_culled_ray_block()
    return culled_launch(p0, p1, culled_prepare(center, angle_start,
                                                angle_end, radius),
                         intersect_eps, ray_start_eps)


def culled_prepare(center, angle_start, angle_end, radius):
    """K8's inputs made on the arcs' device: ``(table, boxes)``, the table
    of :func:`arc_table` and the :func:`twolevel_boxes` of its chunks of
    ``segment_kernels.CULL_CHUNK`` arcs."""
    boxes = twolevel_boxes(center, angle_start, angle_end, radius)
    return arc_table(center, angle_start, angle_end, radius), \
        boxes.contiguous()


def culled_launch(p0, p1, prepared, intersect_eps, ray_start_eps):
    """Launch K8's instance of ``p0``'s dtype on checked CUDA inputs and
    :func:`culled_prepare`'s output; the wrapper's second half."""
    global LAUNCHES_CULLED
    table, boxes = prepared
    out = _launch(getattr(load_culled_library(), LAUNCH_CULLED[p0.dtype][0]),
                  "arc_search_culled", p0,
                  (p0.data_ptr(), p1.data_ptr(), table.data_ptr(),
                   boxes.data_ptr(), p0.shape[0], table.shape[0],
                   segment_kernels.CULL_CHUNK,
                   segment_kernels.CULLED_RAY_BLOCK, float(intersect_eps),
                   float(ray_start_eps), 1.0 + _SLACK, 1.0 - _SLACK, _SLACK))
    LAUNCHES_CULLED += 1
    return out


def nearest_hit_arcs_twolevel_kernel(p0, p1, center, angle_start, angle_end,
                                     radius, intersect_eps, ray_start_eps):
    """K10: K9's two-level search (``segment_kernels.TWOLEVEL_RAY_BLOCK``
    rays a block, chunks of ``segment_kernels.CULL_CHUNK`` arcs, lists
    capped at ``segment_kernels.TWOLEVEL_MAX_CAND``) with K6's arithmetic.
    Same arguments, result and device rules as
    :func:`nearest_hit_arcs_kernel` (``tfrt_torch::arc_search_twolevel``)."""
    check_device(p0, "arc")
    return torch.ops.tfrt_torch.arc_search_twolevel(
        p0, p1, center, angle_start, angle_end, radius, float(intersect_eps),
        float(ray_start_eps))


def arc_search_twolevel_cuda(p0, p1, center, angle_start, angle_end, radius,
                             intersect_eps, ray_start_eps):
    """K10's operator on CUDA tensors: the input checks, the preparation
    (:func:`twolevel_prepare`, with the tunables read now) and the
    launch."""
    _check_arcs(p0, p1, center, angle_start, angle_end, radius,
                kernel="K10")
    check_twolevel_ray_block()
    return twolevel_launch(
        p0, p1, center.shape[0],
        twolevel_prepare(p0, p1, center, angle_start, angle_end, radius,
                         ray_start_eps),
        intersect_eps, ray_start_eps)


def twolevel_boxes(center, angle_start, angle_end, radius):
    """K8's and K10's boxes, for their gates and K10's candidate lists:
    the boxes of chunks of ``segment_kernels.CULL_CHUNK`` arcs over the
    arcs' window-aware boxes, widened (``triangle_kernels.widen_boxes``) by
    ``SNAP_REACH`` of the chunk's largest |radius| and the rounding margin.
    K8 and K10 gate each ray on its own, so a box must hold every point the
    pair test accepts, also a tangent pair's snapped point off the circle
    (tests/test_torch_gate_boxes2d.py)."""
    chunk = segment_kernels.CULL_CHUNK
    boxes = chunk_aabbs_arcs(center, angle_start, angle_end, radius, chunk)
    reach = chunk_major(radius.detach().abs()[:, None], chunk).amax(dim=2)
    return widen_boxes(boxes, 0.0, SNAP_REACH * reach)


def twolevel_table(center, angle_start, angle_end, radius):
    """K10's arc table: :func:`arc_chunk_table` at
    ``segment_kernels.CULL_CHUNK`` with its flags row as the bits of an
    integer of the table's width (``FLAG_BITS``: int32 in float32, as
    search2d::ArcTile reads it; int64 in float64, as K10's float64 instance
    reads it)."""
    table = arc_chunk_table(center, angle_start, angle_end, radius,
                            segment_kernels.CULL_CHUNK)
    table[:, 0, :, 3] = table[:, 0, :, 3].to(FLAG_BITS[table.dtype]) \
        .view(table.dtype)
    return table


def twolevel_prepare(p0, p1, center, angle_start, angle_end, radius,
                     ray_start_eps):
    """K10's inputs, made on the rays' device: ``(table, boxes, counts,
    cand, cap)``, the chunk-major arc table (:func:`twolevel_table`), the
    :func:`twolevel_boxes` of its chunks and each ray block's candidate
    list on them."""
    boxes = twolevel_boxes(center, angle_start, angle_end,
                           radius).contiguous()
    return (twolevel_table(center, angle_start, angle_end, radius), boxes,
            *twolevel_lists(p0, p1, boxes, ray_start_eps))


def twolevel_launch(p0, p1, m, prepared, intersect_eps, ray_start_eps):
    """Launch K10's instance of ``p0``'s dtype on checked CUDA inputs and
    :func:`twolevel_prepare`'s output for ``m`` arcs; the wrapper's second
    half."""
    global LAUNCHES_TWOLEVEL
    table, boxes, counts, cand, cap = prepared
    out = _launch(getattr(load_twolevel_library(),
                          LAUNCH_TWOLEVEL[p0.dtype][0]),
                  "arc_search_twolevel", p0,
                  (p0.data_ptr(), p1.data_ptr(), table.data_ptr(),
                   boxes.data_ptr(), counts.data_ptr(), cand.data_ptr(),
                   p0.shape[0], m, boxes.shape[0], segment_kernels.CULL_CHUNK,
                   segment_kernels.TWOLEVEL_RAY_BLOCK, cap,
                   float(intersect_eps), float(ray_start_eps), 1.0 + _SLACK,
                   1.0 - _SLACK, _SLACK))
    LAUNCHES_TWOLEVEL += 1
    return out


# ======================================================================
# plain PyTorch versions
# ======================================================================

def _arc_columns(table, s0, s1):
    """Arcs s0 .. s1 - 1 of the table as (1, C) rows: centre, 1 / radius,
    the edge vectors, and the window flags as booleans."""
    t = table[s0:s1].T[:, None]
    flags = t[7].to(torch.int32)
    return (t[0], t[1], 1.0 / t[2], t[3], t[4], t[5], t[6],
            (flags & _BIG_WINDOW) != 0, (flags & _FULL_CIRCLE) != 0)


def _arc_discriminant(ox, oy, dx, dy, xc, yc, inv_r, i_eps):
    """The kernels' operations up to the exact reject
    (``search2d::ArcPair``): the scaled ray ``xr, yr, xd, yd``, ``a``, the
    discriminant snapped to 0 below ``i_eps``, and ``ok``, False where it is
    negative or |a| is below ``i_eps``."""
    xr = (ox - xc) * inv_r
    yr = (oy - yc) * inv_r
    xd = dx * inv_r
    yd = dy * inv_r
    a = xd * xd + yd * yd
    # b^2 - 4 a (|x_r|^2 - 1) without its cancellation: see the note in
    # csrc/search2d_common.cuh
    cross = xr * yd - yr * xd
    disc = 4.0 * (a - cross * cross)
    disc = torch.where(torch.abs(disc) < i_eps, torch.zeros_like(disc), disc)
    return xr, yr, xd, yd, a, disc, (disc >= 0) & (torch.abs(a) >= i_eps)


def _arc_pairs(ox, oy, dx, dy, xc, yc, inv_r, sx, sy, ex, ey, big, full,
               i_eps, r_eps):
    """Ray parameter of every ray-arc pair (``BIG`` where neither branch is
    a valid hit) and whether the minus branch gave it: the kernels'
    operations in their order, in the inputs' dtype.  Ray and arc
    components broadcast."""
    xr, yr, xd, yd, a, disc, ok = _arc_discriminant(ox, oy, dx, dy, xc, yc,
                                                    inv_r, i_eps)
    b = 2.0 * (xr * xd + yr * yd)
    inv2a = 1.0 / torch.where(torch.abs(a) >= i_eps, 2.0 * a,
                              torch.ones_like(a))
    sq = torch.sqrt(torch.where(disc >= 0, disc, torch.zeros_like(disc)))
    u_plus = (-b + sq) * inv2a
    u_minus = (-b - sq) * inv2a

    def branch_valid(u):
        px = (ox + dx * u) - xc
        py = (oy + dy * u) - yc
        c1 = sx * py - sy * px       # cross(window start, p)
        c2 = px * ey - py * ex       # cross(p, window end)
        narrow = (c1 >= 0) & (c2 >= 0)
        wide = ~((c1 < 0) & (c2 < 0))
        in_window = torch.where(big, wide, narrow) | full
        return ok & (u >= r_eps) & in_window

    up = torch.where(branch_valid(u_plus), u_plus, BIG)
    um = torch.where(branch_valid(u_minus), u_minus, BIG)
    return torch.minimum(um, up), um < up


def arc_pair_admits(ox, oy, dx, dy, xc, yc, inv_r, i_eps):
    """The kernels' exact reject of a ray-arc pair, elementwise: False where
    the discriminant, snapped to 0 below ``i_eps``, is negative or |a| is
    below ``i_eps`` -- ``_arc_pairs``'s ``ok``.  A pair it refuses has no
    valid branch.  Ray and arc components broadcast."""
    return _arc_discriminant(ox, oy, dx, dy, xc, yc, inv_r, i_eps)[-1]


@torch.no_grad()
def admitted_arc_pairs(p0, p1, center, radius, intersect_eps, piece=1 << 24):
    """How many of the ray-arc pairs of rays ``p0`` -> ``p1`` ((N, 2)) and
    arcs (``center`` (M, 2), ``radius`` (M,)) :func:`arc_pair_admits`
    admits: the pairs a kernel computes past its reject test.  Rays are
    taken ``piece`` pairs at a time."""
    n, m = p0.shape[0], center.shape[0]
    inv_r = 1.0 / radius
    d = p1 - p0
    step = max(1, piece // m)
    total = 0
    for r0 in range(0, n, step):
        o, dd = p0[r0:r0 + step, :, None], d[r0:r0 + step, :, None]
        total += int(arc_pair_admits(o[:, 0], o[:, 1], dd[:, 0], dd[:, 1],
                                     center[:, 0], center[:, 1], inv_r,
                                     float(intersect_eps)).sum())
    return total


def _merge_arcs(best_u, best_idx, best_minus, rows, u, minus, first_idx):
    """Fold the (R, C) pair parameters of rays ``rows`` into the running
    best, as ``triangle_kernels._merge`` does, with the winner's branch."""
    carg = torch.argmin(u, dim=1)
    cu = u.gather(1, carg[:, None])[:, 0]
    cm = minus.gather(1, carg[:, None])[:, 0]
    bu = best_u[rows]
    better = cu < bu
    best_u[rows] = torch.where(better, cu, bu)
    best_idx[rows] = torch.where(better, (carg + first_idx).to(torch.int32),
                                 best_idx[rows])
    best_minus[rows] = torch.where(better, cm, best_minus[rows])


def _best(n, p0):
    return (torch.full((n,), BIG, dtype=p0.dtype, device=p0.device),
            torch.zeros((n,), dtype=torch.int32, device=p0.device),
            torch.zeros((n,), dtype=torch.bool, device=p0.device))


@torch.no_grad()
def nearest_hit_arcs_plain(p0, p1, center, angle_start, angle_end, radius,
                           intersect_eps, ray_start_eps, ray_block=32768,
                           chunk=256):
    """Plain PyTorch version of K6: the same arithmetic in the same order,
    over (ray_block, chunk) tiles with a running minimum merged under strict
    < (``argmin`` takes the first index inside a chunk)."""
    n, m = p0.shape[0], center.shape[0]
    best_u, best_idx, best_minus = _best(n, p0)
    table = arc_table(center, angle_start, angle_end, radius)
    eps = (float(intersect_eps), float(ray_start_eps))
    for r0 in range(0, n, ray_block):
        rows = slice(r0, r0 + ray_block)
        o = p0[rows, :, None]                                # (B, 2, 1)
        d = p1[rows, :, None] - o
        for s0 in range(0, m, chunk):
            u, minus = _arc_pairs(*o.unbind(1), *d.unbind(1),
                                  *_arc_columns(table, s0, s0 + chunk), *eps)
            _merge_arcs(best_u, best_idx, best_minus, rows, u, minus, s0)
    return best_u < BIG * 0.5, best_idx, best_u, best_minus


@torch.no_grad()
def nearest_hit_arcs_culled_plain(p0, p1, center, angle_start, angle_end,
                                  radius, intersect_eps, ray_start_eps):
    """Plain PyTorch version of K8: the chunks of ``CULL_CHUNK`` arcs in
    order (``segment_kernels.culled_walk``); a chunk is computed for the
    rays that pass the slab gate against their own running best on its
    :func:`twolevel_boxes` box, with K6's arithmetic and merge."""
    n, chunk = p0.shape[0], segment_kernels.CULL_CHUNK
    best_u, best_idx, best_minus = _best(n, p0)
    table = arc_table(center, angle_start, angle_end, radius)
    eps = (float(intersect_eps), float(ray_start_eps))
    d = p1 - p0
    boxes = twolevel_boxes(center, angle_start, angle_end, radius)
    for c, rows in culled_walk(p0, p1, boxes, eps[1], best_u):
        s0 = c * chunk
        u, minus = _arc_pairs(
            *(x[rows, None] for x in p0.unbind(1) + d.unbind(1)),
            *_arc_columns(table, s0, s0 + chunk), *eps)
        _merge_arcs(best_u, best_idx, best_minus, rows, u, minus, s0)
    return best_u < BIG * 0.5, best_idx, best_u, best_minus


@torch.no_grad()
def nearest_hit_arcs_twolevel_plain(p0, p1, center, angle_start, angle_end,
                                    radius, intersect_eps, ray_start_eps):
    """Plain PyTorch version of K10: K9's walk
    (``triangle_kernels.twolevel_walk``) over chunks of
    ``segment_kernels.CULL_CHUNK`` arcs, each ray gated on its own on
    :func:`twolevel_boxes`, with K6's arithmetic and merge."""
    n, chunk = p0.shape[0], segment_kernels.CULL_CHUNK
    best_u, best_idx, best_minus = _best(n, p0)
    eps = (float(intersect_eps), float(ray_start_eps))
    d = p1 - p0
    boxes = twolevel_boxes(center, angle_start, angle_end, radius)
    table = arc_chunk_table(center, angle_start, angle_end, radius, chunk)
    for c, rows in twolevel_walk(
            p0, p1, boxes, *twolevel_lists(p0, p1, boxes, eps[1]),
            segment_kernels.TWOLEVEL_RAY_BLOCK, eps[1], best_u):
        head, edge = table[c].unbind(1)                      # (R, F, 4) each
        flags = head[..., 3].to(torch.int32)
        u, minus = _arc_pairs(
            *(x[rows, None] for x in p0.unbind(1) + d.unbind(1)),
            *head[..., :3].unbind(-1), *edge.unbind(-1),
            (flags & _BIG_WINDOW) != 0, (flags & _FULL_CIRCLE) != 0, *eps)
        _merge_arcs(best_u, best_idx, best_minus, rows, u, minus, c * chunk)
    return best_u < BIG * 0.5, best_idx, best_u, best_minus
