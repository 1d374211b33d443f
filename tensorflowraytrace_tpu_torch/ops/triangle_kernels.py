"""The nearest ray-triangle searches on Hopper: brute force (K1), culled
(K3) and two-level (K4).

Each search has a wrapper the engine calls with ``use_kernel=True``: a
call of its ``tfrt_torch`` operator (``ops/custom_ops.py``), so that a
trace that launches the kernel can be exported (``utils/export.py``).  The
operator dispatches on the tensors' device.  On CUDA tensors it launches the
hand-written kernel (``*_cuda`` here: the input checks, the preparation and
the launch) or raises; it never falls back.  On CPU tensors it runs the
plain PyTorch version beside it, the same arithmetic written line by line
in PyTorch.  Any other device raises in the wrapper.

- K1 ``nearest_hit_triangles_kernel`` (``csrc/triangle_search.cu``, port of
  ``_triangle_kernel`` in ``tensorflowraytrace_tpu/ops/pallas_kernels.py``):
  every ray against every triangle, 1 or 4 rays a thread
  (``brute_rays_per_thread``).
- K3 ``nearest_hit_triangles_culled_kernel``
  (``csrc/triangle_search_culled.cu``, port of ``_triangle_kernel_culled``):
  K1 plus a slab test of each ray against the box of each 256-triangle
  chunk (``models/acceleration.chunk_aabbs``, widened by
  ``culled_boxes``); a block computes a chunk for the rays whose own test
  passes; ``cull=True``.
- K4 ``nearest_hit_triangles_twolevel_kernel``
  (``csrc/triangle_search_twolevel.cu``, port of
  ``_twolevel_triangle_kernel``): each ray block walks a precomputed,
  capped list of candidate fine chunks (``twolevel_candidates`` on
  ``culled_boxes`` at ``FINE_CHUNK``), or every chunk when its list
  overflows, each computed for the rays whose own test passes, as in K3;
  ``cull="grid"``.  The candidate precompute and the plain walk serve the
  two-level 2D searches K9 and K10 as well (``ops/segment_kernels.py``,
  ``ops/arc_kernels.py``).

The gate of K3 and K4: a chunk is computed for a ray only if the ray can
hit the chunk's box at t >= r_eps no farther than its current best, with a
relative slack of 1e-6.  The box holds every point Moller-Trumbore accepts
in the chunk (``culled_boxes``), so the gate only skips pairs that cannot
give a nearer hit, and K3 and K4 return K1's hits bit for bit.
Parked rays (p0 = 1e30, see ``engine.project_3d``) fail every slab test.

Contract (shared with every search kernel of the JAX package): per ray
``(valid, idx int32, ray_u)``, ``ray_u`` in the rays' dtype; ``ray_u`` is
``BIG = 3e38`` where nothing is hit and ``valid`` is ``ray_u < BIG / 2``;
the nearest hit wins and a tie goes to the first triangle index; there is
no gradient.

Dtypes, as the JAX package's Pallas searches compute in their inputs'
dtype: K1, K3 and K4 each have a float32 and a float64 instance, launched
by the rays' dtype (``LAUNCH``, ``LAUNCH_CULLED``, ``LAUNCH_TWOLEVEL``),
and every kernel refuses mixed dtypes and any other dtype.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/`` and loaded with ``ctypes`` (``ops/cuda_build.py``); their
operators take the pointers of the tensors they are given, so a fake
tensor (an export's tracing) never reaches them.  Nothing here
imports JAX or the JAX package.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from tensorflowraytrace_tpu_torch.models.acceleration import chunk_aabbs
from tensorflowraytrace_tpu_torch.ops import cuda_build

BIG = 3.0e38

# Launches of each CUDA kernel in this process.  A wrapper adds one where it
# launches and nowhere else; callers reset them to 0 to count a run.
LAUNCHES = 0            # K1
LAUNCHES_CULLED = 0     # K3
LAUNCHES_TWOLEVEL = 0   # K4

SOURCE = "triangle_search.cu"
SOURCE_CULLED = "triangle_search_culled.cu"
SOURCE_TWOLEVEL = "triangle_search_twolevel.cu"

# each kernel's instances by the rays' dtype: the C symbol and the ctypes
# type of its thresholds
LAUNCH = {torch.float32: ("triangle_search_launch", ctypes.c_float),
          torch.float64: ("triangle_search_launch_f64", ctypes.c_double)}
LAUNCH_CULLED = {
    torch.float32: ("triangle_search_culled_launch", ctypes.c_float),
    torch.float64: ("triangle_search_culled_launch_f64", ctypes.c_double)}
LAUNCH_TWOLEVEL = {
    torch.float32: ("triangle_search_twolevel_launch", ctypes.c_float),
    torch.float64: ("triangle_search_twolevel_launch_f64", ctypes.c_double)}

# K1: threads a block (kThreads in csrc/triangle_search.cu) and the rays a
# thread it is compiled for; see brute_rays_per_thread
BRUTE_THREADS = 256
BRUTE_RAYS_PER_THREAD = (1, 4)
# K3: the culling chunk is the kernel's shared-memory tile (kTile in
# csrc/triangle_search_culled.cu; the launch refuses another value)
CULL_CHUNK = 256
# The culling boxes of K3-K4 and K7-K10 (widen_boxes) are widened on
# every side by GATE_PAD times their largest coordinate magnitude (~64
# float32 ulps): the float32 arithmetic can accept a hit a
# few ulps outside the exact surface, and the gate must not refuse it.  The
# slab test's own slack (1 +- 1e-6 and 1e-6 in t) does not cover that far
# from the origin: at x ~ 40 one ulp is 3.8e-6.  Float64 boxes (the float64
# instances of these searches) keep the same pad: float64 rounds 2^29 times
# finer, so they hold every accepted point with that much room to spare.
GATE_PAD = 2.0 ** -17
# K4: rays per block (one thread each, a multiple of 32 up to 1024),
# triangles per fine chunk (the kernel is compiled for 512; the launch
# refuses another value), and the cap of each block's candidate
# list; a block with more candidates sweeps every chunk.  Chosen on the
# H100 by `chip_smoke.py --tune`: see PERF.md.  Read at call time, so a
# test can lower the cap.
TWOLEVEL_RAY_BLOCK = 512
FINE_CHUNK = 512
TWOLEVEL_MAX_CAND = 32
# Byte budget of one chunk group of the candidate precompute's
# (blocks, chunks, rays) slab-test temporaries; more chunks are tested
# group by group.  1 GiB keeps the 2^20-ray guide, 33 chunks of 512
# triangles, in one group.
CAND_GROUP_BYTES = 1 << 30

# the slab test's guards, as in the TPU kernels
_TINY = 1e-30
_SLACK = 1e-6


def library_path() -> Path:
    return cuda_build.library_path(SOURCE)


def load_library():
    """The K1 library, built at first use, with the C signatures of its
    float32 and float64 launches declared."""
    lib = cuda_build.load(SOURCE)
    for name, real in LAUNCH.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
            + [real] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return lib


def load_culled_library():
    """The K3 library, built at first use, with the C signatures of its
    float32 and float64 launches declared."""
    lib = cuda_build.load(SOURCE_CULLED)
    for name, real in LAUNCH_CULLED.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
            + [real] * 7 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return lib


def load_twolevel_library():
    """The K4 library, built at first use, with the C signatures of its
    float32 and float64 launches declared."""
    lib = cuda_build.load(SOURCE_TWOLEVEL)
    for name, real in LAUNCH_TWOLEVEL.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [real] * 7 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return lib


def check_dtypes(what, named):
    """Raise ``TypeError`` unless every tensor of ``named`` (the first the
    rays' ``p0``) has one dtype and the search kernels have an instance of
    it (float32 or float64, ``LAUNCH``'s keys); ``what`` names the search."""
    dtype = next(iter(named.values())).dtype
    for name, t in named.items():
        if t.dtype != dtype:
            raise TypeError(f"the CUDA {what} takes one dtype; {name} is "
                            f"{t.dtype}, p0 {dtype}")
    if dtype not in LAUNCH:
        kinds = " or ".join(str(d).removeprefix("torch.") for d in LAUNCH)
        raise TypeError(f"the CUDA {what} takes {kinds}; p0 is {dtype}")


def _check_cuda_inputs(p0, p1, vp, v1, v2, what="triangle search"):
    """What a triangle kernel takes: (N, 3) rays and (M, 3) triangles, all
    float32 or all float64, contiguous, detached and on one device."""
    named = {"p0": p0, "p1": p1, "vp": vp, "v1": v1, "v2": v2}
    check_dtypes(what, named)
    device = p0.device
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, p0 on {device}")
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be (rows, 3), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad:
            raise ValueError(f"{name} must be detached: the search has no "
                             "gradient")
    if p1.shape != p0.shape:
        raise ValueError(f"p0 {tuple(p0.shape)} and p1 {tuple(p1.shape)} differ")
    if not vp.shape == v1.shape == v2.shape:
        raise ValueError("vp, v1 and v2 must have the same shape")
    if p0.shape[0] < 1:
        raise ValueError("the CUDA triangle search needs at least one ray")
    if max(p0.shape[0], vp.shape[0]) >= 2 ** 31 // 3:
        raise ValueError("too many rays or triangles for 32-bit indexing")


def check_device(p0, what="triangle"):
    """Raise for devices that have no ``what`` search: the operators run
    the plain version on the CPU and the kernel on CUDA, and nothing
    else."""
    if p0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} search for device {p0.device}")


def _thresholds(intersect_eps, size_eps, ray_start_eps):
    """The thresholds the kernels compare with, computed once in Python as
    the plain versions compute them: Python floats, passed to a float32
    instance as float32 and to a float64 instance as they are."""
    return (float(intersect_eps), -float(size_eps), 1.0 + float(size_eps),
            float(ray_start_eps))


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def nearest_hit_triangles_kernel(p0, p1, vp, v1, v2, intersect_eps, size_eps,
                                 ray_start_eps):
    """K1: nearest hit of each ray (p0 -> p1, (N, 3)) among triangles
    (vp, v1, v2, (M, 3)).  Returns ``(valid, idx, ray_u)``.

    The ``tfrt_torch::triangle_search`` operator: CPU tensors go to the
    plain version.  CUDA tensors launch the kernel
    (:func:`triangle_search_cuda`), which takes contiguous, detached
    tensors of one dtype, float32 or float64, on one device and raises on
    anything else.
    """
    check_device(p0)
    return torch.ops.tfrt_torch.triangle_search(
        p0, p1, vp, v1, v2, float(intersect_eps), float(size_eps),
        float(ray_start_eps))


def triangle_search_cuda(p0, p1, vp, v1, v2, intersect_eps, size_eps,
                         ray_start_eps):
    """K1's operator on CUDA tensors: the input checks and the launch."""
    _check_cuda_inputs(p0, p1, vp, v1, v2)
    return brute_launch(p0, p1, vp, v1, v2, intersect_eps, size_eps,
                        ray_start_eps)


def brute_rays_per_thread(n, device):
    """K1's rays a thread for ``n`` rays on ``device``: 4, so that one
    shared load of a triangle serves four pairs, where that still launches
    at least two blocks an SM; else 1 (the flagship's 1024 rays would
    otherwise fill one block on one SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 4 if -(-n // (4 * BRUTE_THREADS)) >= 2 * sms else 1


def brute_launch(p0, p1, vp, v1, v2, intersect_eps, size_eps, ray_start_eps,
                 rays_per_thread=None):
    """Launch K1's instance of ``p0``'s dtype on checked CUDA inputs,
    ``rays_per_thread`` (1 or 4) rays a thread, :func:`brute_rays_per_thread`'s
    choice when None; the wrapper's second half."""
    global LAUNCHES
    n, m = p0.shape[0], vp.shape[0]
    if rays_per_thread is None:
        rays_per_thread = brute_rays_per_thread(n, p0.device)
    fn = getattr(load_library(), LAUNCH[p0.dtype][0])
    u = torch.empty((n,), dtype=p0.dtype, device=p0.device)
    idx = torch.empty((n,), dtype=torch.int32, device=p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        err = fn(p0.data_ptr(), p1.data_ptr(), vp.data_ptr(), v1.data_ptr(),
                 v2.data_ptr(), n, m,
                 *_thresholds(intersect_eps, size_eps, ray_start_eps),
                 rays_per_thread, u.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "triangle_search")
    LAUNCHES += 1
    return u < BIG * 0.5, idx, u


def nearest_hit_triangles_culled_kernel(p0, p1, vp, v1, v2, intersect_eps,
                                        size_eps, ray_start_eps):
    """K3: K1's search with the per-chunk slab gate over chunks of
    ``CULL_CHUNK`` triangles (``tfrt_torch::triangle_search_culled``).
    Same arguments, result and device rules as
    :func:`nearest_hit_triangles_kernel`."""
    check_device(p0)
    return torch.ops.tfrt_torch.triangle_search_culled(
        p0, p1, vp, v1, v2, float(intersect_eps), float(size_eps),
        float(ray_start_eps))


def triangle_search_culled_cuda(p0, p1, vp, v1, v2, intersect_eps, size_eps,
                                ray_start_eps):
    """K3's operator on CUDA tensors: the input checks, the gate boxes and
    the launch."""
    global LAUNCHES_CULLED
    _check_cuda_inputs(p0, p1, vp, v1, v2)
    fn = getattr(load_culled_library(), LAUNCH_CULLED[p0.dtype][0])
    n, m = p0.shape[0], vp.shape[0]
    boxes = culled_boxes(vp, v1, v2, size_eps).contiguous()
    u = torch.empty((n,), dtype=p0.dtype, device=p0.device)
    idx = torch.empty((n,), dtype=torch.int32, device=p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        err = fn(p0.data_ptr(), p1.data_ptr(), vp.data_ptr(), v1.data_ptr(),
                 v2.data_ptr(), boxes.data_ptr(), n, m, CULL_CHUNK,
                 *_thresholds(intersect_eps, size_eps, ray_start_eps),
                 1.0 + _SLACK, 1.0 - _SLACK, _SLACK,
                 u.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "triangle_search_culled")
    LAUNCHES_CULLED += 1
    return u < BIG * 0.5, idx, u


def culled_boxes(vp, v1, v2, size_eps, chunk=None):
    """The gate boxes of K3 and K4: the (C, 6) boxes of chunks of ``chunk``
    triangles (``CULL_CHUNK`` when None; K4's ``FINE_CHUNK``), min xyz then
    max xyz, widened (``widen_boxes``) by 2 ``size_eps`` of the widest
    side.  Moller-Trumbore accepts barycentric weights down to
    -``size_eps`` (tu, tv >= -s_eps, tu + tv <= 1 + s_eps), at most two of
    them negative, so an accepted point lies within 2 s_eps of a side's
    width outside the triangle's box."""
    boxes = chunk_aabbs(vp, v1, v2, CULL_CHUNK if chunk is None else chunk)
    return widen_boxes(boxes, 2.0 * float(size_eps))


def widen_boxes(boxes, size_pad, reach=0.0):
    """(C, 2 dim) boxes, min then max, widened on every side by
    ``size_pad`` times the box's widest side, ``reach`` (a number or a
    (C, 1) tensor) and ``GATE_PAD`` times its largest coordinate magnitude
    (the rounding margin): the boxes of the searches that gate each ray on
    its own (K3, K4, K7, K9, K10), which must hold every point the pair
    test accepts."""
    dim = boxes.shape[1] // 2
    width = (boxes[:, dim:] - boxes[:, :dim]).amax(dim=1, keepdim=True)
    pad = (size_pad * width + reach
           + GATE_PAD * boxes.abs().amax(dim=1, keepdim=True))
    return torch.cat([boxes[:, :dim] - pad, boxes[:, dim:] + pad], dim=1)


def chunk_major(columns, chunk):
    """The (M, k) per-surface ``columns`` as a (C, k, chunk) table, C =
    ceil(M / chunk): one contiguous block per chunk holding its k columns
    as rows (structure of arrays), zero past M.  The two-level kernels
    stage a chunk with one contiguous copy."""
    m, k = columns.shape
    c = -(-m // chunk)
    pad = c * chunk - m
    if pad:
        columns = torch.cat([columns, columns.new_zeros((pad, k))])
    return columns.reshape(c, chunk, k).permute(0, 2, 1).contiguous()


def chunk_major_table(vp, v1, v2, fine_chunk):
    """K4's triangle table: (C, 3, F, 4) in the triangles' dtype, one
    contiguous block per fine chunk holding K3's tile, three rows of F
    4-vectors: (v0x, v0y, v0z, E1x), (E1y, E1z, E2x, E2y), (E2z, 0, 0, 0);
    zero past M (96 bytes a triangle in float64)."""
    cols = torch.cat([vp, v1 - vp, v2 - vp, torch.zeros_like(vp)], dim=1)
    return chunk_major(cols, fine_chunk).view(-1, 3, 4, fine_chunk) \
        .transpose(2, 3).contiguous()


def table_rows(table):
    """K4's (C, 3, F, 4) table as (C, 9, F) rows v0 xyz, E1 xyz, E2 xyz."""
    c, _, f, _ = table.shape
    return table.transpose(2, 3).reshape(c, 12, f)[:, :9]


def nearest_hit_triangles_twolevel_kernel(p0, p1, vp, v1, v2, intersect_eps,
                                          size_eps, ray_start_eps):
    """K4: the two-level search with ``TWOLEVEL_RAY_BLOCK`` rays per block,
    ``FINE_CHUNK`` triangles per chunk and lists capped at
    ``TWOLEVEL_MAX_CAND`` (``tfrt_torch::triangle_search_twolevel``).  Same
    arguments, result and device rules as
    :func:`nearest_hit_triangles_kernel`."""
    check_device(p0)
    return torch.ops.tfrt_torch.triangle_search_twolevel(
        p0, p1, vp, v1, v2, float(intersect_eps), float(size_eps),
        float(ray_start_eps))


def triangle_search_twolevel_cuda(p0, p1, vp, v1, v2, intersect_eps,
                                  size_eps, ray_start_eps):
    """K4's operator on CUDA tensors: the input checks, the preparation
    (:func:`twolevel_prepare`, with the tunables read now) and the
    launch."""
    _check_cuda_inputs(p0, p1, vp, v1, v2,
                       what="two-level triangle search (K4)")
    rb = TWOLEVEL_RAY_BLOCK
    if rb % 32 or not 32 <= rb <= 1024:
        raise ValueError(f"TWOLEVEL_RAY_BLOCK {rb} must be a multiple of 32 "
                         "in [32, 1024]")
    prepared = twolevel_prepare(p0, p1, vp, v1, v2, size_eps, ray_start_eps)
    return twolevel_launch(p0, p1, vp.shape[0], prepared, intersect_eps,
                           size_eps, ray_start_eps)


def twolevel_prepare(p0, p1, vp, v1, v2, size_eps, ray_start_eps):
    """K4's inputs, made on the rays' device: the chunk-major triangle
    table, the gate boxes of its fine chunks (``culled_boxes``), and each
    ray block's candidate list on them (``twolevel_candidates``); the cap
    is lowered to the chunk count."""
    cap = min(TWOLEVEL_MAX_CAND, -(-vp.shape[0] // FINE_CHUNK))
    boxes = culled_boxes(vp, v1, v2, size_eps, FINE_CHUNK).contiguous()
    counts, cand = twolevel_candidates(p0, p1, boxes, ray_start_eps,
                                       TWOLEVEL_RAY_BLOCK, cap)
    return chunk_major_table(vp, v1, v2, FINE_CHUNK), boxes, counts, cand, cap


def twolevel_launch(p0, p1, m, prepared, intersect_eps, size_eps,
                    ray_start_eps):
    """Launch K4's instance of ``p0``'s dtype on checked CUDA inputs and
    ``twolevel_prepare``'s output for ``m`` triangles; the wrapper's second
    half."""
    global LAUNCHES_TWOLEVEL
    table, boxes, counts, cand, cap = prepared
    fn = getattr(load_twolevel_library(), LAUNCH_TWOLEVEL[p0.dtype][0])
    n = p0.shape[0]
    u = torch.empty((n,), dtype=p0.dtype, device=p0.device)
    idx = torch.empty((n,), dtype=torch.int32, device=p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        err = fn(p0.data_ptr(), p1.data_ptr(), table.data_ptr(),
                 boxes.data_ptr(), counts.data_ptr(), cand.data_ptr(),
                 n, m, boxes.shape[0], FINE_CHUNK, TWOLEVEL_RAY_BLOCK, cap,
                 *_thresholds(intersect_eps, size_eps, ray_start_eps),
                 1.0 + _SLACK, 1.0 - _SLACK, _SLACK,
                 u.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "triangle_search_twolevel")
    LAUNCHES_TWOLEVEL += 1
    return u < BIG * 0.5, idx, u


# ======================================================================
# plain PyTorch versions
# ======================================================================

def _tu(ox, oy, oz, dx, dy, dz, a, e1, e2, i_eps):
    """The first half of every ray-triangle pair, up to tu:
    ``(ok, inv, T, tu)``, ``ok`` false where |det| < i_eps.  The kernels'
    operations in their order, in the inputs' dtype; ray components and
    triangle components (``a``, ``e1``, ``e2``: three tensors each) broadcast
    against each other."""
    e2x, e2y, e2z = e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1[0] * px + e1[1] * py + e1[2] * pz

    ok = torch.abs(det) >= i_eps
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))

    t = (ox - a[0], oy - a[1], oz - a[2])
    tu = (t[0] * px + t[1] * py + t[2] * pz) * inv
    return ok, inv, t, tu


def _out_on_tu(ok, tu, s_lo, s_hi):
    """Pairs that fail on tu alone: |det| < i_eps (not ``ok``), or tu
    outside [s_lo, s_hi - s_lo], where no tv can make them valid (tv >=
    s_lo and tu + tv <= s_hi).  The kernels refuse such a pair after the
    operations up to tu's numerator and the approximate reciprocal."""
    return ~(ok & (tu >= s_lo) & (tu <= s_hi - s_lo))


def _moller_trumbore(ox, oy, oz, dx, dy, dz, a, e1, e2, i_eps, s_lo, s_hi,
                     r_eps):
    """Ray parameter of every ray-triangle pair, ``BIG`` where the pair is
    not a valid hit: the kernels' operations in their order, in the inputs'
    dtype.  Ray components and triangle components (``a``, ``e1``,
    ``e2``: three tensors each) broadcast against each other."""
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    ok, inv, (tx, ty, tz), tu = _tu(ox, oy, oz, dx, dy, dz, a, e1, e2, i_eps)

    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    tv = (dx * qx + dy * qy + dz * qz) * inv
    ray_u = (e2x * qx + e2y * qy + e2z * qz) * inv

    ok = ok & (tu >= s_lo) & (tv >= s_lo)
    ok = ok & (tu + tv <= s_hi) & (ray_u >= r_eps)
    return torch.where(ok, ray_u, BIG)


def _merge(best_u, best_idx, rows, u, first_idx):
    """Fold the (R, C) pair parameters of rays ``rows`` (a slice or an index
    tensor) into the running best: ``argmin`` takes the first index inside
    the chunk, and a chunk replaces the best only under strict <.
    ``first_idx`` is the triangle index of column 0 (an int or (R,))."""
    carg = torch.argmin(u, dim=1)
    cu = u.gather(1, carg[:, None])[:, 0]
    bu, bi = best_u[rows], best_idx[rows]
    better = cu < bu
    best_u[rows] = torch.where(better, cu, bu)
    best_idx[rows] = torch.where(better, (carg + first_idx).to(torch.int32), bi)


@torch.no_grad()
def nearest_hit_triangles_plain(p0, p1, vp, v1, v2, intersect_eps, size_eps,
                                ray_start_eps, ray_block=32768, tri_chunk=256):
    """Plain PyTorch version of K1: the same Moller-Trumbore arithmetic in
    the same order, over (ray_block, tri_chunk) tiles with a running minimum
    merged under strict < (ties keep the earlier chunk; ``argmin`` takes the
    first index inside a chunk)."""
    n, m = p0.shape[0], vp.shape[0]
    best_u = torch.full((n,), BIG, dtype=p0.dtype, device=p0.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=p0.device)
    eps = _thresholds(intersect_eps, size_eps, ray_start_eps)
    for r0 in range(0, n, ray_block):
        rows = slice(r0, r0 + ray_block)
        o = p0[rows, :, None]                                # (B, 3, 1)
        d = p1[rows, :, None] - o
        for t0 in range(0, m, tri_chunk):
            a = vp[t0:t0 + tri_chunk].T[:, None]             # (3, 1, C)
            e1 = v1[t0:t0 + tri_chunk].T[:, None] - a
            e2 = v2[t0:t0 + tri_chunk].T[:, None] - a
            u = _moller_trumbore(*o.unbind(1), *d.unbind(1), a, e1, e2, *eps)
            _merge(best_u, best_idx, rows, u, t0)
    return best_u < BIG * 0.5, best_idx, best_u


@torch.no_grad()
def pairs_out_on_tu(p0, p1, vp, v1, v2, intersect_eps, size_eps,
                    piece=1 << 25):
    """How many of the pairs of every ray (p0 -> p1, (N, 3)) with every
    triangle (vp, v1, v2, (M, 3)) fail on tu alone (``_out_on_tu``), by the
    plain version's arithmetic, ``piece`` pairs at a time.  The bounds of
    K1, K3 and K4 charge such a pair 24 operations, the rest 46."""
    n, m = p0.shape[0], vp.shape[0]
    if n == 0 or m == 0:
        return 0
    i_eps, s_lo, s_hi, _ = _thresholds(intersect_eps, size_eps, 0.0)
    a = vp.T[:, None]                                        # (3, 1, M)
    e1, e2 = v1.T[:, None] - a, v2.T[:, None] - a
    step = max(1, piece // m)
    out = 0
    for r0 in range(0, n, step):
        o = p0[r0:r0 + step, :, None]                        # (B, 3, 1)
        d = p1[r0:r0 + step, :, None] - o
        ok, _, _, tu = _tu(*o.unbind(1), *d.unbind(1), a, e1, e2, i_eps)
        out += int(_out_on_tu(ok, tu, s_lo, s_hi).sum())
    return out


def _inverse_direction(d):
    """1 / d with |d| < 1e-30 replaced by +-1e-30 (the slab test's guard)."""
    return 1.0 / torch.where(torch.abs(d) < _TINY,
                             torch.where(d < 0, -_TINY, _TINY), d)


def _slab_gate(o, inv, lo, hi, r_eps, best_u):
    """The culling gate of K3, K4, K7 and K8, elementwise: can the ray
    (origin ``o``, inverse direction ``inv``; one tensor per axis, three in
    3D and two in 2D) hit the box [lo, hi] (one tensor per axis each) at
    t >= r_eps, no farther than its ``best_u``?  ``best_u=None`` tests only
    the first condition (the candidate precompute).  Every operand
    broadcasts."""
    tmin = tmax = None
    for k in range(len(o)):
        t1 = (lo[k] - o[k]) * inv[k]
        t2 = (hi[k] - o[k]) * inv[k]
        near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = near if tmin is None else torch.maximum(tmin, near)
        tmax = far if tmax is None else torch.minimum(tmax, far)
    gate = tmax * (1.0 + _SLACK) + _SLACK >= torch.clamp(tmin, min=r_eps)
    if best_u is not None:
        gate = gate & (tmin * (1.0 - _SLACK) - _SLACK <= best_u)
    return gate


def _selected(mask, piece=32768):
    """Index tensors of the True entries of ``mask``, in pieces."""
    rows = torch.nonzero(mask)[:, 0]
    return [rows[i:i + piece] for i in range(0, rows.shape[0], piece)]


@torch.no_grad()
def nearest_hit_triangles_culled_plain(p0, p1, vp, v1, v2, intersect_eps,
                                       size_eps, ray_start_eps):
    """Plain PyTorch version of K3: the chunks of ``CULL_CHUNK`` triangles
    in order; a chunk is computed for the rays that pass the slab gate
    against their own running best on its ``culled_boxes`` box, with K1's
    arithmetic and merge."""
    n, m = p0.shape[0], vp.shape[0]
    best_u = torch.full((n,), BIG, dtype=p0.dtype, device=p0.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=p0.device)
    eps = _thresholds(intersect_eps, size_eps, ray_start_eps)
    d = p1 - p0
    o3, d3, inv3 = p0.unbind(1), d.unbind(1), _inverse_direction(d).unbind(1)
    chunk = CULL_CHUNK
    boxes = culled_boxes(vp, v1, v2, size_eps)
    for c, t0 in enumerate(range(0, m, chunk)):
        box = boxes[c]
        need = _slab_gate(o3, inv3, box[:3], box[3:], eps[3], best_u)
        a = vp[t0:t0 + chunk].T[:, None]                     # (3, 1, C)
        e1 = v1[t0:t0 + chunk].T[:, None] - a
        e2 = v2[t0:t0 + chunk].T[:, None] - a
        for rows in _selected(need):
            u = _moller_trumbore(*(x[rows, None] for x in o3 + d3), a, e1,
                                 e2, *eps)
            _merge(best_u, best_idx, rows, u, t0)
    return best_u < BIG * 0.5, best_idx, best_u


def _cand_chunk_group(n_pad, n_chunks):
    """Chunks per group of the candidate precompute, so that its ~6 live
    (blocks, chunks, rays) temporaries of 4 bytes stay near
    ``CAND_GROUP_BYTES``; at least 16."""
    per_col = max(n_pad, 1) * 4 * 6
    return max(16, min(n_chunks, CAND_GROUP_BYTES // per_col))


@torch.no_grad()
@torch.profiler.record_function("twolevel_candidates")
def twolevel_candidates(p0, p1, boxes, ray_start_eps, ray_block, max_cand):
    """Candidate fine chunks of each ray block: chunk c is a candidate of
    block b iff some ray of b passes the slab gate against c's box with no
    best yet (best = inf).  Plain PyTorch, as the JAX package computes it in
    XLA (``_twolevel_candidates`` in 3D, ``_twolevel_candidates_2d`` in
    2D); it runs on the card before K4, K9 and K10.  ``p0``, ``p1`` are
    (N, dim) rays and ``boxes`` (C, 2 dim) chunk boxes, minimum then
    maximum.

    Returns ``(counts (nb,) int32, cand (nb * max_cand,) int32)``: each
    block's candidate ids ascending (Morton order) and packed first.  When
    there are more chunks than ``max_cand``, blocks with more candidates
    than that get ``counts == n_chunks`` (sweep every chunk).  The rays that
    pad the last block vote for nothing (the TPU version pads with zero
    rays, which vote)."""
    n, dim = p0.shape
    nb = -(-n // ray_block)
    pad = nb * ray_block - n
    live = torch.ones((n,), dtype=torch.bool, device=p0.device)
    d = p1 - p0
    inv = _inverse_direction(d)
    if pad:
        def pad_rows(a, value):
            return torch.cat([a, a.new_full((pad,) + a.shape[1:], value)])
        p0, inv, live = pad_rows(p0, 0.0), pad_rows(inv, 1.0), pad_rows(live, False)
    o = [a.reshape(nb, 1, ray_block) for a in p0.unbind(1)]
    inv = [a.reshape(nb, 1, ray_block) for a in inv.unbind(1)]
    live = live.reshape(nb, 1, ray_block)
    n_chunks = boxes.shape[0]
    cg = _cand_chunk_group(nb * ray_block, n_chunks)
    need = []
    for c0 in range(0, n_chunks, cg):
        box = boxes[c0:c0 + cg].T[:, None, :, None]          # (2 dim, 1, Cg, 1)
        gate = _slab_gate(o, inv, box[:dim], box[dim:], float(ray_start_eps),
                          None)
        need.append((gate & live).any(dim=-1))               # (nb, Cg)
    need = torch.cat(need, dim=1)
    counts = need.sum(dim=1).to(torch.int32)
    cand = torch.argsort((~need).to(torch.int8), dim=1, stable=True)
    if n_chunks > max_cand:
        cand = cand[:, :max_cand]
        counts = torch.where(counts > max_cand, n_chunks, counts)
    return counts, cand.to(torch.int32).reshape(-1)


def twolevel_walk(p0, p1, boxes, counts, cand, cap, ray_block, r_eps,
                  best_u):
    """The chunks and rays the two-level kernels (K4, K9, K10) compute, as
    their plain versions walk them: each block of ``ray_block`` rays walks
    its candidate list (``counts``, ``cand`` and ``cap`` of
    :func:`twolevel_candidates`) or, on overflow, every chunk of ``boxes``
    in order.  At each step, after the earlier steps have been merged into
    ``best_u``, yields ``(chunk, rows)`` -- ``chunk`` the (R,) chunk id of
    each ray of ``rows`` -- for each piece of the rays that pass the slab
    gate against their own running best."""
    n, dim = p0.shape
    n_chunks, nb = boxes.shape[0], counts.shape[0]
    sweep = counts == n_chunks
    steps = n_chunks if bool(sweep.any()) else int(counts.max())
    k = torch.arange(steps, device=p0.device)
    listed = cand.view(nb, cap).long()[:, torch.clamp(k, max=cap - 1)]
    walk = torch.where(sweep[:, None], k, listed)             # (nb, steps)
    block = torch.arange(n, device=p0.device) // ray_block
    o, inv = p0.unbind(1), _inverse_direction(p1 - p0).unbind(1)
    for step in range(steps):
        chunk = walk[block, step]                             # (N,)
        box = boxes[chunk].T                                  # (2 dim, N)
        need = _slab_gate(o, inv, box[:dim], box[dim:], r_eps, best_u)
        need = need & (step < counts.long())[block]
        for rows in _selected(need):
            yield chunk[rows], rows


@torch.no_grad()
def nearest_hit_triangles_twolevel_plain(p0, p1, vp, v1, v2, intersect_eps,
                                         size_eps, ray_start_eps):
    """Plain PyTorch version of K4: each block of ``TWOLEVEL_RAY_BLOCK``
    rays walks its candidate list (or every chunk on overflow) in order; at
    each step the chunk of ``FINE_CHUNK`` triangles is computed for the rays
    that pass the slab gate against their own running best on its
    ``culled_boxes`` box, with K1's arithmetic and merge."""
    n = p0.shape[0]
    eps = _thresholds(intersect_eps, size_eps, ray_start_eps)
    table, boxes, counts, cand, cap = twolevel_prepare(
        p0, p1, vp, v1, v2, size_eps, eps[3])
    table = table_rows(table)                                # (C, 9, F)
    best_u = torch.full((n,), BIG, dtype=p0.dtype, device=p0.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=p0.device)
    d = p1 - p0
    o3, d3 = p0.unbind(1), d.unbind(1)
    for chunk, rows in twolevel_walk(p0, p1, boxes, counts, cand, cap,
                                     TWOLEVEL_RAY_BLOCK, eps[3], best_u):
        tri = table[chunk].unbind(1)                          # 9 x (R, F)
        a, e1, e2 = tri[0:3], tri[3:6], tri[6:9]
        u = _moller_trumbore(*(x[rows, None] for x in o3 + d3), a, e1, e2,
                             *eps)
        _merge(best_u, best_idx, rows, u, chunk * FINE_CHUNK)
    return best_u < BIG * 0.5, best_idx, best_u
