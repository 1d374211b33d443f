#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tensorflowraytrace_tpu_torch) on
one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, one or more lines each (any failed check raises and the script
exits non-zero without printing a result):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
   exits non-zero when CUDA is not available.
2. build: compiles the ten kernels (csrc/triangle_search.cu,
   triangle_search_culled.cu, triangle_search_twolevel.cu, segment_sum.cu,
   segment_search.cu, segment_search_culled.cu, segment_search_twolevel.cu,
   arc_search.cu, arc_search_culled.cu and arc_search_twolevel.cu), one
   nvcc each, started together, into build/.
3. K1 against its plain PyTorch version on the card, bit for bit (equal
   ``valid``, ``idx`` and ``ray_u``), at the rays a thread its launch
   chooses and at each of 1 and 4: the random soup of bench.py (seed 0:
   4094 random triangles plus the 2-triangle target quad) with 131072
   rays, the flagship's first-bounce search (1024 rays), a ragged tile
   (1000 rays x 333 triangles), a batch that misses everything, both ray
   sets with every third ray parked (p0 = 1e30) and cut to a count that is
   no multiple of a block's rays (1021 and 131035), and a batch of parked
   rays.  Then K3 (culled) and K4
   (two-level) against their plain versions and against K1, bit for bit:
   the soup Morton-sorted as in bench.py (131072 rays), the first bounce
   of the structured guide (131072 rays x 16386 triangles), a ragged tile,
   an all-miss batch, a batch of parked rays, and K4 with its candidate cap
   forced to 1 so that every block overflows and sweeps.  (Phase 10
   checks them again at the main path's shape.)
4. the flagship forward (flagship.entry(): 1024 rays, a lens of two
   217-vertex surfaces, 4 bounces, float32) through the kernel: the loss is
   finite, equals the port's plain search path within rtol 1e-4, and K1
   launched exactly once per bounce.
5. the bench-scale trace: 2^20 rays x 4096 triangles x 8 bounces of the
   soup, kernel path against the plain path: per-state ray counts within
   0.1% of N; median of 5 synchronised runs of each.  Then K1 alone at its
   first bounce, with two bounds: the flat 46 operations a pair, and the
   work these inputs need, the pairs that fail on tu alone
   (``triangle_kernels.pairs_out_on_tu``) charged the 24 operations before
   the reject test refuses them; each with its floor without FMAs.
6. K2 (the segment sum) against float64 ``index_add_`` at the flagship's,
   the soup's and ragged shapes, with k = 13, and at the 2D guide
   backward's (2^20 rays, the 512-arc table, k = 4: the cotangents and
   rows of the K2 call of phase 14's backward whose rays hit the most
   arcs, and each call's share of rays with a zero cotangent, printed):
   elementwise
   ``|K2 - ref64| <= 1e-5 S + 1e-7``, ``S[j] = sum over idx[i] == j of
   |ct[:, i]|``; K2 (by CUDA events, and by device time after phase 14),
   its plain version and ``index_add_`` timed at (2^20, 770), (2^20,
   4096), one row of 770 and the 2D guide's shape.
7. the flagship's training routine at the scale of
   examples/simple_3d_optimize.py through flagship.train() (2025 rays,
   217-vertex surfaces, 3 bounces, 150 steps in three chained phases): K1
   and K2 launch 3 times per step, every parameter stays finite, and the
   mean error of the last 10 steps is below that of the first 10.
8. one training step of the flagship at bench width (1024 x 1024 = 2^20
   rays, 3 bounces): median of 5 synchronised steps; the gradient through
   K2 against the plain ``index_add_`` backward of the same forward within
   1e-4 of its max norm; the loss against the all-plain path (Cramer search)
   within rtol 1e-4; K2's share of device time (torch.profiler) and the
   peak device memory.

9. the Morton-sorted soup (as bench.py traces it: 2^20 rays x 4096
   triangles x 8 bounces) through K1 brute force, ``cull=True`` (K3),
   ``cull="grid"`` (K4), ``cull="grid", resort_rays=True`` and
   ``cull=True, resort_rays=True``: the final
   ``state``, ``p0`` and ``p1`` of every accelerated path equal the brute
   path's bit for bit; each kernel launches once per bounce; median of 5
   synchronised traces of each.
10. the structured guide of bench.py (a 16386-triangle
   ParametricCylindricalGuide, 64 x 128 rings, taper (0.7, 0.0),
   Morton-sorted, 2^20 rays from seed 0, acrylic, 24 bounces) through the
   same five paths, children starting ``engine.start_epsilon`` past their
   surface as under ``TraceConfig.recommended`` on the card, checked and
   timed as in phase 9, with equivalent intersections/s N M B / t.  Then
   K1, K3 and K4 alone at its first bounce (2^20 rays x 16386 triangles),
   the rays in the re-sort's Morton order: K1's time and its two bounds
   as in phase 5; K3 and K4 bit for bit against
   their plain versions and K1 at that shape, their times and plain
   times, and one bound for both, the work these inputs need (pairs
   admitted at 256-triangle chunks, those whose tu fails charged the
   operations before the reject test refuses them), with the floor
   without FMAs; K4's kernel also alone, apart from the preparation of its
   inputs (its table, widened boxes and candidate lists);
   one ``cull=True, resort_rays=True`` trace (the path ``recommended``
   picks) and one ``cull="grid", resort_rays=True`` trace under
   torch.profiler (the search kernel, the candidate precompute, the
   re-sort and the rest of the device time, the idle share, kernels a
   bounce), their peak memory and host synchronisations.

11. the 2D searches: K5 (segments) and K6 (arcs) against their plain
   versions, and K7 and K8 (culled) and K9 and K10 (two-level) against
   theirs and against K5 and K6, all bit for bit, on
   examples/tpu_kernel_check.py's sets (seed 7: 777 random segments and 555
   random arcs with signed radii and sweeps of 0.3-5.8 rad, Morton-sorted)
   against 200000 rays, a ragged tile (1000 rays x 333 surfaces), 1 ray x
   257 surfaces, an all-miss batch, a batch of parked rays and full-circle
   arcs; then the sets and the ragged tile again with K9's and K10's
   candidate cap forced to 1, so that their blocks overflow and sweep; then
   K6, K8 and K10 on scenes2d.arc_edge_cases, the edges of their exact
   reject (the discriminant and |a| within float32 steps of i_eps, tangent
   rays, rays 13000 radii away, windows wider than pi, exact ties, parked
   rays); then all six, at the list cap and at cap 1, on
   scenes2d.gate_edge_cases, hits where the boxes of K7-K10 must reach
   (up to size_eps 1e-2 past a segment's ends, tangent pairs snapped off
   their circle, window ends from near and 13000 radii away, parked and
   all-miss batches); then on scenes2d.block_rays at K7's and K9/K10's
   ray blocks (blocks of which every ray, one ray or no ray needs a
   chunk) over 300 and 100 surfaces.
12. 2D training at example scale: examples/optimize_single_arc.py (60 rays,
   one trainable arc, 2 bounces, 30 steps at momentum 0.8 and 50 at
   lr_scale 0.1, momentum 0.9) through use_kernel=True in float32: K5 and
   K6 launch once per bounce, K2 on each backward, the final error is below
   5% of the first and every parameter stays finite.  Then one step of the
   same problem at bench width (174763 beam points x 6 wavelengths ~ 2^20
   rays): median of 5 synchronised steps.
13. the 2D light guide at full width (scenes2d.light_guide: 4098 segments,
   512 lenslet arcs, 2^20 rays from seed 0, acrylic, 50 bounces) through
   brute (K5 + K6), ``cull=True`` (K7 + K8), ``cull=True,
   resort_rays=True``, ``cull="grid"`` (K9 + K10) and ``cull="grid",
   resort_rays=True``: the final ``state``, ``p0`` and ``p1`` of each
   accelerated path equal the brute path's bit for bit, each kernel
   launches once per bounce, median of 5 synchronised traces per path and
   equivalent intersections/s N (M_seg + M_arc) B / t; one brute, one
   ``cull=True, resort_rays=True`` and one ``cull="grid",
   resort_rays=True`` trace under torch.profiler (shares of the segment
   search, the arc search, the candidate precompute, the re-sort and the
   rest, the idle share, kernels a bounce), peak memory and host
   synchronisations (0).  Then K5-K10 alone at the first bounce (2^20 x
   4098 and 2^20 x 512, the rays in the re-sort's order): bit for bit
   against their plain versions; by CUDA events the kernel alone, apart
   from its inputs' preparation (K6-K10's tables, boxes and candidate
   lists), the whole wrapper and the plain version; and each kernel's
   bound, the work these inputs need: for the arcs the pairs past the exact
   reject (``arc_kernels.admitted_arc_pairs``) at 50 operations and the
   rest at the 15 before it, beside the flat 50-operation bound; the
   bounds count the pairs on the chunks' exact boxes, and beside them the
   pairs a per-ray gate admits on the boxes with the rounding margin alone
   and on the widened boxes K7-K10 gate on; K9's and K10's preparation in
   its three parts (table, boxes, candidate lists), by CUDA events and by
   the host time that enqueues them.
14. the 2D guide as a design problem (scenes2d.guide_design, the same rays
   and scene) under ``TraceConfig.recommended(scene, max_bounces=50,
   dead_ray_length=10)``: the configuration it chose; one forward and
   backward pass of the landing loss (a ``landing_sum_fold``) with respect
   to the lenslets' centres and radii with ``remat=True`` and with
   ``remat=False``: the two gradients within 1e-4 of their max norm (K2's
   atomics make them differ), each search kernel of the chosen path
   launched exactly 50 times in each (the backward searched nothing), the
   median of 3 synchronised passes and the peak memory of each; then one
   ``early_exit=True`` trace under ``torch.no_grad()``: its final
   ``state``, ``p0`` and ``p1`` equal the 50-bounce trace's bit for bit,
   with its depth and its host synchronisations (one a bounce).

Phase 5 keeps the soup unsorted, so its numbers stay comparable with the
earlier runs: the brute-force search does not use the order.  Then the
script's own wall time, one JSON line describing each kernel of the path,
the nvidia-smi line, and as the last line ``{"ok": true, "device":
{...}}``.

``python3 chip_smoke.py --tune`` runs phases 1 and 2, times K2 at phase
6's timed shapes built at each of ``SEGSUM_VARIANTS`` (its rays a lane,
columns loaded ahead and blocks an SM, with and without its warp
aggregation), times K1 alone at the soup's and the guide's first bounce
at 1 and 4 rays a thread and K4 alone at the guide's first bounce at every ray
block, then sweeps K4's ray block and candidate cap on the guide and the
sorted soup; times K7 and K8 at 128-1024 rays a block, alone at the 2D
guide's first bounce and in its ``cull=True`` traces; times K9 alone at
the 2D guide's first bounce at every ray block, then sweeps K9's and
K10's ray block and cap on the 2D guide (median of 3 traces each, every
setting checked against the brute trace), and prints no result line.
``python3 chip_smoke.py --arcs-alone`` runs phases 1 and 2 and times K6
and K8 launched alone at the 2D guide's first bounce (see
``arcs_alone``); ``--segsum-alone`` times K2 at phase 6's timed shapes
(see ``segsum_alone``); neither prints a result line.
"""

import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings

N_SOUP_TRIS = 4094
K1_RAYS = 131072
BENCH_RAYS = 1 << 20
BENCH_BOUNCES = 8
EPS = 1e-6  # default_epsilon(float32)

# phase 6: (label, rays N, table rows m, columns k, idx pattern); k = 13 is
# the 3D gather's table (vp, v1, v2, norm, the packed annotation), k = 4
# the 2D guide's arc table (centre, radius, the packed annotation).  The
# "guide2d" case is phase 14's own arc gather backward (guide2d_backward).
SEGSUM_CASES = [
    ("flagship_example", 2025, 770, 13, "random"),
    ("flagship_bench", 1 << 20, 770, 13, "random"),
    ("soup", 1 << 20, 4096, 13, "random"),
    ("global_random", 5000, 16386, 13, "random"),
    ("global_coherent", 5000, 16386, 13, "coherent"),
    ("one_row", 1 << 20, 770, 13, "same"),
    ("ragged_1x1", 1, 1, 13, "random"),
    ("ragged", 1000, 333, 13, "random"),
    ("guide2d_backward", 1 << 20, 512, 4, "guide2d"),
]
SEGSUM_TIMED = ("flagship_bench", "soup", "one_row", "guide2d_backward")
# --tune: K2 rebuilt from segment_sum.cu with its shared branch's rays a
# lane and the blocks an SM its launch bound asks for (shared_launch's
# choice) forced to each of these, at 8 or 16 cotangent columns loaded
# ahead, with and without its warp aggregation (the match where two
# neighbouring lanes share a row); one build each, timed at SEGSUM_TIMED
# beside the source as it stands
SEGSUM_VARIANTS = tuple(
    {"rays": rays, "min_blocks": blocks, "kCols": cols, "aggregate": agg}
    for rays, blocks in ((1, 2), (2, 2), (2, 1), (1, 1)) for cols in (8, 16)
    for agg in (True, False))

# phases 7 and 8: the flagship's training (examples/simple_3d_optimize.py)
TRAIN_STEPS = 150
TRAIN_BP = 45
TRAIN_RINGS = 8
TRAIN_BOUNCES = 3
WIDE_BP = 1024

# phases 3, 9 and 10: the acceleration path
CULL_RAYS = 131072
GUIDE_RAYS = 1 << 20
GUIDE_BOUNCES = 24
# profiler ranges the port opens around the candidate precompute and the
# re-sort; their device-side annotations are not kernels
RANGES = ("twolevel_candidates", "resort_rays")

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W power limit).  The
# FP32 peak counts an FMA as two operations; the searches are built with
# --fmad=false, so their floor without FMAs is twice the operation bound.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
# FP32 operations of one ray-triangle pair (K1, K3 and K4 do the same
# exact arithmetic, behind a cheaper test): two cross products
# (2 x 9), two dot products against P (2 x 6 with the scaling by inv),
# det (5), T (3), u (6), 1/det (1), tu + tv (1)
K1_FLOPS_PER_PAIR = 46
# the part of that a pair whose tu fails costs in K1, K3 and K4 before the
# reject test refuses it (tsearch::TrianglePair): P (9), det (5), T (3),
# tu's numerator (5), the reciprocal (1), one product (1)
TU_FLOPS_PER_PAIR = 24
# one ray-segment pair of K5, K7 and K9 (search2d::SegmentPair, shared t):
# T (2), den (3), the two numerators (2 x 3), the reciprocal (1), two
# products (2); a pair the reject test refuses costs as much
SEG_FLOPS_PER_PAIR = 14
# one ray-arc pair of K6, K8 and K10 that passes the exact reject
# (search2d::ArcPair): the scaled coordinates (6), a (3), the cross term
# (3), the discriminant (3), b (4), 2a and its reciprocal (2), the square
# root (1), the two roots (4), the window test of each root (2 x 12); a
# pair the reject refuses (a negative discriminant, or |a| < i_eps) costs
# only the operations up to the discriminant
ARC_FLOPS_PER_PAIR = 50
ARC_REJECT_FLOPS = 15

# phases 11-13: the 2D path
CHECK_RAYS = 200000
CHECK_SEGMENTS = 777
CHECK_ARCS = 555
ARC_STEPS = (30, 50)
ARC_WIDE_BEAM = 174763
GUIDE2D_RAYS = 1 << 20
DESIGN_PASSES = 3


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def card():
    """The device every phase runs on."""
    import torch

    return torch.device("cuda:0")


def soup_scene(n_rays, device, sort=False):
    """bench.py's random soup: a box of reflective triangles around the
    origin, a distant target plane, rays from inside in random directions.
    ``sort`` Morton-sorts the soup before the target is added, as bench.py
    does."""
    import numpy as np
    import torch

    from tensorflowraytrace_tpu_torch import RaySet, Scene3D, TriangleSet
    from tensorflowraytrace_tpu_torch.models.acceleration import (
        morton_sort_triangles,
    )

    f32 = torch.float32
    rng = np.random.default_rng(0)
    center = rng.uniform(-3, 3, (N_SOUP_TRIS, 3))
    vp = center + rng.normal(0, 0.5, center.shape)
    v1 = center + rng.normal(0, 0.5, center.shape)
    v2 = center + rng.normal(0, 0.5, center.shape)
    guide = TriangleSet.make(vp.astype(np.float32), v1.astype(np.float32),
                             v2.astype(np.float32), mat_in=1, mat_out=0,
                             dtype=f32, device=device)
    if sort:
        guide, _ = morton_sort_triangles(guide)
    half = 500.0
    target = TriangleSet.make(
        [[50.0, -half, -half], [50.0, half, half]],
        [[50.0, half, -half], [50.0, -half, half]],
        [[50.0, half, half], [50.0, -half, -half]], dtype=f32, device=device)
    scene = Scene3D.build(optical=[guide], targets=[target])
    p0 = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = RaySet.make(p0, p0 + d, 575.0, dtype=f32, device=device)
    return rays, scene


def guide_scene(n_rays, device):
    """bench.py's structured scene: a 16k-triangle cylindrical light guide
    (Morton-sorted) with a small target past its end, rays from a disc near
    the start heading down the guide."""
    import math

    import numpy as np
    import torch

    from tensorflowraytrace_tpu_torch import RaySet, Scene3D, TriangleSet
    from tensorflowraytrace_tpu_torch.models import boundaries as bd
    from tensorflowraytrace_tpu_torch.models.acceleration import (
        morton_sort_triangles,
    )

    f32 = torch.float32
    guide = bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 40.0), minimum_radius=0.3,
        theta_res=64, z_res=128, rotationally_symmetric=True,
        initial_taper=(0.7, 0.0), mat_in=1, mat_out=0, dtype=f32,
        device=device)
    with torch.no_grad():
        surf, _ = morton_sort_triangles(guide.build())
    half = 0.35
    target = TriangleSet.make(
        [[-half, -half, 40.05], [half, half, 40.05]],
        [[half, -half, 40.05], [-half, half, 40.05]],
        [[half, half, 40.05], [-half, -half, 40.05]], dtype=f32, device=device)
    scene = Scene3D.build(optical=[surf], targets=[target])
    rng = np.random.default_rng(0)
    r = 0.2 * np.sqrt(rng.uniform(0, 1, n_rays))
    th = rng.uniform(0, 2 * math.pi, n_rays)
    p0 = np.stack([r * np.cos(th), r * np.sin(th), np.full(n_rays, 0.1)],
                  1).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3))
    d[:, 2] = np.abs(d[:, 2]) * 3 + 1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = RaySet.make(p0, p0 + d.astype(np.float32), 575.0, dtype=f32,
                       device=device)
    return rays, scene


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_k1(label, p0, p1, vp, v1, v2):
    """K1 against its plain version on the same tensors, bit for bit, at
    the rays a thread the wrapper chooses and at each its kernel is
    compiled for; returns max |du| on valid rays (0 when equal).  These
    launches are comparisons, not the main path."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    args = [t.detach().contiguous() for t in (p0, p1, vp, v1, v2)]
    ref = tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS)
    chosen = tk.brute_rays_per_thread(args[0].shape[0], args[0].device)
    err = 0.0
    for rpt in (None,) + tk.BRUTE_RAYS_PER_THREAD:
        got = (tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
               if rpt is None else
               tk.brute_launch(*args, EPS, EPS, EPS, rays_per_thread=rpt))
        torch.cuda.synchronize()
        diffs = [int((a != b).sum()) for a, b in zip(got, ref)]
        both = got[0] & ref[0]
        if both.any():
            err = max(err, float((got[2][both] - ref[2][both]).abs().max()))
        check(not any(diffs), f"K1 {label} at {rpt or chosen} rays a thread: "
              f"valid, idx, u differ from the plain version in {diffs} rays")
    print(f"phase 3 K1 {label}: N={args[0].shape[0]} M={args[2].shape[0]} "
          f"hits={int(ref[0].sum())}; bit for bit at rays a thread "
          f"{tk.BRUTE_RAYS_PER_THREAD} and at the launch's choice {chosen}",
          flush=True)
    return err


def k1_bounds(p0, p1, vp, v1, v2):
    """K1's two bounds (ms) on these inputs: the flat 46 operations a pair,
    and the work they need, the pairs that fail on tu alone charged 24;
    returns (flat, needed, pairs out on tu)."""
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    pairs = p0.shape[0] * vp.shape[0]
    tu_out = tk.pairs_out_on_tu(p0, p1, vp, v1, v2, EPS, EPS)
    flat = pairs * K1_FLOPS_PER_PAIR / PEAK_FP32_FLOP_S * 1e3
    needed = ((pairs - tu_out) * K1_FLOPS_PER_PAIR
              + tu_out * TU_FLOPS_PER_PAIR) / PEAK_FP32_FLOP_S * 1e3
    return flat, needed, tu_out


def compare_culled(label, p0, p1, vp, v1, v2):
    """K3 and K4 against their plain versions and against K1 on the same
    tensors, bit for bit.  These launches are comparisons, not the main
    path."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    args = [t.detach().contiguous() for t in (p0, p1, vp, v1, v2)]
    ref = tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
    got = {
        "K3": tk.nearest_hit_triangles_culled_kernel(*args, EPS, EPS, EPS),
        "K4": tk.nearest_hit_triangles_twolevel_kernel(*args, EPS, EPS, EPS),
    }
    torch.cuda.synchronize()
    plain = {
        "K3": tk.nearest_hit_triangles_culled_plain(*args, EPS, EPS, EPS),
        "K4": tk.nearest_hit_triangles_twolevel_plain(*args, EPS, EPS, EPS),
    }
    report = [culled_agreement(name, got[name], plain[name], ref)[1]
              for name in got]
    print(f"phase 3 K3/K4 {label}: N={args[0].shape[0]} M={args[2].shape[0]} "
          f"hits={int(ref[0].sum())} cap={tk.TWOLEVEL_MAX_CAND} "
          + "; ".join(report), flush=True)


def culled_agreement(name, got, plain, ref):
    """One culled kernel's ``(valid, idx, u)`` against its plain version's
    and K1's, which must be equal bit for bit; returns (max |u - u_plain|
    on rays both find valid, a report)."""
    (v, i, u), (pv, pi, pu) = got, plain
    both = v & pv
    err = float((u[both] - pu[both]).abs().max()) if both.any() else 0.0
    vs_plain = int(((v != pv) | (i != pi) | (u != pu)).sum())
    vs_k1 = int(((v != ref[0]) | (i != ref[1]) | (u != ref[2])).sum())
    check(not (vs_plain or vs_k1), f"{name}: {vs_plain} rays differ from "
          f"its plain version, {vs_k1} from K1")
    return err, (f"{name} rays differing from plain {vs_plain}, from K1 "
                 f"{vs_k1}, max_abs_err {err}")


def admitted_pairs(p0, p1, boxes, m, u, chunk):
    """The ray-surface pairs a culled search must compute on these inputs:
    for each ray, the surfaces of every chunk (of ``chunk`` rows; ``boxes``
    (C, 2 dim) their boxes, ``m`` the surface count) whose box its own slab
    test admits no farther than its final nearest hit ``u``.  In 3D one
    count for K3 and K4 alike, at the finer of their chunks."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    dim = p0.shape[1]
    sizes = torch.full((boxes.shape[0],), chunk, dtype=torch.int64,
                       device=p0.device)
    sizes[-1] = m - (boxes.shape[0] - 1) * chunk
    inv = tk._inverse_direction(p1 - p0)
    o = [a[:, None] for a in p0.unbind(1)]
    inv = [a[:, None] for a in inv.unbind(1)]
    total = 0
    for c0 in range(0, boxes.shape[0], 8):
        box = boxes[c0:c0 + 8].T
        gate = tk._slab_gate(o, inv, box[:dim], box[dim:], EPS, u[:, None])
        total += int((gate.to(torch.int64) * sizes[c0:c0 + 8]).sum())
    return total


def k1_branch_shares(p0, p1, vp, v1, v2, rays_per_thread):
    """K1's divergence on these inputs: the share of its (warp, triangle)
    steps on which some of the warp's 32 x ``rays_per_thread`` pairs
    passes tu's test (the branch a triangle is taken), and of its (warp,
    ray k, triangle) steps on which some lane's ray k does (that ray's
    second half runs).  By the exact tu test, which the kernel's widened
    test passes at least; rays laid out as the kernel takes them, 256
    threads a block, ray k of a thread at offset 256 k."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    i_eps, s_lo, s_hi, _ = tk._thresholds(EPS, EPS, EPS)
    n, m = p0.shape[0], vp.shape[0]
    block = 256 * rays_per_thread
    a = vp.T[:, None]
    e1, e2 = v1.T[:, None] - a, v2.T[:, None] - a
    step = max(1, (1 << 25) // (m * block)) * block
    branch = ray_half = 0
    for r0 in range(0, n, step):
        o = p0[r0:r0 + step, :, None]
        d = p1[r0:r0 + step, :, None] - o
        ok, _, _, tu = tk._tu(*o.unbind(1), *d.unbind(1), a, e1, e2, i_eps)
        passes = ~tk._out_on_tu(ok, tu, s_lo, s_hi)            # (B, M)
        pad = -passes.shape[0] % block
        if pad:
            passes = torch.cat([passes, passes.new_zeros((pad, m))])
        lanes = passes.view(-1, rays_per_thread, 8, 32, m).any(dim=3)
        branch += int(lanes.any(dim=1).sum())
        ray_half += int(lanes.sum())
    warps = -(-n // block) * 8
    return (branch / (warps * m), ray_half / (warps * rays_per_thread * m))


def triangle_pairs(p0, p1, vp, v1, v2, u, chunk):
    """The ray-triangle pairs K3 and K4 must compute on these inputs
    (``admitted_pairs`` at chunks of ``chunk`` triangles) and how many of
    them fail on tu alone (``triangle_kernels.pairs_out_on_tu``).  Returns
    (admitted, out on tu)."""
    from tensorflowraytrace_tpu_torch.models.acceleration import chunk_aabbs
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    o = [a[:, None] for a in p0.unbind(1)]
    inv = [a[:, None] for a in tk._inverse_direction(p1 - p0).unbind(1)]
    boxes = chunk_aabbs(vp, v1, v2, chunk)
    admitted = out = 0
    for c in range(boxes.shape[0]):
        box = boxes[c:c + 1].T
        rows = tk._slab_gate(o, inv, box[:3], box[3:], EPS,
                             u[:, None])[:, 0].nonzero()[:, 0]
        tri = slice(c * chunk, (c + 1) * chunk)
        admitted += rows.numel() * vp[tri].shape[0]
        out += tk.pairs_out_on_tu(p0[rows], p1[rows], vp[tri], v1[tri],
                                  v2[tri], EPS, EPS)
    return admitted, out


def accel_configs(bounces, scene):
    """The five search paths' trace configurations for ``scene``, children
    starting ``engine.start_epsilon`` past their surface."""
    from tensorflowraytrace_tpu_torch import TraceConfig
    from tensorflowraytrace_tpu_torch.engine import start_epsilon

    eps = start_epsilon(scene)

    def cfg(**kw):
        return TraceConfig(max_bounces=bounces, use_kernel=True,
                           ray_start_epsilon=eps, **kw)

    return {"brute": cfg(), "cull": cfg(cull=True), "grid": cfg(cull="grid"),
            "grid+resort": cfg(cull="grid", resort_rays=True),
            "cull+resort": cfg(cull=True, resort_rays=True)}


def accel_paths(label, rays, scene, materials, bounces, launched):
    """The search paths of one scene (``accel_configs``): the final state
    and endpoints of every accelerated path against the brute path's, bit
    for bit, each kernel once per bounce, and the median of 5 synchronised
    traces after one more.  Adds each kernel's launches to ``launched``;
    returns the medians (s) and the state counts."""
    import torch

    from tensorflowraytrace_tpu_torch import trace
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    cfgs = accel_configs(bounces, scene)
    kernel_of = {"brute": "K1", "cull": "K3", "grid": "K4",
                 "grid+resort": "K4", "cull+resort": "K3"}
    times = {k: [] for k in cfgs}
    finals = {}
    for rep in range(6):  # rep 0 warms up and gives the results
        for name, cfg in cfgs.items():
            tk.LAUNCHES = tk.LAUNCHES_CULLED = tk.LAUNCHES_TWOLEVEL = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = trace(rays, scene, materials, cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {"K1": tk.LAUNCHES, "K3": tk.LAUNCHES_CULLED,
                      "K4": tk.LAUNCHES_TWOLEVEL}
            want = {k: bounces if k == kernel_of[name] else 0 for k in counts}
            check(counts == want, f"{label} {name}: launches {counts}, "
                  f"not {want}")
            for k, c in counts.items():
                launched[k] = launched.get(k, 0) + c
            if rep == 0:
                finals[name] = res.rays
            else:
                times[name].append(dt)
            del res
    ref = finals["brute"]
    check(bool(torch.isfinite(ref.p1).all()), f"{label}: non-finite endpoints")
    states = state_counts(ref.state)
    pairs = rays.n_rays * scene.triangles.n_surfaces * bounces
    med = {k: statistics.median(v) for k, v in times.items()}
    for name in cfgs:
        got = finals[name]
        same = {f: torch.equal(getattr(got, f), getattr(ref, f))
                for f in ("state", "p0", "p1")}
        print(f"{label} {name}: median {med[name] * 1e3:.3f} ms over 5 traces "
              f"{[round(t * 1e3, 3) for t in times[name]]} = "
              f"{pairs / med[name]:.4e} equivalent intersections/s; "
              f"bitwise equal to brute {same}", flush=True)
        check(all(same.values()), f"{label} {name}: differs from the brute "
              f"trace ({same})")
    print(f"{label}: N={rays.n_rays} M={scene.triangles.n_surfaces} "
          f"bounces={bounces} states[active,finished,stopped,dead]={states}",
          flush=True)
    return med, states


def state_counts(state):
    import torch

    return torch.bincount(state.long(), minlength=4).tolist()


def guide2d_backward(device):
    """The busiest K2 call of phase 14's backward: one forward and backward
    of the 2D guide design (``scenes2d.guide_design``) under
    ``TraceConfig.recommended``, every K2 call recorded, and of those at
    the ``guide2d_backward`` case's (m, k) the one whose rays carry the
    most nonzero cotangents.  Returns its ``(ct, idx)`` and prints every
    such call's share of rays with a zero cotangent (a ray that hit no
    arc at that bounce).  The recorded calls run the kernel, whose
    launches count nowhere: the main paths reset the counts."""
    import torch

    from tensorflowraytrace_tpu_torch import TraceConfig, scenes2d
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    _, n, m, k, _ = next(c for c in SEGSUM_CASES if c[4] == "guide2d")
    loss, params, scene = scenes2d.guide_design(GUIDE2D_RAYS, device=device)
    cfg = TraceConfig.recommended(scene, max_bounces=scenes2d.GUIDE_BOUNCES,
                                  dead_ray_length=scenes2d.DEAD_RAY_LENGTH)
    kernel, live, best = sk.segment_sum_kernel, [], None

    def record(ct, idx, rows):
        nonlocal best
        if ct.shape == (k, n) and rows == m:
            hit = int((ct != 0).any(dim=0).sum())
            live.append(hit)
            if best is None or hit > best[0]:
                best = (hit, ct.detach().clone(), idx.clone())
        return kernel(ct, idx, rows)

    sk.segment_sum_kernel = record
    try:
        torch.autograd.grad(loss(params, cfg), params)
    finally:
        sk.segment_sum_kernel = kernel
    check(best is not None, f"phase 14's backward made no K2 call at "
          f"m={m} k={k} N={n}")
    zero = sorted(1 - h / n for h in live)
    print(f"K2 guide2d_backward: {len(live)} calls of phase 14's backward at "
          f"m={m} k={k}; rays with a zero cotangent min "
          f"{zero[0]:.4%} median {zero[len(zero) // 2]:.4%} max "
          f"{zero[-1]:.4%}; timed: the busiest call, {1 - best[0] / n:.4%} "
          f"zero", flush=True)
    return best[1], best[2]


def segsum_inputs(n, m, k, pattern, device, seed=0):
    """(k, N) float32 cotangents and (N,) int32 rows for phase 6."""
    import torch

    gen = torch.Generator(device).manual_seed(seed)
    ct = torch.randn((k, n), generator=gen, device=device)
    if pattern == "random":
        idx = torch.randint(0, m, (n,), generator=gen, device=device)
    elif pattern == "coherent":  # blocks of 100 rays on nearby rows
        base = torch.randint(0, m - 40, (n // 100 + 1,), generator=gen,
                             device=device).repeat_interleave(100)[:n]
        idx = base + torch.randint(0, 40, (n,), generator=gen, device=device)
    else:  # every ray on one row: the most contention
        idx = torch.full((n,), m // 2, device=device)
    return ct, idx.to(torch.int32)


def segsum_case(label, device, guide2d=None):
    """Phase 6's case ``label`` of ``SEGSUM_CASES``: ``(ct, idx, m)``; the
    "guide2d" case is ``guide2d``, of ``guide2d_backward``."""
    n, m, k, pattern = {c[0]: c[1:] for c in SEGSUM_CASES}[label]
    if pattern == "guide2d":
        return (*guide2d, m)
    return (*segsum_inputs(n, m, k, pattern, device), m)


def compare_k2(label, ct, idx, m, prefix="phase 6 K2", kernel=None):
    """K2 (or ``kernel``, with its arguments) against float64 index_add_
    (phase 6 criterion) on the (k, N) cotangents ``ct`` and rows ``idx``;
    returns max |K2 - ref64|.  These launches are comparisons."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    kernel = kernel or sk.segment_sum_kernel
    (k, n), device = ct.shape, ct.device
    got = kernel(ct, idx, m)
    again = kernel(ct, idx, m)
    torch.cuda.synchronize()
    ref64 = sk.segment_sum_plain(ct.double(), idx, m)
    scale = sk.segment_sum_plain(ct.double().abs(), idx, m)
    plain32 = sk.segment_sum_plain(ct, idx, m)
    err = (got.double() - ref64).abs()
    worst = float((err - (1e-5 * scale + 1e-7)).max())
    check(worst <= 0.0, f"K2 {label}: exceeds 1e-5 S + 1e-7 by {worst}")
    max_err = float(err.max())
    plain_err = float((plain32.double() - ref64).abs().max())
    print(f"{prefix} {label}: N={n} m={m} k={k} "
          f"branch={sk.branch(m, k, device)} max_abs_err={max_err} "
          f"max_rel_to_S={float((err / (scale + 1e-30)).max()):.3e} "
          f"plain_f32_max_abs_err={plain_err} "
          f"two_runs_bitwise_equal={torch.equal(got, again)}", flush=True)
    return max_err


def time_k2(ct, idx, m, reps=50, kernel=None):
    """K2's wrapper (or ``kernel``) on ``(ct, idx)``: ms a call by CUDA
    events, which count the host's issue when it is slower than the
    kernel, and by device time (its kernel alone, ``kernel_device_ms``)."""
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    kernel = kernel or sk.segment_sum_kernel

    def fn():
        return kernel(ct, idx, m)

    return cuda_ms(fn, reps), kernel_device_ms(fn, "segment_sum", reps)


def segsum_alone(device):
    """``--segsum-alone``: K2 at phase 6's timed shapes, each checked with
    phase 6's criterion, by CUDA events and by device time.  It calls
    ``segsum_kernels``' ``segment_sum_kernel`` and ``branch`` alone, whose
    arguments are the same in every version of the port: copied into the
    root of an earlier checkout, the script times that checkout's K2 the
    same way."""
    guide2d = guide2d_backward(device)
    for label in SEGSUM_TIMED:
        ct, idx, m = segsum_case(label, device, guide2d)
        compare_k2(label, ct, idx, m, prefix="K2 alone")
        ms, dev = time_k2(ct, idx, m)
        dev_ms = "not measured" if dev is None else f"{dev:.5f} ms"
        print(f"K2 alone {label}: kernel {ms:.5f} ms by CUDA events, "
              f"device time {dev_ms}", flush=True)


def segsum_variant_source(text, variant):
    """``segment_sum.cu``'s ``text`` with its shared branch's launch, its
    columns and its aggregation set as ``variant`` (of
    ``SEGSUM_VARIANTS``) says, or as it stands for None; each replaced
    piece must occur once."""
    import re

    def replace(pattern, value):
        nonlocal text
        text, count = re.subn(pattern, value, text, flags=re.DOTALL)
        check(count == 1, f"segment_sum.cu: {pattern!r} found {count} times")

    if variant is None:
        return text
    replace(r"(Launch shared_launch\(int k, int fit\) \{\n).*?\n\}",
            rf"\g<1>  return {{{variant['rays']}, {variant['min_blocks']}}};"
            "\n}")
    replace(r"constexpr int kCols = \d+;",
            f"constexpr int kCols = {variant['kCols']};")
    if not variant["aggregate"]:
        replace(r"__ballot_sync\(kFull, key >= 0 && key == beside\)",
                "__ballot_sync(kFull, false)")
    return text


def ptxas_summary(report):
    """Each kernel's registers and spills from ``-Xptxas -v`` output, as
    ``name: N registers, S bytes spill stores, L bytes spill loads`` joined
    by "; " (a template's arguments in the name's brackets)."""
    import re

    found, name = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '[^']*?(segment_sum_"
                          r"[a-z]+)(?:ILi(\d+)ELi(\d+)E)?E", line)
        if entry:
            name = entry[1] + (f"<{entry[2]},{entry[3]}>" if entry[2] else "")
            found[name] = {}
        elif name and "spill" in line:
            found[name]["spill"] = ", ".join(
                part.strip() for part in line.split(",")[1:])
        elif name and "Used" in line:
            found[name]["regs"] = re.search(r"Used (\d+) registers", line)[1]
    return "; ".join(f"{k}: {v.get('regs')} registers, {v.get('spill')}"
                     for k, v in found.items())


def segsum_variants(device):
    """``--tune``: K2 built from ``segment_sum.cu`` once for each of
    ``SEGSUM_VARIANTS`` (one nvcc each, started together, with ptxas'
    registers and spills printed), each checked with phase 6's criterion
    and timed at ``SEGSUM_TIMED`` by CUDA events and by device time, in
    the variants' order and then in reverse, so that a drift of the card
    shows."""
    import ctypes

    import torch

    from tensorflowraytrace_tpu_torch.ops import cuda_build
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    text = (cuda_build.CSRC_DIR / sk.SOURCE).read_text()
    folder = cuda_build.BUILD_DIR / "segsum_variants"
    folder.mkdir(parents=True, exist_ok=True)
    names, jobs = [], []
    for v in (None, *SEGSUM_VARIANTS):
        name = ("as built (shared_launch's choice)" if v is None else
                f"{v['rays']} rays a lane, {v['min_blocks']} blocks an SM, "
                f"{v['kCols']} columns, "
                f"{'aggregated' if v['aggregate'] else 'no aggregation'}")
        tag = ("built" if v is None else f"r{v['rays']}_b{v['min_blocks']}_"
               f"c{v['kCols']}_a{int(v['aggregate'])}")
        src, lib = folder / f"{tag}.cu", folder / f"{tag}.so"
        src.write_text(segsum_variant_source(text, v))
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(lib), str(src)]
        names.append(name)
        jobs.append((lib, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    kernels = []
    for name, (lib, cmd, proc) in zip(names, jobs):
        report = proc.communicate()[0]
        check(proc.returncode == 0, f"nvcc failed: {' '.join(cmd)}\n{report}")
        print(f"K2 variant {name}: ptxas {ptxas_summary(report)}",
              flush=True)
        clib = ctypes.CDLL(str(lib))
        clib.segment_sum_launch.argtypes = [ctypes.c_void_p] * 2 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        clib.segment_sum_launch.restype = ctypes.c_int

        def launch(ct, idx, m, clib=clib):
            k, n = ct.shape
            out = torch.zeros((m, k), dtype=torch.float32, device=ct.device)
            err = clib.segment_sum_launch(
                ct.data_ptr(), idx.data_ptr(), n, m, k, out.data_ptr(),
                torch.cuda.current_stream(ct.device).cuda_stream)
            check(err == 0, f"K2 variant launch: CUDA error {err}")
            return out

        kernels.append(launch)
    guide2d = guide2d_backward(device)
    for label in SEGSUM_TIMED:
        ct, idx, m = segsum_case(label, device, guide2d)
        for order in (range(len(names)), reversed(range(len(names)))):
            for i in order:
                compare_k2(f"{label}, {names[i]}", ct, idx, m,
                           prefix="K2 variant", kernel=kernels[i])
                ms, dev = time_k2(ct, idx, m, kernel=kernels[i])
                dev_ms = "not measured" if dev is None else f"{dev:.5f} ms"
                print(f"K2 variant {label}, {names[i]}: kernel {ms:.5f} ms "
                      f"by CUDA events, device time {dev_ms}", flush=True)


def phase_6(device):
    """K2 against float64 index_add_ at every case of ``SEGSUM_CASES`` and
    timed at ``SEGSUM_TIMED``; returns the timed cases' fields."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    guide2d = guide2d_backward(device)
    k2 = {}
    for label, n, m, k, _ in SEGSUM_CASES:
        ct, idx, m = segsum_case(label, device, guide2d)
        err = compare_k2(label, ct, idx, m)
        if label not in SEGSUM_TIMED:
            continue
        ct_t, idx_l = ct.T, idx.long()
        buf = torch.zeros((m, k), device=device)
        bytes_ms = 4 * (k * n + n + m * k) / PEAK_BYTES_S * 1e3
        ops_ms = k * n / PEAK_FP32_FLOP_S * 1e3
        k2[label] = f = {
            "n": n, "m": m, "k": k, "max_abs_err": err,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ms": cuda_ms(lambda: sk.segment_sum_kernel(ct, idx, m), 50),
            "plain_ms": cuda_ms(lambda: sk.segment_sum_plain(ct, idx, m), 50),
            "library_ms": cuda_ms(lambda: buf.index_add_(0, idx_l, ct_t), 50),
        }
        print(f"phase 6 K2 {label} timing: kernel {f['ms']:.5f} ms by CUDA "
              f"events (its device time after phase 14), plain "
              f"{f['plain_ms']:.5f} ms, index_add_ {f['library_ms']:.5f} ms, "
              f"bound {f['bound_ms']:.5f} ms ({f['bound_by']})", flush=True)
    return k2


def k2_device_times(k2, device):
    """Phase 6's timed cases again, K2's device time of each (``time_k2``)
    into ``k2``.  It runs after phase 14, so that no profiled run comes
    before the host-bound steps of phases 7 and 8."""
    guide2d = guide2d_backward(device)
    for label, f in k2.items():
        f["device_ms"] = time_k2(*segsum_case(label, device, guide2d))[1]
        dev_ms = ("not measured" if f["device_ms"] is None
                  else f"{f['device_ms']:.5f} ms")
        print(f"phase 6 K2 {label} device time: {dev_ms}", flush=True)


def device_profile(prof):
    """What a torch.profiler run recorded on the device: the time (us) of
    its kernels and copies summed by name, the union of their intervals
    (us), and their count."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name not in RANGES)
    by_name = collections.Counter()
    union, last = 0.0, None
    for a, b, name in spans:
        by_name[name] += b - a
        if last is None or a > last:
            union += b - a
            last = b
        elif b > last:
            union += b - last
            last = b
    return by_name, union, len(spans)


def kernel_device_ms(fn, name, reps=10):
    """Device time (ms a call) of the kernels whose name holds ``name`` that
    torch.profiler records over ``reps`` calls of ``fn`` after one: the
    kernels alone, without the gaps that CUDA events around back-to-back
    calls also count when a kernel is shorter than the host time that
    launches it.  Each kernel's mean span, summed over the kernels a call
    launches: the profiler may miss some spans of a run.  None when the
    profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name:
            spans[e.name].append(e.time_range.end - e.time_range.start)
    return (sum(sum(v) / len(v) for v in spans.values()) / 1e3 if spans
            else None)


def range_device_us(prof, label):
    """Device time (us) of the kernels launched inside the profiler ranges
    named ``label``."""
    import torch

    total = 0.0
    for e in prof.events():
        if e.name == label and e.device_type == torch.autograd.DeviceType.CPU:
            total += (e.device_time_total if hasattr(e, "device_time_total")
                      else e.cuda_time_total)
    return total


def count_syncs(fn):
    """The synchronising calls ``fn()`` makes, as torch's sync debug mode
    reports them."""
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_guide3d(label, kernel, rays, scene, materials, cfg, device):
    """One profiled trace of the 3D guide: the device-time split (the
    search kernel named ``kernel``, the candidate precompute, the re-sort,
    the rest), the idle share, kernels a bounce, peak memory and host
    synchronisations (which must be 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorflowraytrace_tpu_torch import trace

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    trace(rays, scene, materials, cfg)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trace(rays, scene, materials, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, union_us, n_device = device_profile(prof)
    busy_us = sum(by_name.values())
    if busy_us > 0:
        search_us = sum(t for k, t in by_name.items() if kernel in k)
        cand_us = range_device_us(prof, "twolevel_candidates")
        resort_us = range_device_us(prof, "resort_rays")
        rest_us = busy_us - search_us - cand_us - resort_us
        split = (f"device busy {union_us:.1f} us of {wall_us:.1f} us wall "
                 f"(idle share {1 - union_us / wall_us:.4f}); {n_device} "
                 f"kernels and copies ({n_device / cfg.max_bounces:.1f} a "
                 f"bounce), {busy_us:.1f} us: {kernel} {search_us:.1f} us "
                 f"({search_us / busy_us:.4%}), candidate precompute "
                 f"{cand_us:.1f} us ({cand_us / busy_us:.4%}), re-sort "
                 f"{resort_us:.1f} us ({resort_us / busy_us:.4%}), rest "
                 f"{rest_us:.1f} us ({rest_us / busy_us:.4%}); top: "
                 + "; ".join(f"{k[:50]} {t:.1f} us"
                             for k, t in by_name.most_common(5)))
    else:
        split = "the profiler recorded no device time: split not measured"
    syncs = count_syncs(lambda: trace(rays, scene, materials, cfg))
    print(f"phase 10 {label} profiled trace: {split}; peak device memory "
          f"{peak_gib:.3f} GiB; {syncs} synchronising calls", flush=True)
    check(syncs == 0, f"the guide {label} trace synchronised {syncs} times")


def first_bounce_3d(rays, tri):
    """A 3D search's arguments at a scene's first bounce, the rays in the
    Morton order the re-sort gives them: ``[p0, p1, vp, v1, v2]``."""
    import torch

    from tensorflowraytrace_tpu_torch.models.acceleration import (
        morton_codes_device,
    )

    lo = torch.minimum(tri.vp.amin(dim=0), tri.v2.amin(dim=0))
    hi = torch.maximum(tri.vp.amax(dim=0), tri.v2.amax(dim=0))
    order = torch.argsort(morton_codes_device(rays.p0, lo, hi), stable=True)
    return [t.contiguous() for t in (rays.p0[order], rays.p1[order], tri.vp,
                                     tri.v1, tri.v2)]


def tune_brute(device):
    """``--tune``: K1 alone at the unsorted soup's and the guide's first
    bounce (2^20 rays each) at each rays a thread it is compiled for,
    checked against each other bit for bit (``brute_rays_per_thread``
    takes 4 at both shapes)."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    rays, scene = soup_scene(BENCH_RAYS, device)
    tri = scene.triangles
    g_rays, g_scene = guide_scene(GUIDE_RAYS, device)
    cases = {"soup": [t.contiguous() for t in (rays.p0, rays.p1, tri.vp,
                                               tri.v1, tri.v2)],
             "guide": first_bounce_3d(g_rays, g_scene.triangles)}
    for name, args in cases.items():
        ref = tk.brute_launch(*args, EPS, EPS, EPS, rays_per_thread=1)
        for rpt in tk.BRUTE_RAYS_PER_THREAD:
            got = tk.brute_launch(*args, EPS, EPS, EPS, rays_per_thread=rpt)
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  f"tune K1 at {rpt} rays a thread differs on the {name}")
            ms = cuda_ms(lambda: tk.brute_launch(
                *args, EPS, EPS, EPS, rays_per_thread=rpt), 10)
            print(f"tune K1 alone at the {name}'s first bounce "
                  f"{args[0].shape[0]}x{args[2].shape[0]}: {rpt} rays a "
                  f"thread: kernel {ms:.4f} ms", flush=True)


def tune_twolevel(device):
    """``--tune``: K4 alone at the guide's first bounce at every ray block
    (checked against K1 bit for bit); then K4's ray block (cap 32) and its
    cap at the best block, on the guide (24 bounces) and the sorted soup (8 bounces) with ``cull="grid",
    resort_rays=True``: median of 3 traces after one, each checked against
    the brute trace bit for bit."""
    import torch

    from tensorflowraytrace_tpu_torch import TraceConfig, trace
    from tensorflowraytrace_tpu_torch.ops import materials as mats
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    scenes = {
        "guide": guide_scene(GUIDE_RAYS, device) + ((mats.vacuum, mats.acrylic),
                                                    GUIDE_BOUNCES),
        "soup": soup_scene(BENCH_RAYS, device, sort=True)
        + ((mats.vacuum, mats.reflective), BENCH_BOUNCES),
    }
    refs = {k: trace(r, sc, mt, TraceConfig(max_bounces=b, use_kernel=True)).rays
            for k, (r, sc, mt, b) in scenes.items()}

    # K4 alone at the guide's first bounce at each block
    args = first_bounce_3d(scenes["guide"][0], scenes["guide"][1].triangles)
    ref = tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
    m = args[2].shape[0]
    for rb in (64, 128, 256, 512, 1024):
        tk.TWOLEVEL_RAY_BLOCK = rb
        prepared = tk.twolevel_prepare(*args, EPS, EPS)
        got = tk.twolevel_launch(args[0], args[1], m, prepared, EPS, EPS, EPS)
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"tune K4 alone {rb} differs from K1")
        ms = cuda_ms(lambda: tk.twolevel_launch(args[0], args[1], m, prepared,
                                                EPS, EPS, EPS), 10)
        print(f"tune K4 alone at the guide's first bounce: ray_block={rb} "
              f"fine_chunk={tk.FINE_CHUNK} cap={prepared[4]}: kernel "
              f"{ms:.4f} ms, mean candidates "
              f"{float(prepared[2].float().mean()):.2f}", flush=True)
        del prepared, got
    del args, ref

    def run(rb, cap):
        tk.TWOLEVEL_RAY_BLOCK, tk.TWOLEVEL_MAX_CAND = rb, cap
        out = {}
        for k, (rays, scene, materials, bounces) in scenes.items():
            cfg = TraceConfig(max_bounces=bounces, use_kernel=True,
                              cull="grid", resort_rays=True)
            times = []
            for rep in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = trace(rays, scene, materials, cfg)
                torch.cuda.synchronize()
                if rep == 0:
                    check(torch.equal(res.rays.state, refs[k].state)
                          and torch.equal(res.rays.p1, refs[k].p1),
                          f"tune {k} {rb}/{cap} differs from brute")
                else:
                    times.append(time.perf_counter() - t0)
            out[k] = statistics.median(times)
        print(f"tune ray_block={rb} fine_chunk={tk.FINE_CHUNK} max_cand={cap}: "
              + ", ".join(f"{k} {t * 1e3:.3f} ms" for k, t in out.items()),
              flush=True)
        return out

    blocks = {rb: run(rb, 32) for rb in (64, 128, 256, 512, 1024)}
    rb = min(blocks, key=lambda key: blocks[key]["guide"])
    for cap in (8, 16, 64, 128):
        run(rb, cap)


# ----------------------------------------------------------------------
# phases 11-13: the 2D path
# ----------------------------------------------------------------------

# the 2D searches of each kind: variant -> (kernel, function-name suffix)
SEARCHES_2D = {"segment": {"brute": ("K5", ""), "culled": ("K7", "_culled"),
                           "twolevel": ("K9", "_twolevel")},
               "arc": {"brute": ("K6", ""), "culled": ("K8", "_culled"),
                       "twolevel": ("K10", "_twolevel")}}


def search_2d(kind, variant, plain=False, size_eps=EPS):
    """The wrapper (or plain version) of one 2D search (``variant`` brute,
    culled or twolevel) and its epsilons (``size_eps`` for segments)."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    mod, name, eps = ((gk, "segments", (EPS, size_eps, EPS))
                      if kind == "segment" else (ak, "arcs", (EPS, EPS)))
    suffix = SEARCHES_2D[kind][variant][1] + ("_plain" if plain else "_kernel")
    fn = getattr(mod, f"nearest_hit_{name}{suffix}")
    return lambda args: fn(*args, *eps)


def surface_args(p0, p1, surfaces):
    """A 2D search's tensor arguments: the rays and a SegmentSet's
    endpoints or an ArcSet's centre, angles and radius."""
    cols = (("p0", "p1") if hasattr(surfaces, "p0")
            else ("center", "angle_start", "angle_end", "radius"))
    return [t.detach().contiguous()
            for t in (p0, p1) + tuple(getattr(surfaces, c) for c in cols)]


def compare_2d(label, kind, args, variants=("brute", "culled", "twolevel"),
               size_eps=EPS):
    """The 2D kernels ``variants`` of ``kind`` against their plain versions
    and the brute kernel, bit for bit; returns ``(out, err)``: their outputs
    ``{variant: ...}`` and each one's max |u - u_plain| on rays both find
    valid.  These launches are comparisons, not the main path."""
    import torch

    variants = ("brute",) + tuple(v for v in variants if v != "brute")
    out = {c: search_2d(kind, c, size_eps=size_eps)(args) for c in variants}
    torch.cuda.synchronize()
    plain = {c: search_2d(kind, c, plain=True, size_eps=size_eps)(args)
             for c in variants}
    pairs = {f"{c} vs plain": (out[c], plain[c]) for c in variants}
    pairs.update({f"{c} vs brute": (out[c], out["brute"])
                  for c in variants[1:]})
    diffs = {k: int(sum((a != b).sum() for a, b in zip(x, y)))
             for k, (x, y) in pairs.items()}
    err = {}
    for c in out:
        both = out[c][0] & plain[c][0]
        err[c] = (float((out[c][2][both] - plain[c][2][both]).abs().max())
                  if both.any() else 0.0)
    print(f"{label} {kind}: N={args[0].shape[0]} M={args[2].shape[0]} "
          f"hits={int(out['brute'][0].sum())} elements differing: {diffs}; "
          f"max_abs_err {err}", flush=True)
    check(not any(diffs.values()), f"{kind} {label}: differs ({diffs})")
    return out, err


def phase_11(device):
    """K5-K10 against their plain versions and K7-K10 against K5/K6."""
    import numpy as np
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rng = np.random.default_rng(7)
    seg = scenes2d.random_segments(rng, CHECK_SEGMENTS, device=device)
    arc = scenes2d.random_arcs(rng, CHECK_ARCS, device=device)
    full = scenes2d.random_arcs(rng, 300, device=device, full=True)
    p0, p1 = scenes2d.random_rays(rng, CHECK_RAYS, device=device)
    far = torch.full_like(p0[:4096], 100.0)
    parked = torch.full_like(p0[:4096], 1e30)
    cases = [("sets", p0, p1, seg, arc),
             ("ragged", p0[:1000], p1[:1000], seg_slice(seg, 333),
              arc_slice(arc, 333)),
             ("one ray", p0[:1], p1[:1], seg_slice(seg, 257),
              arc_slice(arc, 257)),
             ("all-miss", far, far + 1.0, seg, arc),
             ("parked", parked, torch.full_like(parked, 1e30 * (1 + 1e-6)),
              seg, arc),
             ("full circles", p0, p1, None, full)]
    for label, r0, r1, s, a in cases:
        for kind, surfaces in (("segment", s), ("arc", a)):
            if surfaces is not None:
                out, _ = compare_2d(f"phase 11 {label}", kind,
                                    surface_args(r0, r1, surfaces))
                hits = bool(out["brute"][0].any())
                if label != "one ray":
                    check(hits == (label not in ("all-miss", "parked")),
                          f"{kind} {label}: hits {hits}")
    # K9 and K10 with every block of more than one candidate overflowing
    with override(gk, TWOLEVEL_MAX_CAND=1):
        for label, r0, r1, s, a in cases[:2]:
            for kind, surfaces in (("segment", s), ("arc", a)):
                compare_2d(f"phase 11 {label}, cap 1", kind,
                           surface_args(r0, r1, surfaces), ("twolevel",))
    # K6, K8 and K10 at the edges of their exact reject
    for label, r0, r1, a in scenes2d.arc_edge_cases(device=device):
        out, _ = compare_2d(f"phase 11 reject edge {label}", "arc",
                            surface_args(r0, r1, a))
        check(bool(out["brute"][0].any()) == (label != "parked"),
              f"arc reject edge {label}: hits")
    # hits at the edge of the boxes of the gates (K7-K10), the lists
    # overflowing (cap 1) too
    for label, r0, r1, s, size_eps in scenes2d.gate_edge_cases(device=device):
        kind = "segment" if hasattr(s, "p0") else "arc"
        for cap in (gk.TWOLEVEL_MAX_CAND, 1):
            with override(gk, TWOLEVEL_MAX_CAND=cap):
                out, _ = compare_2d(f"phase 11 gate edge {label}, cap {cap}",
                                    kind, surface_args(r0, r1, s),
                                    size_eps=size_eps)
        hits = label.split()[0] not in ("parked", "all-miss")
        check(bool(out["brute"][0].any()) == hits, f"gate edge {label}: hits")
    # blocks of which every ray, one ray or no ray needs a chunk, over a
    # ragged chunk and fewer than 256 surfaces, at K7's and K9/K10's blocks
    for m in (300, 100):
        for kind, make in (("segment", scenes2d.random_segments),
                           ("arc", scenes2d.random_arcs)):
            surfaces = make(rng, m, device=device)
            for block in sorted({gk.CULLED_RAY_BLOCK, gk.TWOLEVEL_RAY_BLOCK}):
                r0, r1 = scenes2d.block_rays(rng, surfaces, block,
                                             device=device)
                out, _ = compare_2d(f"phase 11 blocks of {block}, M={m}", kind,
                                    surface_args(r0, r1, surfaces))
                valid = out["brute"][0]
                check(bool(valid[:block].any())
                      and not bool(valid[block + 1:3 * block].any()),
                      f"blocks of {block}, {kind} M={m}: hits")


@contextlib.contextmanager
def override(mod, **values):
    """A context in which ``mod``'s attributes take ``values``."""
    old = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def seg_slice(seg, m):
    import dataclasses

    return dataclasses.replace(seg, p0=seg.p0[:m], p1=seg.p1[:m])


def arc_slice(arc, m):
    import dataclasses

    return dataclasses.replace(arc, center=arc.center[:m],
                               angle_start=arc.angle_start[:m],
                               angle_end=arc.angle_end[:m],
                               radius=arc.radius[:m])


def phase_12(device):
    """examples/optimize_single_arc.py through the kernels, then one step at
    bench width.  Returns the kernels' launches in the 80 steps."""
    import numpy as np
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.optim import Optimizer

    loss, params = scenes2d.single_arc(device=device, use_kernel=True)
    opt = Optimizer(loss, params, learning_rate=1.0, grad_clip=0.1,
                    pass_key=False)
    gk.LAUNCHES = ak.LAUNCHES = sk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errors = np.concatenate([
        opt.run_phase(ARC_STEPS[0], momentum=0.8),
        opt.run_phase(ARC_STEPS[1], lr_scale=0.1, momentum=0.9)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = sum(ARC_STEPS)
    launched = {"K5": gk.LAUNCHES, "K6": ak.LAUNCHES, "K2": sk.LAUNCHES}
    # two bounces a step; K2 is the backward of the arc table's gather (the
    # target segment's table has no gradient)
    check(launched == {"K5": 2 * steps, "K6": 2 * steps, "K2": 2 * steps},
          f"single-arc training launches {launched}")
    check(bool(np.all(np.isfinite(errors))), "single-arc errors not finite")
    check(all(bool(torch.isfinite(p).all()) for p in opt.parameters),
          "single-arc parameters not finite")
    check(errors[-1] < 0.05 * errors[0],
          f"single-arc error {errors[0]} -> {errors[-1]}, not below 5%")
    print(f"phase 12 single arc: {steps} steps in {train_s:.3f} s = "
          f"{train_s / steps * 1e3:.3f} ms/step; launches {launched}; error "
          f"{errors[0]!r} -> {errors[-1]!r} "
          f"({errors[-1] / errors[0]:.4%}); radius "
          f"{float(opt.parameters[0][0])!r}", flush=True)

    loss, params = scenes2d.single_arc(beam_count=ARC_WIDE_BEAM,
                                       device=device, use_kernel=True)
    opt = Optimizer(loss, params, learning_rate=1.0, grad_clip=0.1,
                    pass_key=False)
    opt.run_phase(1, momentum=0.8)  # warm-up
    step_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.run_phase(1, momentum=0.8)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    print(f"phase 12 bench-width step: {ARC_WIDE_BEAM * 6} rays, 2 bounces: "
          f"median {statistics.median(step_s) * 1e3:.3f} ms over 5 steps "
          f"{[round(t * 1e3, 3) for t in step_s]}", flush=True)
    return launched


def reset_2d_launches():
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    for mod in (gk, ak):
        mod.LAUNCHES = mod.LAUNCHES_CULLED = mod.LAUNCHES_TWOLEVEL = 0


def launches_2d():
    """The 2D search kernels' launch counts since the last reset."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    return {"K5": gk.LAUNCHES, "K6": ak.LAUNCHES, "K7": gk.LAUNCHES_CULLED,
            "K8": ak.LAUNCHES_CULLED, "K9": gk.LAUNCHES_TWOLEVEL,
            "K10": ak.LAUNCHES_TWOLEVEL}


def kernels_2d(cfg):
    """The segment and arc search kernels a 2D trace under ``cfg`` runs."""
    variant = ("twolevel" if cfg.cull == "grid" else
               "culled" if cfg.cull else "brute")
    return tuple(SEARCHES_2D[kind][variant][0] for kind in ("segment", "arc"))


def guide2d_configs(scene):
    from tensorflowraytrace_tpu_torch import scenes2d

    def cfg(**kw):
        return scenes2d.guide_config(scene, use_kernel=True, **kw)

    return {"brute": cfg(), "cull": cfg(cull=True),
            "cull+resort": cfg(cull=True, resort_rays=True),
            "grid": cfg(cull="grid"),
            "grid+resort": cfg(cull="grid", resort_rays=True)}


def guide2d_paths(rays, scene, materials, launched):
    """The 2D guide through brute, cull=True, cull=True + re-sort,
    cull="grid" and cull="grid" + re-sort: each accelerated path's final
    rays equal the brute path's bit for bit, each kernel launches once per
    bounce, median of 5 synchronised traces after one more.  Adds each
    kernel's launches to ``launched``."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d, trace

    bounces = scenes2d.GUIDE_BOUNCES
    cfgs = guide2d_configs(scene)
    times = {k: [] for k in cfgs}
    finals = {}
    for rep in range(6):  # rep 0 warms up and gives the results
        for name, cfg in cfgs.items():
            reset_2d_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = trace(rays, scene, materials, cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = launches_2d()
            want = {k: bounces if k in kernels_2d(cfg) else 0 for k in counts}
            check(counts == want, f"2D guide {name}: launches {counts}")
            for k, c in counts.items():
                launched[k] = launched.get(k, 0) + c
            if rep == 0:
                finals[name] = res.rays
            else:
                times[name].append(dt)
            del res
    ref = finals["brute"]
    check(bool(torch.isfinite(ref.p1).all()), "2D guide: non-finite endpoints")
    pairs = rays.n_rays * (scene.segments.n_surfaces
                           + scene.arcs.n_surfaces) * bounces
    med = {k: statistics.median(v) for k, v in times.items()}
    for name in cfgs:
        same = {f: torch.equal(getattr(finals[name], f), getattr(ref, f))
                for f in ("state", "p0", "p1")}
        print(f"phase 13 {name}: median {med[name] * 1e3:.3f} ms over 5 traces "
              f"{[round(t * 1e3, 3) for t in times[name]]} = "
              f"{pairs / med[name]:.4e} equivalent intersections/s; "
              f"bitwise equal to brute {same}", flush=True)
        check(all(same.values()), f"2D guide {name} differs from brute ({same})")
    print(f"phase 13 guide: N={rays.n_rays} M_seg={scene.segments.n_surfaces} "
          f"M_arc={scene.arcs.n_surfaces} bounces={bounces} "
          f"states[active,finished,stopped,dead]={state_counts(ref.state)}",
          flush=True)
    return med


def profile_guide2d(label, rays, scene, materials, cfg, device):
    """One profiled trace: the device-time split, idle share, peak memory
    and host synchronisations (which must be 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorflowraytrace_tpu_torch import trace

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    trace(rays, scene, materials, cfg)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trace(rays, scene, materials, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, union_us, n_device = device_profile(prof)
    busy_us = sum(by_name.values())
    if busy_us > 0:
        def busy(part):
            return sum(t for k, t in by_name.items() if part in k)

        seg_us = busy("segment_search")
        arc_us = busy("arc_search")
        cand_us = range_device_us(prof, "twolevel_candidates")
        resort_us = range_device_us(prof, "resort_rays")
        rest_us = busy_us - seg_us - arc_us - cand_us - resort_us
        split = (f"device busy {union_us:.1f} us of {wall_us:.1f} us wall "
                 f"(idle share {1 - union_us / wall_us:.4f}); {n_device} "
                 f"kernels and copies ({n_device / cfg.max_bounces:.1f} a "
                 f"bounce), {busy_us:.1f} us: segment search "
                 f"{seg_us:.1f} us ({seg_us / busy_us:.4%}), arc search "
                 f"{arc_us:.1f} us ({arc_us / busy_us:.4%}), candidate "
                 f"precompute {cand_us:.1f} us ({cand_us / busy_us:.4%}), "
                 f"re-sort {resort_us:.1f} us ({resort_us / busy_us:.4%}), "
                 f"rest {rest_us:.1f} us ({rest_us / busy_us:.4%}); top: "
                 + "; ".join(f"{k[:50]} {t:.1f} us"
                             for k, t in by_name.most_common(5)))
    else:
        split = "the profiler recorded no device time: split not measured"
    syncs = count_syncs(lambda: trace(rays, scene, materials, cfg))
    print(f"phase 13 {label} profiled trace: {split}; peak device memory "
          f"{peak_gib:.3f} GiB; {syncs} synchronising calls", flush=True)
    check(syncs == 0, f"the 2D guide {label} trace synchronised {syncs} times")


def phase_13(device):
    """The 2D light guide at full width; returns the kernels-line fields of
    K5-K10."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d
    from tensorflowraytrace_tpu_torch.models.acceleration import (
        chunk_aabbs_2d, chunk_aabbs_arcs,
    )
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rays, scene, materials = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    seg, arc = scene.segments, scene.arcs
    check((seg.n_surfaces, arc.n_surfaces) == (4098, 512),
          f"2D guide has {seg.n_surfaces} segments, {arc.n_surfaces} arcs")
    launched = {}
    guide2d_paths(rays, scene, materials, launched)
    cfgs = guide2d_configs(scene)
    for label in ("brute", "cull+resort", "grid+resort"):
        profile_guide2d(label, rays, scene, materials, cfgs[label], device)

    # K5-K10 alone at the first bounce, the rays in the re-sort's order
    p0, p1 = first_bounce_2d(rays, seg)
    n = p0.shape[0]
    fields = {}
    for kind, surfaces, boxes in (
            ("segment", seg, chunk_aabbs_2d(seg.p0, seg.p1, gk.CULL_CHUNK)),
            ("arc", arc, chunk_aabbs_arcs(arc.center, arc.angle_start,
                                          arc.angle_end, arc.radius,
                                          gk.CULL_CHUNK))):
        args = surface_args(p0, p1, surfaces)
        m = surfaces.n_surfaces
        out, err = compare_2d("phase 13 first bounce", kind, args)
        # bytes: the rays and the surface table read once, u / idx (/ branch)
        # written once
        surface_bytes = sum(a.numel() * 4 for a in args[2:])
        out_bytes = n * (9 if kind == "arc" else 8)
        bytes_ms = (n * 16 + surface_bytes + out_bytes) / PEAK_BYTES_S * 1e3
        u_final = out["brute"][2]
        gate_pairs = gate_box_pairs(kind, args, u_final)
        if kind == "segment":
            # every pair the same 14 operations; K7 and K9 share one bound,
            # the pairs these inputs need at 256-segment chunks
            culled = admitted_pairs(p0, p1, boxes, m, u_final, gk.CULL_CHUNK)
            work = {"brute": (n * m, n * m), "culled": (culled, culled)}
            flops = (SEG_FLOPS_PER_PAIR, SEG_FLOPS_PER_PAIR)
        else:
            # (pairs, of them past the exact reject), the others charged the
            # operations before it
            work = {"brute": (n * m, ak.admitted_arc_pairs(
                        p0, p1, arc.center, arc.radius, EPS)),
                    "culled": arc_work(p0, p1, boxes, arc, u_final)}
            flops = (ARC_REJECT_FLOPS, ARC_FLOPS_PER_PAIR)
        alone = alone_2d(kind, args, m)
        for variant, (key, _) in SEARCHES_2D[kind].items():
            pairs, past = work["brute" if variant == "brute" else "culled"]
            ops_ms = (((pairs - past) * flops[0] + past * flops[1])
                      / PEAK_FP32_FLOP_S * 1e3)
            prepare, launch = alone[variant]
            kernel = cuda_kernel_name(kind, variant)
            fn = search_2d(kind, variant)
            plain = search_2d(kind, variant, plain=True)
            prepared = prepare()
            fields[key] = f = {
                "launches": launched[key],
                "max_abs_err": err[variant],
                # the kernel alone, apart from its inputs' preparation
                "ms": cuda_ms(lambda: launch(prepared), 10),
                # its device time alone (CUPTI), without the host gaps the
                # events count when a kernel is shorter than its launch
                "device_ms": kernel_device_ms(lambda: launch(prepared),
                                              kernel),
                "wrapper_ms": cuda_ms(lambda: fn(args), 10),
                "prepare_ms": cuda_ms(prepare, 10),
                "plain_ms": cuda_ms(lambda: plain(args), 1),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                # every operation an instruction: the kernels are built
                # with --fmad=false, and the peak counts an FMA as two
                "floor_no_fma_ms": max(bytes_ms, 2 * ops_ms),
                "pairs": pairs,
                "shape": f"{n}x{m} (first bounce of the 2D guide)",
            }
            check(all(torch.equal(a, b) for a, b in
                      zip(launch(prepared), out[variant])),
                  f"{key} launched alone differs from its wrapper")
            if kind == "arc":
                flat_ms = pairs * ARC_FLOPS_PER_PAIR / PEAK_FP32_FLOP_S * 1e3
                f["pairs_past_reject"] = past
                f["flat_bound_ms"] = max(bytes_ms, flat_ms)
            detail = ""
            if variant != "brute":
                f["pairs_on_gate_boxes"] = gate_pairs
                detail += ("; pairs a per-ray gate admits on the boxes with "
                           f"the rounding margin alone {gate_pairs['margin']}"
                           f", on the boxes it gates on "
                           f"{gate_pairs['gate']}")
            if variant == "twolevel":
                f["prepare_split"] = split = prepare_split(kind, args)
                detail += "; its preparation " + ", ".join(
                    f"{k} {ev:.4f} ms by CUDA events, {host:.4f} ms of host "
                    f"time" for k, (ev, host) in split.items())
                counts = prepared[2]
                f["blocks"] = counts.shape[0]
                # a count of n_chunks is a sweep only when the cap is
                # below n_chunks; otherwise it lists every chunk
                n_chunks = prepared[1].shape[0]
                f["overflow_blocks"] = (int((counts == n_chunks).sum())
                                        if prepared[4] < n_chunks else 0)
                f["mean_candidates"] = float(counts.float().mean())
                detail += (f"; ray block {gk.TWOLEVEL_RAY_BLOCK}, chunk "
                           f"{gk.CULL_CHUNK}, cap {prepared[4]}: "
                           f"{f['blocks']} blocks, {f['overflow_blocks']} "
                           f"overflow, mean count "
                           f"{f['mean_candidates']:.2f} of {n_chunks}")
            if kind == "arc":
                detail += (f"; {past} pairs past the exact reject "
                           f"({past / pairs:.4%}), the others charged "
                           f"{flops[0]} flops; flat {ARC_FLOPS_PER_PAIR}-flop "
                           f"bound {f['flat_bound_ms']:.5f} ms")
            del prepared
            dev_ms = ("not measured" if f["device_ms"] is None
                      else f"{f['device_ms']:.4f} ms")
            print(f"phase 13 {key} alone at the first bounce {n}x{m}: kernel "
                  f"{f['ms']:.4f} ms (its device time {dev_ms}), its input "
                  f"preparation "
                  f"{f['prepare_ms']:.4f} ms, wrapper {f['wrapper_ms']:.4f} "
                  f"ms, plain {f['plain_ms']:.4f} ms, bound "
                  f"{f['bound_ms']:.5f} ms ({f['bound_by']}; {pairs} pairs, "
                  f"{pairs / (n * m):.4%} of brute; without FMAs "
                  f"{f['floor_no_fma_ms']:.5f} ms){detail}", flush=True)
    return fields


def cuda_kernel_name(kind, variant):
    """The name of the CUDA kernel (``__global__`` function) of a 2D
    search, as the profiler reports it: its source's stem + ``_kernel``."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    mod = gk if kind == "segment" else ak
    source = getattr(mod, {"brute": "SOURCE", "culled": "SOURCE_CULLED",
                           "twolevel": "SOURCE_TWOLEVEL"}[variant])
    return source.removesuffix(".cu") + "_kernel"


def gate_box_pairs(kind, args, u):
    """The ray-surface pairs a per-ray gate admits on these inputs
    (``admitted_pairs``, ``u`` the final hits) on two kinds of chunk box:
    ``margin``, the exact boxes with the rounding margin alone (K7's, K8's
    and K10's boxes before they had to hold every accepted point), and
    ``gate``, the boxes K7-K10 gate on (``segment_kernels.twolevel_boxes``
    at size_eps EPS, ``arc_kernels.twolevel_boxes``)."""
    from tensorflowraytrace_tpu_torch.models.acceleration import (
        chunk_aabbs_2d, chunk_aabbs_arcs,
    )
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    p0, p1, *surfaces = args
    if kind == "segment":
        exact = chunk_aabbs_2d(*surfaces, gk.CULL_CHUNK)
        gate = gk.twolevel_boxes(*surfaces, EPS)
    else:
        exact = chunk_aabbs_arcs(*surfaces, gk.CULL_CHUNK)
        gate = ak.twolevel_boxes(*surfaces)
    m = surfaces[0].shape[0]
    return {name: admitted_pairs(p0, p1, boxes, m, u, gk.CULL_CHUNK)
            for name, boxes in (("margin", tk.widen_boxes(exact, 0.0)),
                                ("gate", gate))}


def prepare_split(kind, args):
    """K9's or K10's input preparation in its three parts, the chunk-major
    table, the boxes and the candidate lists: ``{part: (ms by CUDA events,
    ms of host time to enqueue it)}``, each the mean of 10 calls after
    one."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    p0, p1, *surfaces = args
    if kind == "segment":
        table = lambda: gk.segment_chunk_table(*surfaces, gk.CULL_CHUNK)
        boxes = lambda: gk.twolevel_boxes(*surfaces, EPS).contiguous()
    else:
        table = lambda: ak.twolevel_table(*surfaces)
        boxes = lambda: ak.twolevel_boxes(*surfaces).contiguous()
    made = boxes()
    parts = {"table": table, "boxes": boxes,
             "lists": lambda: gk.twolevel_lists(p0, p1, made, EPS)}
    split = {}
    for name, fn in parts.items():
        events = cuda_ms(fn, 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        host = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        split[name] = (events, host)
    return split


def first_bounce_2d(rays, seg):
    """The 2D guide's rays at its first bounce in the Morton order the
    re-sort gives them over the segments' box: ``(p0, p1)``."""
    import torch

    from tensorflowraytrace_tpu_torch.models.acceleration import (
        morton_codes_device,
    )

    lo = torch.minimum(seg.p0.amin(dim=0), seg.p1.amin(dim=0))
    hi = torch.maximum(seg.p0.amax(dim=0), seg.p1.amax(dim=0))
    order = torch.argsort(morton_codes_device(rays.p0, lo, hi), stable=True)
    return rays.p0[order], rays.p1[order]


def arcs_alone(device):
    """``--arcs-alone``: K6 and K8 launched alone at the 2D guide's first
    bounce, apart from their table and boxes, each checked against the
    plain K6 bit for bit, by CUDA events (mean of 20 launches) and by
    device time.  It calls ``arc_kernels``' ``arc_table``,
    ``culled_prepare`` and ``_launch`` and the libraries' C entry points:
    K8's takes a ray block (``segment_kernels.CULLED_RAY_BLOCK``) where its
    declared signature has one (the earlier, warp-voting K8 has none), so
    copied into the root of an earlier checkout, the script times that
    checkout's kernels, on that checkout's boxes, the same way."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rays, scene, _ = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    p0, p1 = first_bounce_2d(rays, scene.segments)
    arcs = (scene.arcs.center, scene.arcs.angle_start, scene.arcs.angle_end,
            scene.arcs.radius)
    table = ak.arc_table(*arcs)
    boxes = ak.culled_prepare(*arcs)[1]
    n, m = p0.shape[0], table.shape[0]
    eps = (float(EPS), float(EPS))
    slack = (1.0 + ak._SLACK, 1.0 - ak._SLACK, ak._SLACK)
    k8 = ak.load_culled_library().arc_search_culled_launch
    block = (gk.CULLED_RAY_BLOCK,) if len(k8.argtypes) == 17 else ()
    launches = {
        "K6": lambda: ak._launch(
            ak.load_library().arc_search_launch, "arc_search", p0,
            (p0.data_ptr(), p1.data_ptr(), table.data_ptr(), n, m, *eps)),
        "K8": lambda: ak._launch(
            k8, "arc_search_culled", p0,
            (p0.data_ptr(), p1.data_ptr(), table.data_ptr(), boxes.data_ptr(),
             n, m, gk.CULL_CHUNK, *block, *eps, *slack)),
    }
    ref = ak.nearest_hit_arcs_plain(p0, p1, *arcs, EPS, EPS)
    kernels = {"K6": "arc_search_kernel", "K8": "arc_search_culled_kernel"}
    for key, launch in launches.items():
        check(all(torch.equal(a, b) for a, b in zip(launch(), ref)),
              f"{key} launched alone differs from the plain K6")
        dev = kernel_device_ms(launch, kernels[key])
        dev_ms = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"arcs alone {key} at the 2D guide's first bounce {n}x{m}: "
              f"kernel {cuda_ms(launch, 20):.4f} ms by CUDA events, device "
              f"time {dev_ms}"
              + (f"; ray block {block[0] if block else 256}"
                 if key == "K8" else ""), flush=True)


def alone_2d(kind, args, m):
    """Each 2D kernel of ``kind`` as ``{variant: (prepare, launch)}``: its
    inputs' preparation and its launch on them, the wrapper's two halves
    (K5's wrapper prepares nothing)."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    p0, p1, *surfaces = args
    if kind == "segment":
        eps = (EPS, EPS, EPS)
        return {
            "brute": (lambda: None, lambda _: gk.nearest_hit_segments_kernel(
                *args, *eps)),
            "culled": (lambda: gk.culled_prepare(*surfaces, EPS),
                       lambda prep: gk.culled_launch(p0, p1, prep, *eps)),
            "twolevel": (lambda: gk.twolevel_prepare(*args, EPS, EPS),
                         lambda prep: gk.twolevel_launch(p0, p1, m, prep,
                                                         *eps)),
        }
    return {
        "brute": (lambda: ak.prepare(*surfaces),
                  lambda prep: ak.launch(p0, p1, prep, EPS, EPS)),
        "culled": (lambda: ak.culled_prepare(*surfaces),
                   lambda prep: ak.culled_launch(p0, p1, prep, EPS, EPS)),
        "twolevel": (lambda: ak.twolevel_prepare(*args, EPS),
                     lambda prep: ak.twolevel_launch(p0, p1, m, prep, EPS,
                                                     EPS)),
    }


def arc_work(p0, p1, boxes, arc, u):
    """The ray-arc pairs K8 and K10 must compute on these inputs
    (``admitted_pairs`` at 256-arc chunks, ``boxes`` their boxes) and how
    many of them pass the exact reject (``arc_kernels.admitted_arc_pairs``)."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    chunk = gk.CULL_CHUNK
    o = [a[:, None] for a in p0.unbind(1)]
    inv = [a[:, None] for a in tk._inverse_direction(p1 - p0).unbind(1)]
    admitted = past = 0
    for c in range(boxes.shape[0]):
        box = boxes[c:c + 1].T
        rows = tk._slab_gate(o, inv, box[:2], box[2:], EPS,
                             u[:, None])[:, 0].nonzero()[:, 0]
        arcs = slice(c * chunk, (c + 1) * chunk)
        centre = arc.center[arcs]
        admitted += rows.numel() * centre.shape[0]
        past += ak.admitted_arc_pairs(p0[rows], p1[rows], centre,
                                      arc.radius[arcs], EPS)
    return admitted, past


def phase_14(device):
    """The 2D guide as a design problem under TraceConfig.recommended: one
    forward and backward pass with and without remat, then an early-exit
    trace.  Returns the search kernels' launches in the passes."""
    import dataclasses

    import torch

    from tensorflowraytrace_tpu_torch import TraceConfig, scenes2d, trace
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    bounces = scenes2d.GUIDE_BOUNCES
    loss, params, scene = scenes2d.guide_design(GUIDE2D_RAYS, device=device)
    cfg = TraceConfig.recommended(scene, max_bounces=bounces,
                                  dead_ray_length=scenes2d.DEAD_RAY_LENGTH)
    print(f"phase 14 recommended: {cfg}", flush=True)
    check(cfg.use_kernel and cfg.remat, f"recommended chose {cfg}")
    on_path = kernels_2d(cfg)

    def forward_backward(c):
        value = loss(params, c)
        return value.detach(), torch.autograd.grad(value, params)

    launched, result = {}, {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        forward_backward(c)  # warm-up
        reset_2d_launches()
        sk.LAUNCHES = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        result[remat] = forward_backward(c)
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
        counts = launches_2d()
        want = {k: bounces if k in on_path else 0 for k in counts}
        check(counts == want, f"phase 14 remat={remat}: search launches "
              f"{counts}, not {want}")
        for k in on_path:
            launched[k] = launched.get(k, 0) + counts[k]
        k2 = sk.LAUNCHES
        times = []
        for _ in range(DESIGN_PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward_backward(c)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        value, grads = result[remat]
        print(f"phase 14 remat={remat}: forward + backward median "
              f"{statistics.median(times) * 1e3:.3f} ms over {DESIGN_PASSES} "
              f"{[round(t * 1e3, 3) for t in times]}; peak device memory "
              f"{peak_gib:.3f} GiB; loss {float(value)!r}; max |g| centre "
              f"{float(grads[0].abs().max())!r} radius "
              f"{float(grads[1].abs().max())!r}; search launches "
              f"{ {k: counts[k] for k in on_path} }, K2 {k2}", flush=True)
    gmax = max(float(g.abs().max()) for g in result[False][1])
    gdiff = max(float((a - b).abs().max())
                for a, b in zip(result[True][1], result[False][1]))
    check(gmax > 0 and gdiff <= 1e-4 * gmax,
          f"remat gradient differs by {gdiff} (max {gmax})")
    print(f"phase 14 gradient: max |g_remat - g| = {gdiff!r}, max |g| = "
          f"{gmax!r}, ratio {gdiff / gmax:.3e}; loss remat "
          f"{float(result[True][0])!r}, without {float(result[False][0])!r}",
          flush=True)

    rays, scene, materials = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    with torch.no_grad():
        full = trace(rays, scene, materials, cfg)
        early_cfg = dataclasses.replace(cfg, early_exit=True)
        early = trace(rays, scene, materials, early_cfg)
        syncs = count_syncs(lambda: trace(rays, scene, materials, early_cfg))
    same = {f: torch.equal(getattr(early.rays, f), getattr(full.rays, f))
            for f in ("state", "p0", "p1")}
    print(f"phase 14 early_exit: {early.n_bounces} bounces of {bounces}; "
          f"states[active,finished,stopped,dead]="
          f"{state_counts(early.rays.state)}; bitwise equal to the "
          f"{bounces}-bounce trace {same}; {syncs} synchronising calls",
          flush=True)
    check(all(same.values()), f"early exit differs from the full trace {same}")
    return launched


def tune_culled_2d(device):
    """``--tune``: K7 and K8 at 128, 256, 512 and 1024 rays a block
    (``segment_kernels.CULLED_RAY_BLOCK``, which both read): alone at the
    2D guide's first bounce (checked against K5 and K6 bit for bit; K8 by
    CUDA events and by device time), then the 2D guide (50 bounces) with
    ``cull=True`` with and without the re-sort: median of 3 traces after
    one, each checked against the brute trace bit for bit, the brute
    trace's median beside them."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d, trace
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rays, scene, materials = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    cfgs = guide2d_configs(scene)
    ref = trace(rays, scene, materials, cfgs["brute"]).rays
    p0, p1 = first_bounce_2d(rays, scene.segments)
    args = surface_args(p0, p1, scene.segments)
    k5 = gk.nearest_hit_segments_kernel(*args, EPS, EPS, EPS)
    prepared = gk.culled_prepare(*args[2:], EPS)
    arcs = surface_args(p0, p1, scene.arcs)[2:]
    k6 = ak.nearest_hit_arcs_kernel(p0, p1, *arcs, EPS, EPS)
    arc_prepared = ak.culled_prepare(*arcs)
    for rb in (128, 256, 512, 1024):
        with override(gk, CULLED_RAY_BLOCK=rb):
            got = gk.culled_launch(p0, p1, prepared, EPS, EPS, EPS)
            check(all(torch.equal(a, b) for a, b in zip(got, k5)),
                  f"tune K7 alone {rb} differs from K5")
            ms = cuda_ms(lambda: gk.culled_launch(p0, p1, prepared, EPS, EPS,
                                                  EPS), 10)

            def k8():
                return ak.culled_launch(p0, p1, arc_prepared, EPS, EPS)

            check(all(torch.equal(a, b) for a, b in zip(k8(), k6)),
                  f"tune K8 alone {rb} differs from K6")
            k8_ms = cuda_ms(k8, 10)
            k8_dev = kernel_device_ms(k8, "arc_search_culled_kernel")
            out = {}
            for name in ("brute", "cull", "cull+resort"):
                times = []
                for rep in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = trace(rays, scene, materials, cfgs[name])
                    torch.cuda.synchronize()
                    if rep == 0:
                        check(torch.equal(res.rays.state, ref.state)
                              and torch.equal(res.rays.p1, ref.p1),
                              f"tune 2D {name} K7 block {rb} differs from "
                              "brute")
                    else:
                        times.append(time.perf_counter() - t0)
                out[name] = statistics.median(times)
        k8_dev = "not measured" if k8_dev is None else f"{k8_dev:.4f} ms"
        print(f"tune K7 and K8 ray_block={rb}: alone at the 2D guide's first "
              f"bounce K7 {ms:.4f} ms, K8 {k8_ms:.4f} ms by CUDA events "
              f"(device time {k8_dev}); 2D guide " + ", ".join(
                  f"{k} {t * 1e3:.3f} ms" for k, t in out.items()),
              flush=True)


def tune_twolevel_2d(device):
    """``--tune``: K9 alone at the 2D guide's first bounce at every ray
    block (checked against K5 bit for bit); then K9's and K10's ray block
    (cap 32), then their cap at the best block, on the 2D guide (50
    bounces) with ``cull="grid"`` with and without the re-sort: median of 3
    traces after one, each checked against the brute trace bit for bit; the
    brute trace's median, taken in the same process, is the yardstick."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d, trace
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rays, scene, materials = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    cfgs = guide2d_configs(scene)
    ref = trace(rays, scene, materials, cfgs["brute"]).rays

    # K9 alone at the first bounce at each block (the kernel takes up to
    # 1024 rays a block; the wrapper refuses more than K10's 512)
    p0, p1 = first_bounce_2d(rays, scene.segments)
    args = surface_args(p0, p1, scene.segments)
    m = scene.segments.n_surfaces
    k5 = gk.nearest_hit_segments_kernel(*args, EPS, EPS, EPS)
    block = gk.TWOLEVEL_RAY_BLOCK
    try:
        for rb in (128, 256, 512, 1024):
            gk.TWOLEVEL_RAY_BLOCK = rb
            prepared = gk.twolevel_prepare(*args, EPS, EPS)
            got = gk.twolevel_launch(p0, p1, m, prepared, EPS, EPS, EPS)
            check(all(torch.equal(a, b) for a, b in zip(got, k5)),
                  f"tune K9 alone {rb} differs from K5")
            ms = cuda_ms(lambda: gk.twolevel_launch(p0, p1, m, prepared, EPS,
                                                    EPS, EPS), 10)
            print(f"tune K9 alone at the 2D guide's first bounce: "
                  f"ray_block={rb} cap={prepared[4]}: kernel {ms:.4f} ms, "
                  f"mean candidates {float(prepared[2].float().mean()):.2f}",
                  flush=True)
            del prepared, got
    finally:
        gk.TWOLEVEL_RAY_BLOCK = block
    del args, k5

    def run(rb, cap):
        gk.TWOLEVEL_RAY_BLOCK, gk.TWOLEVEL_MAX_CAND = rb, cap
        out = {}
        for name in ("brute", "grid", "grid+resort"):
            times = []
            for rep in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = trace(rays, scene, materials, cfgs[name])
                torch.cuda.synchronize()
                if rep == 0:
                    check(torch.equal(res.rays.state, ref.state)
                          and torch.equal(res.rays.p1, ref.p1),
                          f"tune 2D {name} {rb}/{cap} differs from brute")
                else:
                    times.append(time.perf_counter() - t0)
            out[name] = statistics.median(times)
        print(f"tune 2D ray_block={rb} chunk={gk.CULL_CHUNK} max_cand={cap}: "
              + ", ".join(f"{k} {t * 1e3:.3f} ms" for k, t in out.items()),
              flush=True)
        return out

    blocks = {rb: run(rb, 32) for rb in (64, 128, 256, 512)}
    rb = min(blocks, key=lambda key: min(blocks[key].values()))
    for cap in (2, 4, 8, 16):
        run(rb, cap)


def main():
    import torch

    wall_t0 = time.perf_counter()
    # ---- phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    device = card()
    print(f"phase 1 device: nvidia-smi: {smi} | torch: {kind} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # imported only now: a directory holding this script alone fails here
    import numpy as np

    from tensorflowraytrace_tpu_torch import FINISHED, Scene3D, TraceConfig, trace
    from tensorflowraytrace_tpu_torch import flagship
    from tensorflowraytrace_tpu_torch.engine import start_epsilon
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import cuda_build
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
    from tensorflowraytrace_tpu_torch.ops import materials as mats
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
    from tensorflowraytrace_tpu_torch.optim import Optimizer

    # ---- phase 2: build, one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = [tk.SOURCE, tk.SOURCE_CULLED, tk.SOURCE_TWOLEVEL, sk.SOURCE,
               gk.SOURCE, gk.SOURCE_CULLED, gk.SOURCE_TWOLEVEL, ak.SOURCE,
               ak.SOURCE_CULLED, ak.SOURCE_TWOLEVEL]
    reports = cuda_build.build(sources, verbose=True)
    for source, report in reports.items():
        print(f"phase 2 nvcc {source}:\n{report.strip()}", flush=True)
    for mod in (tk, gk, ak):
        mod.load_library()
        mod.load_culled_library()
        mod.load_twolevel_library()
    sk.load_library()
    print(f"phase 2 build: "
          + " ".join(cuda_build.library_path(s).name for s in sources)
          + f" in {time.perf_counter() - t0:.2f} s", flush=True)
    if "--tune" in sys.argv[1:]:
        segsum_variants(device)
        tune_brute(device)
        tune_twolevel(device)
        tune_culled_2d(device)
        tune_twolevel_2d(device)
        return 0
    if "--arcs-alone" in sys.argv[1:]:
        arcs_alone(device)
        return 0
    if "--segsum-alone" in sys.argv[1:]:
        segsum_alone(device)
        return 0

    # ---- phase 3: K1 against its plain version
    rays, scene = soup_scene(K1_RAYS, device)
    tri = scene.triangles
    check(tri.n_surfaces == N_SOUP_TRIS + 2, "soup size")
    k1_err = compare_k1("soup", rays.p0, rays.p1, tri.vp, tri.v1, tri.v2)
    compare_k1("ragged", rays.p0[:1000], rays.p1[:1000], tri.vp[:333],
               tri.v1[:333], tri.v2[:333])
    far = torch.full_like(rays.p0[:4096], 1000.0)
    compare_k1("all-miss", far, far + 1.0, tri.vp, tri.v1, tri.v2)
    f_lens, f_source, _ = flagship._flagship(
        torch.float32, 32, 8, 4, True, device)
    f_rays = f_source.sample(torch.Generator(device=device).manual_seed(0),
                             torch.float32, device)
    f_tri = Scene3D.build(optical=f_lens.build(),
                          targets=[flagship.target_plane(torch.float32,
                                                         device)]).triangles
    compare_k1("flagship", f_rays.p0, f_rays.p1, f_tri.vp, f_tri.v1, f_tri.v2)
    # every third ray parked (p0 = 1e30, as the engine parks terminated
    # rays), the count cut to no multiple of a block's rays
    for label, r0, r1, t, n_cut in (
            ("flagship", f_rays.p0, f_rays.p1, f_tri, 1021),
            ("soup", rays.p0, rays.p1, tri, K1_RAYS - 37)):
        third = (torch.arange(r0.shape[0], device=device) % 3 == 0)[:, None]
        q0 = torch.where(third, torch.full_like(r0, 1e30), r0)
        q1 = torch.where(third, torch.full_like(r1, 1e30 * (1 + 1e-6)), r1)
        compare_k1(f"{label} parked and ragged", q0[:n_cut], q1[:n_cut],
                   t.vp, t.v1, t.v2)
    parked = torch.full_like(rays.p0[:4096], 1e30)
    compare_k1("parked", parked, torch.full_like(parked, 1e30 * (1 + 1e-6)),
               tri.vp, tri.v1, tri.v2)

    # K3 and K4 against their plain versions and K1
    rays, scene = soup_scene(K1_RAYS, device, sort=True)
    tri = scene.triangles
    compare_culled("sorted soup", rays.p0, rays.p1, tri.vp, tri.v1, tri.v2)
    g_rays, g_scene = guide_scene(GUIDE_RAYS, device)
    g_tri = g_scene.triangles
    check(g_tri.n_surfaces == 16386, f"guide has {g_tri.n_surfaces} triangles")
    compare_culled("guide first bounce", g_rays.p0[:CULL_RAYS],
                   g_rays.p1[:CULL_RAYS], g_tri.vp, g_tri.v1, g_tri.v2)
    compare_culled("ragged", rays.p0[:1000], rays.p1[:1000], tri.vp[:333],
                   tri.v1[:333], tri.v2[:333])
    far = torch.full_like(rays.p0[:4096], 1000.0)
    compare_culled("all-miss", far, far + 1.0, tri.vp, tri.v1, tri.v2)
    parked = torch.full_like(rays.p0[:4096], 1e30)
    compare_culled("parked", parked,
                   torch.full_like(parked, 1e30 * (1 + 1e-6)), tri.vp, tri.v1,
                   tri.v2)
    cap, tk.TWOLEVEL_MAX_CAND = tk.TWOLEVEL_MAX_CAND, 1  # every block sweeps
    try:
        compare_culled("forced overflow", g_rays.p0[:CULL_RAYS],
                       g_rays.p1[:CULL_RAYS], g_tri.vp, g_tri.v1, g_tri.v2)
    finally:
        tk.TWOLEVEL_MAX_CAND = cap
    del rays, scene, tri

    # ---- phase 4: the flagship forward, through the kernel
    forward, (params, generator) = flagship.entry(device=device)
    tk.LAUNCHES = 0
    loss = forward(params, generator)
    torch.cuda.synchronize()
    forward_launches = tk.LAUNCHES
    check(forward_launches == 4,
          f"flagship launched the kernel {forward_launches} times, not 4")
    check(bool(torch.isfinite(loss)), f"flagship loss is {loss.item()}")
    loss.backward()
    check(all(bool(torch.isfinite(p.grad).all()) for p in params),
          "flagship gradient is not finite")
    forward_p, (params_p, generator_p) = flagship.entry(device=device,
                                                        use_kernel=False)
    loss_p = forward_p(params_p, generator_p)
    rel = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
    check(rel <= 1e-4, f"flagship loss {loss.item()} vs plain {loss_p.item()}")
    print(f"phase 4 flagship: loss={loss.item()!r} plain_loss={loss_p.item()!r} "
          f"rel_diff={rel:.3e} launches={forward_launches}", flush=True)

    # ---- phase 5: the bench-scale trace
    rays, scene = soup_scene(BENCH_RAYS, device)
    n, m = rays.n_rays, scene.triangles.n_surfaces
    materials = (mats.vacuum, mats.reflective)
    cfgs = {"kernel": TraceConfig(max_bounces=BENCH_BOUNCES, use_kernel=True),
            "plain": TraceConfig(max_bounces=BENCH_BOUNCES)}
    times = {k: [] for k in cfgs}
    counts = {}
    tk.LAUNCHES = 0
    for rep in range(6):  # rep 0 warms up and gives the state counts
        for name, cfg in cfgs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = trace(rays, scene, materials, cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if rep == 0:
                counts[name] = state_counts(res.rays.state)
                check(bool(torch.isfinite(res.rays.p1).all()),
                      f"{name} trace has non-finite endpoints")
            else:
                times[name].append(dt)
    check(tk.LAUNCHES == 6 * BENCH_BOUNCES,
          f"bench trace launched the kernel {tk.LAUNCHES} times")
    worst = max(abs(a - b) for a, b in zip(counts["kernel"], counts["plain"]))
    check(worst <= 1e-3 * n,
          f"state counts differ: kernel {counts['kernel']} plain {counts['plain']}")
    pairs = n * m * BENCH_BOUNCES
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"phase 5 trace: N={n} M={m} bounces={BENCH_BOUNCES} "
          f"states[active,finished,stopped,dead] kernel={counts['kernel']} "
          f"plain={counts['plain']} finished={counts['kernel'][FINISHED]}",
          flush=True)
    for k in cfgs:
        print(f"phase 5 {k} path: median {med[k] * 1e3:.3f} ms over 5 runs "
              f"{[round(t * 1e3, 3) for t in times[k]]} = "
              f"{pairs / med[k]:.4e} intersections/s", flush=True)

    # K1 alone at the bench shape (the first bounce's search)
    args = [t.contiguous() for t in (rays.p0, rays.p1, scene.triangles.vp,
                                     scene.triangles.v1, scene.triangles.v2)]
    k1_ms = cuda_ms(lambda: tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS), 20)
    k1_plain_ms = cuda_ms(lambda: tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS), 3)
    k1_flat_ms, k1_bound_ms, k1_tu_out = k1_bounds(*args)
    rpt = tk.brute_rays_per_thread(n, device)
    branch, ray_half = k1_branch_shares(*args, rpt)
    print(f"phase 5 K1 search {n}x{m}: kernel {k1_ms:.4f} ms at "
          f"{rpt} rays a thread (its branch taken on {branch:.4%} of "
          f"(warp, triangle) steps, a ray's second half run on "
          f"{ray_half:.4%}), plain "
          f"{k1_plain_ms:.4f} ms; bound {k1_bound_ms:.4f} ms (operations; "
          f"{k1_tu_out} of {n * m} pairs, {k1_tu_out / (n * m):.4%}, out on "
          f"tu; without FMAs {2 * k1_bound_ms:.4f} ms), flat "
          f"{K1_FLOPS_PER_PAIR}-operation bound {k1_flat_ms:.4f} ms (without "
          f"FMAs {2 * k1_flat_ms:.4f} ms)", flush=True)
    del rays, scene, res, args

    # ---- phase 6: K2 against float64 index_add_
    k2 = phase_6(device)

    # ---- phase 7: the flagship's training routine, example scale
    tk.LAUNCHES = sk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errors, trained = flagship.train(steps=TRAIN_STEPS, bp_count=TRAIN_BP,
                                     mesh_steps=TRAIN_RINGS,
                                     max_bounces=TRAIN_BOUNCES, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {"K1": tk.LAUNCHES, "K2": sk.LAUNCHES}
    for name, count in train_launches.items():
        check(count == TRAIN_BOUNCES * TRAIN_STEPS,
              f"training launched {name} {count} times, not "
              f"{TRAIN_BOUNCES} per step")
    check(len(errors) == TRAIN_STEPS and np.all(np.isfinite(errors)),
          "training errors are not finite")
    check(all(bool(torch.isfinite(p).all()) for p in trained),
          "trained parameters are not finite")
    first, last = float(np.mean(errors[:10])), float(np.mean(errors[-10:]))
    check(last < first, f"training error did not fall: {first} -> {last}")
    print(f"phase 7 train: {TRAIN_STEPS} steps of {TRAIN_BP ** 2} rays, "
          f"{TRAIN_BOUNCES} bounces, in {train_s:.3f} s = "
          f"{train_s / TRAIN_STEPS * 1e3:.3f} ms/step; launches "
          f"{train_launches}; mean error first 10 {first!r} last 10 {last!r}",
          flush=True)
    print("phase 7 error every 10 steps: "
          + " ".join(f"{i}:{errors[i]:.6g}" for i in range(0, TRAIN_STEPS, 10))
          + f" {TRAIN_STEPS - 1}:{errors[-1]:.6g}", flush=True)

    # ---- phase 8: one training step at bench width
    f32 = torch.float32
    vum, acc, smoother = flagship.training_tools(TRAIN_RINGS)
    lens, source, wide_loss = flagship._flagship(
        f32, WIDE_BP, TRAIN_RINGS, TRAIN_BOUNCES, True, device, vum)

    def error(params, gen):
        return wide_loss(params, source.sample(gen, f32, device))

    opt = Optimizer(error, lens.init_params(), learning_rate=1.0,
                    grad_clip=1e-3,
                    generator=torch.Generator(device).manual_seed(0))
    accs = [torch.as_tensor(acc, dtype=f32, device=device)] * 2
    smoothers = [torch.as_tensor(smoother, dtype=f32, device=device)] * 2

    def step():
        return opt.run_phase(1, accs, lr_scale=1.0, momentum=0.8,
                             smoothers=smoothers)

    step()  # warm-up
    step_s = []
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    step_med = statistics.median(step_s)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    by_name, union_us, n_device = device_profile(prof)
    busy_us = sum(by_name.values())

    def busy(part):
        return sum(t for name, t in by_name.items() if part in name)

    if busy_us > 0:
        shares = (f"device busy {union_us:.1f} us of {prof_wall_us:.1f} us wall "
                  f"(idle share {1 - union_us / prof_wall_us:.4f}); "
                  f"{n_device} kernels and copies, {busy_us:.1f} us; K2 "
                  f"{busy('segment_sum'):.1f} us = "
                  f"{busy('segment_sum') / busy_us:.4%}, K1 "
                  f"{busy('triangle_search'):.1f} us = "
                  f"{busy('triangle_search') / busy_us:.4%}; top: "
                  + "; ".join(f"{name[:60]} {t:.1f} us"
                              for name, t in by_name.most_common(6)))
    else:
        shares = "the profiler recorded no device time: shares not measured"

    # host synchronisations in one step (the step's final read of its error
    # is one of them) and in the ray sampling it starts with
    syncs = count_syncs(step)
    sample_syncs = count_syncs(lambda: source.sample(opt.generator, f32, device))

    # the gradient through K2 against the plain backward of the same forward
    rays = source.sample(torch.Generator(device).manual_seed(1), f32, device)

    def value_and_grad():
        leaves = [p.detach().clone().requires_grad_(True) for p in opt.parameters]
        value = wide_loss(leaves, rays)
        return value.detach(), torch.autograd.grad(value, leaves)

    sk.LAUNCHES = 0
    loss_k, grad_k = value_and_grad()
    check(sk.LAUNCHES == TRAIN_BOUNCES, f"K2 launched {sk.LAUNCHES} times")
    kernel_backward = sk.segment_sum_kernel
    sk.segment_sum_kernel = sk.segment_sum_plain  # the same forward, plain backward
    try:
        loss_p, grad_p = value_and_grad()
    finally:
        sk.segment_sum_kernel = kernel_backward
    check(sk.LAUNCHES == TRAIN_BOUNCES, "the plain backward launched K2")
    gmax = max(float(g.abs().max()) for g in grad_p)
    gdiff = max(float((a - b).abs().max()) for a, b in zip(grad_k, grad_p))
    check(gmax > 0 and gdiff <= 1e-4 * gmax,
          f"K2 gradient differs from the plain backward by {gdiff} (max {gmax})")
    _, _, plain_loss = flagship._flagship(f32, WIDE_BP, TRAIN_RINGS,
                                          TRAIN_BOUNCES, False, device, vum)
    with torch.no_grad():
        loss_all_plain = plain_loss(opt.parameters, rays)
    rel = abs(float(loss_k) - float(loss_all_plain)) / abs(float(loss_all_plain))
    check(rel <= 1e-4, f"bench-width loss {float(loss_k)} vs all-plain "
          f"{float(loss_all_plain)}")
    print(f"phase 8 bench-width step: {WIDE_BP ** 2} rays, {TRAIN_BOUNCES} "
          f"bounces: median {step_med * 1e3:.3f} ms over 5 steps "
          f"{[round(t * 1e3, 3) for t in step_s]}; peak device memory "
          f"{peak_gib:.3f} GiB; {syncs} synchronising calls per step, "
          f"{sample_syncs} of them in the ray sampling; "
          f"{shares}", flush=True)
    print(f"phase 8 gradient: max |g_K2 - g_plain| = {gdiff!r}, max |g_plain| "
          f"= {gmax!r}, ratio {gdiff / gmax:.3e}; loss {float(loss_k)!r}, "
          f"all-plain loss {float(loss_all_plain)!r}, rel {rel:.3e}", flush=True)

    # ---- phase 9: the sorted soup through the accelerated paths
    launched = {}
    rays, scene = soup_scene(BENCH_RAYS, device, sort=True)
    soup_med, _ = accel_paths("phase 9 soup", rays, scene,
                              (mats.vacuum, mats.reflective), BENCH_BOUNCES,
                              launched)
    del rays, scene

    # ---- phase 10: the structured guide, children starting the card's
    # float32 ray_start_epsilon past their surface (TraceConfig.recommended)
    g_mats = (mats.vacuum, mats.acrylic)
    g_med, g_states = accel_paths("phase 10 guide", g_rays, g_scene, g_mats,
                                  GUIDE_BOUNCES, launched)
    n, m = g_rays.n_rays, g_tri.n_surfaces
    print(f"phase 10 ray_start_epsilon {start_epsilon(g_scene)!r}; table "
          "(median ms per "
          "trace): " + "; ".join(f"{k}: soup {soup_med[k] * 1e3:.3f}, guide "
                                 f"{g_med[k] * 1e3:.3f}" for k in g_med),
          flush=True)

    # K1, K3 and K4 alone at the guide's first bounce, the rays in the
    # Morton order the re-sort gives them
    args = first_bounce_3d(g_rays, g_tri)
    k1_out = tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
    u_final = k1_out[2]
    brute_bound_ms = n * m * K1_FLOPS_PER_PAIR / PEAK_FP32_FLOP_S * 1e3
    # K4's kernel alone, after its inputs are prepared
    prepared = tk.twolevel_prepare(*args, EPS, EPS)
    k4_kernel_ms = cuda_ms(lambda: tk.twolevel_launch(
        args[0], args[1], m, prepared, EPS, EPS, EPS), 10)
    prepare_ms = cuda_ms(lambda: tk.twolevel_prepare(*args, EPS, EPS), 10)
    counts = prepared[2]
    print(f"phase 10 K4 at the first bounce: kernel alone {k4_kernel_ms:.4f} "
          f"ms, its input preparation (boxes, candidates, table) "
          f"{prepare_ms:.4f} ms; ray block {tk.TWOLEVEL_RAY_BLOCK}, fine "
          f"chunk {tk.FINE_CHUNK}, cap {prepared[4]}: {counts.shape[0]} "
          f"blocks, {int((counts == prepared[1].shape[0]).sum())} overflow, "
          f"mean count {float(counts.float().mean()):.2f}", flush=True)
    del prepared, counts
    k1_guide_ms = cuda_ms(
        lambda: tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS), 10)
    _, k1_guide_bound_ms, k1_guide_tu_out = k1_bounds(*args)
    rpt = tk.brute_rays_per_thread(n, device)
    branch, ray_half = k1_branch_shares(*args, rpt)
    print(f"phase 10 K1 alone at the first bounce {n}x{m}: kernel "
          f"{k1_guide_ms:.4f} ms at {rpt} rays a thread (its branch taken "
          f"on {branch:.4%} of (warp, triangle) steps, a ray's second half "
          f"run on {ray_half:.4%}); bound {k1_guide_bound_ms:.4f} ms "
          f"(operations; "
          f"{k1_guide_tu_out} of {n * m} pairs, "
          f"{k1_guide_tu_out / (n * m):.4%}, out on tu; without FMAs "
          f"{2 * k1_guide_bound_ms:.4f} ms), flat {K1_FLOPS_PER_PAIR}-"
          f"operation bound {brute_bound_ms:.4f} ms (without FMAs "
          f"{2 * brute_bound_ms:.4f} ms)", flush=True)
    # one bound for K3 and K4: the pairs these inputs need, at the finer of
    # their chunks, those refused on tu at their cost so far
    bound_chunk = min(tk.CULL_CHUNK, tk.FINE_CHUNK)
    pairs, tu_out = triangle_pairs(*args, u_final, bound_chunk)
    culled_bound_ms = ((pairs - tu_out) * K1_FLOPS_PER_PAIR
                       + tu_out * TU_FLOPS_PER_PAIR) / PEAK_FP32_FLOP_S * 1e3
    alone = {}
    for name, fn, plain in (
            ("K3", tk.nearest_hit_triangles_culled_kernel,
             tk.nearest_hit_triangles_culled_plain),
            ("K4", tk.nearest_hit_triangles_twolevel_kernel,
             tk.nearest_hit_triangles_twolevel_plain)):
        out = {}
        ms = cuda_ms(lambda: out.update(got=fn(*args, EPS, EPS, EPS)), 10)
        plain_ms = cuda_ms(lambda: out.update(plain=plain(*args, EPS, EPS, EPS)),
                           1)
        err, report = culled_agreement(name, out["got"], out["plain"], k1_out)
        alone[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
        print(f"phase 10 {name} alone at the first bounce {n}x{m}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms; {report}; admitted "
              f"pairs {pairs} at {bound_chunk}-triangle chunks "
              f"({pairs / (n * m):.4%} of brute; {tu_out / pairs:.4%} of "
              f"them out on tu), bound "
              f"{culled_bound_ms:.4f} ms (operations; without FMAs "
              f"{2 * culled_bound_ms:.4f} ms; brute bound "
              f"{brute_bound_ms:.4f} ms)", flush=True)
    del args, u_final, k1_out, out

    # the cull=True + re-sort trace (recommended's) and the grid + re-sort
    # trace: device time, memory and syncs
    g_cfgs = accel_configs(GUIDE_BOUNCES, g_scene)
    for label, kernel in (("cull+resort", "triangle_search_culled"),
                          ("grid+resort", "triangle_search_twolevel")):
        profile_guide3d(label, kernel, g_rays, g_scene, g_mats, g_cfgs[label],
                        device)

    # ---- phases 11-14: the 2D path
    phase_11(device)
    arc_train = phase_12(device)
    k2d = phase_13(device)
    design = phase_14(device)
    k2_device_times(k2, device)

    main_k2 = k2["flagship_bench"]
    print(f"chip_smoke wall time {time.perf_counter() - wall_t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "triangle_search", "route": "cuda",
        "source": "tensorflowraytrace_tpu_torch/csrc/triangle_search.cu",
        "replaces": "tensorflowraytrace_tpu/ops/pallas_kernels.py:76",
        "launches": train_launches["K1"], "launches_forward": forward_launches,
        "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound_ms, "bound_by": "operations", "library_ms": None,
        "floor_no_fma_ms": 2 * k1_bound_ms, "pairs_out_on_tu": k1_tu_out,
        "flat_bound_ms": k1_flat_ms, "flat_floor_no_fma_ms": 2 * k1_flat_ms,
        "shape": f"{BENCH_RAYS}x{N_SOUP_TRIS + 2}",
        "guide_ms": k1_guide_ms, "guide_bound_ms": k1_guide_bound_ms,
        "guide_flat_bound_ms": brute_bound_ms,
        "guide_pairs_out_on_tu": k1_guide_tu_out,
        "guide_shape": f"{n}x{m} (first bounce of the guide)",
    }, {
        "name": "segment_sum", "route": "cuda",
        "source": "tensorflowraytrace_tpu_torch/csrc/segment_sum.cu",
        "replaces": "tensorflowraytrace_tpu/ops/pallas_kernels.py:1664",
        "launches": train_launches["K2"],
        "max_abs_err": main_k2["max_abs_err"], "ms": main_k2["ms"],
        "device_ms": main_k2["device_ms"],
        "plain_ms": main_k2["plain_ms"], "bound_ms": main_k2["bound_ms"],
        "bound_by": main_k2["bound_by"], "library_ms": main_k2["library_ms"],
        "shape": f"{main_k2['k']}x{main_k2['n']}->{main_k2['m']}x"
                 f"{main_k2['k']}",
        "timed": {label: {key: f[key] for key in (
            "n", "m", "k", "ms", "device_ms", "plain_ms", "library_ms",
            "bound_ms", "max_abs_err")} for label, f in k2.items()},
    }] + [{
        "name": name, "route": "cuda",
        "source": f"tensorflowraytrace_tpu_torch/csrc/{source}",
        "replaces": f"tensorflowraytrace_tpu/ops/pallas_kernels.py:{line}",
        "launches": launched[key], "max_abs_err": alone[key]["max_abs_err"],
        "ms": k4_kernel_ms if key == "K4" else alone[key]["ms"],
        "wrapper_ms": alone[key]["ms"], "plain_ms": alone[key]["plain_ms"],
        "bound_ms": culled_bound_ms, "bound_by": "operations",
        "floor_no_fma_ms": 2 * culled_bound_ms,
        "brute_bound_ms": brute_bound_ms, "library_ms": None,
        "shape": f"{n}x{m} (first bounce of the guide)",
        "pairs": pairs, "pairs_out_on_tu": tu_out,
    } for name, source, line, key in (
        ("triangle_search_culled", tk.SOURCE_CULLED, 144, "K3"),
        ("triangle_search_twolevel", tk.SOURCE_TWOLEVEL, 979, "K4"))] + [{
        "name": name, "route": "cuda",
        "source": f"tensorflowraytrace_tpu_torch/csrc/{source}",
        "replaces": f"tensorflowraytrace_tpu/ops/pallas_kernels.py:{line}",
        **k2d[key], "library_ms": None,
        **({"launches_training": arc_train[key]} if key in arc_train else {}),
        **({"launches_design": design[key]} if key in design else {}),
    } for name, source, line, key in (
        ("segment_search", gk.SOURCE, 705, "K5"),
        ("arc_search", ak.SOURCE, 367, "K6"),
        ("segment_search_culled", gk.SOURCE_CULLED, 745, "K7"),
        ("arc_search_culled", ak.SOURCE_CULLED, 454, "K8"),
        ("segment_search_twolevel", gk.SOURCE_TWOLEVEL, 1230, "K9"),
        ("arc_search_twolevel", ak.SOURCE_TWOLEVEL, 1322, "K10"))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
