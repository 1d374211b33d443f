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
3. K1 against its plain PyTorch version on the card: the random soup of
   bench.py (seed 0: 4094 random triangles plus the 2-triangle target quad)
   with 131072 rays, the flagship's first-bounce search, a ragged tile
   (1000 rays x 333 triangles) and a batch that misses everything.
   Criteria of tests/test_pallas.py: equal ``valid``, ``ray_u`` within
   rtol 1e-5 where valid, > 99% equal ``idx``.  Then K3 (culled) and K4
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
   0.1% of N; median of 5 synchronised runs of each.
6. K2 (the segment sum) against float64 ``index_add_`` at the flagship's,
   the soup's and ragged shapes, with k = 13: elementwise
   ``|K2 - ref64| <= 1e-5 S + 1e-7``, ``S[j] = sum over idx[i] == j of
   |ct[:, i]|``; K2, its plain version and ``index_add_`` timed by CUDA
   events at (2^20, 770) and (2^20, 4096).
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
   same five paths, checked and timed as in phase 9, with equivalent
   intersections/s N M B / t.  Then K1, K3 and K4 alone at its first
   bounce (2^20 rays x 16386 triangles), the rays in the re-sort's Morton
   order: K3 and K4 bit for bit against their plain versions and K1 at
   that shape, their times and plain times, and one bound for both, the
   work these inputs need (pairs admitted at 256-triangle chunks); K4's
   kernel also alone, apart from the preparation of its inputs;
   one ``cull="grid", resort_rays=True`` trace under torch.profiler (K4,
   the candidate precompute, the re-sort and the rest of the device time,
   and the idle share), its peak memory and its host synchronisations.

11. the 2D searches: K5 (segments) and K6 (arcs) against their plain
   versions, and K7 and K8 (culled) and K9 and K10 (two-level) against
   theirs and against K5 and K6, all bit for bit, on
   examples/tpu_kernel_check.py's sets (seed 7: 777 random segments and 555
   random arcs with signed radii and sweeps of 0.3-5.8 rad, Morton-sorted)
   against 200000 rays, a ragged tile (1000 rays x 333 surfaces), 1 ray x
   257 surfaces, an all-miss batch, a batch of parked rays and full-circle
   arcs; then the sets and the ragged tile again with K9's and K10's
   candidate cap forced to 1, so that their blocks overflow and sweep.
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
   against their plain versions, kernel and plain times by CUDA events
   (K9 and K10 also apart from their inputs' preparation), and each
   kernel's bound.
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

``python3 chip_smoke.py --tune`` runs phases 1 and 2 and then sweeps K4's
ray block and candidate cap (the fine chunk is compiled into the kernel)
on the guide and the sorted soup, and K9's and K10's on the 2D guide
(median of 3 traces each, every setting checked against the brute trace),
and prints no result line.
"""

import collections
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

# phase 6: (label, rays N, table rows m, idx pattern)
SEGSUM_K = 13
SEGSUM_CASES = [
    ("flagship_example", 2025, 770, "random"),
    ("flagship_bench", 1 << 20, 770, "random"),
    ("soup", 1 << 20, 4096, "random"),
    ("global_random", 5000, 16386, "random"),
    ("global_coherent", 5000, 16386, "coherent"),
    ("one_row", 1 << 20, 770, "same"),
    ("ragged_1x1", 1, 1, "random"),
    ("ragged", 1000, 333, "random"),
]
SEGSUM_TIMED = ("flagship_bench", "soup", "one_row")

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

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
# FP32 operations of one ray-triangle pair in K1: two cross products
# (2 x 9), two dot products against P (2 x 6 with the scaling by inv),
# det (5), T (3), u (6), 1/det (1), tu + tv (1)
K1_FLOPS_PER_PAIR = 46
# one ray-segment pair in K5 (search2d::search_segments): den (3), 1/den
# (1), ray_u (6), seg_u (6)
SEG_FLOPS_PER_PAIR = 16
# one ray-arc pair in K6 (search2d::search_arcs): the scaled coordinates
# (6), a (3), b (4), the discriminant (6), 2a and its reciprocal (2), the
# square root (1), the two roots (4), the window test of each root (2 x 12)
ARC_FLOPS_PER_PAIR = 50

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
    """Kernel against plain on the same tensors; returns max |du| on valid
    rays.  These launches are comparisons, not the main path."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    args = [t.detach().contiguous() for t in (p0, p1, vp, v1, v2)]
    valid, idx, u = tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
    torch.cuda.synchronize()
    rv, ri, ru = tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS)
    check(torch.equal(valid, rv), f"{label}: valid differs from the plain version")
    if rv.any():
        torch.testing.assert_close(u[rv], ru[rv], rtol=1e-5, atol=0)
        agree = (idx[rv] == ri[rv]).double().mean().item()
        check(agree > 0.99, f"{label}: idx agrees on only {agree:.4%}")
        err = (u[rv] - ru[rv]).abs().max().item()
    else:
        agree, err = 1.0, 0.0
    bitwise = torch.equal(u, ru) and torch.equal(idx, ri)
    print(f"phase 3 K1 {label}: N={args[0].shape[0]} M={args[2].shape[0]} "
          f"hits={int(rv.sum())} idx_agree={agree:.6f} max_abs_err={err} "
          f"bitwise_equal={bitwise}", flush=True)
    return err


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


def accel_paths(label, rays, scene, materials, bounces, launched):
    """The four search paths of one scene: the final state and endpoints of
    every accelerated path against the brute path's, bit for bit, each
    kernel once per bounce, and the median of 5 synchronised traces after
    one more.  Adds each kernel's launches to ``launched``; returns the
    medians (s) and the state counts."""
    import torch

    from tensorflowraytrace_tpu_torch import TraceConfig, trace
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    cfgs = {
        "brute": TraceConfig(max_bounces=bounces, use_kernel=True),
        "cull": TraceConfig(max_bounces=bounces, use_kernel=True, cull=True),
        "grid": TraceConfig(max_bounces=bounces, use_kernel=True, cull="grid"),
        "grid+resort": TraceConfig(max_bounces=bounces, use_kernel=True,
                                   cull="grid", resort_rays=True),
        "cull+resort": TraceConfig(max_bounces=bounces, use_kernel=True,
                                   cull=True, resort_rays=True),
    }
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


def segsum_inputs(n, m, pattern, device, seed=0):
    """(k, N) float32 cotangents and (N,) int32 rows for phase 6."""
    import torch

    gen = torch.Generator(device).manual_seed(seed)
    ct = torch.randn((SEGSUM_K, n), generator=gen, device=device)
    if pattern == "random":
        idx = torch.randint(0, m, (n,), generator=gen, device=device)
    elif pattern == "coherent":  # blocks of 100 rays on nearby rows
        base = torch.randint(0, m - 40, (n // 100 + 1,), generator=gen,
                             device=device).repeat_interleave(100)[:n]
        idx = base + torch.randint(0, 40, (n,), generator=gen, device=device)
    else:  # every ray on one row: the most contention
        idx = torch.full((n,), m // 2, device=device)
    return ct, idx.to(torch.int32)


def compare_k2(label, n, m, pattern, device):
    """K2 against float64 index_add_ (phase 6 criterion); returns
    (max |K2 - ref64|, ct, idx).  These launches are comparisons."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    ct, idx = segsum_inputs(n, m, pattern, device)
    got = sk.segment_sum_kernel(ct, idx, m)
    again = sk.segment_sum_kernel(ct, idx, m)
    torch.cuda.synchronize()
    ref64 = sk.segment_sum_plain(ct.double(), idx, m)
    scale = sk.segment_sum_plain(ct.double().abs(), idx, m)
    plain32 = sk.segment_sum_plain(ct, idx, m)
    err = (got.double() - ref64).abs()
    worst = float((err - (1e-5 * scale + 1e-7)).max())
    check(worst <= 0.0, f"K2 {label}: exceeds 1e-5 S + 1e-7 by {worst}")
    max_err = float(err.max())
    plain_err = float((plain32.double() - ref64).abs().max())
    print(f"phase 6 K2 {label}: N={n} m={m} k={SEGSUM_K} idx={pattern} "
          f"branch={sk.branch(m, SEGSUM_K, device)} max_abs_err={max_err} "
          f"max_rel_to_S={float((err / (scale + 1e-30)).max()):.3e} "
          f"plain_f32_max_abs_err={plain_err} "
          f"two_runs_bitwise_equal={torch.equal(got, again)}", flush=True)
    return max_err, ct, idx


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


def tune_twolevel(device):
    """``--tune``: K4's ray block (cap 32), then its cap at the best block,
    at the compiled fine chunk, on the guide (24 bounces) and the sorted
    soup (8 bounces) with ``cull="grid", resort_rays=True``: median of 3
    traces after one, each checked against the brute trace bit for bit."""
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


def search_2d(kind, variant, plain=False):
    """The wrapper (or plain version) of one 2D search (``variant`` brute,
    culled or twolevel) and its epsilons."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    mod, name, eps = ((gk, "segments", (EPS, EPS, EPS)) if kind == "segment"
                      else (ak, "arcs", (EPS, EPS)))
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


def compare_2d(label, kind, args, variants=("brute", "culled", "twolevel")):
    """The 2D kernels ``variants`` of ``kind`` against their plain versions
    and the brute kernel, bit for bit; returns ``(out, err)``: their outputs
    ``{variant: ...}`` and each one's max |u - u_plain| on rays both find
    valid.  These launches are comparisons, not the main path."""
    import torch

    variants = ("brute",) + tuple(v for v in variants if v != "brute")
    out = {c: search_2d(kind, c)(args) for c in variants}
    torch.cuda.synchronize()
    plain = {c: search_2d(kind, c, plain=True)(args) for c in variants}
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
    """K5-K8 against their plain versions and K7/K8 against K5/K6."""
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
    cap, gk.TWOLEVEL_MAX_CAND = gk.TWOLEVEL_MAX_CAND, 1
    try:
        for label, r0, r1, s, a in cases[:2]:
            for kind, surfaces in (("segment", s), ("arc", a)):
                compare_2d(f"phase 11 {label}, cap 1", kind,
                           surface_args(r0, r1, surfaces), ("twolevel",))
    finally:
        gk.TWOLEVEL_MAX_CAND = cap


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


def guide2d_configs():
    from tensorflowraytrace_tpu_torch import scenes2d

    return {"brute": scenes2d.guide_config(use_kernel=True),
            "cull": scenes2d.guide_config(use_kernel=True, cull=True),
            "cull+resort": scenes2d.guide_config(use_kernel=True, cull=True,
                                                 resort_rays=True),
            "grid": scenes2d.guide_config(use_kernel=True, cull="grid"),
            "grid+resort": scenes2d.guide_config(use_kernel=True, cull="grid",
                                                 resort_rays=True)}


def guide2d_paths(rays, scene, materials, launched):
    """The 2D guide through brute, cull=True, cull=True + re-sort,
    cull="grid" and cull="grid" + re-sort: each accelerated path's final
    rays equal the brute path's bit for bit, each kernel launches once per
    bounce, median of 5 synchronised traces after one more.  Adds each
    kernel's launches to ``launched``."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d, trace

    bounces = scenes2d.GUIDE_BOUNCES
    cfgs = guide2d_configs()
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
        chunk_aabbs_2d, chunk_aabbs_arcs, morton_codes_device,
    )
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rays, scene, materials = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    seg, arc = scene.segments, scene.arcs
    check((seg.n_surfaces, arc.n_surfaces) == (4098, 512),
          f"2D guide has {seg.n_surfaces} segments, {arc.n_surfaces} arcs")
    launched = {}
    guide2d_paths(rays, scene, materials, launched)
    cfgs = guide2d_configs()
    for label in ("brute", "cull+resort", "grid+resort"):
        profile_guide2d(label, rays, scene, materials, cfgs[label], device)

    # K5-K10 alone at the first bounce, the rays in the re-sort's order
    lo = torch.minimum(seg.p0.amin(dim=0), seg.p1.amin(dim=0))
    hi = torch.maximum(seg.p0.amax(dim=0), seg.p1.amax(dim=0))
    order = torch.argsort(morton_codes_device(rays.p0, lo, hi), stable=True)
    p0, p1 = rays.p0[order], rays.p1[order]
    n = p0.shape[0]
    fields = {}
    for kind, surfaces, flops, boxes in (
            ("segment", seg, SEG_FLOPS_PER_PAIR,
             chunk_aabbs_2d(seg.p0, seg.p1, gk.CULL_CHUNK)),
            ("arc", arc, ARC_FLOPS_PER_PAIR,
             chunk_aabbs_arcs(arc.center, arc.angle_start, arc.angle_end,
                              arc.radius, gk.CULL_CHUNK))):
        args = surface_args(p0, p1, surfaces)
        m = surfaces.n_surfaces
        out, err = compare_2d("phase 13 first bounce", kind, args)
        # bytes: the rays and the surface table read once, u / idx (/ branch)
        # written once
        surface_bytes = sum(a.numel() * 4 for a in args[2:])
        out_bytes = n * (9 if kind == "arc" else 8)
        bytes_ms = (n * 16 + surface_bytes + out_bytes) / PEAK_BYTES_S * 1e3
        pairs = admitted_pairs(p0, p1, boxes, m, out["brute"][2],
                               gk.CULL_CHUNK)
        for variant, (key, _) in SEARCHES_2D[kind].items():
            # K7-K10 share one bound: the pairs these inputs need at
            # 256-surface chunks
            work = n * m if variant == "brute" else pairs
            ops_ms = work * flops / PEAK_FP32_FLOP_S * 1e3
            fn = search_2d(kind, variant)
            plain = search_2d(kind, variant, plain=True)
            fields[key] = {
                "launches": launched[key],
                "max_abs_err": err[variant],
                "ms": cuda_ms(lambda: fn(args), 10),
                "plain_ms": cuda_ms(lambda: plain(args), 1),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                "pairs": work,
                "shape": f"{n}x{m} (first bounce of the 2D guide)",
            }
            f = fields[key]
            if variant == "twolevel":
                # the kernel alone, apart from its inputs' preparation
                mod = gk if kind == "segment" else ak
                eps = (EPS,) * (3 if kind == "segment" else 2)
                prepared = mod.twolevel_prepare(*args, EPS)
                f["wrapper_ms"] = f["ms"]
                f["ms"] = cuda_ms(lambda: mod.twolevel_launch(
                    args[0], args[1], m, prepared, *eps), 10)
                f["prepare_ms"] = cuda_ms(
                    lambda: mod.twolevel_prepare(*args, EPS), 10)
                counts = prepared[2]
                f["blocks"] = counts.shape[0]
                # a count of n_chunks is a sweep only when the cap is
                # below n_chunks; otherwise it lists every chunk
                n_chunks = prepared[1].shape[0]
                f["overflow_blocks"] = (int((counts == n_chunks).sum())
                                        if prepared[4] < n_chunks else 0)
                f["mean_candidates"] = float(counts.float().mean())
                print(f"phase 13 {key} at the first bounce: kernel alone "
                      f"{f['ms']:.4f} ms, its input preparation (table, "
                      f"boxes, candidates) {f['prepare_ms']:.4f} ms, wrapper "
                      f"{f['wrapper_ms']:.4f} ms; ray block "
                      f"{gk.TWOLEVEL_RAY_BLOCK}, chunk {gk.CULL_CHUNK}, cap "
                      f"{prepared[4]}: {f['blocks']} blocks, "
                      f"{f['overflow_blocks']} overflow, mean count "
                      f"{f['mean_candidates']:.2f} of {prepared[1].shape[0]}",
                      flush=True)
                del prepared, counts
            print(f"phase 13 {key} alone at the first bounce {n}x{m}: kernel "
                  f"{f['ms']:.4f} ms, plain {f['plain_ms']:.4f} ms, bound "
                  f"{f['bound_ms']:.5f} ms ({f['bound_by']}; {work} pairs, "
                  f"{work / (n * m):.4%} of brute, {flops} flops each)",
                  flush=True)
    return fields


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


def tune_twolevel_2d(device):
    """``--tune``: K9's and K10's ray block (cap 32), then their cap at the
    best block, on the 2D guide (50 bounces) with ``cull="grid"`` with and
    without the re-sort: median of 3 traces after one, each checked against
    the brute trace bit for bit; the brute trace's median, taken in the
    same process, is the yardstick."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d, trace
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rays, scene, materials = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    cfgs = guide2d_configs()
    ref = trace(rays, scene, materials, cfgs["brute"]).rays

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
    from tensorflowraytrace_tpu_torch.models.acceleration import (
        chunk_aabbs, morton_codes_device,
    )
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
        tune_twolevel(device)
        tune_twolevel_2d(device)
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
    k1_bound_ms = n * m * K1_FLOPS_PER_PAIR / PEAK_FP32_FLOP_S * 1e3
    print(f"phase 5 K1 search {n}x{m}: kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.4f} ms, bound {k1_bound_ms:.4f} ms (operations)",
          flush=True)
    del rays, scene, res, args

    # ---- phase 6: K2 against float64 index_add_
    k2 = {}
    for label, n, m, pattern in SEGSUM_CASES:
        err, ct, idx = compare_k2(label, n, m, pattern, device)
        if label not in SEGSUM_TIMED:
            continue
        ct_t, idx_l = ct.T, idx.long()
        buf = torch.zeros((m, SEGSUM_K), device=device)
        bytes_ms = 4 * (SEGSUM_K * n + n + m * SEGSUM_K) / PEAK_BYTES_S * 1e3
        ops_ms = SEGSUM_K * n / PEAK_FP32_FLOP_S * 1e3
        k2[label] = {
            "n": n, "m": m, "max_abs_err": err,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ms": cuda_ms(lambda: sk.segment_sum_kernel(ct, idx, m), 50),
            "plain_ms": cuda_ms(lambda: sk.segment_sum_plain(ct, idx, m), 50),
            "library_ms": cuda_ms(lambda: buf.index_add_(0, idx_l, ct_t), 50),
        }
        print(f"phase 6 K2 {label} timing: kernel {k2[label]['ms']:.5f} ms, "
              f"plain {k2[label]['plain_ms']:.5f} ms, index_add_ "
              f"{k2[label]['library_ms']:.5f} ms, bound "
              f"{k2[label]['bound_ms']:.5f} ms ({k2[label]['bound_by']})",
              flush=True)

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

    # ---- phase 10: the structured guide
    g_mats = (mats.vacuum, mats.acrylic)
    g_med, g_states = accel_paths("phase 10 guide", g_rays, g_scene, g_mats,
                                  GUIDE_BOUNCES, launched)
    n, m = g_rays.n_rays, g_tri.n_surfaces
    print("phase 10 table (median ms per trace): "
          + "; ".join(f"{k}: soup {soup_med[k] * 1e3:.3f}, guide "
                      f"{g_med[k] * 1e3:.3f}" for k in g_med), flush=True)

    # K1, K3 and K4 alone at the guide's first bounce, the rays in the
    # Morton order the re-sort gives them
    lo = torch.minimum(g_tri.vp.amin(dim=0), g_tri.v2.amin(dim=0))
    hi = torch.maximum(g_tri.vp.amax(dim=0), g_tri.v2.amax(dim=0))
    order = torch.argsort(morton_codes_device(g_rays.p0, lo, hi), stable=True)
    args = [t.contiguous() for t in (g_rays.p0[order], g_rays.p1[order],
                                     g_tri.vp, g_tri.v1, g_tri.v2)]
    k1_out = tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
    u_final = k1_out[2]
    brute_bound_ms = n * m * K1_FLOPS_PER_PAIR / PEAK_FP32_FLOP_S * 1e3
    # K4's kernel alone, after its inputs are prepared
    prepared = tk.twolevel_prepare(*args, EPS)
    k4_kernel_ms = cuda_ms(lambda: tk.twolevel_launch(
        args[0], args[1], m, prepared, EPS, EPS, EPS), 10)
    prepare_ms = cuda_ms(lambda: tk.twolevel_prepare(*args, EPS), 10)
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
    print(f"phase 10 K1 alone at the first bounce {n}x{m}: kernel "
          f"{k1_guide_ms:.4f} ms, bound {brute_bound_ms:.4f} ms (operations)",
          flush=True)
    # one bound for K3 and K4: the pairs these inputs need, at the finer of
    # their chunks
    bound_chunk = min(tk.CULL_CHUNK, tk.FINE_CHUNK)
    pairs = admitted_pairs(args[0], args[1],
                           chunk_aabbs(*args[2:], bound_chunk), m, u_final,
                           bound_chunk)
    culled_bound_ms = pairs * K1_FLOPS_PER_PAIR / PEAK_FP32_FLOP_S * 1e3
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
              f"({pairs / (n * m):.4%} of brute), bound "
              f"{culled_bound_ms:.4f} ms (operations; brute bound "
              f"{brute_bound_ms:.4f} ms)", flush=True)
    del args, u_final, k1_out, out

    # one grid + resort trace: its device time, memory and syncs
    g_cfg = TraceConfig(max_bounces=GUIDE_BOUNCES, use_kernel=True,
                        cull="grid", resort_rays=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    trace(g_rays, g_scene, g_mats, g_cfg)
    torch.cuda.synchronize()
    g_peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trace(g_rays, g_scene, g_mats, g_cfg)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    by_name, union_us, n_device = device_profile(prof)
    busy_us = sum(by_name.values())
    if busy_us > 0:
        k4_us = sum(t for k, t in by_name.items()
                    if "triangle_search_twolevel" in k)
        cand_us = range_device_us(prof, "twolevel_candidates")
        resort_us = range_device_us(prof, "resort_rays")
        rest_us = busy_us - k4_us - cand_us - resort_us
        split = (f"device busy {union_us:.1f} us of {prof_wall_us:.1f} us "
                 f"wall (idle share {1 - union_us / prof_wall_us:.4f}); "
                 f"{n_device} kernels and copies, {busy_us:.1f} us: K4 "
                 f"{k4_us:.1f} us ({k4_us / busy_us:.4%}), candidate "
                 f"precompute {cand_us:.1f} us ({cand_us / busy_us:.4%}), "
                 f"re-sort {resort_us:.1f} us ({resort_us / busy_us:.4%}), "
                 f"rest {rest_us:.1f} us ({rest_us / busy_us:.4%}); top: "
                 + "; ".join(f"{k[:50]} {t:.1f} us"
                             for k, t in by_name.most_common(5)))
    else:
        split = "the profiler recorded no device time: split not measured"
    g_syncs = count_syncs(lambda: trace(g_rays, g_scene, g_mats, g_cfg))
    print(f"phase 10 grid+resort trace: {split}; peak device memory "
          f"{g_peak_gib:.3f} GiB; {g_syncs} synchronising calls", flush=True)
    check(g_syncs == 0, f"the guide trace synchronised {g_syncs} times")

    # ---- phases 11-14: the 2D path
    phase_11(device)
    arc_train = phase_12(device)
    k2d = phase_13(device)
    design = phase_14(device)

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
        "shape": f"{BENCH_RAYS}x{N_SOUP_TRIS + 2}",
    }, {
        "name": "segment_sum", "route": "cuda",
        "source": "tensorflowraytrace_tpu_torch/csrc/segment_sum.cu",
        "replaces": "tensorflowraytrace_tpu/ops/pallas_kernels.py:1664",
        "launches": train_launches["K2"],
        "max_abs_err": main_k2["max_abs_err"], "ms": main_k2["ms"],
        "plain_ms": main_k2["plain_ms"], "bound_ms": main_k2["bound_ms"],
        "bound_by": main_k2["bound_by"], "library_ms": main_k2["library_ms"],
        "shape": f"{SEGSUM_K}x{main_k2['n']}->{main_k2['m']}x{SEGSUM_K}",
    }] + [{
        "name": name, "route": "cuda",
        "source": f"tensorflowraytrace_tpu_torch/csrc/{source}",
        "replaces": f"tensorflowraytrace_tpu/ops/pallas_kernels.py:{line}",
        "launches": launched[key], "max_abs_err": alone[key]["max_abs_err"],
        "ms": k4_kernel_ms if key == "K4" else alone[key]["ms"],
        "wrapper_ms": alone[key]["ms"], "plain_ms": alone[key]["plain_ms"],
        "bound_ms": culled_bound_ms, "bound_by": "operations",
        "brute_bound_ms": brute_bound_ms, "library_ms": None,
        "shape": f"{n}x{m} (first bounce of the guide)",
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
