#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tensorflowraytrace_tpu_torch) on
one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, one or more lines each (any failed check raises and the script
exits non-zero without printing a result):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
   exits non-zero when CUDA is not available.
2. build: compiles both kernels (csrc/triangle_search.cu and
   csrc/segment_sum.cu), one nvcc each, started together, into build/.
3. K1 against its plain PyTorch version on the card: the random soup of
   bench.py (seed 0: 4094 random triangles plus the 2-triangle target quad)
   with 131072 rays, the flagship's first-bounce search, a ragged tile
   (1000 rays x 333 triangles) and a batch that misses everything.
   Criteria of tests/test_pallas.py: equal ``valid``, ``ray_u`` within
   rtol 1e-5 where valid, > 99% equal ``idx``.
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

Then one JSON line describing each kernel of the path, the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``.  The soup is not
Morton-sorted as in bench.py: the brute-force search does not use the order.
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

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
# FP32 operations of one ray-triangle pair in K1: two cross products
# (2 x 9), two dot products against P (2 x 6 with the scaling by inv),
# det (5), T (3), u (6), 1/det (1), tu + tv (1)
K1_FLOPS_PER_PAIR = 46


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def card():
    """The device every phase runs on."""
    import torch

    return torch.device("cuda:0")


def soup_scene(n_rays, device):
    """bench.py's random soup: a box of reflective triangles around the
    origin, a distant target plane, rays from inside in random directions."""
    import numpy as np
    import torch

    from tensorflowraytrace_tpu_torch import RaySet, Scene3D, TriangleSet

    f32 = torch.float32
    rng = np.random.default_rng(0)
    center = rng.uniform(-3, 3, (N_SOUP_TRIS, 3))
    vp = center + rng.normal(0, 0.5, center.shape)
    v1 = center + rng.normal(0, 0.5, center.shape)
    v2 = center + rng.normal(0, 0.5, center.shape)
    guide = TriangleSet.make(vp.astype(np.float32), v1.astype(np.float32),
                             v2.astype(np.float32), mat_in=1, mat_out=0,
                             dtype=f32, device=device)
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
                   if e.device_type == torch.autograd.DeviceType.CUDA)
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


def main():
    import torch

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
    from tensorflowraytrace_tpu_torch.ops import cuda_build
    from tensorflowraytrace_tpu_torch.ops import materials as mats
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
    from tensorflowraytrace_tpu_torch.optim import Optimizer

    # ---- phase 2: build, one nvcc per source, all started together
    t0 = time.perf_counter()
    reports = cuda_build.build([tk.SOURCE, sk.SOURCE], verbose=True)
    for source, report in reports.items():
        print(f"phase 2 nvcc {source}:\n{report.strip()}", flush=True)
    tk.load_library()
    sk.load_library()
    print(f"phase 2 build: {tk.library_path().name} "
          f"{cuda_build.library_path(sk.SOURCE).name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

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
    def count_syncs(fn):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in caught)

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

    main_k2 = k2["flagship_bench"]
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
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
