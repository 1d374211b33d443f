#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tensorflowraytrace_tpu_torch) on
one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, one line each (any failed check raises and the script exits
non-zero without printing a result):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
   exits non-zero when CUDA is not available.
2. build: compiles the triangle-search kernel (csrc/triangle_search.cu)
   with nvcc into build/ and reports the seconds.
3. K1 against its plain PyTorch version on the card: the random soup of
   bench.py (seed 0: 4094 random triangles plus the 2-triangle target quad)
   with 131072 rays, the flagship's first-bounce search, a ragged tile
   (1000 rays x 333 triangles) and a batch that misses everything.
   Criteria of tests/test_pallas.py: equal ``valid``, ``ray_u`` within
   rtol 1e-5 where valid, > 99% equal ``idx``.
4. the flagship forward (flagship.entry(): 1024 rays, a lens of two
   217-vertex surfaces, 4 bounces, float32) through the kernel: the loss is
   finite, equals the port's plain search path within rtol 1e-4, and the
   kernel launched exactly once per bounce.
5. the bench-scale trace: 2^20 rays x 4096 triangles x 8 bounces of the
   soup, kernel path against the plain path: per-state ray counts within
   0.1% of N; median of 5 synchronised runs of each.

Then one JSON line describing each kernel of the path, the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``.  The soup is not
Morton-sorted as in bench.py: the brute-force search does not use the order.
"""

import json
import statistics
import subprocess
import sys
import time

N_SOUP_TRIS = 4094
K1_RAYS = 131072
BENCH_RAYS = 1 << 20
BENCH_BOUNCES = 8
EPS = 1e-6  # default_epsilon(float32)


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


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
    device = torch.device("cuda:0")
    print(f"phase 1 device: nvidia-smi: {smi} | torch: {kind} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # imported only now: a directory holding this script alone fails here
    from tensorflowraytrace_tpu_torch import FINISHED, Scene3D, TraceConfig, trace
    from tensorflowraytrace_tpu_torch import flagship
    from tensorflowraytrace_tpu_torch.ops import materials as mats
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    # ---- phase 2: build
    t0 = time.perf_counter()
    tk.load_library(verbose=True)
    print(f"phase 2 build: {tk.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- phase 3: K1 against its plain version
    rays, scene = soup_scene(K1_RAYS, device)
    tri = scene.triangles
    check(tri.n_surfaces == N_SOUP_TRIS + 2, "soup size")
    err = compare_k1("soup", rays.p0, rays.p1, tri.vp, tri.v1, tri.v2)
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
    flagship_launches = tk.LAUNCHES
    check(flagship_launches == 4,
          f"flagship launched the kernel {flagship_launches} times, not 4")
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
          f"rel_diff={rel:.3e} launches={flagship_launches}", flush=True)

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
    k_ms = cuda_ms(lambda: tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS), 20)
    p_ms = cuda_ms(lambda: tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS), 3)
    print(f"phase 5 K1 search {n}x{m}: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms", flush=True)

    print(json.dumps({"kernels": [{
        "name": "triangle_search", "route": "cuda",
        "source": "tensorflowraytrace_tpu_torch/csrc/triangle_search.cu",
        "replaces": "tensorflowraytrace_tpu/ops/pallas_kernels.py:76",
        "launches": flagship_launches, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "shape": f"{n}x{m}",
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
