"""K1 on Hopper: the brute-force nearest ray-triangle search.

``nearest_hit_triangles_kernel`` is the wrapper the engine calls with
``use_kernel=True``.  On CUDA tensors it launches the hand-written kernel in
``csrc/triangle_search.cu`` (port of ``_triangle_kernel`` in
``tensorflowraytrace_tpu/ops/pallas_kernels.py``) or raises; it never falls
back.  On CPU tensors it runs ``nearest_hit_triangles_plain``, the same
Moller-Trumbore arithmetic written line by line in PyTorch, chunked over rays
and triangles so that an N x M tensor is never materialised.

Contract (shared with every search kernel of the JAX package): per ray
``(valid, idx int32, ray_u)``; ``ray_u`` is ``BIG = 3e38`` where nothing is
hit and ``valid`` is ``ray_u < BIG / 2``; the nearest hit wins and a tie
goes to the first triangle index; there is no gradient.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/`` and loaded with ``ctypes`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from tensorflowraytrace_tpu_torch.ops import cuda_build

BIG = 3.0e38

# Launches of the CUDA kernel in this process.  The wrapper adds one where it
# launches and nowhere else; callers reset it to 0 to count a run.
LAUNCHES = 0

SOURCE = "triangle_search.cu"


def library_path() -> Path:
    return cuda_build.library_path(SOURCE)


def load_library():
    """The kernel library, built at first use, with its C signature
    declared."""
    lib = cuda_build.load(SOURCE)
    fn = lib.triangle_search_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
        + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return lib


def _check_cuda_inputs(p0, p1, vp, v1, v2):
    named = {"p0": p0, "p1": p1, "vp": vp, "v1": v1, "v2": v2}
    device = p0.device
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, p0 on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA triangle search takes float32 only; "
                            f"{name} is {t.dtype}")
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


def nearest_hit_triangles_kernel(p0, p1, vp, v1, v2, intersect_eps, size_eps,
                                 ray_start_eps):
    """Nearest hit of each ray (p0 -> p1, (N, 3)) among triangles
    (vp, v1, v2, (M, 3)).  Returns ``(valid, idx, ray_u)``.

    CPU tensors go to the plain version.  CUDA tensors launch the kernel,
    which takes contiguous, detached float32 tensors on one device and raises
    on anything else.
    """
    global LAUNCHES
    if p0.device.type == "cpu":
        return nearest_hit_triangles_plain(p0, p1, vp, v1, v2, intersect_eps,
                                           size_eps, ray_start_eps)
    if p0.device.type != "cuda":
        raise ValueError(f"no triangle search for device {p0.device}")
    _check_cuda_inputs(p0, p1, vp, v1, v2)
    fn = load_library().triangle_search_launch
    n, m = p0.shape[0], vp.shape[0]
    u = torch.empty((n,), dtype=torch.float32, device=p0.device)
    idx = torch.empty((n,), dtype=torch.int32, device=p0.device)
    with torch.cuda.device(p0.device):
        stream = torch.cuda.current_stream(p0.device).cuda_stream
        err = fn(p0.data_ptr(), p1.data_ptr(), vp.data_ptr(), v1.data_ptr(),
                 v2.data_ptr(), n, m, float(intersect_eps), -float(size_eps),
                 1.0 + float(size_eps), float(ray_start_eps), u.data_ptr(),
                 idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"triangle_search launch failed: CUDA error {err}")
    LAUNCHES += 1
    return u < BIG * 0.5, idx, u


@torch.no_grad()
def nearest_hit_triangles_plain(p0, p1, vp, v1, v2, intersect_eps, size_eps,
                                ray_start_eps, ray_block=32768, tri_chunk=256):
    """Plain PyTorch version of the kernel: the same Moller-Trumbore
    arithmetic in the same order, over (ray_block, tri_chunk) tiles with a
    running minimum merged under strict < (ties keep the earlier chunk;
    ``argmin`` takes the first index inside a chunk)."""
    n, m = p0.shape[0], vp.shape[0]
    dtype, device = p0.dtype, p0.device
    best_u = torch.full((n,), BIG, dtype=dtype, device=device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=device)
    s_lo, s_hi = -float(size_eps), 1.0 + float(size_eps)
    for r0 in range(0, n, ray_block):
        o = p0[r0:r0 + ray_block, :, None]                  # (B, 3, 1)
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        d = p1[r0:r0 + ray_block, :, None] - o
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        bu = best_u[r0:r0 + ray_block]
        bi = best_idx[r0:r0 + ray_block]
        for t0 in range(0, m, tri_chunk):
            a = vp[t0:t0 + tri_chunk].T[:, None]             # (3, 1, C)
            e1 = v1[t0:t0 + tri_chunk].T[:, None] - a
            e2 = v2[t0:t0 + tri_chunk].T[:, None] - a
            e1x, e1y, e1z = e1[0], e1[1], e1[2]
            e2x, e2y, e2z = e2[0], e2[1], e2[2]

            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz

            ok = torch.abs(det) >= intersect_eps
            inv = 1.0 / torch.where(ok, det, torch.ones_like(det))

            tx = ox - a[0]
            ty = oy - a[1]
            tz = oz - a[2]
            tu = (tx * px + ty * py + tz * pz) * inv

            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            tv = (dx * qx + dy * qy + dz * qz) * inv
            ray_u = (e2x * qx + e2y * qy + e2z * qz) * inv

            ok = ok & (tu >= s_lo) & (tv >= s_lo)
            ok = ok & (tu + tv <= s_hi) & (ray_u >= ray_start_eps)

            u = torch.where(ok, ray_u, BIG)                  # (B, C)
            carg = torch.argmin(u, dim=1)
            cu = u.gather(1, carg[:, None])[:, 0]
            better = cu < bu
            bu.copy_(torch.where(better, cu, bu))
            bi.copy_(torch.where(better, (carg + t0).to(torch.int32), bi))
    return best_u < BIG * 0.5, best_idx, best_u
