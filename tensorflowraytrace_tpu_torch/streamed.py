"""The streamed and data-parallel light-guide problems.

Counterparts of four examples of the JAX package, at their own default
sizes:

* :func:`trace_guide` is ``examples/streamed_trace.py``: 2^27 rays in blocks
  of 2^22 from the entrance disk of the 64 x 128-ring cylindrical guide
  (z in [0, 40], Morton-sorted) onto a 0.7 x 0.7 target quad, 16386
  triangles, 24 bounces in float32 under ``TraceConfig.recommended``
  (on the card: the CUDA searches, ``cull=True`` and the re-sort), folding
  the landing x^2 + y^2 and the state counts; timed at three stream sizes,
  which must scale linearly.
* :func:`train_guide` is ``examples/streamed_training.py``: 2^23 rays a
  step in blocks of 2^21 from a Lambertian point source into the 12 x
  10-ring guide (z in [0, 6], 240 faces and the 2-triangle target), 12
  bounces with ``remat``, 4 momentum steps of the lost rays' squared
  distance from the exit centre, through ``streamed_value_and_grad`` (with
  ``mesh``: ``parallel_streamed_value_and_grad``).
* :func:`sharded_guide` is ``examples/sharded_light_guide.py``: 2^20 rays a
  step, 10 steps, 12 bounces on the same guide through
  ``Optimizer(mesh=...)``.
* :func:`dryrun` is ``examples/multiprocess_dryrun.py``: it spawns ranks
  on a free local port, runs ``parallel_trace``,
  ``parallel_trace_streamed``, ``parallel_streamed_value_and_grad`` and one
  ``Optimizer(mesh=...)`` step on every rank, runs a one-process control of
  the same inputs, checks that they agree, and prints one JSON line.

Every entry point runs on CUDA unless given ``device=`` (or a mesh), with
the CUDA kernels there.  From a shell::

    python -m tensorflowraytrace_tpu_torch.streamed dryrun --world 2 \\
        --backend gloo --device cpu --size tiny
    torchrun --nproc_per_node=<gpus> -m tensorflowraytrace_tpu_torch.streamed sharded
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.config import FINISHED, resolve_device
from tensorflowraytrace_tpu_torch.engine import (
    TraceConfig, landing_sum_fold, path_length_fold, start_epsilon,
    streamed_value_and_grad, trace, trace_streamed,
)
from tensorflowraytrace_tpu_torch.models import boundaries as bd
from tensorflowraytrace_tpu_torch.models import distributions as dist
from tensorflowraytrace_tpu_torch.models import sources as src
from tensorflowraytrace_tpu_torch.models.acceleration import morton_sort_triangles
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import Scene3D, TriangleSet
from tensorflowraytrace_tpu_torch.ops import materials as mats
from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from tensorflowraytrace_tpu_torch.optim import Optimizer, _apply_param_update
from tensorflowraytrace_tpu_torch.parallel import sharding as par

PI = math.pi
MATERIALS = (mats.vacuum, mats.acrylic)
WAVELENGTH = 575.0
_M64 = (1 << 64) - 1


def fold_in(seed: int, i: int) -> int:
    """A seed for item ``i`` of the stream seeded ``seed`` (splitmix64 of
    the pair), so that a block's generator is a pure function of its
    index."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(i) + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def target_quad(z, dtype, device):
    """The 0.7 x 0.7 exit target at height ``z``."""
    half = 0.35
    return TriangleSet.make(
        [[-half, -half, z], [half, half, z]],
        [[half, -half, z], [-half, half, z]],
        [[half, half, z], [-half, -half, z]], dtype=dtype, device=device)


def long_guide_scene(theta_res=64, z_res=128, dtype=torch.float32,
                     device=None):
    """``examples/streamed_trace.py``'s scene: the cylindrical guide over z
    in [0, 40] (minimum radius 0.3, taper (0.7, 0.0), acrylic inside),
    Morton-sorted, and the target quad at z = 40.05."""
    device = resolve_device(device)
    guide = bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 40.0), minimum_radius=0.3,
        theta_res=theta_res, z_res=z_res, rotationally_symmetric=True,
        initial_taper=(0.7, 0.0), mat_in=1, mat_out=0, dtype=dtype,
        device=device)
    with torch.no_grad():
        surf, _ = morton_sort_triangles(guide.build())
    return Scene3D.build(optical=[surf],
                         targets=[target_quad(40.05, dtype, device)])


def short_guide(theta_res=12, z_res=10, dtype=torch.float32, device=None):
    """``examples/streamed_training.py``'s and
    ``examples/sharded_light_guide.py``'s trainable guide over z in [0, 6]
    and its target quad at z = 6.05: ``(guide, target)``."""
    device = resolve_device(device)
    guide = bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 6.0), minimum_radius=0.3,
        theta_res=theta_res, z_res=z_res, rotationally_symmetric=True,
        initial_taper=(0.7, 0.0), mat_in=1, mat_out=0, dtype=dtype,
        device=device)
    return guide, target_quad(6.05, dtype, device)


def entrance_block(generator, block, dtype, device):
    """``examples/streamed_trace.py``'s block: ``block`` rays from a disk of
    radius 0.2 at z = 0.1, heading up the guide in a cone (a normal draw
    with its z made |z| 3 + 1), drawn from ``generator``."""
    u = torch.rand((2, block), generator=generator, dtype=dtype,
                   device=device)
    r = 0.2 * torch.sqrt(u[0])
    th = 2.0 * PI * u[1]
    p0 = torch.stack([r * torch.cos(th), r * torch.sin(th),
                      torch.full_like(r, 0.1)], dim=1)
    d = torch.randn((block, 3), generator=generator, dtype=dtype,
                    device=device)
    d = torch.cat([d[:, :2], d[:, 2:].abs() * 3.0 + 1.0], dim=1)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return RaySet.make(p0, p0 + d, WAVELENGTH, dtype=dtype, device=device)


def entrance_rays_np(n, seed):
    """:func:`entrance_block`'s distribution drawn by numpy in float64 from
    ``seed``: ``(p0, p1)``, the same rays for the JAX package and the port."""
    rng = np.random.default_rng(seed)
    r = 0.2 * np.sqrt(rng.uniform(0.0, 1.0, n))
    th = rng.uniform(0.0, 2.0 * PI, n)
    p0 = np.stack([r * np.cos(th), r * np.sin(th), np.full(n, 0.1)], 1)
    d = rng.normal(0.0, 1.0, (n, 3))
    d[:, 2] = np.abs(d[:, 2]) * 3.0 + 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p0, p0 + d


def _landing_radius2(p1):
    return p1[:, 0] ** 2 + p1[:, 1] ** 2


# ======================================================================
# examples/streamed_trace.py
# ======================================================================

class GuideTrace:
    """The streamed trace of ``examples/streamed_trace.py``: ``stream(n)``
    traces ``n`` blocks of ``block`` rays (block ``i`` drawn from a
    generator seeded ``fold_in(seed, i)``) under ``torch.no_grad()`` and
    returns the ``engine.StreamedResult`` of the landing fold
    ``self.fold`` (x^2 + y^2 of every finished ray) and the state
    counts."""

    def __init__(self, block=1 << 22, bounces=24, theta_res=64, z_res=128,
                 seed=0, device=None):
        self.device = resolve_device(device)
        self.dtype = torch.float32
        self.block_size = block
        self.seed = seed
        self.scene = long_guide_scene(theta_res, z_res, self.dtype,
                                      self.device)
        self.cfg = TraceConfig.recommended(self.scene, max_bounces=bounces)
        self.fold = landing_sum_fold(_landing_radius2, self.dtype,
                                     device=self.device)

    def block(self, i):
        """Block ``i`` of the stream."""
        gen = torch.Generator(self.device).manual_seed(fold_in(self.seed, i))
        return entrance_block(gen, self.block_size, self.dtype, self.device)

    def __call__(self, n_blocks, fold=None, merge="sum"):
        init, fn = self.fold if fold is None else fold
        with torch.no_grad():
            return trace_streamed(self.block, self.scene, MATERIALS, self.cfg,
                                  fold_fn=fn, fold_init=init,
                                  block_size=self.block_size,
                                  n_blocks=n_blocks, merge=merge)

    def timed(self, n_blocks):
        """One stream of ``n_blocks`` blocks and its wall time:
        ``{"n_rays", "seconds", "rays_per_s", "equiv_per_s", "fold",
        "state_counts"}`` (equivalent intersections/s: rays x triangles x
        bounces over the time)."""
        _sync(self.device)
        t0 = time.perf_counter()
        res = self(n_blocks)
        fold = float(res.fold)
        counts = res.state_counts.tolist()
        seconds = time.perf_counter() - t0
        n = n_blocks * self.block_size
        if not math.isfinite(fold) or sum(counts) != n:
            raise RuntimeError(f"stream of {n} rays: fold {fold}, state "
                               f"counts {counts}")
        m = self.scene.triangles.n_surfaces
        return {"n_rays": n, "seconds": seconds, "rays_per_s": n / seconds,
                "equiv_per_s": n * m * self.cfg.max_bounces / seconds,
                "fold": fold, "state_counts": counts}


def check_linear(rows):
    """The example's assertion: doubling the rays at most doubles the time
    x 1.8 + 1 s, size after size."""
    for prev, row in zip(rows, rows[1:]):
        limit = row["n_rays"] / prev["n_rays"] * prev["seconds"] * 1.8 + 1.0
        if not row["seconds"] < limit:
            raise RuntimeError(
                f"streaming is not linear in the ray count: {prev['n_rays']} "
                f"rays in {prev['seconds']:.3f} s, {row['n_rays']} in "
                f"{row['seconds']:.3f} s (limit {limit:.3f} s)")


def trace_guide(n_rays=1 << 27, block=1 << 22, bounces=24, theta_res=64,
                z_res=128, scaling_points=3, seed=0, device=None,
                verbose=True):
    """Run ``examples/streamed_trace.py``: one block to warm up, then
    streams of ``n_rays``, ``n_rays / 2``, ... (``scaling_points`` sizes,
    smallest first), each checked (finite fold, counts summing to its rays)
    and timed, the times checked by :func:`check_linear`.  Returns the
    rows of :meth:`GuideTrace.timed`."""
    stream = GuideTrace(block, bounces, theta_res, z_res, seed, device)
    stream(1)
    total = max(1, n_rays // block)
    rows = []
    for nb in sorted({max(1, total >> k) for k in range(scaling_points)}):
        row = stream.timed(nb)
        rows.append(row)
        if verbose:
            c = row["state_counts"]
            print(f"  {row['n_rays']:>12,} rays  {row['seconds']:8.3f} s  "
                  f"{row['rays_per_s'] / 1e6:8.2f} M rays/s  "
                  f"{row['equiv_per_s'] / 1e9:8.2f} G equiv int/s  "
                  f"finished {c[FINISHED]:,} dead {c[3]:,}", flush=True)
    check_linear(rows)
    return rows


# ======================================================================
# examples/streamed_training.py and examples/sharded_light_guide.py
# ======================================================================

def _guide_config(scene, bounces, use_kernel, device):
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    return TraceConfig(max_bounces=bounces, use_kernel=use_kernel, remat=True,
                       ray_start_epsilon=start_epsilon(scene))


def lost_flux(res, exit_center):
    """The summed squared distance of every ray that did not finish from
    the exit centre: the example's differentiable surrogate of the lost
    flux."""
    dist2 = torch.sum((res.rays.p1 - exit_center) ** 2, dim=1)
    lost = res.rays.state != FINISHED
    return torch.sum(torch.where(lost, dist2, torch.zeros_like(dist2)))


def lambertian_source(n):
    """The examples' source: ``n`` Lambertian rays from (0, 0, 0.05) up the
    guide's axis."""
    sphere = dist.RandomLambertianSphere(PI / 2.001, n)
    return src.PointSource(3, (0.0, 0.0, 0.05), (0.0, 0.0, 1.0), sphere,
                           np.full(n, WAVELENGTH), dense=False)


def guide_block_loss(block, bounces=12, theta_res=12, z_res=10,
                     dtype=torch.float32, device=None, use_kernel=None):
    """``examples/streamed_training.py``'s problem: ``(guide, block_loss)``
    with ``block_loss(params, i, step_seed)`` the lost flux of block ``i``:
    ``block`` rays of :func:`lambertian_source` drawn from a generator
    seeded ``fold_in(step_seed, i)`` (a pure function of its arguments),
    traced through the guide at ``params[0]``.  ``use_kernel=None`` takes
    the CUDA kernels on a CUDA device."""
    device = resolve_device(device)
    guide, target = short_guide(theta_res, z_res, dtype, device)
    with torch.no_grad():
        scene0 = Scene3D.build(optical=[guide.build(guide.init_params())],
                               targets=[target])
    cfg = _guide_config(scene0, bounces, use_kernel, device)
    source = lambertian_source(block)
    exit_center = torch.tensor([0.0, 0.0, 6.05], dtype=dtype, device=device)

    def block_loss(params, i, step_seed):
        scene = Scene3D.build(optical=[guide.build(params[0])],
                              targets=[target])
        gen = torch.Generator(device).manual_seed(fold_in(step_seed, i))
        rays = source.sample(gen, dtype, device)
        return lost_flux(trace(rays, scene, MATERIALS, cfg), exit_center)

    block_loss.cfg = cfg
    return guide, block_loss


def train_guide(rays_per_step=1 << 23, block=1 << 21, steps=4, bounces=12,
                theta_res=12, z_res=10, lr=3e-3, momentum=0.8, mesh=None,
                seed=7, dtype=torch.float32, device=None, use_kernel=None,
                verbose=True):
    """Run ``examples/streamed_training.py``: each step is the mean lost
    flux of ``rays_per_step`` fresh rays in blocks of ``block``, its
    gradient summed block by block (``streamed_value_and_grad``; with
    ``mesh``, a ``parallel.sharding.RayMesh``,
    ``parallel_streamed_value_and_grad``: rank r takes blocks r, r + D, ...),
    then a momentum step ``v = momentum v - lr g; p += v``.  Step ``s``
    draws its blocks from ``fold_in(seed, s)``.

    Each block's backward follows its forward, so the peak memory is one
    block's (``cfg.remat`` keeps each bounce's hits, so the backward
    searches nothing).

    Raises unless a later step's loss is below the first's.  The example
    asserts that the last one is, but its momentum steps descend for two
    steps and then rebound (lr 3e-3 at momentum 0.8 overshoots, in the JAX
    package as here on the same rays: tests/test_torch_train_schedule.py),
    so where the fourth step lands against the first depends on the rays
    drawn.  Returns ``(losses, params, seconds)``: the
    per-step losses, the final guide parameters and the wall time of each
    step."""
    device = mesh.device if mesh is not None else resolve_device(device)
    block = min(block, rays_per_step)
    n_blocks = max(1, rays_per_step // block)
    guide, block_loss = guide_block_loss(block, bounces, theta_res, z_res,
                                         dtype, device, use_kernel)
    if mesh is not None:
        run = par.parallel_streamed_value_and_grad(
            block_loss, n_blocks, mesh=mesh)
        where = f"{mesh.world_size} ranks"
    else:
        run = streamed_value_and_grad(block_loss, n_blocks)
        where = "one device"
    params = guide.init_params()
    vel = torch.zeros_like(params)
    n_total = n_blocks * block
    if verbose:
        print(f"{n_blocks} blocks x {block:,} rays = {n_total:,} rays/step, "
              f"{bounces} bounces, {where}", flush=True)
    losses, seconds = [], []
    for s in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        value, grads = run([params], fold_in(seed, s))
        loss = float(value) / n_total
        vel = momentum * vel - lr * (grads[0] / n_total)
        params = params + vel
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        if verbose:
            print(f"step {s}: lost-flux loss = {loss:.6f}   "
                  f"({seconds[-1]:.3f} s)", flush=True)
    if len(losses) > 1 and not min(losses[1:]) < losses[0]:
        raise RuntimeError(f"train_guide: the loss did not fall: {losses}")
    return losses, params, seconds


def sharded_guide(rays=1 << 20, steps=10, bounces=12, mesh=None,
                  dtype=torch.float32, device=None, use_kernel=None,
                  verbose=True):
    """Run ``examples/sharded_light_guide.py``: ``steps`` steps of
    ``Optimizer`` (lr 3e-3, grad_clip 0.05, momentum 0.8) on the lost flux
    of ``rays`` rays a step (over the ranks of ``mesh``: ``rays / D`` on
    each, sampled from its own generator, the losses and gradients summed by
    one all-reduce a step), each rank's loss divided by its ray count, in
    one ``run_phase``.  Without a mesh it is the single-process optimizer
    with the same generator as rank 0's.  Returns ``(errors, params,
    seconds)``: the per-step errors (summed over the ranks), the final
    parameters and the phase's wall time."""
    device = mesh.device if mesh is not None else resolve_device(device)
    n_ranks = 1 if mesh is None else mesh.world_size
    local_rays = max(rays // n_ranks, 1)
    guide, target = short_guide(12, 10, dtype, device)
    with torch.no_grad():
        scene0 = Scene3D.build(optical=[guide.build(guide.init_params())],
                               targets=[target])
    cfg = _guide_config(scene0, bounces, use_kernel, device)
    source = lambertian_source(local_rays)
    exit_center = torch.tensor([0.0, 0.0, 6.05], dtype=dtype, device=device)

    def local_loss(params, generator):
        scene = Scene3D.build(optical=[guide.build(params[0])],
                              targets=[target])
        res = trace(source.sample(generator, dtype, device), scene,
                    MATERIALS, cfg)
        return lost_flux(res, exit_center) / local_rays

    opt = Optimizer(local_loss, [guide.init_params()], learning_rate=3e-3,
                    grad_clip=0.05, momentum=0.8, mesh=mesh)
    if verbose:
        print(f"{n_ranks} ranks x {local_rays} rays = "
              f"{n_ranks * local_rays} rays/step, {bounces} bounces",
              flush=True)
    _sync(device)
    t0 = time.perf_counter()
    errors = opt.run_phase(steps)
    _sync(device)
    seconds = time.perf_counter() - t0
    if verbose:
        for i, e in enumerate(errors):
            print(f"step {i}: lost-ray exit-distance loss (mean over ranks) "
                  f"= {e / n_ranks:.6f}")
        print(f"{seconds:.3f} s for {steps} steps", flush=True)
    return errors, opt.parameters, seconds


# ======================================================================
# examples/multiprocess_dryrun.py
# ======================================================================

# The dryrun's workloads.  "tiny": float64 on small guides, the CPU tests'
# size, compared with the JAX package there.  "card": float32, the 16386-
# triangle guide's parallel trace at 2^21 rays, 4 blocks of 2^20 through the
# 242-triangle guide.
DRYRUN_SIZES = {
    "tiny": dict(dtype="float64", trace_guide=(8, 6), trace_rays=256,
                 trace_bounces=128, stream_block=48, vag_guide=(6, 6),
                 vag_block=64, vag_blocks=3, vag_bounces=6, step_rays=64,
                 step_bounces=6),
    "card": dict(dtype="float32", trace_guide=(64, 128), trace_rays=1 << 21,
                 trace_bounces=24, stream_block=1 << 19, vag_guide=(12, 10),
                 vag_block=1 << 20, vag_blocks=4, vag_bounces=12,
                 step_rays=1 << 19, step_bounces=12),
}
DRYRUN_SEED = 3
# the dryrun's block loss moves the exit centre up by this much (an
# argument passed through undifferentiated)
VAG_SHIFT = 0.003


def free_port():
    """A free TCP port on this host, for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sha(t):
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()[:16]


class DryrunProblem:
    """The dryrun's inputs at ``size`` (a key of ``DRYRUN_SIZES``), the
    same in every rank and in the control: numpy-made rays
    (:func:`entrance_rays_np`) for the trace, the stream and the blocks,
    and the guides' scenes."""

    def __init__(self, size, device):
        s = DRYRUN_SIZES[size]
        self.size = s
        self.device = torch.device(device)
        self.dtype = getattr(torch, s["dtype"])
        self.trace_scene = long_guide_scene(*s["trace_guide"], self.dtype,
                                            self.device)
        on_card = self.device.type == "cuda"
        self.trace_cfg = TraceConfig(
            max_bounces=s["trace_bounces"], use_kernel=on_card, cull=on_card,
            resort_rays=on_card, early_exit=True,
            ray_start_epsilon=start_epsilon(self.trace_scene))
        p0, p1 = entrance_rays_np(s["trace_rays"], DRYRUN_SEED)
        self.rays = RaySet.make(p0, p1, WAVELENGTH, dtype=self.dtype,
                                device=self.device)
        self.guide, self.target = short_guide(*s["vag_guide"], self.dtype,
                                              self.device)
        with torch.no_grad():
            scene0 = Scene3D.build(optical=[self.guide.build(
                self.guide.init_params())], targets=[self.target])
        self.vag_cfg = _guide_config(scene0, s["vag_bounces"], None,
                                     self.device)
        self.step_cfg = dataclasses.replace(self.vag_cfg,
                                            max_bounces=s["step_bounces"])
        self.exit_center = torch.tensor([0.0, 0.0, 6.05], dtype=self.dtype,
                                        device=self.device)
        self.source = lambertian_source(s["step_rays"])

    def trace_fold(self, n_rays):
        """The trace's fold: the landing sum four times (reduced by "sum",
        "max", "min" and "none") and the per-ray path length."""
        init_l, fn_l = landing_sum_fold(_landing_radius2, self.dtype,
                                        device=self.device)
        init_p, fn_p = path_length_fold(n_rays, self.dtype, self.device)

        def fn(acc, record):
            total = fn_l(acc[0], record)
            return (total, total, total, total, fn_p(acc[4], record))

        return (init_l,) * 4 + (init_p,), fn

    def stream_fold(self):
        return landing_sum_fold(_landing_radius2, self.dtype,
                                device=self.device)

    def block_rays(self, i):
        p0, p1 = entrance_rays_np(self.size["vag_block"],
                                  fold_in(DRYRUN_SEED, i))
        return RaySet.make(p0, p1, WAVELENGTH, dtype=self.dtype,
                           device=self.device)

    def block_loss(self, params, i, shift):
        """Block ``i``'s lost flux, the exit centre moved ``shift`` up."""
        scene = Scene3D.build(optical=[self.guide.build(params[0])],
                              targets=[self.target])
        res = trace(self.block_rays(i), scene, MATERIALS, self.vag_cfg)
        return lost_flux(res, self.exit_center + shift)

    def step_loss(self, params, generator):
        scene = Scene3D.build(optical=[self.guide.build(params[0])],
                              targets=[self.target])
        res = trace(self.source.sample(generator, self.dtype, self.device),
                    scene, MATERIALS, self.step_cfg)
        return lost_flux(res, self.exit_center)

    def optimizer(self, **kw):
        return Optimizer(self.step_loss, [self.guide.init_params()],
                         learning_rate=0.05, momentum=0.9, grad_clip=0.5,
                         **kw)


def _floats(t):
    return [float(x) for x in t.detach().reshape(-1).cpu()]


def _dryrun_rank(rank, world, backend, device, size, port):
    """One rank of :func:`dryrun`; returns its numbers."""
    if device == "cuda":
        local = rank % torch.cuda.device_count()
        os.environ["LOCAL_RANK"] = str(local)
        device = f"cuda:{local}"
        torch.cuda.set_device(torch.device(device))
    config.set_default_device(device)
    par.init_multihost(backend, init_method=f"tcp://localhost:{port}",
                       world_size=world, rank=rank)
    try:
        mesh = par.ray_mesh(device=device)
        prob = DryrunProblem(size, device)
        out = {"rank": rank, "world": world, "backend": backend,
               "device": str(device), "size": size}
        t0 = time.perf_counter()

        rays = par.shard_rays(prob.rays, mesh)
        scene = par.replicate(prob.trace_scene, mesh)
        init, fn = prob.trace_fold(rays.n_rays)
        with torch.no_grad():
            res = par.parallel_trace(
                rays, scene, MATERIALS, prob.trace_cfg, mesh, fold_fn=fn,
                fold_init=init,
                fold_reduce=("sum", "max", "min", "none", "sum"))
        out["trace"] = {
            "fold": [float(x) for x in res.fold[:4]],
            "path_sha": _sha(res.fold[4]), "state_sha": _sha(res.rays.state),
            "p1_sha": _sha(res.rays.p1), "n_bounces": int(res.n_bounces),
            "counts": res.rays.state.bincount(minlength=4).tolist()}
        if rays.n_rays <= 4096:
            out["trace"]["state"] = res.rays.state.tolist()
            out["trace"]["path"] = _floats(res.fold[4])

        init, fn = prob.stream_fold()
        with torch.no_grad():
            st = par.parallel_trace_streamed(
                rays, scene, MATERIALS, prob.trace_cfg, mesh, fold_fn=fn,
                fold_init=init, block_size=prob.size["stream_block"])
        out["streamed"] = {"fold": float(st.fold),
                           "counts": st.state_counts.tolist(),
                           "n_rays": st.n_rays}

        run = par.parallel_streamed_value_and_grad(
            prob.block_loss, prob.size["vag_blocks"], mesh=mesh)
        value, grads = run([prob.guide.init_params()], VAG_SHIFT)
        out["vag"] = {"value": float(value), "grad": _floats(grads[0])}

        opt = prob.optimizer(mesh=mesh)
        error = opt.single_step()
        out["step"] = {"error": error,
                       "params": _floats(opt.parameters[0]),
                       "velocity": _floats(opt._velocity[0])}
        _sync(device)
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = {"K1": tk.LAUNCHES, "K2": sk.LAUNCHES,
                           "K3": tk.LAUNCHES_CULLED}
        return out
    finally:
        torch.distributed.destroy_process_group()


def _dryrun_control(world, device, size):
    """The one-process control of :func:`dryrun`: each rank's shard traced
    alone (its partial fold and the hashes of its slots), all the rays in
    one trace (the hashes of each rank's slice of its slots), ``streamed_value_and_grad`` over every block, and the
    summed single-process optimizer step (the loss and gradient summed over
    the ranks' generators, then the unchanged update)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    prob = DryrunProblem(size, device)
    n = prob.rays.n_rays
    k = n // world
    shards = []
    with torch.no_grad():
        for r in range(world):
            shard = dataclasses.replace(
                prob.rays, p0=prob.rays.p0[r * k:(r + 1) * k],
                p1=prob.rays.p1[r * k:(r + 1) * k],
                wavelength=prob.rays.wavelength[r * k:(r + 1) * k],
                state=prob.rays.state[r * k:(r + 1) * k])
            init, fn = prob.trace_fold(k)
            res = trace(shard, prob.trace_scene, MATERIALS, prob.trace_cfg,
                        fold_fn=fn, fold_init=init)
            shards.append({"fold": float(res.fold[0]),
                           "path_sha": _sha(res.fold[4]),
                           "state_sha": _sha(res.rays.state),
                           "p1_sha": _sha(res.rays.p1),
                           "n_bounces": int(res.n_bounces)})
        init, fn = prob.trace_fold(n)
        whole = trace(prob.rays, prob.trace_scene, MATERIALS, prob.trace_cfg,
                      fold_fn=fn, fold_init=init)
    # the whole trace's slots, cut as the ranks hold them
    whole_slices = [{"path_sha": _sha(whole.fold[4][r * k:(r + 1) * k]),
                     "state_sha": _sha(whole.rays.state[r * k:(r + 1) * k]),
                     "p1_sha": _sha(whole.rays.p1[r * k:(r + 1) * k])}
                    for r in range(world)]
    out = {"trace": {"shards": shards, "whole_slices": whole_slices,
                     "n_bounces": int(whole.n_bounces),
                     "counts": whole.rays.state.bincount(minlength=4).tolist()},
           "streamed": {"fold": float(whole.fold[0])}}

    value, grads = streamed_value_and_grad(
        prob.block_loss, prob.size["vag_blocks"])([prob.guide.init_params()],
                                                  VAG_SHIFT)
    out["vag"] = {"value": float(value), "grad": _floats(grads[0])}

    p = prob.guide.init_params()
    opt = prob.optimizer()
    error, grad = 0.0, torch.zeros_like(p)
    for r in range(world):
        gen = torch.Generator(device).manual_seed(par.rank_seed(0, r))
        leaf = p.detach().requires_grad_(True)
        loss = prob.step_loss([leaf], gen)
        error += float(loss.detach())
        grad = grad + torch.autograd.grad(loss, [leaf])[0]
    with torch.no_grad():
        p_new, v_new = _apply_param_update(
            p, grad, torch.zeros_like(p), 1.0, opt.momentum, 1.0,
            opt.learning_rate, opt.clip_mode, opt.clip_scale, opt.grad_clip,
            None, None)
    out["step"] = {"error": error, "params": _floats(p_new),
                   "velocity": _floats(v_new)}
    return out


def _close(a, b, rtol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), np.finfo(np.float64).tiny)
    err = float(np.abs(a - b).max())
    if not err <= rtol * scale:
        raise RuntimeError(f"dryrun: {what} differs by {err} (scale {scale})")
    return err / scale


def dryrun_check(ranks, control):
    """The dryrun's agreements: every rank's reduced numbers equal rank 0's
    exactly; each rank's trace slots equal the control's trace of its shard
    and its slice of the control's trace of all the rays, bit for bit
    (hashes of states, endpoints and per-ray path lengths);
    the reduced folds, counts, depth, stream, value, gradient and optimizer
    step equal the control's within 1e-10 (float64) or 1e-4 (float32) of
    their largest magnitude.  Returns the relative errors."""
    size = ranks[0]["size"]
    rtol = 1e-10 if DRYRUN_SIZES[size]["dtype"] == "float64" else 1e-4
    for r in ranks[1:]:
        for key in ("streamed", "vag", "step"):
            if r[key] != ranks[0][key]:
                raise RuntimeError(f"dryrun: rank {r['rank']}'s {key} "
                                   f"differs from rank 0's")
        if r["trace"]["fold"] != ranks[0]["trace"]["fold"]:
            raise RuntimeError("dryrun: the reduced trace folds differ")
    shards = control["trace"]["shards"]
    for r, shard, cut in zip(ranks, shards, control["trace"]["whole_slices"]):
        for key in ("path_sha", "state_sha", "p1_sha"):
            if not r["trace"][key] == shard[key] == cut[key]:
                raise RuntimeError(f"dryrun: rank {r['rank']}'s trace {key} "
                                   "differs from the control's trace of its "
                                   "shard or of all the rays")
    partials = [s["fold"] for s in shards]
    fold = ranks[0]["trace"]["fold"]
    errs = {"trace_sum": _close(fold[0], sum(partials), rtol, "trace sum")}
    for got, want, what in ((fold[1], max(partials), "max"),
                            (fold[2], min(partials), "min"),
                            (fold[3], partials[0], "none")):
        if got != want:
            raise RuntimeError(f"dryrun: fold_reduce={what!r} gives {got}, "
                               f"not {want}")
    counts = np.sum([r["trace"]["counts"] for r in ranks], axis=0).tolist()
    depth = ranks[0]["trace"]["n_bounces"]
    if (counts != control["trace"]["counts"]
            or ranks[0]["streamed"]["counts"] != control["trace"]["counts"]
            or any(r["trace"]["n_bounces"] != depth for r in ranks)
            or depth != control["trace"]["n_bounces"]
            or depth != max(s["n_bounces"] for s in shards)):
        raise RuntimeError(f"dryrun: counts {counts} / depth {depth} differ "
                           f"from the control's {control['trace']}")
    errs["streamed"] = _close(ranks[0]["streamed"]["fold"],
                              control["streamed"]["fold"], rtol, "stream")
    errs["vag_value"] = _close(ranks[0]["vag"]["value"],
                               control["vag"]["value"], rtol, "value")
    errs["vag_grad"] = _close(ranks[0]["vag"]["grad"],
                              control["vag"]["grad"], rtol, "gradient")
    errs["step_error"] = _close(ranks[0]["step"]["error"],
                                control["step"]["error"], rtol, "step error")
    errs["step_velocity"] = _close(ranks[0]["step"]["velocity"],
                                   control["step"]["velocity"], rtol,
                                   "step velocity")
    errs["step_params"] = _close(ranks[0]["step"]["params"],
                                 control["step"]["params"], rtol,
                                 "step params")
    return errs


def dryrun(world=2, backend="gloo", device=None, size="tiny", timeout=900):
    """``examples/multiprocess_dryrun.py``: spawn ``world`` ranks of
    ``python -m tensorflowraytrace_tpu_torch.streamed dryrun-rank`` over
    ``backend`` on a free local port, each on ``device`` (``"cpu"``, or
    ``"cuda"``: rank r on card r mod the card count; gloo lets several
    ranks share one card, NCCL does not), run the one-process control
    here, and check them (:func:`dryrun_check`).  Returns ``{"ranks":
    [...], "control": {...}, "errors": {...}, "seconds": s}``; raises if a
    rank fails or disagrees."""
    device = str(resolve_device(device).type if device is None else device)
    port = free_port()
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tensorflowraytrace_tpu_torch.streamed",
         "dryrun-rank", "--rank", str(r), "--world", str(world),
         "--backend", backend, "--device", device, "--size", size,
         "--port", str(port)],
        cwd=root, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        lines = [ln for ln in text.splitlines() if ln.startswith("DRYRUN ")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"dryrun rank {r} failed (exit "
                               f"{p.returncode}):\n{text}")
        ranks.append(json.loads(lines[-1][len("DRYRUN "):]))
    ranks_s = time.perf_counter() - t0
    control = _dryrun_control(world, device, size)
    errors = dryrun_check(ranks, control)
    return {"world": world, "backend": backend, "device": device,
            "size": size, "ranks": ranks, "control": control,
            "errors": errors, "ranks_seconds": ranks_s,
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m tensorflowraytrace_tpu_torch."
                                 "streamed")
    sub = ap.add_subparsers(dest="command", required=True)
    t = sub.add_parser("trace", help="examples/streamed_trace.py")
    t.add_argument("--n-rays", type=int, default=1 << 27)
    t.add_argument("--block", type=int, default=1 << 22)
    t.add_argument("--bounces", type=int, default=24)
    t.add_argument("--device", default=None)
    r = sub.add_parser("train", help="examples/streamed_training.py; under "
                       "torchrun, --mesh splits the blocks over the ranks")
    r.add_argument("--rays-per-step", type=int, default=1 << 23)
    r.add_argument("--block", type=int, default=1 << 21)
    r.add_argument("--steps", type=int, default=4)
    r.add_argument("--bounces", type=int, default=12)
    r.add_argument("--mesh", action="store_true")
    r.add_argument("--device", default=None)
    s = sub.add_parser("sharded", help="examples/sharded_light_guide.py, one "
                       "rank a card under torchrun")
    s.add_argument("--rays", type=int, default=1 << 20)
    s.add_argument("--steps", type=int, default=10)
    s.add_argument("--bounces", type=int, default=12)
    for name in ("dryrun", "dryrun-rank"):
        d = sub.add_parser(name, help="examples/multiprocess_dryrun.py"
                           if name == "dryrun" else "one rank of dryrun")
        d.add_argument("--world", type=int, default=2)
        d.add_argument("--backend", default="gloo")
        d.add_argument("--device", default=None)
        d.add_argument("--size", default="tiny", choices=sorted(DRYRUN_SIZES))
        if name == "dryrun-rank":
            d.add_argument("--rank", type=int, required=True)
            d.add_argument("--port", type=int, required=True)
    a = ap.parse_args(argv)

    if a.command == "trace":
        trace_guide(a.n_rays, a.block, a.bounces, device=a.device)
    elif a.command in ("train", "sharded"):
        mesh = None
        if a.command == "sharded" or a.mesh:
            par.init_multihost()
            mesh = par.ray_mesh()
        try:
            if a.command == "train":
                train_guide(a.rays_per_step, a.block, a.steps, a.bounces,
                            mesh=mesh, device=a.device)
            else:
                sharded_guide(a.rays, a.steps, a.bounces, mesh=mesh)
        finally:
            if mesh is not None:
                torch.distributed.destroy_process_group()
    elif a.command == "dryrun-rank":
        device = a.device or resolve_device(None).type
        out = _dryrun_rank(a.rank, a.world, a.backend, device, a.size,
                           a.port)
        print("DRYRUN " + json.dumps(out), flush=True)
    else:
        out = dryrun(a.world, a.backend, a.device, a.size)
        print(json.dumps({k: out[k] for k in (
            "world", "backend", "device", "size", "errors", "seconds")}
            | {"ranks": out["ranks"], "control": out["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
