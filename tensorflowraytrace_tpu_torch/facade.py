"""The problems that drive the stateful facade, the checkpoint and the goal
pipeline: counterparts of the JAX package's examples, each at the
example's size, on CUDA unless given ``device=``.

* ``tax_bench_system``: the scene of ``examples/facade_tax_bench.py`` in
  an ``OpticalSystem2D``: an acrylic light guide of three segments closed
  by the exit segment, 2^17 rays of a Lambertian fan from a beam just
  inside its base, traced 12 bounces.
* ``guide_system``: ``scenes2d.light_guide`` (4098 segments with the
  target, 512 lenslet arcs, 2^20 rays, 50 bounces, dead rays stretched
  10x) built through ``OpticalSystem2D``.
* ``flagship_system``: ``flagship.py``'s parametric lens, square source
  and image plane in an ``OpticalSystem3D``, with the error function of
  its design (``examples/simple_3d_optimize.py`` through the facade), the
  functional loss it equals, and the mesh tools of its first phase.
* ``stepwise_optimize``: ``examples/stepwise_optimize.py``: the
  single-arc problem (``scenes2d.single_arc``) under the self-scaling
  schedule, checkpointed every 10 steps, rebuilt from scratch, resumed
  and run to the end beside the uninterrupted run.
* ``interactive_optimize``: ``examples/interactive_optimize.py`` driven
  headless: synthetic key events step the single-arc design (space or
  enter one step, ``b`` ten, ``s`` a checkpoint, ``q`` the end) and redraw
  its rays, arc, target and loss curve on a figure made outside pyplot.
* ``precompile_pipeline``: ``examples/precompile_pipeline.py``: goal
  points from a ring image, source points from a Gaussian density, the
  Hungarian matching, the cache pickled and reloaded, and per-step
  downsampling on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

from tensorflowraytrace_tpu_torch import flagship, scenes2d
from tensorflowraytrace_tpu_torch.config import FINISHED, resolve_device
from tensorflowraytrace_tpu_torch.engine import trace
from tensorflowraytrace_tpu_torch.models import distributions as dist
from tensorflowraytrace_tpu_torch.models import goals
from tensorflowraytrace_tpu_torch.models import sources as src
from tensorflowraytrace_tpu_torch.models.surfaces import ArcSet, SegmentSet
from tensorflowraytrace_tpu_torch.ops import materials as mats
from tensorflowraytrace_tpu_torch.optim import Optimizer
from tensorflowraytrace_tpu_torch.system import (
    OpticalEngine, OpticalSystem2D, OpticalSystem3D,
)
from tensorflowraytrace_tpu_torch.utils import checkpoint

PI = math.pi
TAX_RAYS = 1 << 17
TAX_BOUNCES = 12
CHECKPOINT_EVERY = 10


def tax_bench_system(n_rays=TAX_RAYS, dtype=torch.float32, device=None,
                     seed=0):
    """``examples/facade_tax_bench.py``'s scene: ``(system, engine)``, the
    system updated once (its source sampled from its generator, seeded
    ``seed``)."""
    guide = SegmentSet.make(
        [[-0.1, -4.0], [0.0, 4.0], [0.1, -4.0]],
        [[0.0, 4.0], [0.1, -4.0], [-0.1, -4.0]],
        mat_in=1, mat_out=0, dtype=dtype, device=device)
    exit_face = SegmentSet.make([[-0.3, 4.2]], [[0.3, 4.2]], dtype=dtype,
                                device=device)
    source = src.AngularSource(
        2, (0.0, -3.999), PI / 2,
        dist.RandomLambertianAngularDistribution(-0.3 * PI, 0.3 * PI, n_rays),
        dist.RandomUniformBeam(-0.09, 0.09, n_rays), np.full(n_rays, 575.0),
        dense=False)
    system = OpticalSystem2D(dtype=dtype, device=device, seed=seed)
    system.optical_segments = [guide]
    system.target_segments = [exit_face]
    system.sources = [source]
    system.materials = [{"n": mats.vacuum}, {"n": mats.acrylic}]
    system.update()
    engine = OpticalEngine(2)
    engine.optical_system = system
    return system, engine


def guide_system(n_rays=1 << 20, n_wall=2048, n_lenslets=512,
                 dtype=torch.float32, device=None, seed=0):
    """``scenes2d.light_guide``'s guide, source and settings through the
    facade: ``(system, engine)``, the system updated once.  Its scene is
    not Morton-sorted (the brute searches ``recommended`` picks in 2D do
    not use the order)."""
    device = resolve_device(device)
    (p0, p1), target, lenslets = scenes2d.guide_surfaces(n_wall, n_lenslets)
    source = src.AngularSource(
        2, (-0.001, 0.0), 0.0,
        dist.RandomLambertianAngularDistribution(-0.4 * PI, 0.4 * PI, n_rays),
        dist.RandomUniformBeam(-0.95, 0.95, n_rays), np.full(n_rays, 575.0),
        dense=False)
    system = OpticalSystem2D(dtype=dtype, device=device, seed=seed)
    system.optical_segments = [SegmentSet.make(
        p0, p1, mat_in=1, mat_out=0, dtype=dtype, device=device)]
    system.optical_arcs = [ArcSet.make(*lenslets, mat_in=1, mat_out=0,
                                       dtype=dtype, device=device)]
    system.target_segments = [SegmentSet.make(*target, dtype=dtype,
                                              device=device)]
    system.sources = [source]
    system.materials = [{"n": mats.vacuum}, {"n": mats.acrylic}]
    system.update()
    engine = OpticalEngine(2, dead_ray_length=scenes2d.DEAD_RAY_LENGTH)
    engine.optical_system = system
    return system, engine


def flagship_system(bp_count=45, mesh_steps=8, max_bounces=3,
                    dtype=torch.float32, device=None, use_kernel=None):
    """The flagship design through the facade.  Returns a dict:

    ``system``, ``engine``: the lens (with the training's vertex update
    map), the random square source and the image plane in an
    ``OpticalSystem3D``, updated once; ``error_function(result)``: the
    flagship's loss of a trace; ``loss(params, generator)``: the same loss
    built functionally (``flagship._flagship``), with the kernels where
    ``use_kernel`` (by default on CUDA); ``init_params``; ``accumulator``
    and ``smoother``: the mesh tools of the design's first phase.
    """
    device = resolve_device(device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    update_map, accumulator, smoother = flagship.training_tools(mesh_steps)
    lens, source, functional = flagship._flagship(
        dtype, bp_count, mesh_steps, max_bounces, use_kernel, device,
        update_map)
    goal_scale = -(flagship.MAGNIFICATION * flagship.OBJECT_SIZE)

    def error_function(result):
        fin = result.rays.state == FINISHED
        out = result.rays.p1[:, 1:]
        goal = result.rays.fields["rank"] * goal_scale
        per_ray = torch.sum((out - goal) ** 2, dim=1)
        return torch.sum(torch.where(fin, per_ray, torch.zeros_like(per_ray)))

    def loss(params, generator):
        return functional(params, source.sample(generator, dtype, device))

    system = OpticalSystem3D(dtype=dtype, device=device)
    system.optical = [lens]
    system.targets = [flagship.target_plane(dtype, device)]
    system.sources = [source]
    system.materials = [{"n": mats.vacuum}, {"n": mats.acrylic}]
    system.update()
    engine = OpticalEngine(3)
    engine.optical_system = system
    return {"system": system, "engine": engine,
            "error_function": error_function, "loss": loss,
            "init_params": lens.init_params(), "accumulator": accumulator,
            "smoother": smoother}


def self_scaling_step(opt):
    """The example's step: lr 1.0 and momentum 0.8 for the first 20 steps,
    then lr 0.1 and momentum 0.9."""
    if opt.iterations < 20:
        return opt.single_step(None, momentum=0.8)
    return opt.single_step(None, lr_scale=0.1, momentum=0.9)


def adam_lambda(lr=0.1, decay=0.98):
    """An ``optax_tx`` factory: Adam under an exponentially decaying
    ``LambdaLR``."""
    def factory(params):
        adam = torch.optim.Adam(params, lr=lr)
        return adam, torch.optim.lr_scheduler.LambdaLR(
            adam, functools.partial(pow, decay))
    return factory


def single_arc_optimizer(arc_loss, params, device, optax_tx=None):
    """The stepwise example's optimizer of ``scenes2d.single_arc``'s loss
    (``make_optimizer``: learning rate 1, gradient clip 0.1)."""
    def loss(params, generator):
        return arc_loss(params)

    return Optimizer(loss, params, learning_rate=1.0, grad_clip=0.1,
                     generator=torch.Generator(device).manual_seed(0),
                     optax_tx=optax_tx)


def stepwise_optimize(path, steps=25, dtype=torch.float32, device=None,
                      use_kernel=None, optax_tx=None):
    """``examples/stepwise_optimize.py``: the single arc, ``steps`` steps
    of the self-scaling schedule with a checkpoint to ``path`` every 10,
    then ``steps`` more (the uninterrupted run); an optimizer rebuilt from
    scratch loads the checkpoint, replays the steps after it and runs the
    same ``steps`` more.  ``optax_tx`` runs the torch optimizer in place of
    the Nesterov stage (``adam_lambda()``).  The kernels run where
    ``use_kernel`` (by default on CUDA).

    Returns a dict: ``saved`` and ``restored`` (``checkpoint.state_dict``
    of the optimizer at the last checkpoint and of the rebuilt one right
    after loading it), ``errors`` (the uninterrupted run's 2 ``steps``
    errors), ``resumed_errors`` (the rebuilt run's, from the checkpoint's
    iteration on), ``param`` and ``resumed_param`` (the final radius of
    each) and ``drift`` (their absolute difference).
    """
    device = resolve_device(device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    arc_loss, params = scenes2d.single_arc(dtype=dtype, device=device,
                                           use_kernel=use_kernel)

    def make():
        return single_arc_optimizer(arc_loss, params, device, optax_tx)

    opt = make()
    errors = []
    saved = None
    for i in range(steps):
        errors.append(self_scaling_step(opt))
        if (i + 1) % CHECKPOINT_EVERY == 0:
            checkpoint.save_checkpoint(path, opt)
            saved = checkpoint.state_dict(opt)
    for _ in range(steps):
        errors.append(self_scaling_step(opt))

    resumed = make()
    checkpoint.load_checkpoint(path, resumed)
    restored = checkpoint.state_dict(resumed)
    resumed_errors = []
    while resumed.iterations < 2 * steps:
        resumed_errors.append(self_scaling_step(resumed))
    param = float(opt.parameters[0][0])
    resumed_param = float(resumed.parameters[0][0])
    return {"saved": saved, "restored": restored, "errors": errors,
            "resumed_errors": resumed_errors, "param": param,
            "resumed_param": resumed_param,
            "drift": abs(resumed_param - param)}


class InteractiveLoop:
    """``examples/interactive_optimize.py``'s loop: the single-arc design
    (``scenes2d.single_arc_parts``, the stepwise example's optimizer and
    schedule) on a figure, stepped by key events.  The figure is made
    outside pyplot (``drawing.figure``), so the loop runs headless; its
    ``on_key`` takes matplotlib ``KeyEvent``s, and :meth:`simulate_key`
    makes them.  ``s`` saves a checkpoint into ``checkpoint_dir`` (nothing
    without one)."""

    def __init__(self, dtype=torch.float32, device=None, use_kernel=None,
                 checkpoint_dir=None):
        from tensorflowraytrace_tpu_torch import drawing

        device = resolve_device(device)
        if use_kernel is None:
            use_kernel = device.type == "cuda"
        self.parts = scenes2d.single_arc_parts(dtype=dtype, device=device,
                                               use_kernel=use_kernel)
        self.opt = single_arc_optimizer(self.parts["loss"],
                                        [self.parts["init"]], device)
        self.checkpoint_dir = checkpoint_dir
        self.saved = []
        self.losses = []
        self.closed = False
        self.fig = drawing.figure(figsize=(10, 4.5))
        self.ax, self.ax_loss = self.fig.subplots(1, 2, width_ratios=[3, 2])
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.redraw()

    def on_key(self, event):
        if event.key in (" ", "enter"):
            self.step()
        elif event.key == "b":
            for _ in range(10):
                self.step(redraw=False)
            self.redraw()
        elif event.key == "s" and self.checkpoint_dir is not None:
            path = os.path.join(self.checkpoint_dir, f"interactive_ckpt_"
                                f"{self.opt.iterations:04d}")
            self.saved.append(checkpoint.save_checkpoint(path, self.opt))
        elif event.key in ("q", "escape"):
            self.closed = True

    def step(self, redraw=True):
        self.losses.append(float(self_scaling_step(self.opt)))
        if redraw:
            self.redraw()

    def redraw(self):
        from tensorflowraytrace_tpu_torch import drawing

        parts, p = self.parts, self.opt.parameters[0][0]
        with torch.no_grad():
            scene = parts["build_scene"](p)
            res = trace(parts["rays"], scene, parts["materials"],
                        dataclasses.replace(parts["cfg"], keep_history=True))
        self.ax.clear()
        drawing.SegmentDrawer(self.ax, parts["target"], color="black",
                              draw_norm_arrows=False).draw()
        drawing.ArcDrawer(self.ax, scene.arcs, color="cyan").draw()
        drawing.RayDrawer2D(self.ax, drawing.history_rays(res)).draw()
        n_fin = int((res.rays.state == FINISHED).sum())
        self.ax.set_title(
            f"step {self.opt.iterations}  radius {float(p):.3f}  "
            f"{n_fin}/{res.rays.n_rays} land  "
            "(space: step, b: x10, s: save, q: quit)", fontsize=9)
        self.ax.set_xlim(-2, 11)
        self.ax.set_ylim(-6, 6)
        self.ax_loss.clear()
        if self.losses:
            self.ax_loss.semilogy(self.losses)
        self.ax_loss.set_xlabel("step")
        self.ax_loss.set_ylabel("loss")
        self.fig.canvas.draw()

    def simulate_key(self, key):
        """Drive :meth:`on_key` with a synthetic event."""
        from matplotlib.backend_bases import KeyEvent

        self.on_key(KeyEvent("key_press_event", self.fig.canvas, key))


def interactive_optimize(simulate, dtype=torch.float32, device=None,
                         use_kernel=None, checkpoint_dir=None, png=None):
    """Run ``examples/interactive_optimize.py``'s headless path: the keys
    of ``simulate`` through :class:`InteractiveLoop`; the loss must fall.
    Returns the loop (``losses``, ``opt``, ``saved``).  ``png``: a path to
    write the last drawn figure to."""
    loop = InteractiveLoop(dtype, device, use_kernel, checkpoint_dir)
    for key in simulate:
        loop.simulate_key(key)
    if not (loop.losses and loop.losses[-1] < loop.losses[0]):
        raise RuntimeError(f"interactive optimize: the simulated steps did "
                           f"not reduce the loss: {loop.losses}")
    if png is not None:
        loop.fig.savefig(png, dpi=100)
    return loop


def states_equal(a, b):
    """Whether two ``checkpoint.state_dict`` states are equal bit for bit
    (tensors by value, dtype and shape; everything else by ``==``)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(a.cpu(), b.cpu())))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(states_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(states_equal(x, y) for x, y in zip(a, b)))
    return a == b


def ring_image(size=64):
    """The example's goal image: a ring of grey level 200 at radius 0.6 of
    a (size, size) square on [-1, 1]^2."""
    yy, xx = np.mgrid[-1:1:size * 1j, -1:1:size * 1j]
    return ((np.abs(np.hypot(xx, yy) - 0.6) < 0.12) * 200).astype(np.uint8)


def precompile_pipeline(directory, n=300, sample_count=64, steps=3,
                        dtype=torch.float32, device=None, generator=None):
    """``examples/precompile_pipeline.py``: the offline stage on the host,
    its draws from CPU generators seeded 0 (the goal) and 1 (the source),
    as the example's keys 0 and 1, so that it is the same on every device;
    the cache pickled to ``directory``/precompiled_points.pkl and
    reloaded; then ``steps`` per-step samples on ``device`` from
    ``generator`` (one on the device seeded 0 when None).

    Returns a dict: ``goal_points`` and ``source_points`` (NumPy),
    ``matched`` (the goals matched to the sources), ``mean_distance``,
    ``path`` and ``samples`` (the per-step ``(points, ranks)``)."""
    device = resolve_device(device)
    host = torch.device("cpu")
    goal_dist = goals.ImageBasePoints.from_array(ring_image(), x_size=2.0)
    goal_points = goal_dist.sample(torch.Generator().manual_seed(0), dtype,
                                   host)[0].numpy()
    idx = np.random.default_rng(0).choice(goal_points.shape[0], n,
                                          replace=False)
    goal_points = goal_points[idx]
    src_dist = goals.ArbitraryBasePoints(
        goals.ArbitraryDistribution(
            lambda x, y: np.exp(-(x ** 2 + y ** 2) / 0.08),
            ((-1, 1, 64), (-1, 1, 64))),
        n, conserve_etendue=False)
    source_points = src_dist.sample(torch.Generator().manual_seed(1), dtype,
                                    host)[0].numpy()
    matched = goals.transform_map(source_points, goal_points)
    mean_distance = float(np.linalg.norm(source_points - matched,
                                         axis=1).mean())

    cache = goals.PrecompiledBasePoints(sample_count=sample_count,
                                        perturbation=(0.01, 0.01))
    cache.full_points = source_points
    cache.full_ranks = matched
    path = os.path.join(directory, "precompiled_points.pkl")
    cache.save(path)
    loaded = goals.PrecompiledBasePoints(path, sample_count=sample_count,
                                         perturbation=(0.01, 0.01))
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    samples = [loaded.sample(generator, dtype, device) for _ in range(steps)]
    return {"goal_points": goal_points, "source_points": source_points,
            "matched": matched, "mean_distance": mean_distance, "path": path,
            "samples": samples}
