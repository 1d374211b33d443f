"""Populations of lenses: ``examples/tolerancing.py`` (sensitivities and a
Monte-Carlo of manufacturing errors) and ``examples/design_sweep.py`` (a
coarse sweep and a momentum refinement of the best candidates).

The JAX examples ``jax.vmap`` one trace over the candidates.  A trace
that launches CUDA kernels cannot be vmapped, so here each candidate is
traced in turn: the same arithmetic a candidate, one after the other.  On
the card every trace runs K5 and K6 and every backward K2; elsewhere the
plain searches.  Each function raises where one of the example's checks
fails and returns the numbers the example prints.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.config import FINISHED, resolve_device
from tensorflowraytrace_tpu_torch.engine import trace
from tensorflowraytrace_tpu_torch.models import distributions as dist
from tensorflowraytrace_tpu_torch.models.surfaces import ArcSet, Scene2D, SegmentSet
from tensorflowraytrace_tpu_torch.ops import materials as mats
from tensorflowraytrace_tpu_torch.physics2d import (
    _checks, _collimated, _config, _host,
)

PI = math.pi


def _gradient(fn, p):
    """The value and gradient of the scalar ``fn`` at ``p``."""
    leaf = p.detach().requires_grad_(True)
    value = fn(leaf)
    grad, = torch.autograd.grad(value, leaf)
    return value.detach(), grad


# ----------------------------------------------------------------------
# examples/tolerancing.py
# ----------------------------------------------------------------------

TOL_GLASS = 1.5168
TOL_SCREEN_X = 12.0
TOL_APERTURE = 0.8
TOL_START = (0.08, 0.08, 0.0)
TOL_DESIGN_STEPS = 400
PARAM_NAMES = ("front curvature", "back curvature", "element x-shift")


def tolerancing_problem(n_rays=64, dtype=torch.float32, device=None):
    """``examples/tolerancing.py``'s biconvex arc lens from (c1, c2, dx)
    (curvatures clipped to [1e-3, 0.5]; glass of n = 1.5168), a screen at
    x = 12, ``n_rays`` collimated rays over |y| <= 0.8 (3 bounces).
    Returns ``spot(params)``, the RMS landing height of the landed
    rays."""
    device = resolve_device(device)
    materials = (mats.vacuum, mats.build_constant_material(TOL_GLASS))
    rays = _collimated(torch.as_tensor(np.linspace(
        -TOL_APERTURE, TOL_APERTURE, n_rays), dtype=dtype, device=device),
        -1.0, 550.0, dtype, device)
    screen = SegmentSet.make([[TOL_SCREEN_X, -6.0]], [[TOL_SCREEN_X, 6.0]],
                             dtype=dtype, device=device)

    def scene(params):
        c1, c2, dx = params[0], params[1], params[2]
        r1 = 1.0 / torch.clamp(c1, 1e-3, 0.5)
        r2 = 1.0 / torch.clamp(c2, 1e-3, 0.5)
        front = ArcSet.make(
            torch.stack([torch.stack([dx + r1, torch.zeros_like(r1)])]),
            3 * PI / 4, 5 * PI / 4, r1, mat_in=1, mat_out=0, dtype=dtype,
            device=device)
        back = ArcSet.make(
            torch.stack([torch.stack([dx + 0.4 - r2, torch.zeros_like(r2)])]),
            -PI / 4, PI / 4, r2, mat_in=1, mat_out=0, dtype=dtype,
            device=device)
        return Scene2D.build(optical_arcs=[front, back],
                             target_segments=[screen])

    cfg = _config(scene(torch.tensor(TOL_START, dtype=dtype, device=device)),
                  3, device)

    def spot(params):
        res = trace(rays, scene(params), materials, cfg)
        ok = res.rays.state == FINISHED
        y = torch.where(ok, res.rays.p1[:, 1], 0.0)
        n = torch.clamp(torch.sum(ok), min=1)
        return torch.sqrt(torch.sum(y * y) / n)

    spot.cfg = cfg
    return spot


def tolerance_design(spot, params, steps=TOL_DESIGN_STEPS):
    """The example's quick nominal design: ``steps`` of gradient descent
    (step 2e-3) on both curvatures, the position held."""
    mask = torch.tensor([1.0, 1.0, 0.0], dtype=params.dtype,
                        device=params.device)
    for _ in range(steps):
        _, g = _gradient(spot, params)
        params = params - 2e-3 * mask * g
    return params


def tolerancing(samples=512, n_rays=64, generator=None, normals=None,
                design_steps=TOL_DESIGN_STEPS, dtype=torch.float32,
                device=None, verbose=True):
    """``examples/tolerancing.py``: the nominal design, the spot's
    sensitivities to the three parameters, and a Monte-Carlo of
    ``samples`` builds with Gaussian errors (0.2% on each curvature, 0.02
    on the position), each build traced in turn (``design_steps``: the
    nominal design's, the example's 400); the example's checks: a
    yield above one half at the spec 4 x nominal + 0.01, every spot
    finite.  The errors are ``normals`` (samples, 3) standard normal
    draws where given, else drawn from ``generator`` (seeded 0 by
    default).  Returns a dict."""
    device = resolve_device(device)
    spot = tolerancing_problem(n_rays, dtype, device)
    t0 = time.perf_counter()
    params = tolerance_design(spot, torch.tensor(TOL_START, dtype=dtype,
                                                 device=device), design_steps)
    design_seconds = time.perf_counter() - t0
    nominal, sens = _gradient(spot, params)
    nominal, sens = float(nominal), _host(sens)
    p = [float(v) for v in params]
    sigmas = torch.tensor([0.002 * p[0], 0.002 * p[1], 0.02], dtype=dtype,
                          device=device)
    if normals is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        normals = torch.randn((samples, 3), generator=generator, dtype=dtype,
                              device=device)
    deltas = torch.as_tensor(normals, dtype=dtype, device=device) * sigmas
    t0 = time.perf_counter()
    with torch.no_grad():
        builds = params + deltas
        spots = _host(torch.stack([spot(b) for b in builds]))
    mc_seconds = time.perf_counter() - t0
    med, p95 = np.percentile(spots, [50, 95])
    spec = 4.0 * nominal + 0.01
    yield_frac = float(np.mean(spots <= spec))
    lin = float(torch.sqrt(torch.sum((torch.as_tensor(
        sens, dtype=dtype, device=device) * sigmas) ** 2)))
    out = {"params": p, "nominal": nominal, "sensitivities": sens,
           "spots": spots, "median": float(med), "p95": float(p95),
           "spec": spec, "yield": yield_frac, "linear_sigma": lin,
           "mc_sigma": float(np.std(spots)), "design_seconds": design_seconds,
           "mc_seconds": mc_seconds}
    if verbose:
        print(f"nominal design: RMS spot {nominal:.5f} (c1 {p[0]:.4f}, c2 "
              f"{p[1]:.4f}); sensitivities "
              + ", ".join(f"d(spot)/d({n}) = {s:+.4f}"
                          for n, s in zip(PARAM_NAMES, sens))
              + f"; Monte-Carlo of {samples}: median {med:.5f}, 95th pct "
              f"{p95:.5f}, yield at spec {spec:.4f}: {100 * yield_frac:.1f}%; "
              f"linear sigma {lin:.5f} vs MC sigma {out['mc_sigma']:.5f}")
    _checks("tolerancing", [
        (f"yield {yield_frac} not above 0.5", yield_frac > 0.5),
        ("a spot is not finite", bool(np.isfinite(spots).all()))])
    return out


# ----------------------------------------------------------------------
# examples/design_sweep.py
# ----------------------------------------------------------------------

def sweep_problem(n_rays=128, dtype=torch.float32, device=None):
    """``examples/design_sweep.py``'s problem (the single arc of
    ``optimize_single_arc.py``): ``n_rays`` collimated rays over
    |y| <= 1.2 through one acrylic arc whose centre x equals its radius,
    onto a target at x = 10 (2 bounces).  Returns ``loss(radius)``: the
    mean squared landing height, a miss counting 1."""
    device = resolve_device(device)
    rays = _collimated(torch.as_tensor(np.linspace(-1.2, 1.2, n_rays),
                                       dtype=dtype, device=device),
                       -1.0, 550.0, dtype, device)
    target = SegmentSet.make([[10.0, -5.0]], [[10.0, 5.0]], dtype=dtype,
                             device=device)
    materials = (mats.vacuum, mats.acrylic)

    def scene(radius):
        center = torch.stack([torch.stack([radius,
                                           torch.zeros_like(radius)])])
        arc = ArcSet.make(center, 0.75 * PI, 1.25 * PI, radius, mat_in=1,
                          mat_out=0, dtype=dtype, device=device)
        return Scene2D.build(optical_arcs=[arc], target_segments=[target])

    # the sweep's widest candidate sets the children's start
    cfg = _config(scene(torch.tensor(12.0, dtype=dtype, device=device)), 2,
                  device)

    def loss(radius):
        res = trace(rays, scene(radius), materials, cfg)
        hit = res.rays.state == FINISHED
        err = torch.sum(torch.where(hit, res.rays.p1[:, 1] ** 2, 1.0))
        return err / n_rays

    loss.cfg = cfg
    return loss


def population_losses(loss, radii):
    """The loss of every candidate, traced in turn (forward only)."""
    with torch.no_grad():
        return torch.stack([loss(r) for r in radii])


class MomentumPopulation:
    """The example's batched refinement: every candidate's gradient (one
    trace and backward each, in turn), non-finite entries zeroed, clipped
    to +-0.1, then the momentum update v = 0.8 v + g, p -= g + 0.8 v."""

    def __init__(self, loss, params):
        self.loss = loss
        self.params = params.detach().clone()
        self.velocity = torch.zeros_like(self.params)

    def step(self):
        g = torch.stack([_gradient(self.loss, p)[1] for p in self.params])
        g = torch.where(torch.isfinite(g), g, 0.0)
        g = torch.clamp(g, -0.1, 0.1)
        self.velocity = 0.8 * self.velocity + g
        self.params = self.params - (g + 0.8 * self.velocity)


def design_sweep(population=64, steps=60, top_k=8, n_rays=128,
                 dtype=torch.float32, device=None, verbose=True):
    """``examples/design_sweep.py``: the loss over ``population`` radii in
    [2, 12], ``steps`` momentum steps of the best ``top_k``, then the
    refined candidates and the coarse best evaluated again; the example's
    check: the best final loss no worse than the coarse best (+1e-9).
    Returns a dict."""
    device = resolve_device(device)
    loss = sweep_problem(n_rays, dtype, device)
    t0 = time.perf_counter()
    radii = dist._linspace(2.0, 12.0, population, dtype, device)
    losses = population_losses(loss, radii)
    order = torch.argsort(losses, stable=True)
    sweep_seconds = time.perf_counter() - t0
    pop = MomentumPopulation(loss, radii[order[:top_k]])
    t0 = time.perf_counter()
    for _ in range(steps):
        pop.step()
    refine_seconds = time.perf_counter() - t0
    pool = torch.cat([pop.params, radii[order[:1]]])
    final = population_losses(loss, pool)
    best = int(torch.argmin(final))
    coarse = float(losses[order[0]])
    out = {"radii": _host(radii), "losses": _host(losses),
           "coarse_radius": float(radii[order[0]]), "coarse_loss": coarse,
           "pool": _host(pool), "final": _host(final),
           "best_radius": float(pool[best]), "best_loss": float(final[best]),
           "sweep_seconds": sweep_seconds, "refine_seconds": refine_seconds}
    if verbose:
        print(f"swept {population} candidates; best coarse: r="
              f"{out['coarse_radius']:.3f} loss={coarse:.5f}; refined top-"
              f"{top_k} for {steps} steps: best r={out['best_radius']:.4f} "
              f"loss={out['best_loss']:.6f}")
    _checks("design_sweep", [
        (f"best final loss {out['best_loss']} above the coarse best "
         f"{coarse}", out["best_loss"] <= coarse + 1e-9)])
    return out
