"""Optimization: gradient processing and training routines.

Counterpart of ``tensorflowraytrace_tpu/optim.py``.  The per-step pipeline
is the JAX package's, stage for stage:

    grads = d(error)/d(params)            # through scene build + trace
    grad  = where(finite, grad, 0)        # non-finite guard
    grad *= lr_scale * individual_lr * learning_rate
    grad  = clip(grad, +-clip)            # common or individual mode
    grad  = accumulator @ grad            # mesh-graph accumulation
    v = mu v + grad; params -= grad + mu v  # explicit Nesterov momentum
    params  = smoother @ params           # optional smoothing

Loss functions are pure: ``loss_fn(params, generator, *args, **kwargs) ->
scalar`` (without the generator when ``pass_key=False``).  The optimizer
owns one ``torch.Generator`` and hands it to the loss every step, so a loss
that samples its rays from it draws fresh rays each step.

The optimizer's stages keep everything on the device: the learning-rate
scale, momentum and clip enter as Python numbers, so they copy no scalar to
the device and read none back (the loss may sync on its own).
``run_phase`` (and ``training_routine(chain=True)``) keeps the per-step
errors on the device and fetches them once at the end of the phase.  Not ported: ``mesh=`` (data parallelism over devices) and
``optax_tx=``; both raise ``NotImplementedError``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.config import resolve_device


def _plist(data, n, what):
    """Broadcast a scalar-or-list argument to a list of length n."""
    if isinstance(data, (list, tuple)):
        if len(data) != n:
            raise ValueError(f"{what} must have one element per parameter")
        return list(data)
    return [data] * n


def _lr_schedule(lr, steps):
    """Scalar or (start, end) ramp -> per-step list."""
    if isinstance(lr, (tuple, list)) and len(lr) == 2:
        return [float(x) for x in np.linspace(lr[0], lr[1], steps)]
    return [lr] * steps


def _grad_hygiene(g, lr_scale, ind_lr, learning_rate, clip_mode, clip_scale,
                  grad_clip, accumulator):
    """Finite-guard -> lr scale -> clip -> accumulator matmul.  The clip
    thresholds apply to the lr-premultiplied gradient.  ``lr_scale`` and the
    clip are Python numbers; the accumulator is in the gradient's dtype."""
    scale = lr_scale * ind_lr * learning_rate
    g = torch.where(torch.isfinite(g), g, 0.0)
    g = g * scale
    if clip_mode == "common":
        clip = grad_clip
    else:
        clip = ind_lr * clip_scale * learning_rate * lr_scale
    g = torch.clamp(g, -clip, clip)
    if accumulator is not None:
        g = (accumulator @ g.reshape(-1, 1)).reshape(g.shape)
    return g


def _smooth(p, smoother):
    if smoother is not None:
        p = (smoother @ p.reshape(-1, 1)).reshape(p.shape)
    return p


def _apply_param_update(p, g, v, lr_scale, momentum, ind_lr, learning_rate,
                        clip_mode, clip_scale, grad_clip, accumulator,
                        smoother):
    """One parameter's gradient hygiene + Nesterov update + smoothing.
    Returns the new ``(p, v)``."""
    g = _grad_hygiene(g, lr_scale, ind_lr, learning_rate, clip_mode,
                      clip_scale, grad_clip, accumulator)
    v = momentum * v + g
    p = p - (g + momentum * v)
    return _smooth(p, smoother), v


def _as_param(p):
    """A detached copy of ``p`` (a tensor keeps its device; anything else
    goes to the default device)."""
    if isinstance(p, torch.Tensor):
        return p.detach().clone()
    return torch.as_tensor(np.asarray(p), device=resolve_device(None))


def _as_matrices(mats, params, what):
    """Per-parameter accumulator or smoother matrices in each parameter's
    dtype and on its device (None stays None)."""
    return [None if a is None else
            torch.as_tensor(a, dtype=p.dtype, device=p.device)
            for a, p in zip(_plist(mats, len(params), what), params)]


def _value_and_grad(loss_fn, params, pass_key, generator, args, kwargs):
    """The loss and its gradient with respect to every parameter (zeros for
    a parameter the loss does not reach)."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        if pass_key:
            error = loss_fn(leaves, generator, *args, **kwargs)
        else:
            error = loss_fn(leaves, *args, **kwargs)
        grads = torch.autograd.grad(error, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return error.detach(), grads


class Optimizer:
    """Gradient descent for parametric optics.

    Parameters
    ----------
    loss_fn : callable
        ``loss_fn(params, generator, *args, **kwargs) -> scalar`` when
        ``pass_key`` (default), else ``loss_fn(params, *args, **kwargs)``.
        ``params`` is a list of tensors.  The function builds the scene from
        params, traces, and returns the error.
    parameters : list of tensors or arrays
        Initial parameter values (one entry per optic surface).
    generator : torch.Generator, optional
        The sampling generator handed to ``loss_fn`` (default: one on the
        first parameter's device, seeded 0).
    """

    def __init__(self, loss_fn, parameters, learning_rate=1.0, momentum=0.0,
                 individual_lr=None, grad_clip="default", clip_mode="common",
                 clip_scale=10.0, pass_key=True, generator=None, mesh=None,
                 optax_tx=None):
        if not isinstance(parameters, (list, tuple)):
            raise ValueError("Optimizer: parameters must be a list of arrays")
        if mesh is not None:
            raise NotImplementedError(
                "Optimizer(mesh=...) (data parallelism over devices) is not "
                "ported yet")
        if optax_tx is not None:
            raise NotImplementedError(
                "Optimizer(optax_tx=...) is not ported; the builtin Nesterov "
                "update is")
        self.loss_fn = loss_fn
        self.parameters = [_as_param(p) for p in parameters]
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.individual_lr = (list(individual_lr) if individual_lr is not None
                              else [1.0] * len(self.parameters))
        self.clip_scale = clip_scale
        self.grad_clip = (clip_scale * learning_rate if grad_clip == "default"
                          else grad_clip)
        if clip_mode not in ("common", "individual"):
            raise ValueError("clip_mode must be 'common' or 'individual'")
        self.clip_mode = clip_mode
        self.pass_key = pass_key
        self.generator = (generator if generator is not None else
                          torch.Generator(self.parameters[0].device)
                          .manual_seed(0))
        self.iterations = 0
        self._velocity = [torch.zeros_like(p) for p in self.parameters]

    def _step(self, accumulators, smoothers, lr_scale, momentum, args,
              kwargs):
        """One step on the device; returns the error as a device scalar."""
        error, grads = _value_and_grad(self.loss_fn, self.parameters,
                                       self.pass_key, self.generator, args,
                                       kwargs)
        with torch.no_grad():
            for i, (p, g, v) in enumerate(zip(self.parameters, grads,
                                              self._velocity)):
                self.parameters[i], self._velocity[i] = _apply_param_update(
                    p, g, v, lr_scale, momentum, self.individual_lr[i],
                    self.learning_rate, self.clip_mode, self.clip_scale,
                    self.grad_clip, accumulators[i], smoothers[i])
        self.iterations += 1
        return error

    def single_step(self, accumulators=None, *args, lr_scale=1.0,
                    momentum=None, smoothers=None, verbose=False, sync=True,
                    **kwargs):
        """One optimization step.  Returns the error (a Python float if
        ``sync``, else a device scalar)."""
        accumulators = _as_matrices(accumulators, self.parameters,
                                    "accumulators")
        smoothers = _as_matrices(smoothers, self.parameters, "smoothers")
        momentum = self.momentum if momentum is None else momentum
        error = self._step(accumulators, smoothers, float(lr_scale),
                           float(momentum), args, kwargs)
        if not sync:
            return error
        err = float(error)
        if verbose:
            print(f"step {self.iterations} error: {err}")
        return err

    def run_phase(self, steps, accumulators=None, *args, lr_scale=1.0,
                  momentum=None, smoothers=None, **kwargs):
        """Run ``steps`` optimization steps; the optimizer adds no host sync
        between them.

        ``lr_scale`` may be a scalar or a (start, end) ramp.  Returns the
        per-step errors as a numpy array, fetched from the device once.
        """
        accumulators = _as_matrices(accumulators, self.parameters,
                                    "accumulators")
        smoothers = _as_matrices(smoothers, self.parameters, "smoothers")
        momentum = float(self.momentum if momentum is None else momentum)
        errors = [self._step(accumulators, smoothers, float(s), momentum,
                             args, kwargs)
                  for s in _lr_schedule(lr_scale, steps)]
        if not errors:
            return np.zeros((0,))
        return torch.stack(errors).cpu().numpy()

    @staticmethod
    def smooth(parameters, smoother):
        """Standalone smoothing."""
        if smoother is None:
            return parameters
        smoother = torch.as_tensor(smoother, dtype=parameters.dtype,
                                   device=parameters.device)
        return (smoother @ parameters.reshape(-1, 1)).reshape(parameters.shape)

    def training_routine(self, routine, post_step=None, report_frequency=1,
                         show_time=True, chain=False):
        """Run phases of optimization steps.

        Each phase dict may override: steps, learning_rate (scalar or
        (start, end) ramp of the *relative* rate), momentum, accumulators,
        smoothers, erf_args, erf_kwargs, individual_lr.  Returns the list of
        per-step errors.

        ``chain=True`` runs each whole phase through :meth:`run_phase`: no
        host sync between its steps, per-step reporting and ``post_step``
        are skipped (``post_step`` runs once after the phase).
        """
        phase = {
            "steps": 10,
            "learning_rate": 1.0,
            "momentum": 0.0,
            "accumulators": None,
            "smoothers": None,
            "erf_args": [],
            "erf_kwargs": {},
            "individual_lr": None,
        }
        self.iterations = 0
        errors = []
        total_iterations = sum(p.get("steps", phase["steps"]) for p in routine)
        start_time = time.time()

        for phase_idx, new_phase in enumerate(routine):
            phase.update(new_phase)
            if phase["steps"] <= 0:
                continue  # a scaled-down routine may round a phase to 0 steps
            lrs = _lr_schedule(phase["learning_rate"], phase["steps"])
            if phase["individual_lr"] is not None:
                self.individual_lr = list(phase["individual_lr"])
            if chain:
                phase_errors = self.run_phase(
                    phase["steps"], phase["accumulators"],
                    *phase["erf_args"],
                    lr_scale=phase["learning_rate"],
                    momentum=phase["momentum"],
                    smoothers=phase["smoothers"],
                    **phase["erf_kwargs"],
                )
                errors.extend(float(e) for e in phase_errors)
                if report_frequency:
                    print(f"Phase {phase_idx + 1}/{len(routine)} "
                          f"({phase['steps']} steps, chained): final error "
                          f"{float(phase_errors[-1])}.")
                if post_step:
                    post_step()
                continue
            for i in range(phase["steps"]):
                reporting = (report_frequency
                             and (self.iterations + 1) % report_frequency == 0)
                err = self.single_step(
                    phase["accumulators"],
                    *phase["erf_args"],
                    lr_scale=lrs[i],
                    momentum=phase["momentum"],
                    smoothers=phase["smoothers"],
                    sync=bool(reporting),
                    **phase["erf_kwargs"],
                )
                errors.append(err)
                if reporting:
                    print(
                        f"Phase {phase_idx + 1}/{len(routine)}, "
                        f"step {i + 1}/{phase['steps']}, "
                        f"total {self.iterations}/{total_iterations}-"
                        f"{100 * self.iterations / total_iterations:.1f}%.  "
                        f"Error: {err}."
                    )
                if post_step:
                    post_step()

        # one device-to-host fetch for all unsynced per-step errors
        device_errors = [e for e in errors if isinstance(e, torch.Tensor)]
        if device_errors:
            fetched = iter(torch.stack(device_errors).cpu().tolist())
            errors = [next(fetched) if isinstance(e, torch.Tensor) else e
                      for e in errors]

        if show_time:
            total = time.time() - start_time
            print(f"Completed training routine.  Took {total} seconds.")
            print(f"Steps took an average of {total / max(total_iterations, 1)}"
                  " seconds per step.")
        return errors


class CanyonOptimizer:
    """Adaptive-step momentum descent with undo-on-regression.

    Each successful step grows the step size; a step that increases the
    error is UNDONE, the velocity is zeroed, and the step size shrinks.
    ``loss_fn(params, generator) -> scalar`` as with Optimizer
    (``pass_key=True``), else ``loss_fn(params)``.  Each step reads its error
    back to the host to decide.
    """

    def __init__(self, loss_fn, parameters, base_step_size=1.0, momentum=0.95,
                 growth_factor=1.1, shrink_factor=0.5, pass_key=True,
                 generator=None):
        if not isinstance(parameters, (list, tuple)):
            raise ValueError("CanyonOptimizer: parameters must be a list")
        self.loss_fn = loss_fn
        self.parameters = [_as_param(p) for p in parameters]
        self.step_size = base_step_size
        self.momentum = momentum
        self.growth_factor = growth_factor
        self.shrink_factor = shrink_factor
        self.pass_key = pass_key
        self.generator = (generator if generator is not None else
                          torch.Generator(self.parameters[0].device)
                          .manual_seed(0))
        self._velocity = [torch.zeros_like(p) for p in self.parameters]
        self._prev_error = None
        self._prev_params = None
        self.iterations = 0

    def single_step(self, verbose=False):
        error, grads = _value_and_grad(self.loss_fn, self.parameters,
                                       self.pass_key, self.generator, (), {})
        error = float(error)

        if self._prev_error is not None and error > self._prev_error:
            # regression: undo, kill velocity, shrink
            self.parameters = self._prev_params
            self._velocity = [torch.zeros_like(p) for p in self.parameters]
            self.step_size *= self.shrink_factor
            if verbose:
                print(f"step {self.iterations}: regression "
                      f"({self._prev_error:.4g} -> {error:.4g}); undo, "
                      f"step_size={self.step_size:.3g}")
            self.iterations += 1
            return self._prev_error

        self._prev_params = list(self.parameters)
        new_params = []
        new_velocity = []
        with torch.no_grad():
            for p, g, v in zip(self.parameters, grads, self._velocity):
                g = torch.where(torch.isfinite(g), g, 0.0)
                v = self.momentum * v + g
                new_params.append(p - self.step_size * v)
                new_velocity.append(v)
        self.parameters = new_params
        self._velocity = new_velocity
        self._prev_error = error
        self.step_size *= self.growth_factor
        self.iterations += 1
        if verbose:
            print(f"step {self.iterations} error: {error:.4g} "
                  f"step_size={self.step_size:.3g}")
        return error

    def run(self, steps, verbose=False):
        return [self.single_step(verbose=verbose) for _ in range(steps)]
