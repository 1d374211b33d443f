"""Ahead-of-time export: serialise a trace or a gradient program, reload it
and run it.

Counterpart of ``tensorflowraytrace_tpu/utils/export.py``, through
``torch.export``: a program is traced once for the example's shapes and
dtypes, saved with ``torch.export.save`` and run again from the bytes, in
another process too, without the code that built its scene.  Uses: freeze
a finished design's forward trace for an evaluation job; ship a training
step's value and gradient; archive the exact program beside a checkpoint
and an STL file.

The package's containers (``RaySet``, ``SegmentSet``, ``ArcSet``,
``TriangleSet``, ``Scene2D``, ``Scene3D``, ``Projection``,
``TraceResult``) are registered as pytrees with a serialised name, their
non-tensor fields in the context, so a program takes and returns them as
the original function does.

A program is shape-locked: a call with another shape or dtype than the
example's raises.

Departures from the JAX module:

- ``platforms``: ``None`` or the example's own device type.  ``jax.export``
  lowers for another platform than the one it runs on; ``torch.export``
  cannot, so any other value raises ``NotImplementedError``.
- A loaded program calls the port's ``tfrt_torch`` operators
  (``ops/custom_ops.py``) where the traced code ran a search or K2, so the
  process that loads it needs this package importable: :func:`load_fn`
  imports the operators, and on CUDA the kernels build at first use.  It
  needs none of the scene-building code.  A JAX artifact needs nothing of
  its package.
- :func:`export_trace` refuses ``early_exit``: the port's early exit reads
  the device before each bounce, where JAX's ``while_loop`` exports.
- The gradient program.  ``jax.value_and_grad(loss)`` exports like any
  function; ``torch.func`` transforms do not export.  :func:`value_and_grad`
  marks ``loss`` instead, with ``jax.value_and_grad``'s contract (the value
  and the gradient with respect to the first argument), and
  :func:`export_fn` exports it as a joint forward-backward program (the
  first argument as a parameter, the loss and its gradient as outputs);
  :func:`load_fn` gives back a callable of the original arguments that
  returns ``(value, grad)``.  This is the JAX module's capability, not a
  new one.  The joint export goes through
  ``torch.export.experimental._export_forward_backward``, torch's only
  route to it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
from typing import Callable, Optional, Sequence

import torch
import torch.export.experimental
import torch.fx.config as fx_config
from torch.utils import _pytree as pytree

from tensorflowraytrace_tpu_torch.engine import Projection, TraceResult, trace
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import (
    ArcSet, Scene2D, Scene3D, SegmentSet, TriangleSet,
)
from tensorflowraytrace_tpu_torch.ops import custom_ops  # noqa: F401 (the operators a program calls)

# the fields of each container that are not tensors (nor containers of
# them): they go into the pytree's context
_STATIC_FIELDS = {
    RaySet: (), SegmentSet: ("mats_specified",), ArcSet: ("mats_specified",),
    TriangleSet: ("mats_specified",), Scene2D: (), Scene3D: (),
    Projection: ("dim",), TraceResult: ("n_bounces",),
}


def _register(cls, static):
    names = [f.name for f in dataclasses.fields(cls)]
    children = [n for n in names if n not in static]

    def flatten(obj):
        return ([getattr(obj, n) for n in children],
                [getattr(obj, n) for n in static])

    def unflatten(values, context):
        return cls(**dict(zip(children, values)), **dict(zip(static, context)))

    def flatten_with_keys(obj):
        return ([(pytree.GetAttrKey(n), getattr(obj, n)) for n in children],
                [getattr(obj, n) for n in static])

    pytree.register_pytree_node(
        cls, flatten, unflatten,
        serialized_type_name=f"tensorflowraytrace_tpu_torch.{cls.__name__}",
        to_dumpable_context=json.dumps,
        from_dumpable_context=json.loads,
        flatten_with_keys_fn=flatten_with_keys)


for _cls, _static in _STATIC_FIELDS.items():
    if _cls not in pytree.SUPPORTED_NODES:
        _register(_cls, _static)


class ValueAndGrad:
    """``loss`` marked for a joint export: called, it returns ``(value,
    grad)``, the gradient of ``loss`` with respect to its first argument
    (a tensor), as ``jax.value_and_grad(loss)`` does."""

    def __init__(self, loss: Callable):
        self.loss = loss

    def __call__(self, x, *args, **kwargs):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            value = self.loss(x, *args, **kwargs)
            (grad,) = torch.autograd.grad(value, x)
        return value.detach(), grad


def value_and_grad(loss: Callable) -> ValueAndGrad:
    """The value and gradient of ``loss`` with respect to its first
    argument, as a callable that :func:`export_fn` exports as a joint
    program."""
    return ValueAndGrad(loss)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


class _Loss(torch.nn.Module):
    """The loss with its first argument as the parameter ``x``."""

    def __init__(self, loss, x):
        super().__init__()
        self.loss = loss
        self.x = torch.nn.Parameter(x.detach().clone())

    def forward(self, *args, **kwargs):
        return self.loss(self.x, *args, **kwargs)


def _check_platforms(platforms, example_args, example_kwargs):
    if platforms is None:
        return
    leaves = [t for t in pytree.tree_leaves((example_args, example_kwargs))
              if isinstance(t, torch.Tensor)]
    own = {t.device.type for t in leaves}
    if set(platforms) != own:
        raise NotImplementedError(
            f"torch.export lowers for the example's own device ({sorted(own)}"
            f"), not for {tuple(platforms)}: export on the device that will "
            "run the program")


@contextlib.contextmanager
def _no_stack_traces():
    """Trace without recording each node's Python stack trace, debugging
    metadata that costs a third of a trace's export time (where this
    torch has the switch)."""
    if not hasattr(fx_config, "do_not_emit_stack_traces"):
        yield
        return
    previous = fx_config.do_not_emit_stack_traces
    fx_config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        fx_config.do_not_emit_stack_traces = previous


def export_fn(fn: Callable, *example_args,
              platforms: Optional[Sequence[str]] = None,
              **example_kwargs) -> bytes:
    """Serialise ``fn`` traced for ``example_args``' shapes and dtypes.

    ``fn`` is a function of tensors and the package's containers, or a
    :func:`value_and_grad` of one (exported as a joint program).
    ``platforms``: ``None`` or the example tensors' own device type (see
    the module's notes).  Returns the bytes of ``torch.export.save``.
    """
    _check_platforms(platforms, example_args, example_kwargs)
    with _no_stack_traces():
        if isinstance(fn, ValueAndGrad):
            x, *rest = example_args
            exported = torch.export.export(_Loss(fn.loss, x), tuple(rest),
                                           example_kwargs or None)
            exported = torch.export.experimental._export_forward_backward(
                exported)
        else:
            exported = torch.export.export(_Fn(fn), tuple(example_args),
                                           example_kwargs or None)
    # the example's data is not part of the program (2^20 rays are 25 MB)
    exported.example_inputs = None
    buffer = io.BytesIO()
    torch.export.save(exported, buffer)
    return buffer.getvalue()


def _is_joint(exported) -> bool:
    return any(s.kind == torch.export.graph_signature.OutputKind.LOSS_OUTPUT
               for s in exported.graph_signature.output_specs)


class _JointProgram:
    """A loaded joint program as ``(x, *args) -> (value, grad)``.  The bare
    graph module checks no shape, so this checks every input against the
    example's."""

    def __init__(self, exported):
        self.exported = exported
        sig = exported.graph_signature
        kinds = torch.export.graph_signature
        self.inputs = [(s.kind, s.target) for s in sig.input_specs]
        self.examples = [node.meta["val"] for node in
                         exported.graph_module.graph.nodes
                         if node.op == "placeholder"]
        self.in_spec = exported.call_spec.in_spec
        outputs = sig.output_specs
        self.loss_at = next(i for i, s in enumerate(outputs)
                            if s.kind == kinds.OutputKind.LOSS_OUTPUT)
        # the gradient of _Loss's parameter x (a loss that is itself a
        # module adds its own parameters, read from the state dict)
        self.grad_at = next(i for i, s in enumerate(outputs)
                            if s.kind == kinds.OutputKind.GRADIENT_TO_PARAMETER
                            and s.target == "x")
        self.constants = {**exported.state_dict, **exported.constants}

    def __call__(self, x, *args, **kwargs):
        kinds = torch.export.graph_signature.InputKind
        user, spec = pytree.tree_flatten((args, kwargs))
        if spec != self.in_spec:
            raise ValueError(f"the program takes {self.in_spec}, got {spec}")
        user = iter(user)
        flat = []
        for kind, target in self.inputs:
            if kind == kinds.PARAMETER and target == "x":
                flat.append(x)
            elif kind == kinds.USER_INPUT:
                flat.append(next(user))
            else:
                flat.append(self.constants[target])
        for got, want in zip(flat, self.examples):
            if isinstance(want, torch.Tensor) and (
                    not isinstance(got, torch.Tensor)
                    or got.shape != want.shape or got.dtype != want.dtype):
                raise ValueError(
                    f"the program was exported for {tuple(want.shape)} "
                    f"{want.dtype}, got "
                    f"{tuple(getattr(got, 'shape', ()))} "
                    f"{getattr(got, 'dtype', type(got))}")
        out = self.exported.graph_module(*flat)
        return out[self.loss_at], out[self.grad_at]


def load_fn(blob: bytes) -> Callable:
    """Deserialise an :func:`export_fn` artifact into a callable of the
    original arguments: the traced function's outputs, or ``(value, grad)``
    for a joint program.  The port must be importable (its operators run
    the searches and K2); no scene code is needed."""
    exported = torch.export.load(io.BytesIO(blob))
    if _is_joint(exported):
        return _JointProgram(exported)
    return exported.module()


def save_exported(path: str, fn: Callable, *example_args, **kw) -> None:
    """:func:`export_fn` straight to a file."""
    blob = export_fn(fn, *example_args, **kw)
    with open(path, "wb") as f:
        f.write(blob)


def load_exported(path: str) -> Callable:
    """Load a :func:`save_exported` artifact."""
    with open(path, "rb") as f:
        return load_fn(f.read())


def export_trace(scene, materials, cfg, example_rays,
                 platforms: Optional[Sequence[str]] = None) -> bytes:
    """Freeze a scene's forward trace: an artifact whose callable maps a
    ``RaySet`` of the example's shapes and dtypes to the final
    ``TraceResult.rays``.  The scene, the materials and the configuration
    are baked into the program as constants; the serving side gives only
    rays.  ``cfg.early_exit`` raises (see the module's notes)."""
    if cfg.early_exit:
        raise ValueError("export_trace: early_exit reads the device before "
                         "each bounce and cannot be exported; export a "
                         "fixed max_bounces")
    materials = tuple(materials or ())

    def forward(rays):
        return trace(rays, scene, materials, cfg).rays

    return export_fn(forward, example_rays, platforms=platforms)
