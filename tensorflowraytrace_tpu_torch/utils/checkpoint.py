"""Checkpoint and resume of optimization runs, and export of trained
surfaces.

Counterpart of ``tensorflowraytrace_tpu/utils/checkpoint.py``.  The state
of an ``optim.Optimizer`` is its parameters, its Nesterov momentum buffers,
its iteration count and the state of its own ``torch.Generator`` (the
sampling stream its loss draws from), and, where it was built with
``optax_tx=``, the torch optimizer's and the scheduler's ``state_dict()``.
``save_checkpoint`` writes it to one file with ``torch.save``;
``load_checkpoint`` reads it with ``torch.load(weights_only=True)``.

A checkpoint restores the optimizer's generator explicitly: restoring the
global RNG (``torch.set_rng_state``) would leave a ``torch.Generator``
where it was.  Under a mesh every rank draws from its own generator, so
each rank saves and loads a file of its own.
"""

from __future__ import annotations

import copy

import torch


def state_dict(optimizer):
    """A copy of ``optimizer``'s full training state (no tensor in it is
    shared with the optimizer, so later steps leave it as it was)."""
    state = {
        "parameters": [p.detach().clone() for p in optimizer.parameters],
        "velocity": [v.detach().clone() for v in optimizer._velocity],
        "generator": optimizer.generator.get_state(),
        "iterations": int(optimizer.iterations),
    }
    tx = getattr(optimizer, "_tx", None)
    if tx is not None:
        scheduler = optimizer._scheduler
        state["tx"] = copy.deepcopy(tx.state_dict())
        state["scheduler"] = (None if scheduler is None
                              else copy.deepcopy(scheduler.state_dict()))
    return state


def _like(values, targets):
    """``values`` as tensors in the dtype and on the device of ``targets``."""
    if len(values) != len(targets):
        raise ValueError(f"the optimizer has {len(targets)} tensors here; the "
                         f"state has {len(values)}")
    return [torch.as_tensor(v, dtype=t.dtype, device=t.device).clone()
            for v, t in zip(values, targets)]


def restore_into(optimizer, state):
    """Restore a state made by :func:`state_dict` (or read by
    :func:`load_checkpoint`) into ``optimizer``, which must have been built
    alike (the same parameter shapes, and ``optax_tx=`` if and only if the
    saved one had it).  The parameters and buffers take the dtype and the
    device of the optimizer's own; with ``optax_tx=`` the parameters are
    copied into the tensors the torch optimizer steps.  Returns the
    optimizer."""
    tx = getattr(optimizer, "_tx", None)
    if (tx is None) != ("tx" not in state):
        raise ValueError(
            "the checkpoint and the optimizer differ in their optax_tx: "
            f"the state {'has' if 'tx' in state else 'has no'} torch "
            f"optimizer state, the optimizer {'has' if tx else 'has no'} "
            "torch optimizer")
    parameters = _like(state["parameters"], optimizer.parameters)
    if tx is not None:
        with torch.no_grad():
            for p, saved in zip(optimizer.parameters, parameters):
                p.copy_(saved)
        tx.load_state_dict(state["tx"])
        if (optimizer._scheduler is None) != (state["scheduler"] is None):
            raise ValueError("the checkpoint and the optimizer differ in "
                             "their learning-rate scheduler")
        if optimizer._scheduler is not None:
            optimizer._scheduler.load_state_dict(state["scheduler"])
    else:
        optimizer.parameters = parameters
    optimizer._velocity = _like(state["velocity"], optimizer._velocity)
    optimizer.generator.set_state(
        torch.as_tensor(state["generator"], dtype=torch.uint8, device="cpu"))
    optimizer.iterations = int(state["iterations"])
    return optimizer


def save_checkpoint(path, optimizer):
    """Save ``optimizer``'s training state to the file ``path``; returns
    ``path``."""
    torch.save(state_dict(optimizer), path)
    return path


def load_checkpoint(path, optimizer):
    """Load the training state :func:`save_checkpoint` wrote to ``path``
    into ``optimizer``; returns the optimizer."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return restore_into(optimizer, state)


def export_boundary_stl(boundary, params, filename):
    """Write ``boundary`` (a parametric triangle boundary or guide) at
    ``params`` to ``filename`` as binary STL; returns the file name."""
    boundary.updated_mesh(params).save(filename)
    return filename
