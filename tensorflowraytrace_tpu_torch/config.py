"""Global numeric configuration for the PyTorch port.

Counterpart of ``tensorflowraytrace_tpu/config.py``: the surface categories,
the ray life-cycle state codes and the dtype-derived divide-safety epsilon.
The working dtype is float32 by default (the GPU path); float64 is opt-in for
parity and gradient checks.  The default device is CUDA.
"""

from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float32

# Boundary categories (reference engine.py:14-16)
OPTICAL = 0
STOP = 1
TARGET = 2

# Ray life-cycle states: a ray keeps its slot for the whole trace and only
# its state code changes.
ACTIVE = 0
FINISHED = 1
STOPPED = 2
DEAD = 3


# The device that constructors given no ``device=`` build on.  The port runs
# on the card; the CPU is had only by asking for it.
_default_device = torch.device("cuda")


def resolve_dtype(dtype=None) -> torch.dtype:
    return DEFAULT_DTYPE if dtype is None else dtype


def set_default_device(device) -> torch.device:
    """Make ``device`` the default of every constructor that is given no
    ``device=``; returns the previous default, so a caller can restore it."""
    global _default_device
    previous = _default_device
    _default_device = torch.device(device)
    return previous


def default_device() -> torch.device:
    """The default device as set (CUDA unless :func:`set_default_device`
    changed it).  Unlike :func:`resolve_device` it does not check that the
    device is available: it says where the port would run."""
    return _default_device


def resolve_device(device=None) -> torch.device:
    """``device``, or the default device (CUDA unless set otherwise by
    :func:`set_default_device`).  Raises when the default is CUDA and no
    CUDA device is available: the port never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if _default_device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' or call "
            "tensorflowraytrace_tpu_torch.config.set_default_device('cpu') "
            "to run on the CPU")
    return _default_device


def default_epsilon(dtype) -> float:
    """Divide-safety epsilon matched to the dtype: 1e-10 in float64 (the
    reference's value), 1e-6 in float32."""
    if dtype == torch.float64:
        return 1e-10
    return 1e-6
