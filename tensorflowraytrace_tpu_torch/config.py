"""Global numeric configuration for the PyTorch port.

Counterpart of ``tensorflowraytrace_tpu/config.py``: the surface categories,
the ray life-cycle state codes and the dtype-derived divide-safety epsilon.
The working dtype is float32 by default (the GPU path); float64 is opt-in for
parity and gradient checks.
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


def resolve_dtype(dtype=None) -> torch.dtype:
    return DEFAULT_DTYPE if dtype is None else dtype


def resolve_device(device=None) -> torch.device:
    return torch.device("cpu") if device is None else torch.device(device)


def default_epsilon(dtype) -> float:
    """Divide-safety epsilon matched to the dtype: 1e-10 in float64 (the
    reference's value), 1e-6 in float32."""
    if dtype == torch.float64:
        return 1e-10
    return 1e-6
