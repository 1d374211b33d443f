"""RaySet: the fixed-slot ray container.

Counterpart of ``tensorflowraytrace_tpu/models/rays.py``.  One slot per ray
for the whole trace: a ray that dies or finishes keeps its slot and only its
``state`` code changes, so extra per-ray fields ride along automatically.
Coordinates are ``p0``/``p1`` of shape (N, dim).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict

import torch

from tensorflowraytrace_tpu_torch.config import (
    ACTIVE, DEAD, FINISHED, STOPPED, resolve_device, resolve_dtype,
)


@dataclass
class RaySet:
    """A batch of rays.

    p0, p1 : (N, dim) start / end points.
    wavelength : (N,) in nm.
    state : (N,) int32 life-cycle code (ACTIVE/FINISHED/STOPPED/DEAD).
    fields : extra per-ray tensors with leading dimension N (rank, ...).
    """

    p0: torch.Tensor
    p1: torch.Tensor
    wavelength: torch.Tensor
    state: torch.Tensor
    fields: Dict[str, torch.Tensor] = field(default_factory=dict)

    @staticmethod
    def make(p0, p1, wavelength=None, state=None, fields=None, dtype=None,
             device=None):
        dtype = resolve_dtype(dtype)
        if device is None and isinstance(p0, torch.Tensor):
            device = p0.device
        device = resolve_device(device)
        p0 = torch.as_tensor(p0, dtype=dtype, device=device)
        p1 = torch.as_tensor(p1, dtype=dtype, device=device)
        n = p0.shape[0]
        if wavelength is None:
            wavelength = torch.zeros((n,), dtype=dtype, device=device)
        else:
            wavelength = torch.as_tensor(
                wavelength, dtype=dtype, device=device).expand(n).clone()
        if state is None:
            state = torch.full((n,), ACTIVE, dtype=torch.int32, device=device)
        else:
            state = torch.as_tensor(state, dtype=torch.int32, device=device)
        fields = {k: torch.as_tensor(v, device=device)
                  for k, v in dict(fields or {}).items()}
        return RaySet(p0=p0, p1=p1, wavelength=wavelength, state=state,
                      fields=fields)

    @property
    def dim(self) -> int:
        return self.p0.shape[-1]

    @property
    def n_rays(self) -> int:
        return self.p0.shape[0]

    def __len__(self) -> int:
        return self.n_rays

    def with_field(self, name, value):
        fields = dict(self.fields)
        fields[name] = torch.as_tensor(value, device=self.p0.device)
        return dataclasses.replace(self, fields=fields)

    # ---------------- state masks ----------------

    @property
    def active_mask(self):
        return self.state == ACTIVE

    @property
    def finished_mask(self):
        return self.state == FINISHED

    @property
    def stopped_mask(self):
        return self.state == STOPPED

    @property
    def dead_mask(self):
        return self.state == DEAD

    def select(self, mask):
        """Compacted copy of the slots where ``mask`` holds (for drawing and
        analysis; the trace itself never compacts)."""
        return RaySet(
            p0=self.p0[mask], p1=self.p1[mask],
            wavelength=self.wavelength[mask], state=self.state[mask],
            fields={k: v[mask] for k, v in self.fields.items()},
        )

    @property
    def finished(self):
        return self.select(self.finished_mask)

    @property
    def active(self):
        return self.select(self.active_mask)

    @property
    def stopped(self):
        return self.select(self.stopped_mask)

    @property
    def dead(self):
        return self.select(self.dead_mask)
