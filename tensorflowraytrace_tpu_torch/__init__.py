"""tensorflowraytrace_tpu_torch: the PyTorch / CUDA port of the
differentiable optical ray tracer.

It mirrors the module paths of ``tensorflowraytrace_tpu`` (the JAX package,
which stays the reference) and imports no JAX.  This first slice is the 3D
forward trace:

  models/     rays, triangle surfaces, sources, distributions, boundaries,
              meshes
  ops/        geometry, materials, the nearest-hit search and its CUDA
              kernel (ops/triangle_kernels.py, csrc/triangle_search.cu)
  engine      the multi-bounce trace loop
  flagship    the parametric-lens imaging problem
  utils/      quaternions, NumPy conversion
"""

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.config import (
    ACTIVE, DEAD, FINISHED, OPTICAL, STOP, STOPPED, TARGET,
)
from tensorflowraytrace_tpu_torch.engine import TraceConfig, TraceResult, trace
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import Scene3D, TriangleSet

__version__ = "0.1.0"
