"""tensorflowraytrace_tpu_torch: the PyTorch / CUDA port of the
differentiable optical ray tracer.

It mirrors the module paths of ``tensorflowraytrace_tpu`` (the JAX package,
which stays the reference) and imports no JAX and nothing of the JAX
package.  Its slices so far are the 3D forward trace, training, and the
acceleration path:

  models/     rays, triangle surfaces, sources, distributions, boundaries
              (lens surfaces, the cylindrical light guide), meshes and their
              accumulator / smoother tools, acceleration (Morton sort, chunk
              boxes)
  ops/        geometry, materials, the nearest-hit search and its CUDA
              kernels (ops/triangle_kernels.py: brute force
              csrc/triangle_search.cu, culled triangle_search_culled.cu,
              two-level triangle_search_twolevel.cu), the gather's backward
              as a CUDA segment sum (ops/segsum_kernels.py,
              csrc/segment_sum.cu), and their nvcc build (ops/cuda_build.py)
  engine      the multi-bounce trace loop
  optim       the optimizers (gradient pipeline, phases)
  flagship    the parametric-lens imaging problem and its training run
  utils/      quaternions, NumPy conversion

Everything is built on CUDA unless a ``device=`` says otherwise
(``config.set_default_device`` changes the default).
"""

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.config import (
    ACTIVE, DEAD, FINISHED, OPTICAL, STOP, STOPPED, TARGET,
)
from tensorflowraytrace_tpu_torch.engine import TraceConfig, TraceResult, trace
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import Scene3D, TriangleSet

__version__ = "0.1.0"
