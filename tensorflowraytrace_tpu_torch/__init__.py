"""tensorflowraytrace_tpu_torch: the PyTorch / CUDA port of the
differentiable optical ray tracer.

It mirrors the module paths of ``tensorflowraytrace_tpu`` (the JAX package,
which stays the reference) and imports no JAX and nothing of the JAX
package.  Its slices so far are the 3D forward trace, training, the
acceleration path, the 2D trace and the deep 2D trace (two-level 2D
searches, remat, early exit, folds, TraceConfig.recommended):

  models/     rays, surfaces (2D segments and arcs, 3D triangles, the
              merged Scene2D and Scene3D), sources, distributions (2D
              angles and beams, 3D squares and spheres), boundaries (lens
              surfaces, the cylindrical light guide), meshes and their
              accumulator / smoother tools, acceleration (Morton sorts,
              chunk boxes)
  ops/        geometry (2D and 3D), materials, the nearest-hit search and
              its CUDA kernels: triangles (ops/triangle_kernels.py: brute
              force csrc/triangle_search.cu, culled triangle_search_culled.cu,
              two-level triangle_search_twolevel.cu), segments
              (ops/segment_kernels.py: segment_search.cu,
              segment_search_culled.cu, segment_search_twolevel.cu) and
              arcs (ops/arc_kernels.py: arc_search.cu, arc_search_culled.cu,
              arc_search_twolevel.cu); the gather's backward
              as a CUDA segment sum (ops/segsum_kernels.py,
              csrc/segment_sum.cu); and their nvcc build (ops/cuda_build.py)
  engine      the multi-bounce trace loop, 2D and 3D, and its folds
  optim       the optimizers (gradient pipeline, phases)
  flagship    the parametric-lens imaging problem and its training run
  utils/      rotations, NumPy conversion

Everything is built on CUDA unless a ``device=`` says otherwise
(``config.set_default_device`` changes the default).
"""

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.config import (
    ACTIVE, DEAD, FINISHED, OPTICAL, STOP, STOPPED, TARGET,
)
from tensorflowraytrace_tpu_torch.engine import TraceConfig, TraceResult, trace
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import (
    ArcSet, Scene2D, Scene3D, SegmentSet, TriangleSet,
)

__version__ = "0.1.0"
