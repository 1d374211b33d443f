"""tensorflowraytrace_tpu_torch: the PyTorch / CUDA port of the
differentiable optical ray tracer.

It mirrors the module paths of ``tensorflowraytrace_tpu`` (the JAX package,
which stays the reference) and imports no JAX and nothing of the JAX
package.  Its slices so far are the 3D forward trace, training, the
acceleration path, the 2D trace, the deep 2D trace (two-level 2D
searches, remat, early exit, folds, TraceConfig.recommended), and the
sources, distributions, STL I/O and analysis core that run the hexalens
design and the 3D point-source trace, streaming and data parallelism, the
reactions and trackers, and the rest of the boundaries and mesh tools,
the torch-optimizer stage (``Optimizer(optax_tx=...)``) and the
physical-optics analysis that run the asphere singlet, BASELINE config 2,
the Strehl lens and the hexalens image-quality test, and the classical
lens design that runs the Cooke triplet, the lens report, the best-form
singlet and the sequential-against-mesh trace, the goals, the
checkpoint and the reference's stateful facade, and the last examples
(the reaction designs, tolerancing and the design sweep, the source
demos, the guide benchmark):

  system      the stateful facade (OpticalSystem2D / OpticalSystem3D,
              OpticalEngine, SGD_Optimizer) over update.RecursivelyUpdatable;
              drawing.history_rays flattens a trace's history
  models/     rays (and concat_rays), surfaces (2D segments and arcs, 3D
              triangles, the merged Scene2D and Scene3D), sources (point,
              angular, aperture, precompiled, manual), distributions
              (angles, beams, apertures, squares, circles, sphere caps,
              transformations; the goals of models/goals: density warps,
              CDFs, the Hungarian matching, image and precompiled point
              sets), boundaries (triangle, segment and
              even-asphere surfaces, single or several under constraints,
              master-slave symmetry, the cylindrical light guide, static
              surfaces from data or STL), meshes (circular, hexagonal,
              cylindrical; STL files; re-meshing and cleaning) and their
              accumulator / smoother tools, acceleration (Morton sorts,
              chunk boxes)
  operations  the reactions and trackers: Fresnel intensity, Jones
              polarization, optical path and ancestry, thin films,
              gratings, bulk and surface absorption, metasurfaces, rough
              surfaces, forced branches and Russian roulette, with the
              counter-based random stream of the stochastic ones
  ops/        geometry (2D and 3D), materials, spectrum, thin-film stacks
              (thinfilm), the even-asphere sag (asphere), the nearest-hit
              search and its CUDA kernels: triangles
              (ops/triangle_kernels.py: brute force csrc/triangle_search.cu,
              culled triangle_search_culled.cu, two-level
              triangle_search_twolevel.cu), segments
              (ops/segment_kernels.py: segment_search.cu,
              segment_search_culled.cu, segment_search_twolevel.cu) and
              arcs (ops/arc_kernels.py: arc_search.cu, arc_search_culled.cu,
              arc_search_twolevel.cu); the gather's backward
              as a CUDA segment sum (ops/segsum_kernels.py,
              csrc/segment_sum.cu); and their nvcc build (ops/cuda_build.py)
  engine      the multi-bounce trace loop, 2D and 3D, and its folds (the
              landing histogram among them); the streamed trace and the
              streamed value and gradient
  parallel/   rays split over torch.distributed ranks (sharding), the
              ray-sharded PSF
  analysis    histograms (hard and differentiable), imaging tests, the
              distribution differential; the Huygens-Fresnel PSF
              (monochromatic and polychromatic), Zernike fits, encircled
              energy and the MTF
  sequential  the analytic tracer of an ordered stack of rotationally
              symmetric aspheres (classical lens design): exact conic
              seeds refined by Newton on the sag, no tessellation
  paraxial    first- and third-order analysis of such a stack: the ABCD
              system, cardinal points, Petzval and Seidel sums, stop
              solves, axial and lateral colour, Gaussian beams, real-ray
              field curves
  lsq         damped least squares (Levenberg-Marquardt), the classical
              lens optimizer (not exported here, as in the JAX package)
  optim       the optimizers (gradient pipeline, phases; a torch.optim
              optimizer in place of the Nesterov stage)
  flagship    the parametric-lens imaging problem and its training run
  hexalens    examples/hexalens.py's two-image wedge lens and its design
  scenes2d    the 2D problems, with examples/stray_light.py,
              ghost_analysis.py, asphere_singlet.py, strehl_lens.py and
              BASELINE config 2; facade: the facade-tax scene, the 2D
              guide and the flagship through the facade,
              examples/stepwise_optimize.py and precompile_pipeline.py;
              scenes3d: examples/trace_3d.py's scene,
              the pool caustic of examples/caustic_render.py,
              image_quality_3d.py and remesh.py; classical:
              examples/cooke_triplet.py, paraxial_analysis.py,
              lens_report.py, sequential_vs_mesh_bench.py and the
              best-form singlet of tests/test_lsq.py
  streamed    the streamed guide trace and training, the sharded guide
              training and the multi-process dryrun
  physics2d   the 2D reaction examples: examples/fresnel_intensity.py,
              spectrometer.py, fresnel_rhomb.py, ar_coating.py,
              wavefront_lens.py, achromat.py, hybrid_achromat.py;
              populations: tolerancing.py and design_sweep.py (each
              candidate traced in turn); source_demos:
              source_rotation_roll.py, cdf_demo.py, source_gallery.py;
              scenes3d.guide_trace_bench: guide_trace_bench.py
  utils/      rotations, NumPy conversion (rays, surfaces, parameters,
              asphere stacks, reaction tables, JAX keys, a JAX
              checkpoint's state), checkpoint and resume of an optimizer
              (its generator too), STL export of a surface

Everything is built on CUDA unless a ``device=`` says otherwise
(``config.set_default_device`` changes the default).
"""

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.config import (
    ACTIVE, DEAD, FINISHED, OPTICAL, STOP, STOPPED, TARGET,
)
from tensorflowraytrace_tpu_torch.engine import (
    StreamedResult, TraceConfig, TraceResult, bounce_count_fold,
    landing_histogram_fold, landing_sum_fold, newly_terminated,
    path_length_fold, streamed_value_and_grad, trace, trace_streamed,
)
from tensorflowraytrace_tpu_torch.models.acceleration import (
    morton_sort_segments, morton_sort_triangles,
)
from tensorflowraytrace_tpu_torch.models.rays import RaySet, concat_rays
from tensorflowraytrace_tpu_torch.models.surfaces import (
    ArcSet, Scene2D, Scene3D, SegmentSet, TriangleSet,
)
from tensorflowraytrace_tpu_torch.paraxial import (
    FieldCurves, GaussianBeamResult, ParaxialSystem, SeidelSums, StopSolve,
    axial_color, field_curves, gaussian_beam, lateral_color,
    paraxial_system, paraxial_trace, petzval_sum, seidel_sums, solve_stop,
)
from tensorflowraytrace_tpu_torch.sequential import (
    AsphereStack, SequentialResult, collimated_bundle, trace_sequential,
)

__version__ = "0.1.0"
