#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tensorflowraytrace_tpu_torch) on
one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, one or more lines each (any failed check raises and the script
exits non-zero without printing a result):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
   exits non-zero when CUDA is not available.
2. build: compiles the ten kernels (csrc/triangle_search.cu,
   triangle_search_culled.cu, triangle_search_twolevel.cu, segment_sum.cu,
   segment_search.cu, segment_search_culled.cu, segment_search_twolevel.cu,
   arc_search.cu, arc_search_culled.cu and arc_search_twolevel.cu), one
   nvcc each, started together, into build/.
3. K1 against its plain PyTorch version on the card, bit for bit (equal
   ``valid``, ``idx`` and ``ray_u``), at the rays a thread its launch
   chooses and at each of 1 and 4: the random soup of bench.py (seed 0:
   4094 random triangles plus the 2-triangle target quad) with 131072
   rays, the flagship's first-bounce search (1024 rays), a ragged tile
   (1000 rays x 333 triangles), a batch that misses everything, both ray
   sets with every third ray parked (p0 = 1e30) and cut to a count that is
   no multiple of a block's rays (1021 and 131035), and a batch of parked
   rays.  Then K3 (culled) and K4
   (two-level) against their plain versions and against K1, bit for bit:
   the soup Morton-sorted as in bench.py (131072 rays), the first bounce
   of the structured guide (131072 rays x 16386 triangles), a ragged tile,
   an all-miss batch, a batch of parked rays, and K4 with its candidate cap
   forced to 1 so that every block overflows and sweeps.  (Phase 10
   checks them again at the main path's shape.)
4. the flagship forward (flagship.entry(): 1024 rays, a lens of two
   217-vertex surfaces, 4 bounces, float32) through the kernel: the loss is
   finite, equals the port's plain search path within rtol 1e-4, and K1
   launched exactly once per bounce.
5. the bench-scale trace: 2^20 rays x 4096 triangles x 8 bounces of the
   soup, kernel path against the plain path: per-state ray counts within
   0.1% of N; median of 5 synchronised runs of the kernel path, one of
   the plain path (~14 s a trace).  Then K1 alone at its
   first bounce, with two bounds: the flat 46 operations a pair, and the
   work these inputs need, the pairs that fail on tu alone
   (``triangle_kernels.pairs_out_on_tu``) charged the 24 operations before
   the reject test refuses them; each with its floor without FMAs.
6. K2 (the segment sum, which adds in a fixed order: tiles of 1024 rays,
   each row's rays in order, then its tile sums in order) against its
   plain version at the flagship's, the soup's, the global tables' and
   ragged shapes, with k = 13, and at the 2D guide backward's (2^20 rays,
   the 512-arc table, k = 4: the cotangents and rows of the K2 call of
   phase 14's backward whose rays hit the most arcs, and each call's share
   of rays with a zero cotangent, printed), and at the caustic image's
   histogram (2^22 rays, 512 x 512 bins, k = 1): bit for bit in float32
   and in float64, 10 launches on the same inputs bit for bit each;
   beside that elementwise
   ``|K2 - ref64| <= 1e-5 S + 1e-7`` against float64, ``S[j] = sum over
   idx[i] == j of |ct[:, i]|``; K2 (by CUDA events, and by device time
   after phase 14), its plain version (on the host), ``index_add_`` and
   ``index_add_`` under ``torch.use_deterministic_algorithms`` timed in
   float32 and float64 at (2^20, 770), (2^20, 4096), one row of 770, the
   2D guide's shape and the histogram's.
7. the flagship's training routine at the scale of
   examples/simple_3d_optimize.py through flagship.train() (2025 rays,
   217-vertex surfaces, 3 bounces, 150 steps in three chained phases): K1
   and K2 launch 3 times per step, every parameter stays finite, and the
   mean error of the last 10 steps is below that of the first 10.
8. one training step of the flagship at bench width (1024 x 1024 = 2^20
   rays, 3 bounces): median of 5 synchronised steps; the gradient through
   K2 against the plain backward of the same forward bit for bit; the
   loss against the all-plain path (Cramer search)
   within rtol 1e-4; K2's share of device time (torch.profiler) and the
   peak device memory.

9. the Morton-sorted soup (as bench.py traces it: 2^20 rays x 4096
   triangles x 8 bounces) through K1 brute force, ``cull=True`` (K3),
   ``cull="grid"`` (K4), ``cull="grid", resort_rays=True`` and
   ``cull=True, resort_rays=True``: the final
   ``state``, ``p0`` and ``p1`` of every accelerated path equal the brute
   path's bit for bit; each kernel launches once per bounce; median of 5
   synchronised traces of each.
10. the structured guide of bench.py (a 16386-triangle
   ParametricCylindricalGuide, 64 x 128 rings, taper (0.7, 0.0),
   Morton-sorted, 2^20 rays from seed 0, acrylic, 24 bounces) through the
   same five paths, children starting ``engine.start_epsilon`` past their
   surface as under ``TraceConfig.recommended`` on the card, checked and
   timed as in phase 9, with equivalent intersections/s N M B / t.  Then
   K1, K3 and K4 alone at its first bounce (2^20 rays x 16386 triangles),
   the rays in the re-sort's Morton order: K1's time and its two bounds
   as in phase 5; K3 and K4 bit for bit against
   their plain versions and K1 at that shape, their times and plain
   times, and one bound for both, the work these inputs need (pairs
   admitted at 256-triangle chunks, those whose tu fails charged the
   operations before the reject test refuses them), with the floor
   without FMAs; K4's kernel also alone, apart from the preparation of its
   inputs (its table, widened boxes and candidate lists);
   one ``cull=True, resort_rays=True`` trace (the path ``recommended``
   picks) and one ``cull="grid", resort_rays=True`` trace under
   torch.profiler (the search kernel, the candidate precompute, the
   re-sort and the rest of the device time, the idle share, kernels a
   bounce), their peak memory and host synchronisations.

11. the 2D searches: K5 (segments) and K6 (arcs) against their plain
   versions, and K7 and K8 (culled) and K9 and K10 (two-level) against
   theirs and against K5 and K6, all bit for bit, on
   examples/tpu_kernel_check.py's sets (seed 7: 777 random segments and 555
   random arcs with signed radii and sweeps of 0.3-5.8 rad, Morton-sorted)
   against 200000 rays, a ragged tile (1000 rays x 333 surfaces), 1 ray x
   257 surfaces, an all-miss batch, a batch of parked rays and full-circle
   arcs; then the sets and the ragged tile again with K9's and K10's
   candidate cap forced to 1, so that their blocks overflow and sweep; then
   K6, K8 and K10 on scenes2d.arc_edge_cases, the edges of their exact
   reject (the discriminant and |a| within float32 steps of i_eps, tangent
   rays, rays 13000 radii away, windows wider than pi, exact ties, parked
   rays); then all six, at the list cap and at cap 1, on
   scenes2d.gate_edge_cases, hits where the boxes of K7-K10 must reach
   (up to size_eps 1e-2 past a segment's ends, tangent pairs snapped off
   their circle, window ends from near and 13000 radii away, parked and
   all-miss batches); then on scenes2d.block_rays at K7's and K9/K10's
   ray blocks (blocks of which every ray, one ray or no ray needs a
   chunk) over 300 and 100 surfaces.
12. 2D training at example scale: examples/optimize_single_arc.py (60 rays,
   one trainable arc, 2 bounces, 30 steps at momentum 0.8 and 50 at
   lr_scale 0.1, momentum 0.9) through use_kernel=True in float32: K5 and
   K6 launch once per bounce, K2 on each backward, the final error is below
   5% of the first and every parameter stays finite.  Then one step of the
   same problem at bench width (174763 beam points x 6 wavelengths ~ 2^20
   rays): median of 5 synchronised steps.
13. the 2D light guide at full width (scenes2d.light_guide: 4098 segments,
   512 lenslet arcs, 2^20 rays from seed 0, acrylic, 50 bounces) through
   brute (K5 + K6), ``cull=True`` (K7 + K8), ``cull=True,
   resort_rays=True``, ``cull="grid"`` (K9 + K10) and ``cull="grid",
   resort_rays=True``: the final ``state``, ``p0`` and ``p1`` of each
   accelerated path equal the brute path's bit for bit, each kernel
   launches once per bounce, median of 5 synchronised traces per path and
   equivalent intersections/s N (M_seg + M_arc) B / t; one brute, one
   ``cull=True, resort_rays=True`` and one ``cull="grid",
   resort_rays=True`` trace under torch.profiler (shares of the segment
   search, the arc search, the candidate precompute, the re-sort and the
   rest, the idle share, kernels a bounce), peak memory and host
   synchronisations (0).  Then K5-K10 alone at the first bounce (2^20 x
   4098 and 2^20 x 512, the rays in the re-sort's order): bit for bit
   against their plain versions; by CUDA events the kernel alone, apart
   from its inputs' preparation (K6-K10's tables, boxes and candidate
   lists), the whole wrapper and the plain version; and each kernel's
   bound, the work these inputs need: for the arcs the pairs past the exact
   reject (``arc_kernels.admitted_arc_pairs``) at 50 operations and the
   rest at the 15 before it, beside the flat 50-operation bound; the
   bounds count the pairs on the chunks' exact boxes, and beside them the
   pairs a per-ray gate admits on the boxes with the rounding margin alone
   and on the widened boxes K7-K10 gate on; K9's and K10's preparation in
   its three parts (table, boxes, candidate lists), by CUDA events and by
   the host time that enqueues them.
14. the 2D guide as a design problem (scenes2d.guide_design, the same rays
   and scene) under ``TraceConfig.recommended(scene, max_bounces=50,
   dead_ray_length=10)``: the configuration it chose; one forward and
   backward pass of the landing loss (a ``landing_sum_fold``) with respect
   to the lenslets' centres and radii with ``remat=True`` and with
   ``remat=False``: the two gradients bit for bit (the recomputed forward
   and K2 repeat their bits), each search kernel of the chosen path
   launched exactly 50 times in each (the backward searched nothing), the
   median of 3 synchronised passes and the peak memory of each; then one
   ``early_exit=True`` trace under ``torch.no_grad()``: its final
   ``state``, ``p0`` and ``p1`` equal the 50-bounce trace's bit for bit,
   with its depth and its host synchronisations (one a bounce).
15. the examples' 3D problems at their sizes, through the entry points
   that pick the kernels on the card, building nothing new:
   ``scenes3d.trace_3d`` (examples/trace_3d.py: 200 rays of a static
   sphere cap through a 6-ring lens and a 12-ring mirror sphere, 4
   bounces, history kept, float32) launches K1 once a bounce; the same
   trace with K1 and with its plain version logged call by call: every
   call's hits, the history and the final rays bit for bit, and the
   Cramer search's finished count equal; median of 5 traces.  Then the
   hexalens (``hexalens.problem``: 2000 rays, mesh edge 0.08, 3 bounces,
   float32) at its initial lens on identical rays: each K1 call bit for
   bit with its plain version, the loss within rtol 1e-4 and the gradient
   within 1e-4 of its max norm of the plain path's (its Cramer search
   computes the hits another way; the plain K2); ``hexalens.train`` at the
   example's defaults
   (150 steps in two chained phases): K1 and K2 launch 3 times a step, the
   error falls (the mean of the last 10 steps below the first 10's, and on
   a fixed sample of rays), one step profiled for its idle share; both
   surfaces exported with ``export_boundary_stl`` under build/ and read
   back with ``load_stl`` (corners within float32 rounding of
   ``updated_mesh``), ``imaging_test`` of 5 batches into 64 x 64 bins, and
   one trace's ``landing_histogram_fold`` equal to ``histogram2d`` of its
   finished landings.
16. streaming and data parallelism at the JAX examples' sizes (the port's
   ``streamed`` module): 16a ``streamed.GuideTrace`` (examples/
   streamed_trace.py: the 16386-triangle guide, 24 bounces, float32,
   ``TraceConfig.recommended``, so K3 with the re-sort): one 2^22-ray
   block's trace alone for its peak memory, then streams of 2^24, 2^25 and
   2^26 rays (the example's 2^27 cut for the time limit) in blocks of
   2^22, each timed (rays/s, equivalent intersections/s), its state counts
   summing to its rays, K3 launched 24 times a block, the times linear
   (``streamed.check_linear``), the 2^26 stream's peak memory at most 1.25
   x the one block's; a 2-block stream
   of 2^20-ray blocks with a per-ray ``path_length_fold`` under
   ``merge="concat"`` equal to one trace of the same 2^21 rays bit for bit
   (states equal, the landing sum within rtol 1e-5).  16b
   ``streamed.train_guide`` (examples/streamed_training.py: 4 steps of 4
   blocks of 2^21 rays through the 242-triangle guide, 12 bounces, remat):
   the first step lowers the loss (whether the last step's loss is below
   the first's, the example's own test, is printed: its momentum steps
   rebound after two, in the JAX package as here, which
   tests/test_torch_train_schedule.py shows on the same rays), K1
   launched 12 times a block (the backward searches nothing), K2's
   launches a block, ms a step and the peak memory; at 2 blocks of 2^20
   ``streamed_value_and_grad`` against autograd of the fused sum: the
   value and the gradient bit for bit.  16c ``streamed.sharded_guide``
   (examples/sharded_light_guide.py: 10 steps of 2^20 rays) through
   ``Optimizer(mesh=...)`` on a one-rank NCCL group against the
   single-process optimizer, run twice: every step's loss and the final
   parameters bit for bit in all three (K2 adds in a fixed order; the
   one-rank all-reduce is a copy), one step's parameters bit for bit, a
   later step's loss below the first, ms a step; then
   ``streamed.dryrun`` with two gloo ranks on the
   one card (size "card": ``parallel_trace`` of the 16386-triangle guide at
   2^21 rays, ``parallel_trace_streamed``,
   ``parallel_streamed_value_and_grad`` over 4 blocks of 2^20 through the
   242-triangle guide, one ``Optimizer(mesh=...)`` step): each rank's trace
   slots equal the one-process control's trace of its shard bit for bit
   (hashes of states, endpoints and path lengths), the folds, counts,
   depth, value, gradient and step within 1e-4 of their largest
   magnitude.  No multi-GPU speed is measured.
17. the reactions at the JAX examples' sizes: 17a ``scenes3d.caustic_render``
   (examples/caustic_render.py: 2^26 sun rays, the example's 2^27 cut for
   the time limit, in 2^22-ray blocks through
   the 124,416-triangle water surface and the 2-triangle floor, 2 bounces,
   float32, ``fresnel_intensity_reaction``, the intensity-weighted 512 x
   512 landing image, ``TraceConfig.recommended``, so K3 with the
   re-sort): one block's trace alone for its peak memory, then the stream
   timed (rays/s, equivalent intersections/s N M B / t), K3 launched 2
   times a block and K2 (the image's fold, ``analysis.histogram2d``) 2
   times a block, its counts summing to its rays, the mean landed weight
   within 0.02 of 1 - (1/7)^2 (the example's test), its peak memory; one
   block profiled (K3, the re-sort, the reaction and the fold, the rest,
   the idle share); 2 blocks against one trace of the same 2^23 rays,
   the image accumulated in float64 (exact sums of the float32 weights),
   equal bit for bit with equal state counts; K3 alone at block 0's first
   bounce and its admitted-work bound there; one block's trace with
   K3's wrapper logged against the same trace with K3's plain version in
   its place (2^22 rays x 124,418 triangles, 487 chunks): every call, the
   final states, endpoints, intensities and image bit for bit; one block
   through brute (K1), ``cull=True`` with and without the re-sort (K3)
   and ``"grid"`` + re-sort (K4), each timed, states, endpoints,
   intensities and image equal bit for bit.  17b ``scenes2d.stray_light``
   (examples/stray_light.py: 4000 rays, 6 (sigma, absorptivity) pairs x 4
   keys, 12 bounces, K5 and K6 each once a bounce): the example's three
   assertions; the example again with K5's and K6's plain versions in
   their place, every search call bit for bit and the same ghost powers;
   the stream's uniforms over 2^20 positions equal the CPU's bit for bit
   (float32 and float64) and its float32 normals within 4 ulps.  17c
   ``scenes2d.ghost_analysis`` (examples/ghost_analysis.py: 801 rays, the
   16 branch schedules of depth 4, bare and AR-coated, float32, K5 and K6
   each once a bounce): the analytic T^2, T^2 R^2 and R^2 checks within
   rtol 1e-5 (float32; the example's 1e-6 is float64's) and the coating
   cutting the ghost more than 8x; the example again with the plain
   versions, every call and every schedule's power, landing height and
   branch counter bit for bit.

18. the designs at the JAX examples' sizes (float32, K5 and K2, K1 in
   18d): 18a ``scenes2d.asphere_singlet`` (examples/asphere_singlet.py: two
   ParametricAsphereSegments of 256 segments and the screen, 160 rays, 3
   bounces, the sphere control and the asphere design of 200 of the
   example's 1500 Adam steps each under a cosine LambdaLR, through
   ``Optimizer(optax_tx=...)``): ms a step by CUDA events over 100 steps,
   a probe that fails the phase where the cut designs would pass their
   budget, the example's two checks, the launches (K5 3 a step and one a
   bounce of the three spot evaluations, K2 the same each step), 20
   steps profiled (idle share; K5, K2 and the
   rest), then 5 steps each held against the plain K5 and K2 (every K5
   call bit for bit, the loss and the gradient bit for bit); 18b
   ``scenes2d.multisegment_lens``
   (BASELINE config 2: 68 rays, the two-surface multi-segment lens, 4
   bounces, 61 steps): the test's three checks (the thickness with a
   1e-6 float32 margin), launches, ms a step, one step against the plain
   versions; 18c ``scenes2d.strehl_lens`` (examples/strehl_lens.py: 48
   segments, 128 rays carrying their optical path, 2 bounces, 3 stages of
   100 of the example's 300 Adam steps, behind the same probe): the
   example's check, ms a step a stage, launches, 5
   steps profiled with the PSF's forward in the range ``strehl_psf``,
   then 5 steps held against the plain K5 and K2 as in 18a; 18d ``scenes3d.image_quality_3d`` (examples/image_quality_3d.py: the
   hexalens trained by ``hexalens.train``, exported as STL under build/,
   reloaded with ``manual_triangle_boundary``; 20 batches of 4000 rays, 3
   bounces, brute K1): the reloaded faces equal the 7-decimal rounding of
   ``lens.build(params)`` exactly (the reader's merge rule), K1 3 a
   batch, both images carry flux, one batch's K1 calls bit for bit with
   the plain version; 18e ``scenes3d.remesh``: its check.
19. the classical lens design (``classical.py``; the analytic tracer, the
   paraxial algebra and the damped least squares are plain torch): 19a
   examples/sequential_vs_mesh_bench.py: one asphere singlet as a
   2-surface ``AsphereStack`` and as 35,826 triangles
   (``ParametricAsphereBoundary`` at edge 0.02, Morton-sorted), float32,
   3 bounces: the example's 512-ray check (more than 90% finished, every
   landing within 0.02 of ``trace_sequential``) through its ``"grid"`` +
   re-sort configuration (K4, each call logged and held bit for bit
   against the plain K4) and through ``TraceConfig.recommended`` (K3 +
   re-sort), and one brute bounce of 2^20 rays (K1): the main path's
   launches; the first bounce at 2^20 rays, K3 and K4 against K1 and
   their plain versions bit for bit; the analytic trace and both mesh
   traces at 2^20 rays, median of 5 synchronised runs (ms, rays/s,
   launches a trace, finished share and landing gap) and one of each
   profiled (idle share).  19b examples/cooke_triplet.py at its defaults
   (48 rays x 3 lines x 3 fields, Adam under the cosine schedule): one
   step by CUDA events and under the profiler (kernels a step, idle
   share), then the design, cut below 2000 steps only as far as 100 s
   force (never below 200), and the example's check rms1 < rms0 / 2.
   19c examples/paraxial_analysis.py and lens_report.py in float32 on the
   card: their checks, and every number held against the CPU's float64
   within the tolerances stated at ``FIRST_ORDER_RTOL``.  19d the
   best-form singlet (tests/test_lsq.py's design through ``lm_solve``) in
   float64 on the card: ``accepted`` equal to the CPU run's, the cost
   history within rtol 1e-8, the cost below 1e-2 of the start and the EFL
   within 1e-3 of 50 (its shape factor stalls, as in the JAX package).
20. the stateful facade (``system.py``, through ``facade.py``), float32:
   20a examples/facade_tax_bench.py's scene (2^17 rays, 12 bounces, three
   guide segments and the exit segment, K5) and the 2D light guide of
   phase 13 (4098 segments, 512 arcs, 2^20 rays, 50 bounces, K5 + K6),
   each built through ``OpticalSystem2D``: the facade's ``ray_trace``
   equals ``engine.trace`` of the same rays and scene bit for bit
   (states, their counts, p0, p1), the four ray views partition the
   slots, each kernel launches once a bounce, and each of its K5 and K6
   calls equals the plain version's on the same inputs bit for bit (all
   rays of the first scene, every 16th of the guide); median of 10
   synchronised runs, in turns, of the functional trace, of
   ``ray_trace`` and of ``update()`` + ``ray_trace``, with their ratios.
   20b the flagship (2025 rays, 770
   triangles, 3 bounces) in ``OpticalSystem3D``: ``SGD_Optimizer`` and
   ``optim.Optimizer`` on the same loss built functionally, 10 steps of
   the design's first phase each from one generator seed: every step's
   loss equal and the parameters bit for bit, K1 and K2 3 times a step,
   the parameters written back into the lens; one forward + backward of
   the facade's loss with K1 and K2 and with their plain versions (K1's
   calls, the loss and the gradient bit for bit); ms a step (the median
   of 10 synchronised steps, in turns) and the idle share
   (``profiled_steps``) of each.
   20c examples/stepwise_optimize.py (the single arc, K5, K6 and K2)
   checkpointed every 10 steps, rebuilt, resumed, with the Nesterov stage
   and with Adam under a LambdaLR: the restored state equal to the saved
   one bit for bit, the first resumed loss equal to the uninterrupted
   run's, the final radius EXACT or within 1e-9; at the checkpoint's
   parameters one forward + backward against the plain K5, K6 and K2, as
   in 20b.  20d
   examples/precompile_pipeline.py: the Hungarian matching's mean
   distance within 1e-12 of the CPU run's (the same host NumPy), the
   cache pickled to a temporary directory, per-step samples drawn on the
   card from a CUDA generator.
21. export, profiling and drawing (``utils/export.py``,
   ``utils/profiling.py``, ``drawing.py``): 21a ``torch.library.opcheck``
   of the ten ``tfrt_torch`` operators (``ops/custom_ops.py``) on CUDA
   inputs; 21b programs exported by a process of its own started before
   phase 19 (``--export-programs``, ``export_all``: the exports' host
   tracing runs beside phases 19 and 20), saved under build/export/,
   loaded from the file and run, each held against the live trace with the launch
   counts read while the loaded program runs: the flagship forward (2025
   rays, 770 triangles, 3 bounces; K1) bit for bit, a half-size call
   refused; the flagship loss's value and gradient through
   ``export.value_and_grad`` (a joint program; K1, K2): the loss and the
   gradient bit for bit (the normals' cross product is written out, so
   the program's backward and eager autograd's add in one order); phase
   13's 2D guide at full width, brute (K5, K6), ``cull=True`` and
   ``"grid"`` (K7, K8; K9, K10), each at 1 bounce; phase 10's 3D guide
   under ``recommended`` (K3) and ``"grid"`` (K4) at 1: each bit for bit; each export's seconds and
   bytes, the served run against the live one by ``interleaved_ms``; 21c
   three flagship steps under ``profile_trace`` (build/profile/): the
   trace names the K1 and K2 kernels, ``StepTimer.report()``; 21d where
   matplotlib is installed, the 2D guide's ``history_rays`` (4096 rays, 3
   bounces) drawn from CUDA tensors into build/guide_2d.png, else one line
   saying it did not run.
22. the last examples at their defaults, float32 (``physics2d.py``,
   ``populations.py``, ``source_demos.py``, ``scenes3d.guide_trace_bench``):
   22a the source demos (``source_rotation_roll``, ``cdf_demo``,
   ``source_gallery``, its figure only where matplotlib is installed; no
   kernel); 22b the 2D reaction examples (``fresnel_intensity`` 2000
   rays, ``fresnel_rhomb`` 150 steps, ``wavefront_lens`` 400 of its 800
   steps, ``achromat`` 200 of its 400 steps a lens, ``ar_coating`` 300
   steps and 512 rays, ``spectrometer`` 400 steps, ``hybrid_achromat``
   400 of its 600 steps a design), ``tolerancing`` (512 builds, 200 of
   its 400 design steps) and ``design_sweep`` (64 candidates, 60 steps of
   the best 8), each with its own checks, its wall seconds and its
   launches: K5 in every trace (each scene has a segment), K6 where the
   scene has arcs, K2 where a design takes a gradient through a trace;
   ms a step and the idle share (torch.profiler) of the three cut
   designs, each a probe that fails the phase where the cut design
   would pass its budget, and of the sweep's refinement; one forward and
   backward of the hybrid design with the kernels and with their plain
   versions, every K5 and K6 call, the loss and the gradient bit for bit;
   22c ``guide_trace_bench``
   (2^20 rays, 16,386 triangles, 24 bounces: ``"grid"`` + re-sort on K4,
   ``cull=True`` ± re-sort on K3, brute on K1), its four checksums equal.
   The kernels line gives K1-K6 ``launches_examples``.
23. every design path run twice from the same seeds and generators, in
   one process, ``REPEAT_STEPS`` (5) steps each, the streamed training's
   4 whole: the flagship and the hexalens trainings (and the hexalens's
   landing image), one float32 caustic block image (2 K2 launches a
   trace), the 2D guide design's loss and gradient, the streamed
   training, the asphere singlet, config 2, the Strehl lens, a Cooke
   step, the stepwise single arc, and phase 22b's designs (the rhomb, the
   wavefront lens, the achromat, the AR coating and its coated trace, the
   spectrometer, the hybrid achromat, the tolerancing design and the
   sweep's refinement): every step's loss, the final parameters and the
   images bit for bit (``differing``); the seconds of each path.

Phase 5 keeps the soup unsorted, so its numbers stay comparable with the
earlier runs: the brute-force search does not use the order.  Each phase
prints its seconds.  Then the script's own wall time with the seconds by
phase, one JSON line describing each kernel of the path,
the nvidia-smi line, and as the last line ``{"ok": true, "device":
{...}}``.

``python3 chip_smoke.py --tune`` runs phases 1 and 2, times K2 at phase
6's timed shapes built at each of ``SEGSUM_VARIANTS`` (the columns a tile
stages, its tile pass's launch bound, the loads issued ahead of their adds
and the threads a row, none of which changes its bits), times K1 alone at
the soup's and the guide's first bounce at 1 and 4 rays a thread and K4
alone at the guide's first bounce at every ray block, then sweeps K4's ray
block and candidate cap on the guide and the sorted soup; times K7 and
K8 at 128-1024 rays a block, alone at the 2D guide's first bounce and in
its ``cull=True`` traces; times K9 alone at the 2D guide's first bounce
at every ray block, then sweeps K9's and K10's ray block and cap on the
2D guide (median of 3 traces each, every setting checked against the
brute trace), and prints no result line.  ``--tune-rows`` times K2 the
same way with its row pass one warp a row and one block a row at every
table (``SEGSUM_ROW_VARIANTS``), at ``SEGSUM_ROW_TIMED``.
``python3 chip_smoke.py --export-programs`` runs phases 1 and 2 and
writes phase 21b's programs under build/export/ (the script runs it
itself).
``python3 chip_smoke.py --caustic-block`` runs phases 1 and 2 and times
one caustic block with its image folded (``caustic_block``); copied into
the root of an earlier checkout, it times that checkout's.
``python3 chip_smoke.py --arcs-alone`` runs phases 1 and 2 and times K6
and K8 launched alone at the 2D guide's first bounce (see
``arcs_alone``); ``--segsum-alone`` times K2 at phase 6's timed shapes
(see ``segsum_alone``); neither prints a result line.
``python3 chip_smoke.py --dispatch-cost`` runs phases 1 and 2 and prints
one JSON line: the facade-tax trace and a flagship step by
``interleaved_ms`` (``dispatch_cost``); copied into the root of an
earlier checkout it times that checkout the same way.
"""

import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

N_SOUP_TRIS = 4094
K1_RAYS = 131072
BENCH_RAYS = 1 << 20
BENCH_BOUNCES = 8
# the plain (Cramer) path's traces timed after its warm-up: ~14 s each on
# an H100
PLAIN_TRACE_TIMED = 1
EPS = 1e-6  # default_epsilon(float32)

# phase 6: (label, rays N, table rows m, columns k, idx pattern); k = 13 is
# the 3D gather's table (vp, v1, v2, norm, the packed annotation), k = 4
# the 2D guide's arc table (centre, radius, the packed annotation).  The
# "guide2d" case is phase 14's own arc gather backward (guide2d_backward);
# "histogram" the caustic image's sum of one 2^22-ray block (k = 1, the
# 512 x 512 bins of a blurred spot).  Every case runs in float32 and in
# float64.
SEGSUM_CASES = [
    ("flagship_example", 2025, 770, 13, "random"),
    ("flagship_bench", 1 << 20, 770, 13, "random"),
    ("soup", 1 << 20, 4096, 13, "random"),
    ("global_random", 5000, 16386, 13, "random"),
    ("global_coherent", 5000, 16386, 13, "coherent"),
    ("one_row", 1 << 20, 770, 13, "same"),
    ("ragged_1x1", 1, 1, 13, "random"),
    ("ragged", 1000, 333, 13, "random"),
    ("guide2d_backward", 1 << 20, 512, 4, "guide2d"),
    ("histogram", 1 << 22, 512 * 512, 1, "spot"),
]
SEGSUM_TIMED = ("flagship_bench", "soup", "one_row", "guide2d_backward",
                "histogram")
# calls timed of K2's plain version (on the host) and of index_add_ under
# torch.use_deterministic_algorithms (up to 0.26 s a call on one row)
K2_SLOW_REPS = 3
# --tune: K2 rebuilt from segment_sum.cu with its columns a tile stages at
# a time (kStageCols), the blocks an SM its tile pass's launch bound asks
# for (kTileMinBlocks), the loads issued ahead of their adds (kUnroll) and
# the threads of its pass over the rows (kRowThreads) set to each of these;
# none changes the order of the adds.  One build each, timed at
# SEGSUM_TIMED beside the source as it stands
SEGSUM_VARIANTS = tuple(
    {"kStageCols": cols, "kTileMinBlocks": blocks, "kUnroll": unroll,
     "kRowThreads": threads}
    for cols in (8, 16) for blocks in (2, 3) for unroll in (4, 8)
    for threads in (128, 256))
# --tune-rows: K2's row pass one warp a row at every table (kWarpRowsMin 1)
# and one block a row at every table (kWarpRowsMin 2^30), timed at
# SEGSUM_ROW_TIMED beside the source as it stands
SEGSUM_ROW_VARIANTS = ({"kWarpRowsMin": 1}, {"kWarpRowsMin": 1 << 30})
SEGSUM_ROW_TIMED = ("flagship_example", *SEGSUM_TIMED)

# phases 7 and 8: the flagship's training (examples/simple_3d_optimize.py)
TRAIN_STEPS = 150
TRAIN_BP = 45
TRAIN_RINGS = 8
TRAIN_BOUNCES = 3
WIDE_BP = 1024

# phases 3, 9 and 10: the acceleration path
CULL_RAYS = 131072
GUIDE_RAYS = 1 << 20
GUIDE_BOUNCES = 24
# profiler ranges the port opens around the candidate precompute and the
# re-sort, and phase 17 around the caustic's reaction and fold; their
# device-side annotations are not kernels
RANGES = ("twolevel_candidates", "resort_rays", "caustic_reaction",
          "caustic_fold", "strehl_psf")

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W power limit).  The
# FP32 peak counts an FMA as two operations; the searches are built with
# --fmad=false, so their floor without FMAs is twice the operation bound.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
PEAK_FP64_FLOP_S = 34e12  # off the tensor cores (NVIDIA's data sheet, SXM)
# FP32 operations of one ray-triangle pair (K1, K3 and K4 do the same
# exact arithmetic, behind a cheaper test): two cross products
# (2 x 9), two dot products against P (2 x 6 with the scaling by inv),
# det (5), T (3), u (6), 1/det (1), tu + tv (1)
K1_FLOPS_PER_PAIR = 46
# the part of that a pair whose tu fails costs in K1, K3 and K4 before the
# reject test refuses it (tsearch::TrianglePair): P (9), det (5), T (3),
# tu's numerator (5), the reciprocal (1), one product (1)
TU_FLOPS_PER_PAIR = 24
# one ray-segment pair of K5, K7 and K9 (search2d::SegmentPair, shared t):
# T (2), den (3), the two numerators (2 x 3), the reciprocal (1), two
# products (2); a pair the reject test refuses costs as much
SEG_FLOPS_PER_PAIR = 14
# one ray-arc pair of K6, K8 and K10 that passes the exact reject
# (search2d::ArcPair): the scaled coordinates (6), a (3), the cross term
# (3), the discriminant (3), b (4), 2a and its reciprocal (2), the square
# root (1), the two roots (4), the window test of each root (2 x 12); a
# pair the reject refuses (a negative discriminant, or |a| < i_eps) costs
# only the operations up to the discriminant
ARC_FLOPS_PER_PAIR = 50
ARC_REJECT_FLOPS = 15

# phases 11-13: the 2D path
CHECK_RAYS = 200000
CHECK_SEGMENTS = 777
CHECK_ARCS = 555
ARC_STEPS = (30, 50)
ARC_WIDE_BEAM = 174763
GUIDE2D_RAYS = 1 << 20
DESIGN_PASSES = 3
# phase 15: examples/trace_3d.py and examples/hexalens.py at their sizes
TRACE3D_BOUNCES = 4
HEX_RAYS = 2000
HEX_MESH_STEP = 0.08
HEX_STEPS = 150
HEX_BOUNCES = 3
HEX_IMAGE_BATCHES = 5
HEX_IMAGE_BINS = 64
# phase 16: examples/streamed_trace.py, streamed_training.py and
# sharded_light_guide.py at their own sizes
STREAM_RAYS = 1 << 26     # the example's 2^27, cut for the time limit
STREAM_BLOCK = 1 << 22
STREAM_BOUNCES = 24
STREAM_SIZES = 3          # 2^24, 2^25 and 2^26 rays
STREAM_EXACT_BLOCK = 1 << 20
STREAM_PEAK_RATIO = 1.25
TRAIN_STREAM_RAYS = 1 << 23
TRAIN_STREAM_BLOCK = 1 << 21
TRAIN_STREAM_STEPS = 4
TRAIN_STREAM_BOUNCES = 12
SHARDED_RAYS = 1 << 20
SHARDED_STEPS = 10
SHARDED_BOUNCES = 12
# phase 17: examples/caustic_render.py, stray_light.py, ghost_analysis.py
CAUSTIC_RAYS = 1 << 26    # the example's 2^27, cut for the time limit
CAUSTIC_BLOCK = 1 << 22
CAUSTIC_RES = 512
CAUSTIC_MESH_STEPS = 144
CAUSTIC_TRIANGLES = 124418
CAUSTIC_BOUNCES = 2
STRAY_RAYS = 4000
GHOST_RAYS = 801
GHOST_DEPTH = 4
STREAM_DRAWS = 1 << 20
NORMAL_ULPS = 4
# phase 18: the designs of the optimizer's torch stage and the analysis
ASPHERE_STEPS = 1500       # a design; the example runs two
ASPHERE_CUT_STEPS = 100    # PERF.md 4: its checks' margins at the cut
ASPHERE_RES = 256
ASPHERE_RAYS = 160
ASPHERE_TIMED = 30         # steps timed one by one by CUDA events
ASPHERE_PROFILED = 20
PLAIN_STEPS = 5            # steps held against the plain K5 and K2
CONFIG2_STEPS = 60
STREHL_STEPS = 300         # a stage; three stages
STREHL_CUT_STEPS = 100
STREHL_SEGMENTS = 48
STREHL_RAYS = 128
STREHL_PROFILED = 5
IMAGE_BATCHES = 20
IMAGE_RAYS = 4000
# phase 19: the classical lens design (examples/sequential_vs_mesh_bench.py,
# cooke_triplet.py, paraxial_analysis.py, lens_report.py; the best-form
# singlet of tests/test_lsq.py)
SVM_RAYS = 1 << 20
SVM_TRIANGLES = 35826
COOKE_STEPS = 2000         # the example's default
# cut so that the script stays inside its time limit: the step is
# host-bound, ~190-290 ms on the H100 (11,750 launches), and the loss
# settles by step 200, the floor of the cut
COOKE_CUT_STEPS = 200
COOKE_BUDGET_S = 120.0     # the most the cut design may take by the probe
COOKE_TIMED = 20           # steps timed one by one by CUDA events
COOKE_PROFILED = 3
# the card's float32 against the CPU's float64 (19c): the CPU's own
# float32 differs by at most 2.7e-6 relative in the first-order numbers,
# 4e-5 of each Seidel sum's largest magnitude, 2.4e-5 in the foci, 8e-6
# relative in the spots and 7.2e-6 in the MTF
FIRST_ORDER_RTOL = 1e-5
SEIDEL_SHARE = 1e-3
FOCUS_ATOL = 5e-4
DISTORTION_ATOL = 5e-6
SPOT_RTOL = 1e-4
MTF_ATOL = 1e-4
LSQ_RTOL = 1e-8            # the card's float64 solve against the CPU's (19d)

# phase 20: the facade, the goals and the checkpoint
FACADE_TIMED = 10          # synchronised runs a way, after one warm-up
FACADE_STEPS = 10          # 20b's steps of each optimizer
FACADE_PROFILED = 5
STEPWISE_DRIFT = 1e-9      # 20c: the example's own bound
PIPELINE_ATOL = 1e-12      # 20d: host NumPy on the same inputs
# 20a replays the guide trace's 50 K5 and 50 K6 calls through the plain
# versions on every 16th ray (65,536 rays a call): on all rays they take
# ~27 s on an H100 (phase 13's plain K5 and K6 at the first bounce: 381.9
# and 159.4 ms), half of phase 20's 60 s
GUIDE_PLAIN_STRIDE = 16
# phase 21: export, profiling, drawing
EXPORT_TIMED = 5            # served and live runs a program, in turns
EXPORTER_WAIT_S = 900       # the most phase 21 waits for the exporter
EXPORT_GUIDE2D_BOUNCES = 1  # the brute 2D guide's export depth (export
                            # time grows with the bounces: ~5 s a bounce)
EXPORT_SHALLOW_BOUNCES = 1  # the culled and two-level guides' depth
DRAW_RAYS = 4096
DRAW_BOUNCES = 3
# phase 22: the last examples.  Phase 22 alone took 266.0 s uncut (PR 18's
# first chip call, against 180 s allowed), so four designs are cut, each
# still meeting its example's checks (PERF.md §4); a one-step probe fails
# the phase where a cut design would pass its budget
WAVEFRONT_STEPS = 800       # the example's default
WAVEFRONT_CUT_STEPS = 400
ACHROMAT_STEPS = 400        # a lens; the example designs two
ACHROMAT_CUT_STEPS = 200
HYBRID_STEPS = 600          # a design; the example runs two
HYBRID_CUT_STEPS = 400
TOL_DESIGN_CUT_STEPS = 200  # the nominal design's 400 (populations.py)
CUT_BUDGET_S = {"wavefront_lens": 20.0, "achromat": 60.0,
                "hybrid_achromat": 100.0, "asphere_singlet": 30.0,
                "strehl_lens": 20.0}
EXAMPLE_TIMED = 5           # steps timed one by one by CUDA events
EXAMPLE_PROFILED = 2
# --dispatch-cost: rounds of interleaved_ms, and runs a round
DISPATCH_ROUNDS = 3
DISPATCH_TIMED = 10
# phase 23: the steps each design path is run for, twice
REPEAT_STEPS = 5


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def same_bits(a, b):
    """``a`` and ``b`` of one shape and dtype hold the same bits (-0 is not
    +0; two NaNs match only with one payload)."""
    import torch

    def raw(t):
        return t.detach().contiguous().reshape(-1).view(torch.uint8)

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        raw(a), raw(b))


def grads_same_bits(got, want):
    """Every tensor of ``got`` holds the bits of its partner in ``want``."""
    return len(got) == len(want) and all(
        same_bits(a, b) for a, b in zip(got, want))


def card():
    """The device every phase runs on."""
    import torch

    return torch.device("cuda:0")


def soup_scene(n_rays, device, sort=False):
    """bench.py's random soup: a box of reflective triangles around the
    origin, a distant target plane, rays from inside in random directions.
    ``sort`` Morton-sorts the soup before the target is added, as bench.py
    does."""
    import numpy as np
    import torch

    from tensorflowraytrace_tpu_torch import RaySet, Scene3D, TriangleSet
    from tensorflowraytrace_tpu_torch.models.acceleration import (
        morton_sort_triangles,
    )

    f32 = torch.float32
    rng = np.random.default_rng(0)
    center = rng.uniform(-3, 3, (N_SOUP_TRIS, 3))
    vp = center + rng.normal(0, 0.5, center.shape)
    v1 = center + rng.normal(0, 0.5, center.shape)
    v2 = center + rng.normal(0, 0.5, center.shape)
    guide = TriangleSet.make(vp.astype(np.float32), v1.astype(np.float32),
                             v2.astype(np.float32), mat_in=1, mat_out=0,
                             dtype=f32, device=device)
    if sort:
        guide, _ = morton_sort_triangles(guide)
    half = 500.0
    target = TriangleSet.make(
        [[50.0, -half, -half], [50.0, half, half]],
        [[50.0, half, -half], [50.0, -half, half]],
        [[50.0, half, half], [50.0, -half, -half]], dtype=f32, device=device)
    scene = Scene3D.build(optical=[guide], targets=[target])
    p0 = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = RaySet.make(p0, p0 + d, 575.0, dtype=f32, device=device)
    return rays, scene


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_k1(label, p0, p1, vp, v1, v2):
    """K1 against its plain version on the same tensors, bit for bit, at
    the rays a thread the wrapper chooses and at each its kernel is
    compiled for; returns max |du| on valid rays (0 when equal).  These
    launches are comparisons, not the main path."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    args = [t.detach().contiguous() for t in (p0, p1, vp, v1, v2)]
    ref = tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS)
    chosen = tk.brute_rays_per_thread(args[0].shape[0], args[0].device)
    err = 0.0
    for rpt in (None,) + tk.BRUTE_RAYS_PER_THREAD:
        got = (tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
               if rpt is None else
               tk.brute_launch(*args, EPS, EPS, EPS, rays_per_thread=rpt))
        torch.cuda.synchronize()
        diffs = [int((a != b).sum()) for a, b in zip(got, ref)]
        both = got[0] & ref[0]
        if both.any():
            err = max(err, float((got[2][both] - ref[2][both]).abs().max()))
        check(not any(diffs), f"K1 {label} at {rpt or chosen} rays a thread: "
              f"valid, idx, u differ from the plain version in {diffs} rays")
    print(f"phase 3 K1 {label}: N={args[0].shape[0]} M={args[2].shape[0]} "
          f"hits={int(ref[0].sum())}; bit for bit at rays a thread "
          f"{tk.BRUTE_RAYS_PER_THREAD} and at the launch's choice {chosen}",
          flush=True)
    return err


def k1_bounds(p0, p1, vp, v1, v2):
    """K1's two bounds (ms) on these inputs: the flat 46 operations a pair,
    and the work they need, the pairs that fail on tu alone charged 24;
    returns (flat, needed, pairs out on tu)."""
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    pairs = p0.shape[0] * vp.shape[0]
    tu_out = tk.pairs_out_on_tu(p0, p1, vp, v1, v2, EPS, EPS)
    flat = pairs * K1_FLOPS_PER_PAIR / PEAK_FP32_FLOP_S * 1e3
    needed = ((pairs - tu_out) * K1_FLOPS_PER_PAIR
              + tu_out * TU_FLOPS_PER_PAIR) / PEAK_FP32_FLOP_S * 1e3
    return flat, needed, tu_out


def compare_culled(label, p0, p1, vp, v1, v2):
    """K3 and K4 against their plain versions and against K1 on the same
    tensors, bit for bit.  These launches are comparisons, not the main
    path."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    args = [t.detach().contiguous() for t in (p0, p1, vp, v1, v2)]
    ref = tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
    got = {
        "K3": tk.nearest_hit_triangles_culled_kernel(*args, EPS, EPS, EPS),
        "K4": tk.nearest_hit_triangles_twolevel_kernel(*args, EPS, EPS, EPS),
    }
    torch.cuda.synchronize()
    plain = {
        "K3": tk.nearest_hit_triangles_culled_plain(*args, EPS, EPS, EPS),
        "K4": tk.nearest_hit_triangles_twolevel_plain(*args, EPS, EPS, EPS),
    }
    report = [culled_agreement(name, got[name], plain[name], ref)[1]
              for name in got]
    print(f"phase 3 K3/K4 {label}: N={args[0].shape[0]} M={args[2].shape[0]} "
          f"hits={int(ref[0].sum())} cap={tk.TWOLEVEL_MAX_CAND} "
          + "; ".join(report), flush=True)


def culled_agreement(name, got, plain, ref):
    """One culled kernel's ``(valid, idx, u)`` against its plain version's
    and K1's, which must be equal bit for bit; returns (max |u - u_plain|
    on rays both find valid, a report)."""
    (v, i, u), (pv, pi, pu) = got, plain
    both = v & pv
    err = float((u[both] - pu[both]).abs().max()) if both.any() else 0.0
    vs_plain = int(((v != pv) | (i != pi) | (u != pu)).sum())
    vs_k1 = int(((v != ref[0]) | (i != ref[1]) | (u != ref[2])).sum())
    check(not (vs_plain or vs_k1), f"{name}: {vs_plain} rays differ from "
          f"its plain version, {vs_k1} from K1")
    return err, (f"{name} rays differing from plain {vs_plain}, from K1 "
                 f"{vs_k1}, max_abs_err {err}")


def admitted_pairs(p0, p1, boxes, m, u, chunk):
    """The ray-surface pairs a culled search must compute on these inputs:
    for each ray, the surfaces of every chunk (of ``chunk`` rows; ``boxes``
    (C, 2 dim) their boxes, ``m`` the surface count) whose box its own slab
    test admits no farther than its final nearest hit ``u``.  In 3D one
    count for K3 and K4 alike, at the finer of their chunks."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    dim = p0.shape[1]
    sizes = torch.full((boxes.shape[0],), chunk, dtype=torch.int64,
                       device=p0.device)
    sizes[-1] = m - (boxes.shape[0] - 1) * chunk
    inv = tk._inverse_direction(p1 - p0)
    o = [a[:, None] for a in p0.unbind(1)]
    inv = [a[:, None] for a in inv.unbind(1)]
    total = 0
    for c0 in range(0, boxes.shape[0], 8):
        box = boxes[c0:c0 + 8].T
        gate = tk._slab_gate(o, inv, box[:dim], box[dim:], EPS, u[:, None])
        total += int((gate.to(torch.int64) * sizes[c0:c0 + 8]).sum())
    return total


def k1_branch_shares(p0, p1, vp, v1, v2, rays_per_thread):
    """K1's divergence on these inputs: the share of its (warp, triangle)
    steps on which some of the warp's 32 x ``rays_per_thread`` pairs
    passes tu's test (the branch a triangle is taken), and of its (warp,
    ray k, triangle) steps on which some lane's ray k does (that ray's
    second half runs).  By the exact tu test, which the kernel's widened
    test passes at least; rays laid out as the kernel takes them, 256
    threads a block, ray k of a thread at offset 256 k."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    i_eps, s_lo, s_hi, _ = tk._thresholds(EPS, EPS, EPS)
    n, m = p0.shape[0], vp.shape[0]
    block = 256 * rays_per_thread
    a = vp.T[:, None]
    e1, e2 = v1.T[:, None] - a, v2.T[:, None] - a
    step = max(1, (1 << 25) // (m * block)) * block
    branch = ray_half = 0
    for r0 in range(0, n, step):
        o = p0[r0:r0 + step, :, None]
        d = p1[r0:r0 + step, :, None] - o
        ok, _, _, tu = tk._tu(*o.unbind(1), *d.unbind(1), a, e1, e2, i_eps)
        passes = ~tk._out_on_tu(ok, tu, s_lo, s_hi)            # (B, M)
        pad = -passes.shape[0] % block
        if pad:
            passes = torch.cat([passes, passes.new_zeros((pad, m))])
        lanes = passes.view(-1, rays_per_thread, 8, 32, m).any(dim=3)
        branch += int(lanes.any(dim=1).sum())
        ray_half += int(lanes.sum())
    warps = -(-n // block) * 8
    return (branch / (warps * m), ray_half / (warps * rays_per_thread * m))


def triangle_pairs(p0, p1, vp, v1, v2, u, chunk):
    """The ray-triangle pairs K3 and K4 must compute on these inputs
    (``admitted_pairs`` at chunks of ``chunk`` triangles) and how many of
    them fail on tu alone (``triangle_kernels.pairs_out_on_tu``).  Returns
    (admitted, out on tu)."""
    from tensorflowraytrace_tpu_torch.models.acceleration import chunk_aabbs
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    o = [a[:, None] for a in p0.unbind(1)]
    inv = [a[:, None] for a in tk._inverse_direction(p1 - p0).unbind(1)]
    boxes = chunk_aabbs(vp, v1, v2, chunk)
    admitted = out = 0
    for c in range(boxes.shape[0]):
        box = boxes[c:c + 1].T
        rows = tk._slab_gate(o, inv, box[:3], box[3:], EPS,
                             u[:, None])[:, 0].nonzero()[:, 0]
        tri = slice(c * chunk, (c + 1) * chunk)
        admitted += rows.numel() * vp[tri].shape[0]
        out += tk.pairs_out_on_tu(p0[rows], p1[rows], vp[tri], v1[tri],
                                  v2[tri], EPS, EPS)
    return admitted, out


def accel_configs(bounces, scene):
    """The five search paths' trace configurations for ``scene``, children
    starting ``engine.start_epsilon`` past their surface."""
    from tensorflowraytrace_tpu_torch import TraceConfig
    from tensorflowraytrace_tpu_torch.engine import start_epsilon

    eps = start_epsilon(scene)

    def cfg(**kw):
        return TraceConfig(max_bounces=bounces, use_kernel=True,
                           ray_start_epsilon=eps, **kw)

    return {"brute": cfg(), "cull": cfg(cull=True), "grid": cfg(cull="grid"),
            "grid+resort": cfg(cull="grid", resort_rays=True),
            "cull+resort": cfg(cull=True, resort_rays=True)}


def accel_paths(label, rays, scene, materials, bounces, launched):
    """The search paths of one scene (``accel_configs``): the final state
    and endpoints of every accelerated path against the brute path's, bit
    for bit, each kernel once per bounce, and the median of 5 synchronised
    traces after one more.  Adds each kernel's launches to ``launched``;
    returns the medians (s) and the state counts."""
    import torch

    from tensorflowraytrace_tpu_torch import trace
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    cfgs = accel_configs(bounces, scene)
    kernel_of = {"brute": "K1", "cull": "K3", "grid": "K4",
                 "grid+resort": "K4", "cull+resort": "K3"}
    times = {k: [] for k in cfgs}
    finals = {}
    for rep in range(6):  # rep 0 warms up and gives the results
        for name, cfg in cfgs.items():
            tk.LAUNCHES = tk.LAUNCHES_CULLED = tk.LAUNCHES_TWOLEVEL = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = trace(rays, scene, materials, cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {"K1": tk.LAUNCHES, "K3": tk.LAUNCHES_CULLED,
                      "K4": tk.LAUNCHES_TWOLEVEL}
            want = {k: bounces if k == kernel_of[name] else 0 for k in counts}
            check(counts == want, f"{label} {name}: launches {counts}, "
                  f"not {want}")
            for k, c in counts.items():
                launched[k] = launched.get(k, 0) + c
            if rep == 0:
                finals[name] = res.rays
            else:
                times[name].append(dt)
            del res
    ref = finals["brute"]
    check(bool(torch.isfinite(ref.p1).all()), f"{label}: non-finite endpoints")
    states = state_counts(ref.state)
    pairs = rays.n_rays * scene.triangles.n_surfaces * bounces
    med = {k: statistics.median(v) for k, v in times.items()}
    for name in cfgs:
        got = finals[name]
        same = {f: torch.equal(getattr(got, f), getattr(ref, f))
                for f in ("state", "p0", "p1")}
        print(f"{label} {name}: median {med[name] * 1e3:.3f} ms over 5 traces "
              f"{[round(t * 1e3, 3) for t in times[name]]} = "
              f"{pairs / med[name]:.4e} equivalent intersections/s; "
              f"bitwise equal to brute {same}", flush=True)
        check(all(same.values()), f"{label} {name}: differs from the brute "
              f"trace ({same})")
    print(f"{label}: N={rays.n_rays} M={scene.triangles.n_surfaces} "
          f"bounces={bounces} states[active,finished,stopped,dead]={states}",
          flush=True)
    return med, states


def state_counts(state):
    import torch

    return torch.bincount(state.long(), minlength=4).tolist()


def guide2d_backward(device):
    """The busiest K2 call of phase 14's backward: one forward and backward
    of the 2D guide design (``scenes2d.guide_design``) under
    ``TraceConfig.recommended``, every K2 call recorded, and of those at
    the ``guide2d_backward`` case's (m, k) the one whose rays carry the
    most nonzero cotangents.  Returns its ``(ct, idx)`` and prints every
    such call's share of rays with a zero cotangent (a ray that hit no
    arc at that bounce).  The recorded calls run the kernel, whose
    launches count nowhere: the main paths reset the counts."""
    import torch

    from tensorflowraytrace_tpu_torch import TraceConfig, scenes2d
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    _, n, m, k, _ = next(c for c in SEGSUM_CASES if c[4] == "guide2d")
    loss, params, scene = scenes2d.guide_design(GUIDE2D_RAYS, device=device)
    cfg = TraceConfig.recommended(scene, max_bounces=scenes2d.GUIDE_BOUNCES,
                                  dead_ray_length=scenes2d.DEAD_RAY_LENGTH)
    kernel, live, best = sk.segment_sum_kernel, [], None

    def record(ct, idx, rows):
        nonlocal best
        if ct.shape == (k, n) and rows == m:
            hit = int((ct != 0).any(dim=0).sum())
            live.append(hit)
            if best is None or hit > best[0]:
                best = (hit, ct.detach().clone(), idx.clone())
        return kernel(ct, idx, rows)

    sk.segment_sum_kernel = record
    try:
        torch.autograd.grad(loss(params, cfg), params)
    finally:
        sk.segment_sum_kernel = kernel
    check(best is not None, f"phase 14's backward made no K2 call at "
          f"m={m} k={k} N={n}")
    zero = sorted(1 - h / n for h in live)
    print(f"K2 guide2d_backward: {len(live)} calls of phase 14's backward at "
          f"m={m} k={k}; rays with a zero cotangent min "
          f"{zero[0]:.4%} median {zero[len(zero) // 2]:.4%} max "
          f"{zero[-1]:.4%}; timed: the busiest call, {1 - best[0] / n:.4%} "
          f"zero", flush=True)
    return best[1], best[2]


def segsum_inputs(n, m, k, pattern, device, seed=0):
    """(k, N) float32 cotangents and (N,) int32 rows for phase 6."""
    import torch

    gen = torch.Generator(device).manual_seed(seed)
    ct = torch.randn((k, n), generator=gen, device=device)
    if pattern == "spot":  # weights in [0, 1) on a square image's bins
        side = math.isqrt(m)
        ct = torch.rand((k, n), generator=gen, device=device)
        xy = (torch.randn((2, n), generator=gen, device=device) * side / 6
              + side / 2).long().clamp(0, side - 1)
        return ct, (xy[0] * side + xy[1]).to(torch.int32)
    if pattern == "random":
        idx = torch.randint(0, m, (n,), generator=gen, device=device)
    elif pattern == "coherent":  # blocks of 100 rays on nearby rows
        base = torch.randint(0, m - 40, (n // 100 + 1,), generator=gen,
                             device=device).repeat_interleave(100)[:n]
        idx = base + torch.randint(0, 40, (n,), generator=gen, device=device)
    else:  # every ray on one row: the most contention
        idx = torch.full((n,), m // 2, device=device)
    return ct, idx.to(torch.int32)


def segsum_case(label, device, guide2d=None):
    """Phase 6's case ``label`` of ``SEGSUM_CASES``: ``(ct, idx, m)``; the
    "guide2d" case is ``guide2d``, of ``guide2d_backward``."""
    n, m, k, pattern = {c[0]: c[1:] for c in SEGSUM_CASES}[label]
    if pattern == "guide2d":
        return (*guide2d, m)
    return (*segsum_inputs(n, m, k, pattern, device), m)


def compare_k2(label, ct, idx, m, prefix="phase 6 K2", kernel=None,
               exact=True):
    """K2 (or ``kernel``, with its arguments) against its plain version on
    the (k, N) cotangents ``ct`` and rows ``idx``: bit for bit in ``ct``'s
    dtype, and 10 launches on the same inputs give the same bits (both
    printed, and checked where ``exact``); its distance to the float64
    plain version within ``1e-5 S + 1e-7``.  Returns max |K2 - ref64|.
    These launches are comparisons."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    kernel = kernel or sk.segment_sum_kernel
    k, n = ct.shape
    got = kernel(ct, idx, m)
    runs = [kernel(ct, idx, m) for _ in range(9)]
    torch.cuda.synchronize()
    repeated = all(same_bits(r, got) for r in runs)
    plain32 = sk.segment_sum_plain(ct, idx, m)
    equal = same_bits(got, plain32)
    ref64 = sk.segment_sum_plain(ct.double(), idx, m)
    scale = sk.segment_sum_plain(ct.double().abs(), idx, m)
    err = (got.double() - ref64).abs()
    worst = float((err - (1e-5 * scale + 1e-7)).max())
    max_err = float(err.max())
    print(f"{prefix} {label}: N={n} m={m} k={k} "
          f"equal_to_plain_bit_for_bit={equal} "
          f"ten_launches_bit_for_bit={repeated} max_abs_err={max_err} "
          f"max_rel_to_S={float((err / (scale + 1e-30)).max()):.3e}",
          flush=True)
    check(equal or not exact, f"K2 {label}: differs from its plain version "
          f"in {int((got != plain32).sum())} entries")
    check(repeated or not exact,
          f"K2 {label}: 10 launches on the same inputs differ")
    check(worst <= 0.0, f"K2 {label}: exceeds 1e-5 S + 1e-7 by {worst}")
    return max_err


def time_k2(ct, idx, m, reps=50, kernel=None):
    """K2's wrapper (or ``kernel``) on ``(ct, idx)``: ms a call by CUDA
    events, which count the host's issue when it is slower than the
    kernel, and by device time (its kernels alone, ``kernel_device_ms``;
    None if not measured), and the device time split by kernel (a text)."""
    import re

    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    kernel = kernel or sk.segment_sum_kernel

    def fn():
        return kernel(ct, idx, m)

    split = kernel_device_split(fn, "segment_sum", reps)
    short = {k: (re.search(r"segment_sum_([a-z_]+?)(?:<|E|I|\()", k)
                 or [k, k])[1] for k in split}
    parts = ", ".join(f"{short[k]} {v:.5f}" for k, v in split.items())
    return (cuda_ms(fn, reps), sum(split.values()) if split else None,
            parts or "not measured")


def segsum_alone(device):
    """``--segsum-alone``: K2 at phase 6's timed shapes, each checked with
    phase 6's criterion, by CUDA events and by device time.  It calls
    ``segsum_kernels``' ``segment_sum_kernel`` and ``segment_sum_plain``
    alone, whose arguments are the same in every version of the port:
    copied into the root of an earlier checkout, the script times that
    checkout's K2 the same way (a K2 from before the fixed order, without
    ``segsum_kernels.TILE``, is held to the float64 bound alone)."""
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    guide2d = guide2d_backward(device)
    for label in SEGSUM_TIMED:
        ct, idx, m = segsum_case(label, device, guide2d)
        compare_k2(label, ct, idx, m, prefix="K2 alone",
                   exact=hasattr(sk, "TILE"))
        ms, dev, parts = time_k2(ct, idx, m)
        dev_ms = "not measured" if dev is None else f"{dev:.5f} ms"
        print(f"K2 alone {label}: kernel {ms:.5f} ms by CUDA events, "
              f"device time {dev_ms} (ms by kernel: {parts})", flush=True)


def segsum_variant_source(text, variant):
    """``segment_sum.cu``'s ``text`` with the constants of ``variant`` (of
    ``SEGSUM_VARIANTS``) set, or as it stands for None; each replaced
    constant must occur once."""
    import re

    for name, value in (variant or {}).items():
        text, count = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        check(count == 1, f"segment_sum.cu: {name} found {count} times")
    return text


def ptxas_summary(report):
    """Each kernel's registers and spills from ``-Xptxas -v`` output, as
    ``name: N registers, S bytes spill stores, L bytes spill loads`` joined
    by "; " (a template's arguments in the name's brackets)."""
    import re

    found, name = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '[^']*?(segment_sum_"
                          r"[a-z_]+?)(?:I([fd])E)?E", line)
        if entry:
            name = entry[1] + (f"<{entry[2]}>" if entry[2] else "")
            found[name] = {}
        elif name and "spill" in line:
            found[name]["spill"] = ", ".join(
                part.strip() for part in line.split(",")[1:])
        elif name and "Used" in line:
            found[name]["regs"] = re.search(r"Used (\d+) registers", line)[1]
    return "; ".join(f"{k}: {v.get('regs')} registers, {v.get('spill')}"
                     for k, v in found.items())


def segsum_variants(device, variants=SEGSUM_VARIANTS, timed=SEGSUM_TIMED):
    """``--tune``: K2 built from ``segment_sum.cu`` once for each of
    ``variants`` (one nvcc each, started together, with ptxas' registers
    and spills printed), each checked with phase 6's criterion and timed
    at ``timed`` by CUDA events and by device time, in the variants' order
    and then in reverse, so that a drift of the card shows."""
    import ctypes
    import functools

    from tensorflowraytrace_tpu_torch.ops import cuda_build
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    text = (cuda_build.CSRC_DIR / sk.SOURCE).read_text()
    folder = cuda_build.BUILD_DIR / "segsum_variants"
    folder.mkdir(parents=True, exist_ok=True)
    names, jobs = [], []
    for v in (None, *variants):
        name = ("as built" if v is None else
                ", ".join(f"{k} {x}" for k, x in v.items()))
        tag = ("built" if v is None else
               "_".join(f"{k}{x}" for k, x in v.items()))
        src, lib = folder / f"{tag}.cu", folder / f"{tag}.so"
        src.write_text(segsum_variant_source(text, v))
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(lib), str(src)]
        names.append(name)
        jobs.append((lib, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    kernels = []
    for name, (lib, cmd, proc) in zip(names, jobs):
        report = proc.communicate()[0]
        check(proc.returncode == 0, f"nvcc failed: {' '.join(cmd)}\n{report}")
        print(f"K2 variant {name}: ptxas {ptxas_summary(report)}",
              flush=True)
        kernels.append(functools.partial(sk.launch,
                                         sk.declare(ctypes.CDLL(str(lib)))))
    guide2d = guide2d_backward(device)
    for label in timed:
        ct, idx, m = segsum_case(label, device, guide2d)
        for order in (range(len(names)), reversed(range(len(names)))):
            for i in order:
                compare_k2(f"{label}, {names[i]}", ct, idx, m,
                           prefix="K2 variant", kernel=kernels[i])
                ms, dev, _ = time_k2(ct, idx, m, kernel=kernels[i])
                dev_ms = "not measured" if dev is None else f"{dev:.5f} ms"
                print(f"K2 variant {label}, {names[i]}: kernel {ms:.5f} ms "
                      f"by CUDA events, device time {dev_ms}", flush=True)


def deterministic_ms(fn, reps):
    """``cuda_ms`` of ``fn`` under ``torch.use_deterministic_algorithms``,
    reset afterwards."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        return cuda_ms(fn, reps)
    finally:
        torch.use_deterministic_algorithms(False)


def k2_timing(label, ct, idx, m, err):
    """Phase 6's fields of one timed case in ``ct``'s dtype: K2 by CUDA
    events, its plain version (on the host), ``index_add_`` and
    ``index_add_`` under ``torch.use_deterministic_algorithms``, and the
    bound; printed."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    k, n = ct.shape
    e = ct.element_size()
    ct_t, idx_l = ct.T, idx.long()
    buf = torch.zeros((m, k), device=ct.device, dtype=ct.dtype)
    bytes_ms = (e * (k * n + m * k) + 4 * n) / PEAK_BYTES_S * 1e3
    peak = PEAK_FP32_FLOP_S if e == 4 else PEAK_FP64_FLOP_S
    ops_ms = k * n / peak * 1e3
    f = {
        "n": n, "m": m, "k": k, "dtype": str(ct.dtype).split(".")[-1],
        "max_abs_err": err, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "ms": cuda_ms(lambda: sk.segment_sum_kernel(ct, idx, m), 50),
        # on the host, where the plain version computes for CUDA
        "plain_ms": cuda_ms(lambda: sk.segment_sum_plain(ct, idx, m),
                            K2_SLOW_REPS),
        "library_ms": cuda_ms(lambda: buf.index_add_(0, idx_l, ct_t), 50),
        # the library's fixed-order counterpart
        "library_deterministic_ms": deterministic_ms(
            lambda: buf.index_add_(0, idx_l, ct_t), K2_SLOW_REPS),
    }
    print(f"phase 6 K2 {label} {f['dtype']} timing: kernel {f['ms']:.5f} ms "
          f"by CUDA events (its device time after phase 14), plain "
          f"{f['plain_ms']:.5f} ms (on the host), index_add_ "
          f"{f['library_ms']:.5f} ms, deterministic index_add_ "
          f"{f['library_deterministic_ms']:.5f} ms, bound "
          f"{f['bound_ms']:.5f} ms ({f['bound_by']})", flush=True)
    return f


def phase_6(device):
    """K2 against its plain version bit for bit at every case of
    ``SEGSUM_CASES``, in float32 and in float64 (10 launches each), and
    timed at ``SEGSUM_TIMED``; returns the timed cases' fields, the
    float64 ones under the label + " float64"."""
    guide2d = guide2d_backward(device)
    k2 = {}
    for label, *_ in SEGSUM_CASES:
        ct, idx, m = segsum_case(label, device, guide2d)
        err = compare_k2(label, ct, idx, m)
        ct64 = ct.double()
        err64 = compare_k2(label, ct64, idx, m, prefix="phase 6 K2 float64")
        if label in SEGSUM_TIMED:
            k2[label] = k2_timing(label, ct, idx, m, err)
            k2[f"{label} float64"] = k2_timing(label, ct64, idx, m, err64)
    return k2


def k2_device_times(k2, device):
    """Phase 6's timed cases again, K2's device time of each (``time_k2``)
    into ``k2``.  It runs after phase 14, so that no profiled run comes
    before the host-bound steps of phases 7 and 8."""
    guide2d = guide2d_backward(device)
    for key, f in k2.items():
        label = key.removesuffix(" float64")
        ct, idx, m = segsum_case(label, device, guide2d)
        if key != label:
            ct = ct.double()
        _, f["device_ms"], parts = time_k2(ct, idx, m)
        dev_ms = ("not measured" if f["device_ms"] is None
                  else f"{f['device_ms']:.5f} ms")
        print(f"phase 6 K2 {key} device time: {dev_ms} (ms by kernel: "
              f"{parts})", flush=True)


def device_profile(prof):
    """What a torch.profiler run recorded on the device: the time (us) of
    its kernels and copies summed by name, the union of their intervals
    (us), and their count."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name not in RANGES)
    by_name = collections.Counter()
    union, last = 0.0, None
    for a, b, name in spans:
        by_name[name] += b - a
        if last is None or a > last:
            union += b - a
            last = b
        elif b > last:
            union += b - last
            last = b
    return by_name, union, len(spans)


def kernel_device_ms(fn, name, reps=10):
    """Device time (ms a call) of the kernels whose name holds ``name`` that
    torch.profiler records over ``reps`` calls of ``fn`` after one: the
    kernels alone, without the gaps that CUDA events around back-to-back
    calls also count when a kernel is shorter than the host time that
    launches it.  Each kernel's mean span, summed over the kernels a call
    launches: the profiler may miss some spans of a run.  None when the
    profiler records none."""
    split = kernel_device_split(fn, name, reps)
    return sum(split.values()) if split else None


def kernel_device_split(fn, name, reps=10):
    """``kernel_device_ms``'s kernels one by one: {kernel name: mean ms of
    its spans}, empty when the profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name:
            spans[e.name].append(e.time_range.end - e.time_range.start)
    return {k: sum(v) / len(v) / 1e3 for k, v in spans.items()}


def range_device_us(prof, label):
    """Device time (us) of the kernels launched inside the profiler ranges
    named ``label``."""
    import torch

    total = 0.0
    for e in prof.events():
        if e.name == label and e.device_type == torch.autograd.DeviceType.CPU:
            total += (e.device_time_total if hasattr(e, "device_time_total")
                      else e.cuda_time_total)
    return total


def count_syncs(fn):
    """The synchronising calls ``fn()`` makes, as torch's sync debug mode
    reports them."""
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_guide3d(label, kernel, rays, scene, materials, cfg, device,
                    phase="phase 10"):
    """One profiled trace of the 3D guide: the device-time split (the
    search kernel named ``kernel``, the candidate precompute, the re-sort,
    the rest), the idle share, kernels a bounce, peak memory and host
    synchronisations (which must be 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorflowraytrace_tpu_torch import trace

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    trace(rays, scene, materials, cfg)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trace(rays, scene, materials, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, union_us, n_device = device_profile(prof)
    busy_us = sum(by_name.values())
    if busy_us > 0:
        search_us = sum(t for k, t in by_name.items() if kernel in k)
        cand_us = range_device_us(prof, "twolevel_candidates")
        resort_us = range_device_us(prof, "resort_rays")
        rest_us = busy_us - search_us - cand_us - resort_us
        split = (f"device busy {union_us:.1f} us of {wall_us:.1f} us wall "
                 f"(idle share {1 - union_us / wall_us:.4f}); {n_device} "
                 f"kernels and copies ({n_device / cfg.max_bounces:.1f} a "
                 f"bounce), {busy_us:.1f} us: {kernel} {search_us:.1f} us "
                 f"({search_us / busy_us:.4%}), candidate precompute "
                 f"{cand_us:.1f} us ({cand_us / busy_us:.4%}), re-sort "
                 f"{resort_us:.1f} us ({resort_us / busy_us:.4%}), rest "
                 f"{rest_us:.1f} us ({rest_us / busy_us:.4%}); top: "
                 + "; ".join(f"{k[:50]} {t:.1f} us"
                             for k, t in by_name.most_common(5)))
    else:
        split = "the profiler recorded no device time: split not measured"
    syncs = count_syncs(lambda: trace(rays, scene, materials, cfg))
    print(f"{phase} {label} profiled trace: {split}; peak device memory "
          f"{peak_gib:.3f} GiB; {syncs} synchronising calls", flush=True)
    check(syncs == 0, f"the guide {label} trace synchronised {syncs} times")


def first_bounce_3d(rays, tri):
    """A 3D search's arguments at a scene's first bounce, the rays in the
    Morton order the re-sort gives them: ``[p0, p1, vp, v1, v2]``."""
    import torch

    from tensorflowraytrace_tpu_torch.models.acceleration import (
        morton_codes_device,
    )

    lo = torch.minimum(tri.vp.amin(dim=0), tri.v2.amin(dim=0))
    hi = torch.maximum(tri.vp.amax(dim=0), tri.v2.amax(dim=0))
    order = torch.argsort(morton_codes_device(rays.p0, lo, hi), stable=True)
    return [t.contiguous() for t in (rays.p0[order], rays.p1[order], tri.vp,
                                     tri.v1, tri.v2)]


def tune_brute(device):
    """``--tune``: K1 alone at the unsorted soup's and the guide's first
    bounce (2^20 rays each) at each rays a thread it is compiled for,
    checked against each other bit for bit (``brute_rays_per_thread``
    takes 4 at both shapes)."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
    from tensorflowraytrace_tpu_torch.scenes3d import structured_guide

    rays, scene = soup_scene(BENCH_RAYS, device)
    tri = scene.triangles
    g_rays, g_scene = structured_guide(GUIDE_RAYS, device=device)
    cases = {"soup": [t.contiguous() for t in (rays.p0, rays.p1, tri.vp,
                                               tri.v1, tri.v2)],
             "guide": first_bounce_3d(g_rays, g_scene.triangles)}
    for name, args in cases.items():
        ref = tk.brute_launch(*args, EPS, EPS, EPS, rays_per_thread=1)
        for rpt in tk.BRUTE_RAYS_PER_THREAD:
            got = tk.brute_launch(*args, EPS, EPS, EPS, rays_per_thread=rpt)
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  f"tune K1 at {rpt} rays a thread differs on the {name}")
            ms = cuda_ms(lambda: tk.brute_launch(
                *args, EPS, EPS, EPS, rays_per_thread=rpt), 10)
            print(f"tune K1 alone at the {name}'s first bounce "
                  f"{args[0].shape[0]}x{args[2].shape[0]}: {rpt} rays a "
                  f"thread: kernel {ms:.4f} ms", flush=True)


def tune_twolevel(device):
    """``--tune``: K4 alone at the guide's first bounce at every ray block
    (checked against K1 bit for bit); then K4's ray block (cap 32) and its
    cap at the best block, on the guide (24 bounces) and the sorted soup (8 bounces) with ``cull="grid",
    resort_rays=True``: median of 3 traces after one, each checked against
    the brute trace bit for bit."""
    import torch

    from tensorflowraytrace_tpu_torch import TraceConfig, trace
    from tensorflowraytrace_tpu_torch.ops import materials as mats
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
    from tensorflowraytrace_tpu_torch.scenes3d import structured_guide

    scenes = {
        "guide": structured_guide(GUIDE_RAYS, device=device)
        + ((mats.vacuum, mats.acrylic), GUIDE_BOUNCES),
        "soup": soup_scene(BENCH_RAYS, device, sort=True)
        + ((mats.vacuum, mats.reflective), BENCH_BOUNCES),
    }
    refs = {k: trace(r, sc, mt, TraceConfig(max_bounces=b, use_kernel=True)).rays
            for k, (r, sc, mt, b) in scenes.items()}

    # K4 alone at the guide's first bounce at each block
    args = first_bounce_3d(scenes["guide"][0], scenes["guide"][1].triangles)
    ref = tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
    m = args[2].shape[0]
    for rb in (64, 128, 256, 512, 1024):
        tk.TWOLEVEL_RAY_BLOCK = rb
        prepared = tk.twolevel_prepare(*args, EPS, EPS)
        got = tk.twolevel_launch(args[0], args[1], m, prepared, EPS, EPS, EPS)
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"tune K4 alone {rb} differs from K1")
        ms = cuda_ms(lambda: tk.twolevel_launch(args[0], args[1], m, prepared,
                                                EPS, EPS, EPS), 10)
        print(f"tune K4 alone at the guide's first bounce: ray_block={rb} "
              f"fine_chunk={tk.FINE_CHUNK} cap={prepared[4]}: kernel "
              f"{ms:.4f} ms, mean candidates "
              f"{float(prepared[2].float().mean()):.2f}", flush=True)
        del prepared, got
    del args, ref

    def run(rb, cap):
        tk.TWOLEVEL_RAY_BLOCK, tk.TWOLEVEL_MAX_CAND = rb, cap
        out = {}
        for k, (rays, scene, materials, bounces) in scenes.items():
            cfg = TraceConfig(max_bounces=bounces, use_kernel=True,
                              cull="grid", resort_rays=True)
            times = []
            for rep in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = trace(rays, scene, materials, cfg)
                torch.cuda.synchronize()
                if rep == 0:
                    check(torch.equal(res.rays.state, refs[k].state)
                          and torch.equal(res.rays.p1, refs[k].p1),
                          f"tune {k} {rb}/{cap} differs from brute")
                else:
                    times.append(time.perf_counter() - t0)
            out[k] = statistics.median(times)
        print(f"tune ray_block={rb} fine_chunk={tk.FINE_CHUNK} max_cand={cap}: "
              + ", ".join(f"{k} {t * 1e3:.3f} ms" for k, t in out.items()),
              flush=True)
        return out

    blocks = {rb: run(rb, 32) for rb in (64, 128, 256, 512, 1024)}
    rb = min(blocks, key=lambda key: blocks[key]["guide"])
    for cap in (8, 16, 64, 128):
        run(rb, cap)


# ----------------------------------------------------------------------
# phases 11-13: the 2D path
# ----------------------------------------------------------------------

# the 2D searches of each kind: variant -> (kernel, function-name suffix)
SEARCHES_2D = {"segment": {"brute": ("K5", ""), "culled": ("K7", "_culled"),
                           "twolevel": ("K9", "_twolevel")},
               "arc": {"brute": ("K6", ""), "culled": ("K8", "_culled"),
                       "twolevel": ("K10", "_twolevel")}}


def search_2d(kind, variant, plain=False, size_eps=EPS):
    """The wrapper (or plain version) of one 2D search (``variant`` brute,
    culled or twolevel) and its epsilons (``size_eps`` for segments)."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    mod, name, eps = ((gk, "segments", (EPS, size_eps, EPS))
                      if kind == "segment" else (ak, "arcs", (EPS, EPS)))
    suffix = SEARCHES_2D[kind][variant][1] + ("_plain" if plain else "_kernel")
    fn = getattr(mod, f"nearest_hit_{name}{suffix}")
    return lambda args: fn(*args, *eps)


def surface_args(p0, p1, surfaces):
    """A 2D search's tensor arguments: the rays and a SegmentSet's
    endpoints or an ArcSet's centre, angles and radius."""
    cols = (("p0", "p1") if hasattr(surfaces, "p0")
            else ("center", "angle_start", "angle_end", "radius"))
    return [t.detach().contiguous()
            for t in (p0, p1) + tuple(getattr(surfaces, c) for c in cols)]


def compare_2d(label, kind, args, variants=("brute", "culled", "twolevel"),
               size_eps=EPS):
    """The 2D kernels ``variants`` of ``kind`` against their plain versions
    and the brute kernel, bit for bit; returns ``(out, err)``: their outputs
    ``{variant: ...}`` and each one's max |u - u_plain| on rays both find
    valid.  These launches are comparisons, not the main path."""
    import torch

    variants = ("brute",) + tuple(v for v in variants if v != "brute")
    out = {c: search_2d(kind, c, size_eps=size_eps)(args) for c in variants}
    torch.cuda.synchronize()
    plain = {c: search_2d(kind, c, plain=True, size_eps=size_eps)(args)
             for c in variants}
    pairs = {f"{c} vs plain": (out[c], plain[c]) for c in variants}
    pairs.update({f"{c} vs brute": (out[c], out["brute"])
                  for c in variants[1:]})
    diffs = {k: int(sum((a != b).sum() for a, b in zip(x, y)))
             for k, (x, y) in pairs.items()}
    err = {}
    for c in out:
        both = out[c][0] & plain[c][0]
        err[c] = (float((out[c][2][both] - plain[c][2][both]).abs().max())
                  if both.any() else 0.0)
    print(f"{label} {kind}: N={args[0].shape[0]} M={args[2].shape[0]} "
          f"hits={int(out['brute'][0].sum())} elements differing: {diffs}; "
          f"max_abs_err {err}", flush=True)
    check(not any(diffs.values()), f"{kind} {label}: differs ({diffs})")
    return out, err


def phase_11(device):
    """K5-K10 against their plain versions and K7-K10 against K5/K6."""
    import numpy as np
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rng = np.random.default_rng(7)
    seg = scenes2d.random_segments(rng, CHECK_SEGMENTS, device=device)
    arc = scenes2d.random_arcs(rng, CHECK_ARCS, device=device)
    full = scenes2d.random_arcs(rng, 300, device=device, full=True)
    p0, p1 = scenes2d.random_rays(rng, CHECK_RAYS, device=device)
    far = torch.full_like(p0[:4096], 100.0)
    parked = torch.full_like(p0[:4096], 1e30)
    cases = [("sets", p0, p1, seg, arc),
             ("ragged", p0[:1000], p1[:1000], seg_slice(seg, 333),
              arc_slice(arc, 333)),
             ("one ray", p0[:1], p1[:1], seg_slice(seg, 257),
              arc_slice(arc, 257)),
             ("all-miss", far, far + 1.0, seg, arc),
             ("parked", parked, torch.full_like(parked, 1e30 * (1 + 1e-6)),
              seg, arc),
             ("full circles", p0, p1, None, full)]
    for label, r0, r1, s, a in cases:
        for kind, surfaces in (("segment", s), ("arc", a)):
            if surfaces is not None:
                out, _ = compare_2d(f"phase 11 {label}", kind,
                                    surface_args(r0, r1, surfaces))
                hits = bool(out["brute"][0].any())
                if label != "one ray":
                    check(hits == (label not in ("all-miss", "parked")),
                          f"{kind} {label}: hits {hits}")
    # K9 and K10 with every block of more than one candidate overflowing
    with override(gk, TWOLEVEL_MAX_CAND=1):
        for label, r0, r1, s, a in cases[:2]:
            for kind, surfaces in (("segment", s), ("arc", a)):
                compare_2d(f"phase 11 {label}, cap 1", kind,
                           surface_args(r0, r1, surfaces), ("twolevel",))
    # K6, K8 and K10 at the edges of their exact reject
    for label, r0, r1, a in scenes2d.arc_edge_cases(device=device):
        out, _ = compare_2d(f"phase 11 reject edge {label}", "arc",
                            surface_args(r0, r1, a))
        check(bool(out["brute"][0].any()) == (label != "parked"),
              f"arc reject edge {label}: hits")
    # hits at the edge of the boxes of the gates (K7-K10), the lists
    # overflowing (cap 1) too
    for label, r0, r1, s, size_eps in scenes2d.gate_edge_cases(device=device):
        kind = "segment" if hasattr(s, "p0") else "arc"
        for cap in (gk.TWOLEVEL_MAX_CAND, 1):
            with override(gk, TWOLEVEL_MAX_CAND=cap):
                out, _ = compare_2d(f"phase 11 gate edge {label}, cap {cap}",
                                    kind, surface_args(r0, r1, s),
                                    size_eps=size_eps)
        hits = label.split()[0] not in ("parked", "all-miss")
        check(bool(out["brute"][0].any()) == hits, f"gate edge {label}: hits")
    # blocks of which every ray, one ray or no ray needs a chunk, over a
    # ragged chunk and fewer than 256 surfaces, at K7's and K9/K10's blocks
    for m in (300, 100):
        for kind, make in (("segment", scenes2d.random_segments),
                           ("arc", scenes2d.random_arcs)):
            surfaces = make(rng, m, device=device)
            for block in sorted({gk.CULLED_RAY_BLOCK, gk.TWOLEVEL_RAY_BLOCK}):
                r0, r1 = scenes2d.block_rays(rng, surfaces, block,
                                             device=device)
                out, _ = compare_2d(f"phase 11 blocks of {block}, M={m}", kind,
                                    surface_args(r0, r1, surfaces))
                valid = out["brute"][0]
                check(bool(valid[:block].any())
                      and not bool(valid[block + 1:3 * block].any()),
                      f"blocks of {block}, {kind} M={m}: hits")


@contextlib.contextmanager
def override(mod, **values):
    """A context in which ``mod``'s attributes take ``values``."""
    old = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def seg_slice(seg, m):
    import dataclasses

    return dataclasses.replace(seg, p0=seg.p0[:m], p1=seg.p1[:m])


def arc_slice(arc, m):
    import dataclasses

    return dataclasses.replace(arc, center=arc.center[:m],
                               angle_start=arc.angle_start[:m],
                               angle_end=arc.angle_end[:m],
                               radius=arc.radius[:m])


def phase_12(device):
    """examples/optimize_single_arc.py through the kernels, then one step at
    bench width.  Returns the kernels' launches in the 80 steps."""
    import numpy as np
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.optim import Optimizer

    loss, params = scenes2d.single_arc(device=device, use_kernel=True)
    opt = Optimizer(loss, params, learning_rate=1.0, grad_clip=0.1,
                    pass_key=False)
    gk.LAUNCHES = ak.LAUNCHES = sk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errors = np.concatenate([
        opt.run_phase(ARC_STEPS[0], momentum=0.8),
        opt.run_phase(ARC_STEPS[1], lr_scale=0.1, momentum=0.9)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = sum(ARC_STEPS)
    launched = {"K5": gk.LAUNCHES, "K6": ak.LAUNCHES, "K2": sk.LAUNCHES}
    # two bounces a step; K2 is the backward of the arc table's gather (the
    # target segment's table has no gradient)
    check(launched == {"K5": 2 * steps, "K6": 2 * steps, "K2": 2 * steps},
          f"single-arc training launches {launched}")
    check(bool(np.all(np.isfinite(errors))), "single-arc errors not finite")
    check(all(bool(torch.isfinite(p).all()) for p in opt.parameters),
          "single-arc parameters not finite")
    check(errors[-1] < 0.05 * errors[0],
          f"single-arc error {errors[0]} -> {errors[-1]}, not below 5%")
    print(f"phase 12 single arc: {steps} steps in {train_s:.3f} s = "
          f"{train_s / steps * 1e3:.3f} ms/step; launches {launched}; error "
          f"{errors[0]!r} -> {errors[-1]!r} "
          f"({errors[-1] / errors[0]:.4%}); radius "
          f"{float(opt.parameters[0][0])!r}", flush=True)

    loss, params = scenes2d.single_arc(beam_count=ARC_WIDE_BEAM,
                                       device=device, use_kernel=True)
    opt = Optimizer(loss, params, learning_rate=1.0, grad_clip=0.1,
                    pass_key=False)
    opt.run_phase(1, momentum=0.8)  # warm-up
    step_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.run_phase(1, momentum=0.8)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    print(f"phase 12 bench-width step: {ARC_WIDE_BEAM * 6} rays, 2 bounces: "
          f"median {statistics.median(step_s) * 1e3:.3f} ms over 5 steps "
          f"{[round(t * 1e3, 3) for t in step_s]}", flush=True)
    return launched


def reset_2d_launches():
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    for mod in (gk, ak):
        mod.LAUNCHES = mod.LAUNCHES_CULLED = mod.LAUNCHES_TWOLEVEL = 0


def launches_2d():
    """The 2D search kernels' launch counts since the last reset."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    return {"K5": gk.LAUNCHES, "K6": ak.LAUNCHES, "K7": gk.LAUNCHES_CULLED,
            "K8": ak.LAUNCHES_CULLED, "K9": gk.LAUNCHES_TWOLEVEL,
            "K10": ak.LAUNCHES_TWOLEVEL}


def kernels_2d(cfg):
    """The segment and arc search kernels a 2D trace under ``cfg`` runs."""
    variant = ("twolevel" if cfg.cull == "grid" else
               "culled" if cfg.cull else "brute")
    return tuple(SEARCHES_2D[kind][variant][0] for kind in ("segment", "arc"))


def guide2d_configs(scene):
    from tensorflowraytrace_tpu_torch import scenes2d

    def cfg(**kw):
        return scenes2d.guide_config(scene, use_kernel=True, **kw)

    return {"brute": cfg(), "cull": cfg(cull=True),
            "cull+resort": cfg(cull=True, resort_rays=True),
            "grid": cfg(cull="grid"),
            "grid+resort": cfg(cull="grid", resort_rays=True)}


def guide2d_paths(rays, scene, materials, launched):
    """The 2D guide through brute, cull=True, cull=True + re-sort,
    cull="grid" and cull="grid" + re-sort: each accelerated path's final
    rays equal the brute path's bit for bit, each kernel launches once per
    bounce, median of 5 synchronised traces after one more.  Adds each
    kernel's launches to ``launched``."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d, trace

    bounces = scenes2d.GUIDE_BOUNCES
    cfgs = guide2d_configs(scene)
    times = {k: [] for k in cfgs}
    finals = {}
    for rep in range(6):  # rep 0 warms up and gives the results
        for name, cfg in cfgs.items():
            reset_2d_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = trace(rays, scene, materials, cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = launches_2d()
            want = {k: bounces if k in kernels_2d(cfg) else 0 for k in counts}
            check(counts == want, f"2D guide {name}: launches {counts}")
            for k, c in counts.items():
                launched[k] = launched.get(k, 0) + c
            if rep == 0:
                finals[name] = res.rays
            else:
                times[name].append(dt)
            del res
    ref = finals["brute"]
    check(bool(torch.isfinite(ref.p1).all()), "2D guide: non-finite endpoints")
    pairs = rays.n_rays * (scene.segments.n_surfaces
                           + scene.arcs.n_surfaces) * bounces
    med = {k: statistics.median(v) for k, v in times.items()}
    for name in cfgs:
        same = {f: torch.equal(getattr(finals[name], f), getattr(ref, f))
                for f in ("state", "p0", "p1")}
        print(f"phase 13 {name}: median {med[name] * 1e3:.3f} ms over 5 traces "
              f"{[round(t * 1e3, 3) for t in times[name]]} = "
              f"{pairs / med[name]:.4e} equivalent intersections/s; "
              f"bitwise equal to brute {same}", flush=True)
        check(all(same.values()), f"2D guide {name} differs from brute ({same})")
    print(f"phase 13 guide: N={rays.n_rays} M_seg={scene.segments.n_surfaces} "
          f"M_arc={scene.arcs.n_surfaces} bounces={bounces} "
          f"states[active,finished,stopped,dead]={state_counts(ref.state)}",
          flush=True)
    return med


def profile_guide2d(label, rays, scene, materials, cfg, device):
    """One profiled trace: the device-time split, idle share, peak memory
    and host synchronisations (which must be 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorflowraytrace_tpu_torch import trace

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    trace(rays, scene, materials, cfg)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trace(rays, scene, materials, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, union_us, n_device = device_profile(prof)
    busy_us = sum(by_name.values())
    if busy_us > 0:
        def busy(part):
            return sum(t for k, t in by_name.items() if part in k)

        seg_us = busy("segment_search")
        arc_us = busy("arc_search")
        cand_us = range_device_us(prof, "twolevel_candidates")
        resort_us = range_device_us(prof, "resort_rays")
        rest_us = busy_us - seg_us - arc_us - cand_us - resort_us
        split = (f"device busy {union_us:.1f} us of {wall_us:.1f} us wall "
                 f"(idle share {1 - union_us / wall_us:.4f}); {n_device} "
                 f"kernels and copies ({n_device / cfg.max_bounces:.1f} a "
                 f"bounce), {busy_us:.1f} us: segment search "
                 f"{seg_us:.1f} us ({seg_us / busy_us:.4%}), arc search "
                 f"{arc_us:.1f} us ({arc_us / busy_us:.4%}), candidate "
                 f"precompute {cand_us:.1f} us ({cand_us / busy_us:.4%}), "
                 f"re-sort {resort_us:.1f} us ({resort_us / busy_us:.4%}), "
                 f"rest {rest_us:.1f} us ({rest_us / busy_us:.4%}); top: "
                 + "; ".join(f"{k[:50]} {t:.1f} us"
                             for k, t in by_name.most_common(5)))
    else:
        split = "the profiler recorded no device time: split not measured"
    syncs = count_syncs(lambda: trace(rays, scene, materials, cfg))
    print(f"phase 13 {label} profiled trace: {split}; peak device memory "
          f"{peak_gib:.3f} GiB; {syncs} synchronising calls", flush=True)
    check(syncs == 0, f"the 2D guide {label} trace synchronised {syncs} times")


def phase_13(device):
    """The 2D light guide at full width; returns the kernels-line fields of
    K5-K10."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d
    from tensorflowraytrace_tpu_torch.models.acceleration import (
        chunk_aabbs_2d, chunk_aabbs_arcs,
    )
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rays, scene, materials = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    seg, arc = scene.segments, scene.arcs
    check((seg.n_surfaces, arc.n_surfaces) == (4098, 512),
          f"2D guide has {seg.n_surfaces} segments, {arc.n_surfaces} arcs")
    launched = {}
    guide2d_paths(rays, scene, materials, launched)
    cfgs = guide2d_configs(scene)
    for label in ("brute", "cull+resort", "grid+resort"):
        profile_guide2d(label, rays, scene, materials, cfgs[label], device)

    # K5-K10 alone at the first bounce, the rays in the re-sort's order
    p0, p1 = first_bounce_2d(rays, seg)
    n = p0.shape[0]
    fields = {}
    for kind, surfaces, boxes in (
            ("segment", seg, chunk_aabbs_2d(seg.p0, seg.p1, gk.CULL_CHUNK)),
            ("arc", arc, chunk_aabbs_arcs(arc.center, arc.angle_start,
                                          arc.angle_end, arc.radius,
                                          gk.CULL_CHUNK))):
        args = surface_args(p0, p1, surfaces)
        m = surfaces.n_surfaces
        out, err = compare_2d("phase 13 first bounce", kind, args)
        # bytes: the rays and the surface table read once, u / idx (/ branch)
        # written once
        surface_bytes = sum(a.numel() * 4 for a in args[2:])
        out_bytes = n * (9 if kind == "arc" else 8)
        bytes_ms = (n * 16 + surface_bytes + out_bytes) / PEAK_BYTES_S * 1e3
        u_final = out["brute"][2]
        gate_pairs = gate_box_pairs(kind, args, u_final)
        if kind == "segment":
            # every pair the same 14 operations; K7 and K9 share one bound,
            # the pairs these inputs need at 256-segment chunks
            culled = admitted_pairs(p0, p1, boxes, m, u_final, gk.CULL_CHUNK)
            work = {"brute": (n * m, n * m), "culled": (culled, culled)}
            flops = (SEG_FLOPS_PER_PAIR, SEG_FLOPS_PER_PAIR)
        else:
            # (pairs, of them past the exact reject), the others charged the
            # operations before it
            work = {"brute": (n * m, ak.admitted_arc_pairs(
                        p0, p1, arc.center, arc.radius, EPS)),
                    "culled": arc_work(p0, p1, boxes, arc, u_final)}
            flops = (ARC_REJECT_FLOPS, ARC_FLOPS_PER_PAIR)
        alone = alone_2d(kind, args, m)
        for variant, (key, _) in SEARCHES_2D[kind].items():
            pairs, past = work["brute" if variant == "brute" else "culled"]
            ops_ms = (((pairs - past) * flops[0] + past * flops[1])
                      / PEAK_FP32_FLOP_S * 1e3)
            prepare, launch = alone[variant]
            kernel = cuda_kernel_name(kind, variant)
            fn = search_2d(kind, variant)
            plain = search_2d(kind, variant, plain=True)
            prepared = prepare()
            fields[key] = f = {
                "launches": launched[key],
                "max_abs_err": err[variant],
                # the kernel alone, apart from its inputs' preparation
                "ms": cuda_ms(lambda: launch(prepared), 10),
                # its device time alone (CUPTI), without the host gaps the
                # events count when a kernel is shorter than its launch
                "device_ms": kernel_device_ms(lambda: launch(prepared),
                                              kernel),
                "wrapper_ms": cuda_ms(lambda: fn(args), 10),
                "prepare_ms": cuda_ms(prepare, 10),
                "plain_ms": cuda_ms(lambda: plain(args), 1),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                # every operation an instruction: the kernels are built
                # with --fmad=false, and the peak counts an FMA as two
                "floor_no_fma_ms": max(bytes_ms, 2 * ops_ms),
                "pairs": pairs,
                "shape": f"{n}x{m} (first bounce of the 2D guide)",
            }
            check(all(torch.equal(a, b) for a, b in
                      zip(launch(prepared), out[variant])),
                  f"{key} launched alone differs from its wrapper")
            if kind == "arc":
                flat_ms = pairs * ARC_FLOPS_PER_PAIR / PEAK_FP32_FLOP_S * 1e3
                f["pairs_past_reject"] = past
                f["flat_bound_ms"] = max(bytes_ms, flat_ms)
            detail = ""
            if variant != "brute":
                f["pairs_on_gate_boxes"] = gate_pairs
                detail += ("; pairs a per-ray gate admits on the boxes with "
                           f"the rounding margin alone {gate_pairs['margin']}"
                           f", on the boxes it gates on "
                           f"{gate_pairs['gate']}")
            if variant == "twolevel":
                f["prepare_split"] = split = prepare_split(kind, args)
                detail += "; its preparation " + ", ".join(
                    f"{k} {ev:.4f} ms by CUDA events, {host:.4f} ms of host "
                    f"time" for k, (ev, host) in split.items())
                counts = prepared[2]
                f["blocks"] = counts.shape[0]
                # a count of n_chunks is a sweep only when the cap is
                # below n_chunks; otherwise it lists every chunk
                n_chunks = prepared[1].shape[0]
                f["overflow_blocks"] = (int((counts == n_chunks).sum())
                                        if prepared[4] < n_chunks else 0)
                f["mean_candidates"] = float(counts.float().mean())
                detail += (f"; ray block {gk.TWOLEVEL_RAY_BLOCK}, chunk "
                           f"{gk.CULL_CHUNK}, cap {prepared[4]}: "
                           f"{f['blocks']} blocks, {f['overflow_blocks']} "
                           f"overflow, mean count "
                           f"{f['mean_candidates']:.2f} of {n_chunks}")
            if kind == "arc":
                detail += (f"; {past} pairs past the exact reject "
                           f"({past / pairs:.4%}), the others charged "
                           f"{flops[0]} flops; flat {ARC_FLOPS_PER_PAIR}-flop "
                           f"bound {f['flat_bound_ms']:.5f} ms")
            del prepared
            dev_ms = ("not measured" if f["device_ms"] is None
                      else f"{f['device_ms']:.4f} ms")
            print(f"phase 13 {key} alone at the first bounce {n}x{m}: kernel "
                  f"{f['ms']:.4f} ms (its device time {dev_ms}), its input "
                  f"preparation "
                  f"{f['prepare_ms']:.4f} ms, wrapper {f['wrapper_ms']:.4f} "
                  f"ms, plain {f['plain_ms']:.4f} ms, bound "
                  f"{f['bound_ms']:.5f} ms ({f['bound_by']}; {pairs} pairs, "
                  f"{pairs / (n * m):.4%} of brute; without FMAs "
                  f"{f['floor_no_fma_ms']:.5f} ms){detail}", flush=True)
    return fields


def cuda_kernel_name(kind, variant):
    """The name of the CUDA kernel (``__global__`` function) of a 2D
    search, as the profiler reports it: its source's stem + ``_kernel``."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    mod = gk if kind == "segment" else ak
    source = getattr(mod, {"brute": "SOURCE", "culled": "SOURCE_CULLED",
                           "twolevel": "SOURCE_TWOLEVEL"}[variant])
    return source.removesuffix(".cu") + "_kernel"


def gate_box_pairs(kind, args, u):
    """The ray-surface pairs a per-ray gate admits on these inputs
    (``admitted_pairs``, ``u`` the final hits) on two kinds of chunk box:
    ``margin``, the exact boxes with the rounding margin alone (K7's, K8's
    and K10's boxes before they had to hold every accepted point), and
    ``gate``, the boxes K7-K10 gate on (``segment_kernels.twolevel_boxes``
    at size_eps EPS, ``arc_kernels.twolevel_boxes``)."""
    from tensorflowraytrace_tpu_torch.models.acceleration import (
        chunk_aabbs_2d, chunk_aabbs_arcs,
    )
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    p0, p1, *surfaces = args
    if kind == "segment":
        exact = chunk_aabbs_2d(*surfaces, gk.CULL_CHUNK)
        gate = gk.twolevel_boxes(*surfaces, EPS)
    else:
        exact = chunk_aabbs_arcs(*surfaces, gk.CULL_CHUNK)
        gate = ak.twolevel_boxes(*surfaces)
    m = surfaces[0].shape[0]
    return {name: admitted_pairs(p0, p1, boxes, m, u, gk.CULL_CHUNK)
            for name, boxes in (("margin", tk.widen_boxes(exact, 0.0)),
                                ("gate", gate))}


def prepare_split(kind, args):
    """K9's or K10's input preparation in its three parts, the chunk-major
    table, the boxes and the candidate lists: ``{part: (ms by CUDA events,
    ms of host time to enqueue it)}``, each the mean of 10 calls after
    one."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    p0, p1, *surfaces = args
    if kind == "segment":
        table = lambda: gk.segment_chunk_table(*surfaces, gk.CULL_CHUNK)
        boxes = lambda: gk.twolevel_boxes(*surfaces, EPS).contiguous()
    else:
        table = lambda: ak.twolevel_table(*surfaces)
        boxes = lambda: ak.twolevel_boxes(*surfaces).contiguous()
    made = boxes()
    parts = {"table": table, "boxes": boxes,
             "lists": lambda: gk.twolevel_lists(p0, p1, made, EPS)}
    split = {}
    for name, fn in parts.items():
        events = cuda_ms(fn, 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        host = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        split[name] = (events, host)
    return split


def first_bounce_2d(rays, seg):
    """The 2D guide's rays at its first bounce in the Morton order the
    re-sort gives them over the segments' box: ``(p0, p1)``."""
    import torch

    from tensorflowraytrace_tpu_torch.models.acceleration import (
        morton_codes_device,
    )

    lo = torch.minimum(seg.p0.amin(dim=0), seg.p1.amin(dim=0))
    hi = torch.maximum(seg.p0.amax(dim=0), seg.p1.amax(dim=0))
    order = torch.argsort(morton_codes_device(rays.p0, lo, hi), stable=True)
    return rays.p0[order], rays.p1[order]


def arcs_alone(device):
    """``--arcs-alone``: K6 and K8 launched alone at the 2D guide's first
    bounce, apart from their table and boxes, each checked against the
    plain K6 bit for bit, by CUDA events (mean of 20 launches) and by
    device time.  It calls ``arc_kernels``' ``arc_table``,
    ``culled_prepare`` and ``_launch`` and the libraries' C entry points:
    K8's takes a ray block (``segment_kernels.CULLED_RAY_BLOCK``) where its
    declared signature has one (the earlier, warp-voting K8 has none), so
    copied into the root of an earlier checkout, the script times that
    checkout's kernels, on that checkout's boxes, the same way."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rays, scene, _ = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    p0, p1 = first_bounce_2d(rays, scene.segments)
    arcs = (scene.arcs.center, scene.arcs.angle_start, scene.arcs.angle_end,
            scene.arcs.radius)
    table = ak.arc_table(*arcs)
    boxes = ak.culled_prepare(*arcs)[1]
    n, m = p0.shape[0], table.shape[0]
    eps = (float(EPS), float(EPS))
    slack = (1.0 + ak._SLACK, 1.0 - ak._SLACK, ak._SLACK)
    k8 = ak.load_culled_library().arc_search_culled_launch
    block = (gk.CULLED_RAY_BLOCK,) if len(k8.argtypes) == 17 else ()
    launches = {
        "K6": lambda: ak._launch(
            ak.load_library().arc_search_launch, "arc_search", p0,
            (p0.data_ptr(), p1.data_ptr(), table.data_ptr(), n, m, *eps)),
        "K8": lambda: ak._launch(
            k8, "arc_search_culled", p0,
            (p0.data_ptr(), p1.data_ptr(), table.data_ptr(), boxes.data_ptr(),
             n, m, gk.CULL_CHUNK, *block, *eps, *slack)),
    }
    ref = ak.nearest_hit_arcs_plain(p0, p1, *arcs, EPS, EPS)
    kernels = {"K6": "arc_search_kernel", "K8": "arc_search_culled_kernel"}
    for key, launch in launches.items():
        check(all(torch.equal(a, b) for a, b in zip(launch(), ref)),
              f"{key} launched alone differs from the plain K6")
        dev = kernel_device_ms(launch, kernels[key])
        dev_ms = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"arcs alone {key} at the 2D guide's first bounce {n}x{m}: "
              f"kernel {cuda_ms(launch, 20):.4f} ms by CUDA events, device "
              f"time {dev_ms}"
              + (f"; ray block {block[0] if block else 256}"
                 if key == "K8" else ""), flush=True)


def alone_2d(kind, args, m):
    """Each 2D kernel of ``kind`` as ``{variant: (prepare, launch)}``: its
    inputs' preparation and its launch on them, the wrapper's two halves
    (K5's wrapper prepares nothing)."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    p0, p1, *surfaces = args
    if kind == "segment":
        eps = (EPS, EPS, EPS)
        return {
            "brute": (lambda: None, lambda _: gk.nearest_hit_segments_kernel(
                *args, *eps)),
            "culled": (lambda: gk.culled_prepare(*surfaces, EPS),
                       lambda prep: gk.culled_launch(p0, p1, prep, *eps)),
            "twolevel": (lambda: gk.twolevel_prepare(*args, EPS, EPS),
                         lambda prep: gk.twolevel_launch(p0, p1, m, prep,
                                                         *eps)),
        }
    return {
        "brute": (lambda: ak.prepare(*surfaces),
                  lambda prep: ak.launch(p0, p1, prep, EPS, EPS)),
        "culled": (lambda: ak.culled_prepare(*surfaces),
                   lambda prep: ak.culled_launch(p0, p1, prep, EPS, EPS)),
        "twolevel": (lambda: ak.twolevel_prepare(*args, EPS),
                     lambda prep: ak.twolevel_launch(p0, p1, m, prep, EPS,
                                                     EPS)),
    }


def arc_work(p0, p1, boxes, arc, u):
    """The ray-arc pairs K8 and K10 must compute on these inputs
    (``admitted_pairs`` at 256-arc chunks, ``boxes`` their boxes) and how
    many of them pass the exact reject (``arc_kernels.admitted_arc_pairs``)."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    chunk = gk.CULL_CHUNK
    o = [a[:, None] for a in p0.unbind(1)]
    inv = [a[:, None] for a in tk._inverse_direction(p1 - p0).unbind(1)]
    admitted = past = 0
    for c in range(boxes.shape[0]):
        box = boxes[c:c + 1].T
        rows = tk._slab_gate(o, inv, box[:2], box[2:], EPS,
                             u[:, None])[:, 0].nonzero()[:, 0]
        arcs = slice(c * chunk, (c + 1) * chunk)
        centre = arc.center[arcs]
        admitted += rows.numel() * centre.shape[0]
        past += ak.admitted_arc_pairs(p0[rows], p1[rows], centre,
                                      arc.radius[arcs], EPS)
    return admitted, past


def phase_14(device):
    """The 2D guide as a design problem under TraceConfig.recommended: one
    forward and backward pass with and without remat, then an early-exit
    trace.  Returns the search kernels' launches in the passes."""
    import dataclasses

    import torch

    from tensorflowraytrace_tpu_torch import TraceConfig, scenes2d, trace
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    bounces = scenes2d.GUIDE_BOUNCES
    loss, params, scene = scenes2d.guide_design(GUIDE2D_RAYS, device=device)
    cfg = TraceConfig.recommended(scene, max_bounces=bounces,
                                  dead_ray_length=scenes2d.DEAD_RAY_LENGTH)
    print(f"phase 14 recommended: {cfg}", flush=True)
    check(cfg.use_kernel and cfg.remat, f"recommended chose {cfg}")
    on_path = kernels_2d(cfg)

    def forward_backward(c):
        value = loss(params, c)
        return value.detach(), torch.autograd.grad(value, params)

    launched, result = {}, {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        forward_backward(c)  # warm-up
        reset_2d_launches()
        sk.LAUNCHES = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        result[remat] = forward_backward(c)
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
        counts = launches_2d()
        want = {k: bounces if k in on_path else 0 for k in counts}
        check(counts == want, f"phase 14 remat={remat}: search launches "
              f"{counts}, not {want}")
        for k in on_path:
            launched[k] = launched.get(k, 0) + counts[k]
        k2 = sk.LAUNCHES
        times = []
        for _ in range(DESIGN_PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward_backward(c)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        value, grads = result[remat]
        print(f"phase 14 remat={remat}: forward + backward median "
              f"{statistics.median(times) * 1e3:.3f} ms over {DESIGN_PASSES} "
              f"{[round(t * 1e3, 3) for t in times]}; peak device memory "
              f"{peak_gib:.3f} GiB; loss {float(value)!r}; max |g| centre "
              f"{float(grads[0].abs().max())!r} radius "
              f"{float(grads[1].abs().max())!r}; search launches "
              f"{ {k: counts[k] for k in on_path} }, K2 {k2}", flush=True)
    gmax = max(float(g.abs().max()) for g in result[False][1])
    gdiff = max(float((a - b).abs().max())
                for a, b in zip(result[True][1], result[False][1]))
    # the recomputed forward and K2 repeat their bits
    check(gmax > 0 and grads_same_bits(result[True][1], result[False][1]),
          f"remat gradient differs by {gdiff} (max {gmax})")
    print(f"phase 14 gradient: with and without remat bit for bit (max "
          f"|g_remat - g| = {gdiff!r}), max |g| = {gmax!r}; loss remat "
          f"{float(result[True][0])!r}, without {float(result[False][0])!r}",
          flush=True)

    rays, scene, materials = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    with torch.no_grad():
        full = trace(rays, scene, materials, cfg)
        early_cfg = dataclasses.replace(cfg, early_exit=True)
        early = trace(rays, scene, materials, early_cfg)
        syncs = count_syncs(lambda: trace(rays, scene, materials, early_cfg))
    same = {f: torch.equal(getattr(early.rays, f), getattr(full.rays, f))
            for f in ("state", "p0", "p1")}
    print(f"phase 14 early_exit: {early.n_bounces} bounces of {bounces}; "
          f"states[active,finished,stopped,dead]="
          f"{state_counts(early.rays.state)}; bitwise equal to the "
          f"{bounces}-bounce trace {same}; {syncs} synchronising calls",
          flush=True)
    check(all(same.values()), f"early exit differs from the full trace {same}")
    return launched


def tune_culled_2d(device):
    """``--tune``: K7 and K8 at 128, 256, 512 and 1024 rays a block
    (``segment_kernels.CULLED_RAY_BLOCK``, which both read): alone at the
    2D guide's first bounce (checked against K5 and K6 bit for bit; K8 by
    CUDA events and by device time), then the 2D guide (50 bounces) with
    ``cull=True`` with and without the re-sort: median of 3 traces after
    one, each checked against the brute trace bit for bit, the brute
    trace's median beside them."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d, trace
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rays, scene, materials = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    cfgs = guide2d_configs(scene)
    ref = trace(rays, scene, materials, cfgs["brute"]).rays
    p0, p1 = first_bounce_2d(rays, scene.segments)
    args = surface_args(p0, p1, scene.segments)
    k5 = gk.nearest_hit_segments_kernel(*args, EPS, EPS, EPS)
    prepared = gk.culled_prepare(*args[2:], EPS)
    arcs = surface_args(p0, p1, scene.arcs)[2:]
    k6 = ak.nearest_hit_arcs_kernel(p0, p1, *arcs, EPS, EPS)
    arc_prepared = ak.culled_prepare(*arcs)
    for rb in (128, 256, 512, 1024):
        with override(gk, CULLED_RAY_BLOCK=rb):
            got = gk.culled_launch(p0, p1, prepared, EPS, EPS, EPS)
            check(all(torch.equal(a, b) for a, b in zip(got, k5)),
                  f"tune K7 alone {rb} differs from K5")
            ms = cuda_ms(lambda: gk.culled_launch(p0, p1, prepared, EPS, EPS,
                                                  EPS), 10)

            def k8():
                return ak.culled_launch(p0, p1, arc_prepared, EPS, EPS)

            check(all(torch.equal(a, b) for a, b in zip(k8(), k6)),
                  f"tune K8 alone {rb} differs from K6")
            k8_ms = cuda_ms(k8, 10)
            k8_dev = kernel_device_ms(k8, "arc_search_culled_kernel")
            out = {}
            for name in ("brute", "cull", "cull+resort"):
                times = []
                for rep in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = trace(rays, scene, materials, cfgs[name])
                    torch.cuda.synchronize()
                    if rep == 0:
                        check(torch.equal(res.rays.state, ref.state)
                              and torch.equal(res.rays.p1, ref.p1),
                              f"tune 2D {name} K7 block {rb} differs from "
                              "brute")
                    else:
                        times.append(time.perf_counter() - t0)
                out[name] = statistics.median(times)
        k8_dev = "not measured" if k8_dev is None else f"{k8_dev:.4f} ms"
        print(f"tune K7 and K8 ray_block={rb}: alone at the 2D guide's first "
              f"bounce K7 {ms:.4f} ms, K8 {k8_ms:.4f} ms by CUDA events "
              f"(device time {k8_dev}); 2D guide " + ", ".join(
                  f"{k} {t * 1e3:.3f} ms" for k, t in out.items()),
              flush=True)


def tune_twolevel_2d(device):
    """``--tune``: K9 alone at the 2D guide's first bounce at every ray
    block (checked against K5 bit for bit); then K9's and K10's ray block
    (cap 32), then their cap at the best block, on the 2D guide (50
    bounces) with ``cull="grid"`` with and without the re-sort: median of 3
    traces after one, each checked against the brute trace bit for bit; the
    brute trace's median, taken in the same process, is the yardstick."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes2d, trace
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk

    rays, scene, materials = scenes2d.light_guide(GUIDE2D_RAYS, device=device)
    cfgs = guide2d_configs(scene)
    ref = trace(rays, scene, materials, cfgs["brute"]).rays

    # K9 alone at the first bounce at each block (the kernel takes up to
    # 1024 rays a block; the wrapper refuses more than K10's 512)
    p0, p1 = first_bounce_2d(rays, scene.segments)
    args = surface_args(p0, p1, scene.segments)
    m = scene.segments.n_surfaces
    k5 = gk.nearest_hit_segments_kernel(*args, EPS, EPS, EPS)
    block = gk.TWOLEVEL_RAY_BLOCK
    try:
        for rb in (128, 256, 512, 1024):
            gk.TWOLEVEL_RAY_BLOCK = rb
            prepared = gk.twolevel_prepare(*args, EPS, EPS)
            got = gk.twolevel_launch(p0, p1, m, prepared, EPS, EPS, EPS)
            check(all(torch.equal(a, b) for a, b in zip(got, k5)),
                  f"tune K9 alone {rb} differs from K5")
            ms = cuda_ms(lambda: gk.twolevel_launch(p0, p1, m, prepared, EPS,
                                                    EPS, EPS), 10)
            print(f"tune K9 alone at the 2D guide's first bounce: "
                  f"ray_block={rb} cap={prepared[4]}: kernel {ms:.4f} ms, "
                  f"mean candidates {float(prepared[2].float().mean()):.2f}",
                  flush=True)
            del prepared, got
    finally:
        gk.TWOLEVEL_RAY_BLOCK = block
    del args, k5

    def run(rb, cap):
        gk.TWOLEVEL_RAY_BLOCK, gk.TWOLEVEL_MAX_CAND = rb, cap
        out = {}
        for name in ("brute", "grid", "grid+resort"):
            times = []
            for rep in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = trace(rays, scene, materials, cfgs[name])
                torch.cuda.synchronize()
                if rep == 0:
                    check(torch.equal(res.rays.state, ref.state)
                          and torch.equal(res.rays.p1, ref.p1),
                          f"tune 2D {name} {rb}/{cap} differs from brute")
                else:
                    times.append(time.perf_counter() - t0)
            out[name] = statistics.median(times)
        print(f"tune 2D ray_block={rb} chunk={gk.CULL_CHUNK} max_cand={cap}: "
              + ", ".join(f"{k} {t * 1e3:.3f} ms" for k, t in out.items()),
              flush=True)
        return out

    blocks = {rb: run(rb, 32) for rb in (64, 128, 256, 512)}
    rb = min(blocks, key=lambda key: min(blocks[key].values()))
    for cap in (2, 4, 8, 16):
        run(rb, cap)


def logged(fn, log):
    """``fn``, keeping each call's arguments and result in ``log``."""
    def call(*args):
        out = fn(*args)
        log.append((args, out))
        return out
    return call


def calls_equal(label, got, ref):
    """Two logs of a search wrapper (the kernel's, and its plain version's
    through the same trace): each call's inputs (rays, surfaces and
    epsilons) and its outputs (valid, idx, u and, for arcs, the branch),
    bit for bit.  Returns the number of calls."""
    import torch

    check(len(got) == len(ref) > 0,
          f"{label}: {len(got)} kernel calls against {len(ref)} plain calls")
    for k, ((g_args, g_out), (r_args, r_out)) in enumerate(zip(got, ref)):
        check(len(g_args) == len(r_args) and all(
            torch.equal(a, b) if torch.is_tensor(a) else a == b
            for a, b in zip(g_args, r_args)),
              f"{label}: call {k} searched other rays or surfaces")
        diffs = [int((a != b).sum()) for a, b in zip(g_out, r_out)]
        check(not any(diffs), f"{label}: call {k}: the outputs differ from "
              f"the plain version's in {diffs} rays")
    return len(got)


def phase_15(device):
    """The 3D point-source trace and the hexalens design at the examples'
    sizes, through K1 (and K2 in training) as the entry points choose them
    on the card.  Returns the main path's launches."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorflowraytrace_tpu_torch import (
        FINISHED, analysis, hexalens, landing_histogram_fold, scenes3d, trace,
    )
    from tensorflowraytrace_tpu_torch.models import mesh as mt
    from tensorflowraytrace_tpu_torch.ops import cuda_build
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
    from tensorflowraytrace_tpu_torch.optim import Optimizer
    from tensorflowraytrace_tpu_torch.utils.checkpoint import export_boundary_stl

    f32 = torch.float32
    t_phase = time.perf_counter()

    # ---- 1. trace_3d: the main path, then K1 and its plain version
    tk.LAUNCHES = 0
    res = scenes3d.trace_3d(device=device)
    torch.cuda.synchronize()
    trace3d_launches = tk.LAUNCHES
    check(trace3d_launches == TRACE3D_BOUNCES,
          f"trace_3d launched K1 {trace3d_launches} times")
    rays, scene, cfg = scenes3d.point_source_scene(device=device)
    check(cfg.use_kernel and cfg.keep_history
          and cfg.max_bounces == TRACE3D_BOUNCES, f"trace_3d config {cfg}")
    trace_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace(rays, scene, scenes3d.MATERIALS, cfg)
        torch.cuda.synchronize()
        trace_s.append(time.perf_counter() - t0)
    log_k, log_p = [], []
    with override(tk, nearest_hit_triangles_kernel=logged(
            tk.nearest_hit_triangles_kernel, log_k)):
        res_k = trace(rays, scene, scenes3d.MATERIALS, cfg)
    with override(tk, nearest_hit_triangles_kernel=logged(
            tk.nearest_hit_triangles_plain, log_p)):
        res_p = trace(rays, scene, scenes3d.MATERIALS, cfg)
    calls = calls_equal("phase 15 trace_3d", log_k, log_p)
    for name in ("history_p0", "history_p1", "history_state"):
        check(torch.equal(getattr(res_k, name), getattr(res_p, name)),
              f"trace_3d {name}: K1 and its plain version differ")
    check(torch.equal(res_k.rays.state, res_p.rays.state)
          and torch.equal(res_k.rays.p1, res_p.rays.p1)
          and torch.equal(res.rays.state, res_k.rays.state),
          "trace_3d final rays: K1 and its plain version differ")
    res_c = trace(rays, scene, scenes3d.MATERIALS,
                  dataclasses.replace(cfg, use_kernel=False))
    finished = {k: int((r.rays.state == FINISHED).sum())
                for k, r in (("K1", res_k), ("plain", res_p), ("cramer", res_c))}
    check(len(set(finished.values())) == 1,
          f"trace_3d finished counts differ: {finished}")
    print(f"phase 15 trace_3d: {rays.n_rays} rays x "
          f"{scene.triangles.n_surfaces} triangles, {TRACE3D_BOUNCES} bounces, "
          f"float32, ray_start_epsilon {cfg.ray_start_epsilon!r}: K1 "
          f"launched {trace3d_launches} times; {calls} calls bit for bit with "
          f"the plain version (states, history, final rays equal); finished "
          f"{finished}; median {statistics.median(trace_s) * 1e3:.3f} ms a "
          f"trace over 5 {[round(t * 1e3, 3) for t in trace_s]}", flush=True)
    del res, res_k, res_p, res_c, log_k, log_p

    # ---- 2. hexalens: K1 and K2 against the plain path, identical rays
    lens, source, loss = hexalens.problem(HEX_RAYS, HEX_MESH_STEP, f32, device)
    check(loss.cfg.use_kernel, "hexalens.problem did not choose the kernels")
    _, _, loss_p = hexalens.problem(HEX_RAYS, HEX_MESH_STEP, f32, device,
                                    use_kernel=False)
    rays = source.sample(torch.Generator(device).manual_seed(123), f32, device)

    def value_and_grad(fn, params):
        leaves = [p.detach().clone().requires_grad_(True) for p in params]
        value = fn(leaves, rays)
        return value.detach(), torch.autograd.grad(value, leaves)

    log_k, log_p = [], []
    tk.LAUNCHES = sk.LAUNCHES = 0
    with override(tk, nearest_hit_triangles_kernel=logged(
            tk.nearest_hit_triangles_kernel, log_k)):
        v_k, g_k = value_and_grad(loss, lens.init_params())
    step_launches = {"K1": tk.LAUNCHES, "K2": sk.LAUNCHES}
    check(step_launches == {"K1": HEX_BOUNCES, "K2": HEX_BOUNCES},
          f"hexalens forward + backward launched {step_launches}")
    with override(tk, nearest_hit_triangles_kernel=logged(
            tk.nearest_hit_triangles_plain, log_p)):
        loss(lens.init_params(), rays)
    calls = calls_equal("phase 15 hexalens", log_k, log_p)
    v_p, g_p = value_and_grad(loss_p, lens.init_params())
    rel = abs(float(v_k) - float(v_p)) / abs(float(v_p))
    gmax = max(float(g.abs().max()) for g in g_p)
    gdiff = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p))
    check(rel <= 1e-4, f"hexalens loss {float(v_k)} vs plain {float(v_p)}")
    check(gmax > 0 and gdiff <= 1e-4 * gmax,
          f"hexalens gradient differs from the plain path's by {gdiff} "
          f"(max {gmax})")
    n_faces = [s.faces.shape[0] for s in lens.surfaces]
    print(f"phase 15 hexalens: {HEX_RAYS} rays, mesh edge {HEX_MESH_STEP} "
          f"({lens.surfaces[0].n_params} vertices, {n_faces} faces), "
          f"{HEX_BOUNCES} bounces, float32, ray_start_epsilon "
          f"{loss.cfg.ray_start_epsilon!r}; one forward + backward launches "
          f"{step_launches}; {calls} K1 calls bit for bit with the plain "
          f"version; loss {float(v_k)!r} against the plain path's (Cramer "
          f"search, plain K2) {float(v_p)!r}, rel {rel:.3e}; max "
          f"|g_kernel - g_plain| {gdiff!r} of max |g_plain| {gmax!r}, ratio "
          f"{gdiff / gmax:.3e}", flush=True)
    del log_k, log_p

    # ---- 3. hexalens.train at the example's defaults: the main path
    tk.LAUNCHES = sk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errors, trained = hexalens.train(steps=HEX_STEPS, ray_count=HEX_RAYS,
                                     mesh_step=HEX_MESH_STEP, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    hex_launches = {"K1": tk.LAUNCHES, "K2": sk.LAUNCHES}
    for name, count in hex_launches.items():
        check(count == HEX_BOUNCES * HEX_STEPS,
              f"hexalens training launched {name} {count} times, not "
              f"{HEX_BOUNCES} a step")
    check(len(errors) == HEX_STEPS and np.all(np.isfinite(errors)),
          "hexalens errors are not finite")
    check(all(bool(torch.isfinite(p).all()) for p in trained),
          "hexalens parameters are not finite")
    first, last = float(np.mean(errors[:10])), float(np.mean(errors[-10:]))
    check(last < first, f"hexalens error did not fall: {first} -> {last}")
    fixed = source.sample(torch.Generator(device).manual_seed(99), f32, device)
    with torch.no_grad():
        e0, e1 = float(loss(lens.init_params(), fixed)), float(loss(trained,
                                                                    fixed))
    check(e1 < e0, f"hexalens error on fixed rays did not fall: {e0} -> {e1}")

    # one step, profiled: the idle share (the step of train(), built alike)
    _, _, accumulator = hexalens.lens_tools(HEX_MESH_STEP)
    opt = Optimizer(lambda params, gen: loss(params, source.sample(
        gen, f32, device)), trained, learning_rate=1.0, grad_clip=1e-3,
        generator=torch.Generator(device).manual_seed(0))
    accs = [torch.as_tensor(accumulator, dtype=f32, device=device)] * 2

    def step():
        return opt.run_phase(1, accs, lr_scale=1e-5, momentum=0.5)

    step()
    step_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    step_us = statistics.median(step_s) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    by_name, union_us, n_device = device_profile(prof)
    if union_us > 0:
        busy_us = sum(by_name.values())
        idle = (f"device busy {union_us:.1f} us of {prof_wall_us:.1f} us wall "
                f"(idle share {1 - union_us / prof_wall_us:.4f}; of the "
                f"untraced median step {step_us:.1f} us, "
                f"{1 - union_us / step_us:.4f}); {n_device} "
                f"kernels and copies; K1 "
                f"{sum(t for n, t in by_name.items() if 'triangle_search' in n):.1f}"
                f" us, K2 "
                f"{sum(t for n, t in by_name.items() if 'segment_sum' in n):.1f}"
                f" us of {busy_us:.1f} us")
    else:
        idle = "the profiler recorded no device time: idle share not measured"
    syncs = count_syncs(step)
    sample_syncs = count_syncs(lambda: source.sample(opt.generator, f32,
                                                     device))
    print(f"phase 15 hexalens train: {HEX_STEPS} steps of {HEX_RAYS} rays in "
          f"{train_s:.3f} s = {train_s / HEX_STEPS * 1e3:.3f} ms/step (set-up "
          f"included); launches {hex_launches} = "
          f"{hex_launches['K1'] / HEX_STEPS:g} K1 and "
          f"{hex_launches['K2'] / HEX_STEPS:g} K2 a step; error first "
          f"{errors[0]!r} last {errors[-1]!r}, mean first 10 {first!r} last 10 "
          f"{last!r}; on fixed rays {e0!r} -> {e1!r}; one step alone: "
          f"median {step_us / 1e3:.3f} ms over 5 "
          f"{[round(t * 1e3, 3) for t in step_s]}; one profiled step: "
          f"{idle}; {syncs} synchronising calls a step, {sample_syncs} of them "
          f"in the ray sampling", flush=True)

    # ---- 4. STL export, the image and the landing fold
    p_front, p_back = lens.constrain(trained)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    worst = 0.0
    for k, (surface, params) in enumerate(zip(lens.surfaces,
                                              (p_front, p_back))):
        path = export_boundary_stl(surface, params, str(
            cuda_build.BUILD_DIR / f"hexalens_{k}.stl"))
        back, mesh = mt.load_stl(path), surface.updated_mesh(params)
        check(back.n_faces == mesh.n_faces,
              f"STL {path}: {back.n_faces} faces, not {mesh.n_faces}")
        err = float(np.abs(back.points[back.faces]
                           - mesh.points[mesh.faces]).max())
        scale = max(1.0, float(np.abs(mesh.points).max()))
        check(err <= 2.5e-7 * scale,
              f"STL {path}: corners off updated_mesh by {err}")
        worst = max(worst, err)
    image_gen = torch.Generator(device).manual_seed(7)

    def landings(**trace_kw):
        batch = source.sample(image_gen, f32, device)
        with torch.no_grad():
            res = loss.trace(trained, batch, **trace_kw)
        fin = res.rays.state == FINISHED
        return res, res.rays.p1[fin][:, 1:]

    h, _, _, _ = analysis.imaging_test(lambda: landings()[1],
                                       hexalens.IMAGE_RANGE,
                                       batch_count=HEX_IMAGE_BATCHES,
                                       bins=HEX_IMAGE_BINS, verbose=False)
    check(h.shape == (HEX_IMAGE_BINS, HEX_IMAGE_BINS) and h.sum() > 0,
          f"imaging_test image {h.shape}, {h.sum()} rays")
    init, fold = landing_histogram_fold(hexalens.IMAGE_RANGE, 96, 64,
                                        axes=(1, 2), device=device)
    res, yz = landings(fold_fn=fold, fold_init=init)
    ref = analysis.histogram2d(yz[:, 0], yz[:, 1], hexalens.IMAGE_RANGE, 96, 64)
    check(torch.equal(res.fold, ref),
          f"the landing fold differs from histogram2d in "
          f"{int((res.fold != ref).sum())} bins")
    print(f"phase 15 STL and images: both surfaces exported and read back "
          f"(max corner error {worst!r}); imaging_test {HEX_IMAGE_BATCHES} "
          f"batches into {HEX_IMAGE_BINS}x{HEX_IMAGE_BINS} bins: {h.sum():g} "
          f"rays, {int((h > 0).sum())} bins lit; landing fold 96x64 equals "
          f"histogram2d of {yz.shape[0]} finished rays exactly; phase 15 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"K1": hex_launches["K1"], "K2": hex_launches["K2"],
            "K1_trace_3d": trace3d_launches}


def phase_16(device):
    """Streaming and data parallelism at the JAX examples' sizes: the
    streamed guide trace, the streamed guide training, the sharded guide
    training on a one-rank NCCL group and the two-rank gloo dryrun on the
    one card.  Returns the main paths' launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorflowraytrace_tpu_torch import (
        concat_rays, path_length_fold, streamed, streamed_value_and_grad,
        trace,
    )
    from tensorflowraytrace_tpu_torch.parallel import sharding as par
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    f32 = torch.float32
    t_phase = time.perf_counter()

    def peak_above(base):
        return (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30

    def start_peak():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        return torch.cuda.memory_allocated(device)

    # ---- 16a. the streamed trace (examples/streamed_trace.py)
    stream = streamed.GuideTrace(STREAM_BLOCK, STREAM_BOUNCES, device=device)
    cfg = stream.cfg
    m = stream.scene.triangles.n_surfaces
    check(m == 16386 and cfg.use_kernel and cfg.cull is True
          and cfg.resort_rays and cfg.max_bounces == STREAM_BOUNCES,
          f"streamed trace: {m} triangles, config {cfg}")
    # one block's trace alone: the warm-up, and the peak to hold the
    # stream's against (above what was allocated before, rays included)
    base = start_peak()
    init, fn = stream.fold
    with torch.no_grad():
        res = trace(stream.block(0), stream.scene, streamed.MATERIALS, cfg,
                    fold_fn=fn, fold_init=init)
    block_fold = float(res.fold)
    block_gib = peak_above(base)
    del res
    rows, stream_launches, stream_gib = [], {}, {}
    total = STREAM_RAYS // STREAM_BLOCK
    for nb in sorted({total >> k for k in range(STREAM_SIZES)}):
        tk.LAUNCHES = tk.LAUNCHES_CULLED = tk.LAUNCHES_TWOLEVEL = 0
        base = start_peak()
        row = stream.timed(nb)
        stream_gib[nb] = peak_above(base)
        stream_launches[nb] = {"K1": tk.LAUNCHES, "K3": tk.LAUNCHES_CULLED,
                               "K4": tk.LAUNCHES_TWOLEVEL}
        check(stream_launches[nb] == {"K1": 0, "K3": STREAM_BOUNCES * nb,
                                      "K4": 0},
              f"a stream of {nb} blocks launched {stream_launches[nb]}")
        rows.append(row)
        print(f"phase 16a stream {row['n_rays']} rays ({nb} blocks of "
              f"{STREAM_BLOCK}): {row['seconds']:.3f} s = "
              f"{row['rays_per_s']:.4e} rays/s = {row['equiv_per_s']:.4e} "
              f"equivalent intersections/s (x {m} triangles x "
              f"{STREAM_BOUNCES} bounces); states[active,finished,stopped,"
              f"dead] {row['state_counts']}; fold {row['fold']!r}; K3 "
              f"launched {stream_launches[nb]['K3']} times; peak "
              f"{stream_gib[nb]:.3f} GiB above the start", flush=True)
    streamed.check_linear(rows)
    full = rows[-1]
    check(full["n_rays"] == STREAM_RAYS and sum(full["state_counts"])
          == STREAM_RAYS, f"the full stream counted {full['state_counts']}")
    check(stream_gib[total] <= STREAM_PEAK_RATIO * block_gib,
          f"the {STREAM_RAYS}-ray stream peaked at {stream_gib[total]:.3f} "
          f"GiB, one block's trace at {block_gib:.3f} GiB")
    print(f"phase 16a memory: one {STREAM_BLOCK}-ray block's trace peaks "
          f"{block_gib:.3f} GiB above the start (fold {block_fold!r}); the "
          f"{STREAM_RAYS}-ray stream {stream_gib[total]:.3f} GiB = "
          f"{stream_gib[total] / block_gib:.4f} of it (limit "
          f"{STREAM_PEAK_RATIO}); linear scaling holds (time x 1.8 + 1 s a "
          f"doubling)", flush=True)
    # one block's trace profiled: where the stream's time goes
    profile_guide3d(f"one {STREAM_BLOCK}-ray block", "triangle_search_culled",
                    stream.block(0), stream.scene, streamed.MATERIALS, cfg,
                    device, phase="phase 16a")
    del stream

    # exactness at a size one trace holds: 2 blocks of 2^20 against one
    # trace of the same 2^21 rays
    small = streamed.GuideTrace(STREAM_EXACT_BLOCK, STREAM_BOUNCES,
                                device=device)
    per_ray = path_length_fold(STREAM_EXACT_BLOCK, f32, device)
    res_c = small(2, fold=per_ray, merge="concat")
    res_s = small(2)
    rays = concat_rays([small.block(0), small.block(1)])
    init_p, fn_p = path_length_fold(2 * STREAM_EXACT_BLOCK, f32, device)
    init_s, fn_s = small.fold
    with torch.no_grad():
        one = trace(rays, small.scene, streamed.MATERIALS, small.cfg,
                    fold_fn=lambda acc, rec: (fn_p(acc[0], rec),
                                              fn_s(acc[1], rec)),
                    fold_init=(init_p, init_s))
    one_counts = state_counts(one.rays.state)
    check(torch.equal(res_c.fold, one.fold[0]),
          f"the 2-block stream's path lengths differ from one trace's in "
          f"{int((res_c.fold != one.fold[0]).sum())} rays")
    check(res_c.state_counts.tolist() == one_counts
          == res_s.state_counts.tolist(),
          f"state counts: stream {res_c.state_counts.tolist()}, one trace "
          f"{one_counts}")
    sum_rel = abs(float(res_s.fold) - float(one.fold[1])) / abs(
        float(one.fold[1]))
    check(sum_rel <= 1e-5, f"the 2-block stream's landing sum "
          f"{float(res_s.fold)} against one trace's {float(one.fold[1])}")
    print(f"phase 16a exactness: 2 blocks of {STREAM_EXACT_BLOCK} rays "
          f"against one trace of {2 * STREAM_EXACT_BLOCK}: per-ray path "
          f"lengths equal bit for bit, states {one_counts} equal, landing "
          f"sum {float(res_s.fold)!r} against {float(one.fold[1])!r} (rel "
          f"{sum_rel:.3e})", flush=True)
    del small, res_c, res_s, rays, one

    # ---- 16b. the streamed training (examples/streamed_training.py)
    n_blocks = TRAIN_STREAM_RAYS // TRAIN_STREAM_BLOCK
    tk.LAUNCHES = tk.LAUNCHES_CULLED = sk.LAUNCHES = 0
    base = start_peak()
    losses, params, seconds = streamed.train_guide(
        TRAIN_STREAM_RAYS, TRAIN_STREAM_BLOCK, TRAIN_STREAM_STEPS,
        TRAIN_STREAM_BOUNCES, device=device, verbose=False)
    torch.cuda.synchronize()
    train_gib = peak_above(base)
    train_launches = {"K1": tk.LAUNCHES, "K2": sk.LAUNCHES,
                      "K3": tk.LAUNCHES_CULLED}
    blocks_run = n_blocks * TRAIN_STREAM_STEPS
    check(train_launches["K1"] == TRAIN_STREAM_BOUNCES * blocks_run
          and train_launches["K2"] > 0 and train_launches["K3"] == 0,
          f"the streamed training launched {train_launches}, not K1 "
          f"{TRAIN_STREAM_BOUNCES} a block")
    # the first step descends; the example's own test, the last step below
    # the first, is printed (its momentum steps rebound after two)
    check(losses[1] < losses[0], f"streamed training loss {losses}")
    check(bool(torch.isfinite(params).all()), "trained guide not finite")
    # the streamed gradient against autograd of the fused sum, 2 blocks
    guide, block_loss = streamed.guide_block_loss(
        STREAM_EXACT_BLOCK, TRAIN_STREAM_BOUNCES, device=device)
    check(block_loss.cfg.use_kernel and block_loss.cfg.remat
          and not block_loss.cfg.cull, f"training config {block_loss.cfg}")
    p0 = [guide.init_params()]
    seed = streamed.fold_in(7, 0)
    leaf = p0[0].clone().requires_grad_(True)
    fused = block_loss([leaf], 0, seed) + block_loss([leaf], 1, seed)
    g_fused = torch.autograd.grad(fused, leaf)[0]
    gmax = float(g_fused.abs().max())
    v, g = streamed_value_and_grad(block_loss, 2)(p0, seed)
    gdiff = float((g[0] - g_fused).abs().max())
    # the blocks' sums in the fused sum's order, and K2 in a fixed order
    check(same_bits(torch.as_tensor(v).reshape(()), fused.detach())
          and gmax > 0 and same_bits(g[0], g_fused),
          f"streamed_value_and_grad: value {float(v)!r} against "
          f"{float(fused)!r}, gradient off by {gdiff} of {gmax}")
    one_block = streamed_value_and_grad(block_loss, 1)
    one_block(p0, seed)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_block(p0, seed)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    by_name, union_us, n_device = device_profile(prof)
    if union_us > 0:
        busy_us = sum(by_name.values())
        k1_us = sum(t for n, t in by_name.items() if "triangle_search" in n)
        k2_us = sum(t for n, t in by_name.items() if "segment_sum" in n)
        block_split = (
            f"device busy {union_us:.1f} us of {prof_wall_us:.1f} us wall "
            f"(idle share {1 - union_us / prof_wall_us:.4f}); {n_device} "
            f"kernels and copies, {busy_us:.1f} us: K1 {k1_us:.1f} us "
            f"({k1_us / busy_us:.4%}), K2 {k2_us:.1f} us "
            f"({k2_us / busy_us:.4%}); top: "
            + "; ".join(f"{k[:50]} {t:.1f} us"
                        for k, t in by_name.most_common(5)))
    else:
        block_split = ("the profiler recorded no device time: split not "
                       "measured")
    print(f"phase 16b streamed training: {TRAIN_STREAM_STEPS} steps of "
          f"{n_blocks} blocks x {TRAIN_STREAM_BLOCK} rays, "
          f"{TRAIN_STREAM_BOUNCES} bounces, 242 triangles: losses "
          f"{losses} (the last below the first: {losses[-1] < losses[0]}); "
          f"{statistics.median(seconds) * 1e3:.3f} ms a step "
          f"(median of {[round(t * 1e3, 3) for t in seconds]}); peak "
          f"{train_gib:.3f} GiB above the start; launches {train_launches} "
          f"= {train_launches['K1'] / blocks_run:g} K1 and "
          f"{train_launches['K2'] / blocks_run:g} K2 a block; at 2 blocks of "
          f"{STREAM_EXACT_BLOCK} against autograd of the fused sum: value "
          f"and gradient bit for bit (max |g| {gmax!r}); one "
          f"{STREAM_EXACT_BLOCK}-ray "
          f"block's forward and backward profiled: {block_split}",
          flush=True)
    del guide, block_loss, leaf, fused, g_fused

    # ---- 16c. data parallelism: a one-rank NCCL group on the card
    kw = dict(rays=SHARDED_RAYS, bounces=SHARDED_BOUNCES, verbose=False)
    par.init_multihost(
        "nccl", init_method=f"tcp://localhost:{streamed.free_port()}",
        world_size=1, rank=0)
    try:
        mesh = par.ray_mesh(device=device)
        backend = torch.distributed.get_backend()
        tk.LAUNCHES = sk.LAUNCHES = 0
        errors_m, params_m, sec_m = streamed.sharded_guide(
            steps=SHARDED_STEPS, mesh=mesh, **kw)
        torch.cuda.synchronize()
        sharded_launches = {"K1": tk.LAUNCHES, "K2": sk.LAUNCHES}
        _, step_m, _ = streamed.sharded_guide(steps=1, mesh=mesh, **kw)
    finally:
        torch.distributed.destroy_process_group()
    # the single process twice: K2 adds in a fixed order, so the runs repeat
    # every step's loss and the final parameters bit for bit, and the
    # one-rank group's all-reduce is a copy, so it runs the same arithmetic
    errors_s, params_s, sec_s = streamed.sharded_guide(steps=SHARDED_STEPS,
                                                       device=device, **kw)
    errors_s2, params_s2, _ = streamed.sharded_guide(steps=SHARDED_STEPS,
                                                     device=device, **kw)
    _, step_s, _ = streamed.sharded_guide(steps=1, device=device, **kw)
    p_init = streamed.short_guide(12, 10, f32, device)[0].init_params()
    update = float((step_s[0] - p_init).abs().max())
    step_diff = float((step_m[0] - step_s[0]).abs().max())
    check(backend == "nccl", f"the one-rank group ran over {backend}")
    check(sharded_launches == {"K1": SHARDED_BOUNCES * SHARDED_STEPS,
                               "K2": SHARDED_BOUNCES * SHARDED_STEPS},
          f"the sharded training launched {sharded_launches}")
    repeats = (same_bits(torch.as_tensor(errors_s2), torch.as_tensor(errors_s))
               and grads_same_bits(params_s2, params_s))
    check(repeats, f"the single process's two runs: losses "
          f"{list(errors_s)} and {list(errors_s2)}, the final parameters "
          f"apart by {float((params_s2[0] - params_s[0]).abs().max())!r}")
    check(same_bits(torch.as_tensor(errors_m), torch.as_tensor(errors_s))
          and grads_same_bits(params_m, params_s)
          and grads_same_bits(step_m, step_s),
          f"NCCL one-rank against the single process: losses "
          f"{list(errors_m)} and {list(errors_s)}, one step's parameters "
          f"apart by {step_diff} of an update of {update}")
    check(update > 0, "one sharded step left the parameters as they were")
    check(min(errors_m[1:]) < errors_m[0], f"sharded loss {list(errors_m)}")
    print(f"phase 16c sharded training on a one-rank {backend} group: "
          f"{SHARDED_STEPS} steps of {SHARDED_RAYS} rays, {SHARDED_BOUNCES} "
          f"bounces: losses {[float(e) for e in errors_m]}; the single "
          f"process's two runs and the one-rank group equal bit for bit at "
          f"every step's loss and in the final parameters, and in one "
          f"step's parameters (an update of {update!r}); "
          f"{sec_m / SHARDED_STEPS * 1e3:.3f} ms a step (single process "
          f"{sec_s / SHARDED_STEPS * 1e3:.3f}); launches {sharded_launches}",
          flush=True)

    # the two-rank dryrun over gloo, both ranks on this card
    torch.cuda.empty_cache()
    out = streamed.dryrun(world=2, backend="gloo", device="cuda",
                          size="card", timeout=600)
    for r in out["ranks"]:
        check(r["launches"]["K1"] > 0 and r["launches"]["K2"] > 0
              and r["launches"]["K3"] > 0,
              f"dryrun rank {r['rank']} launched {r['launches']}")
    print(f"phase 16c dryrun: 2 gloo ranks on {out['ranks'][0]['device']}, "
          f"size 'card' ({streamed.DRYRUN_SIZES['card']}): the ranks' "
          f"trace slots equal the one-process control's bit for bit (state, "
          f"p1, path hashes); depth {out['ranks'][0]['trace']['n_bounces']}; "
          f"relative errors {out['errors']}; rank seconds "
          f"{[round(r['seconds'], 3) for r in out['ranks']]}, launches "
          f"{[r['launches'] for r in out['ranks']]}; ranks done in "
          f"{out['ranks_seconds']:.1f} s, with the control "
          f"{out['seconds']:.1f} s; phase 16 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"K3_stream": stream_launches[total]["K3"],
            "K1_train": train_launches["K1"], "K2_train": train_launches["K2"],
            "K1_sharded": sharded_launches["K1"],
            "K2_sharded": sharded_launches["K2"]}


def phase_17(device):
    """The reactions at the JAX examples' sizes: the pool caustic at 2^26
    rays, the example's 2^27 cut (17a), the stray-light barrel (17b) and
    the ghost tree of a coated singlet (17c), each also held against its
    searches' plain versions.
    Returns the main paths' launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tensorflowraytrace_tpu_torch import concat_rays, operations, trace
    from tensorflowraytrace_tpu_torch import scenes2d, scenes3d
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
    from tensorflowraytrace_tpu_torch.streamed import fold_in

    t_phase = time.perf_counter()

    def peak_above(base):
        return (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30

    def start_peak():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        return torch.cuda.memory_allocated(device)

    def k134():
        return {"K1": tk.LAUNCHES, "K3": tk.LAUNCHES_CULLED,
                "K4": tk.LAUNCHES_TWOLEVEL}

    def reset_3d():
        tk.LAUNCHES = tk.LAUNCHES_CULLED = tk.LAUNCHES_TWOLEVEL = 0

    # ---- 17a. the caustic (examples/caustic_render.py)
    render = scenes3d.CausticRender(CAUSTIC_BLOCK, CAUSTIC_RES,
                                    CAUSTIC_MESH_STEPS, device=device)
    cfg = render.cfg
    m = render.scene.triangles.n_surfaces
    check(m == CAUSTIC_TRIANGLES and cfg.use_kernel and cfg.cull is True
          and cfg.resort_rays and cfg.max_bounces == CAUSTIC_BOUNCES,
          f"caustic: {m} triangles, config {cfg}")
    init, fn = render.fold
    # one block's trace alone: the warm-up, and the peak to hold the
    # stream's against
    base = start_peak()
    with torch.no_grad():
        res = trace(render.block(0), render.scene, scenes3d.CAUSTIC_MATERIALS,
                    cfg, reaction=render.reaction, fold_fn=fn,
                    fold_init=init, fold_fields=True)
    torch.cuda.synchronize()
    block_gib = peak_above(base)
    del res
    n_blocks = CAUSTIC_RAYS // CAUSTIC_BLOCK
    reset_3d()
    sk.LAUNCHES = 0
    base = start_peak()
    out = scenes3d.caustic_render(CAUSTIC_RAYS, CAUSTIC_BLOCK, CAUSTIC_RES,
                                  CAUSTIC_MESH_STEPS, device=device,
                                  verbose=False)
    stream_gib = peak_above(base)
    # the image's fold bins each bounce's landings through K2
    stream_launches = {**k134(), "K2": sk.LAUNCHES}
    check(stream_launches == {"K1": 0, "K3": CAUSTIC_BOUNCES * n_blocks,
                              "K4": 0, "K2": CAUSTIC_BOUNCES * n_blocks},
          f"the caustic stream launched {stream_launches}")
    img = out["image"]
    check(img.shape == (CAUSTIC_RES, CAUSTIC_RES)
          and bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0,
          "the caustic image is not finite and non-negative")
    check(sum(out["state_counts"]) == CAUSTIC_RAYS,
          f"the caustic counted {out['state_counts']}")
    print(f"phase 17a caustic: {CAUSTIC_RAYS} rays ({n_blocks} blocks of "
          f"{CAUSTIC_BLOCK}) through {m} triangles, {CAUSTIC_BOUNCES} "
          f"bounces, into {CAUSTIC_RES}x{CAUSTIC_RES}: {out['seconds']:.3f} s "
          f"= {out['rays_per_s']:.4e} rays/s = {out['equiv_per_s']:.4e} "
          f"equivalent intersections/s; states[active,finished,stopped,dead] "
          f"{out['state_counts']}; landed power {float(img.sum())!r}; mean "
          f"transmission {out['mean_transmission']!r} (1 - (1/7)^2 = "
          f"{scenes3d.T_NORMAL!r}, limit 0.02); launches {stream_launches}; "
          f"peak {stream_gib:.3f} GiB above the start, one block's trace "
          f"{block_gib:.3f} GiB ({stream_gib / block_gib:.4f} of it); "
          f"config {cfg}", flush=True)

    # one block profiled: the search, the re-sort, the reaction, the fold
    reaction, (init, fold) = render.reaction, render.fold

    def timed_reaction(proj, rays, c):
        with record_function("caustic_reaction"):
            return reaction(proj, rays, c)

    def timed_fold(acc, record):
        with record_function("caustic_fold"):
            return fold(acc, record)

    blk = render.block(1)
    with torch.no_grad():
        trace(blk, render.scene, scenes3d.CAUSTIC_MATERIALS, cfg,
              reaction=timed_reaction, fold_fn=timed_fold, fold_init=init,
              fold_fields=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trace(blk, render.scene, scenes3d.CAUSTIC_MATERIALS, cfg,
                  reaction=timed_reaction, fold_fn=timed_fold,
                  fold_init=init, fold_fields=True)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    by_name, union_us, n_device = device_profile(prof)
    busy_us = sum(by_name.values())
    if busy_us > 0:
        k3_us = sum(t for k, t in by_name.items()
                    if "triangle_search_culled" in k)
        parts = {name: range_device_us(prof, name) for name in (
            "resort_rays", "caustic_reaction", "caustic_fold")}
        rest_us = busy_us - k3_us - sum(parts.values())
        block_split = (
            f"device busy {union_us:.1f} us of {wall_us:.1f} us wall (idle "
            f"share {1 - union_us / wall_us:.4f}); {n_device} kernels and "
            f"copies, {busy_us:.1f} us: K3 {k3_us:.1f} us "
            f"({k3_us / busy_us:.4%}), "
            + ", ".join(f"{k} {v:.1f} us ({v / busy_us:.4%})"
                        for k, v in parts.items())
            + f", rest {rest_us:.1f} us ({rest_us / busy_us:.4%}); top: "
            + "; ".join(f"{k[:50]} {t:.1f} us"
                        for k, t in by_name.most_common(6)))
    else:
        block_split = ("the profiler recorded no device time: split not "
                       "measured")
    print(f"phase 17a one {CAUSTIC_BLOCK}-ray block profiled: {block_split}",
          flush=True)
    del render, out, img

    # exactness: 2 blocks against one trace of the same rays, the image in
    # float64 (an exact sum of the float32 weights, whatever the order)
    exact = scenes3d.CausticRender(CAUSTIC_BLOCK, CAUSTIC_RES,
                                   CAUSTIC_MESH_STEPS, device=device,
                                   image_dtype=torch.float64)
    two = exact(2)
    rays = concat_rays([exact.block(0), exact.block(1)])
    init, fn = exact.fold
    with torch.no_grad():
        one = trace(rays, exact.scene, scenes3d.CAUSTIC_MATERIALS, exact.cfg,
                    reaction=exact.reaction, fold_fn=fn, fold_init=init,
                    fold_fields=True)
    one_counts = state_counts(one.rays.state)
    check(torch.equal(two.fold, one.fold),
          f"the 2-block caustic's image differs from one trace's in "
          f"{int((two.fold != one.fold).sum())} bins")
    check(two.state_counts.tolist() == one_counts,
          f"state counts: stream {two.state_counts.tolist()}, one trace "
          f"{one_counts}")
    print(f"phase 17a exactness: 2 blocks of {CAUSTIC_BLOCK} rays against "
          f"one trace of {2 * CAUSTIC_BLOCK}: the float64 images equal bit "
          f"for bit (landed power {float(one.fold.sum())!r}), states "
          f"{one_counts} equal", flush=True)
    del two, rays, one

    # K3 against its plain version at the path's shapes: block 0 through
    # the recommended trace with K3's wrapper logged, then with its plain
    # version logged in its place; every call and the final rays and image
    # bit for bit
    blk = exact.block(0)
    traced, logs, k3_ms = {}, {}, {}
    for label, search in (("K3", tk.nearest_hit_triangles_culled_kernel),
                          ("plain", tk.nearest_hit_triangles_culled_plain)):
        logs[label] = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), override(
                tk, nearest_hit_triangles_culled_kernel=logged(
                    search, logs[label])):
            traced[label] = trace(blk, exact.scene,
                                  scenes3d.CAUSTIC_MATERIALS, exact.cfg,
                                  reaction=exact.reaction, fold_fn=fn,
                                  fold_init=init, fold_fields=True)
        torch.cuda.synchronize()
        k3_ms[label] = (time.perf_counter() - t0) * 1e3
    calls = calls_equal("phase 17a K3", logs["K3"], logs["plain"])
    rk, rp = traced["K3"], traced["plain"]
    same = {f: torch.equal(getattr(rk.rays, f), getattr(rp.rays, f))
            for f in ("state", "p0", "p1")}
    same["intensity"] = torch.equal(rk.rays.fields["intensity"],
                                    rp.rays.fields["intensity"])
    same["image"] = torch.equal(rk.fold, rp.fold)
    check(all(same.values()), f"caustic block 0: the K3 trace differs from "
          f"the plain version's: {same}")
    print(f"phase 17a K3 against its plain version: block 0 ({CAUSTIC_BLOCK} "
          f"rays x {m} triangles, {-(-m // tk.CULL_CHUNK)} chunks): "
          f"{calls} calls bit for bit, the final states, "
          f"endpoints, intensities and image equal; trace with K3 "
          f"{k3_ms['K3']:.3f} ms, with the plain version "
          f"{k3_ms['plain']:.3f} ms", flush=True)
    del traced, logs, rk, rp

    # K3 alone at block 0's first bounce (the rays in the re-sort's order)
    # and its admitted-work bound there: the pairs of the chunks its slab
    # test admits up to each ray's final hit, those refused on tu at their
    # cost so far
    t0 = time.perf_counter()
    args = first_bounce_3d(blk, exact.scene.triangles)
    hit = {}
    k3_alone_ms = cuda_ms(lambda: hit.update(k3=(
        tk.nearest_hit_triangles_culled_kernel(*args, EPS, EPS, EPS))), 5)
    k3_pairs, tu_out = triangle_pairs(*args, hit["k3"][2], tk.CULL_CHUNK)
    k3_bound_ms = ((k3_pairs - tu_out) * K1_FLOPS_PER_PAIR
                   + tu_out * TU_FLOPS_PER_PAIR) / PEAK_FP32_FLOP_S * 1e3
    n_pairs = args[0].shape[0] * m
    print(f"phase 17a K3 alone at block 0's first bounce ({CAUSTIC_BLOCK} "
          f"rays x {m} triangles): kernel {k3_alone_ms:.4f} ms; admitted "
          f"pairs {k3_pairs} at {tk.CULL_CHUNK}-triangle chunks "
          f"({k3_pairs / n_pairs:.4%} of brute; "
          f"{tu_out / max(k3_pairs, 1):.4%} "
          f"of them out on tu), bound {k3_bound_ms:.4f} ms (operations; "
          f"without FMAs {2 * k3_bound_ms:.4f} ms; counted in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    del args, hit

    # one block through brute (K1), cull=True with and without the re-sort
    # (K3) and "grid" + re-sort (K4): hits and states bit for bit, each
    # timed
    paths = {"brute": dataclasses.replace(exact.cfg, cull=False,
                                          resort_rays=False),
             "cull+resort": exact.cfg,
             "cull": dataclasses.replace(exact.cfg, resort_rays=False),
             "grid+resort": dataclasses.replace(exact.cfg, cull="grid",
                                                resort_rays=True)}
    kernel_of = {"brute": "K1", "cull+resort": "K3", "cull": "K3",
                 "grid+resort": "K4"}
    finals, path_ms, path_launches = {}, {}, {}
    for name, pcfg in paths.items():
        with torch.no_grad():
            trace(blk, exact.scene, scenes3d.CAUSTIC_MATERIALS, pcfg,
                  reaction=exact.reaction, fold_fn=fn, fold_init=init,
                  fold_fields=True)
            reset_3d()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = trace(blk, exact.scene, scenes3d.CAUSTIC_MATERIALS, pcfg,
                      reaction=exact.reaction, fold_fn=fn, fold_init=init,
                      fold_fields=True)
            torch.cuda.synchronize()
        path_ms[name] = (time.perf_counter() - t0) * 1e3
        path_launches[name] = k134()
        want = {k: CAUSTIC_BOUNCES if k == kernel_of[name] else 0
                for k in ("K1", "K3", "K4")}
        check(path_launches[name] == want,
              f"caustic {name}: launches {path_launches[name]}, not {want}")
        finals[name] = r
    ref = finals["brute"]
    pairs = CAUSTIC_BLOCK * m * CAUSTIC_BOUNCES
    for name, r in finals.items():
        same = {f: torch.equal(getattr(r.rays, f), getattr(ref.rays, f))
                for f in ("state", "p0", "p1")}
        same["intensity"] = torch.equal(r.rays.fields["intensity"],
                                        ref.rays.fields["intensity"])
        same["image"] = torch.equal(r.fold, ref.fold)
        check(all(same.values()), f"caustic {name} differs from brute: "
              f"{same}")
    print(f"phase 17a one {CAUSTIC_BLOCK}-ray block x {m} triangles x "
          f"{CAUSTIC_BOUNCES} bounces: "
          + "; ".join(f"{k} {v:.3f} ms ({pairs / v * 1e3:.4e} equivalent "
                      f"intersections/s, launches {path_launches[k]})"
                      for k, v in path_ms.items())
          + "; every path's states, endpoints, intensities and image equal "
          "the brute path's bit for bit", flush=True)
    del exact, finals, ref, blk

    def run_2d(example, plain):
        """``example()`` with K5's and K6's wrappers logged call by call,
        or their plain versions logged in their place; returns its result,
        the logs and its seconds."""
        logs = {"K5": [], "K6": []}
        seg = gk.nearest_hit_segments_plain if plain else \
            gk.nearest_hit_segments_kernel
        arc = ak.nearest_hit_arcs_plain if plain else ak.nearest_hit_arcs_kernel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with override(gk, nearest_hit_segments_kernel=logged(
                seg, logs["K5"])), override(
                ak, nearest_hit_arcs_kernel=logged(arc, logs["K6"])):
            out = example()
        torch.cuda.synchronize()
        return out, logs, time.perf_counter() - t0

    def plain_agreement(label, logs, logs_p):
        return {k: calls_equal(f"phase {label} {k}", logs[k], logs_p[k])
                for k in logs}

    # ---- 17b. stray light (examples/stray_light.py) on K5 and K6
    def stray_run():
        return scenes2d.stray_light(STRAY_RAYS, device=device, verbose=False)

    reset_2d_launches()
    stray, logs, stray_s = run_2d(stray_run, plain=False)
    stray_launches = launches_2d()
    traces = (len(scenes2d.STRAY_SIGMAS) * len(scenes2d.STRAY_ABSORPTIVITIES)
              * scenes2d.STRAY_KEYS)
    want = {k: scenes2d.STRAY_BOUNCES * traces if k in ("K5", "K6") else 0
            for k in stray_launches}
    check(stray_launches == want,
          f"stray light launched {stray_launches}, not {want}")
    # the same example with the plain searches: every call bit for bit
    stray_p, logs_p, stray_plain_s = run_2d(stray_run, plain=True)
    stray_calls = plain_agreement("17b", logs, logs_p)
    check(stray_p == stray, f"stray light: the plain searches give {stray_p}"
          f", the kernels {stray}")
    del logs, logs_p
    # the stream: the same bits on the card as on the CPU
    ctr = torch.arange(STREAM_DRAWS, dtype=torch.int32) % 7
    key = fold_in(scenes2d.STRAY_SEED, 0)
    mix_cpu = operations.ray_mix(ctr)
    mix_card = operations.ray_mix(ctr.to(device))
    check(torch.equal(mix_card.cpu(), mix_cpu), "ray_mix differs on the card")
    for dtype in (torch.float32, torch.float64):
        u_card = operations.ray_uniform(key, mix_card, dtype).cpu()
        u_cpu = operations.ray_uniform(key, mix_cpu, dtype)
        check(torch.equal(u_card, u_cpu),
              f"ray_uniform ({dtype}) differs on the card in "
              f"{int((u_card != u_cpu).sum())} of {STREAM_DRAWS} draws")
    g_card = operations.ray_normal(key, mix_card, 3, torch.float32).cpu()
    g_cpu = operations.ray_normal(key, mix_cpu, 3, torch.float32)
    a, b = g_card.numpy(), g_cpu.numpy()
    ulps = np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))
    worst = float(ulps.max())
    check(bool(np.isfinite(a).all()) and worst <= NORMAL_ULPS,
          f"ray_normal differs by {worst} float32 ulps on the card")
    print(f"phase 17b stray light: {STRAY_RAYS} rays, {traces} traces of "
          f"{scenes2d.STRAY_BOUNCES} bounces in {stray_s:.3f} s; ghost power "
          f"a launched ray {{(sigma, absorptivity): mean of "
          f"{scenes2d.STRAY_KEYS} keys}} "
          + ", ".join(f"{k}: {v!r}" for k, v in stray.items())
          + f"; the example's assertions hold; launches {stray_launches}; "
          f"the stream over {STREAM_DRAWS} draws: uniforms (float32, float64) "
          f"equal the CPU's bit for bit, normals within {worst:g} float32 "
          f"ulps (limit {NORMAL_ULPS}; {int((ulps > 0).sum())} differ); "
          f"with the plain searches in {stray_plain_s:.3f} s, calls bit for "
          f"bit {stray_calls} and the same ghost powers", flush=True)

    # ---- 17c. the ghost tree (examples/ghost_analysis.py), float32
    def ghost_run():
        return scenes2d.ghost_analysis(GHOST_RAYS, GHOST_DEPTH,
                                       device=device, verbose=False)

    reset_2d_launches()
    (ghosts, names), logs, ghost_s = run_2d(ghost_run, plain=False)
    ghost_launches = launches_2d()
    want = {k: (GHOST_DEPTH + 1) * 2 * len(names) if k in ("K5", "K6")
            else 0 for k in ghost_launches}
    check(ghost_launches == want,
          f"the ghost analysis launched {ghost_launches}, not {want}")
    # the same example with the plain searches: every call, and every
    # schedule's landed power, height and branch counter, bit for bit
    (ghosts_p, _), logs_p, ghost_plain_s = run_2d(ghost_run, plain=True)
    ghost_calls = plain_agreement("17c", logs, logs_p)
    for label, r in ghosts.items():
        for f in ("power", "y", "ctr"):
            check(np.array_equal(r[f], ghosts_p[label][f]),
                  f"ghost analysis [{label}] {f}: the plain searches differ")
    del logs, logs_p, ghosts_p
    ghost_rtol = scenes2d.GHOST_RTOL[torch.float32]
    k = names.index("TRRT")
    bare, coated = ghosts["bare"], ghosts["AR-coated"]
    print(f"phase 17c ghost analysis: {GHOST_RAYS} rays, {len(names)} "
          f"schedules of depth {GHOST_DEPTH} x (bare, AR-coated), float32, in "
          f"{ghost_s:.3f} s; on-axis R bare {bare['R']!r}, coated "
          f"{coated['R']!r}; analytic checks' relative errors (limit "
          f"{ghost_rtol}) bare {bare['rel']}, coated {coated['rel']}; beam "
          f"TRRT power bare {float(bare['tot'][k])!r}, coated "
          f"{float(coated['tot'][k])!r}: cut "
          f"{float(bare['tot'][k] / coated['tot'][k]):.2f}x (more than 8x "
          f"required); launches {ghost_launches}; with the plain searches "
          f"in {ghost_plain_s:.3f} s, calls bit for bit {ghost_calls} and "
          f"every schedule's power, height and counter equal; phase 17 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"K2_caustic": stream_launches["K2"],
            "K3_caustic_ms": k3_alone_ms, "K3_caustic_bound_ms": k3_bound_ms,
            "K3_caustic_pairs": k3_pairs,
            "K1_caustic": path_launches["brute"]["K1"],
            "K3_caustic": stream_launches["K3"],
            "K4_caustic": path_launches["grid+resort"]["K4"],
            "K5_stray": stray_launches["K5"], "K6_stray": stray_launches["K6"],
            "K5_ghost": ghost_launches["K5"], "K6_ghost": ghost_launches["K6"]}


def cut_probe(label, step_ms, steps):
    """A design cut in steps: ``steps`` steps at the mean of ``step_ms``
    (its steps timed before the design runs) must fit
    ``CUT_BUDGET_S[label]``, or the phase fails."""
    budget = CUT_BUDGET_S[label]
    mean_s = statistics.fmean(step_ms) * 1e-3
    check(mean_s * steps <= budget, f"{label}: a step takes "
          f"{mean_s * 1e3:.3f} ms: {steps} steps would take more than "
          f"{budget:.0f} s")
    print(f"{label} cut: {steps} steps predicted {mean_s * steps:.1f} s "
          f"from {len(step_ms)} timed steps (budget {budget:.0f} s)",
          flush=True)


def event_step_ms(step, n):
    """``n`` calls of ``step`` after one, each followed by a CUDA event and
    none by a host synchronisation: the ms between consecutive events, the
    card's timeline a step (the host's issue time when it holds the card
    back)."""
    import torch

    step()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for e in events[1:]:
        step()
        e.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def profiled_steps(step, n, label, parts):
    """``n`` calls of ``step`` under torch.profiler: the idle share and the
    device-time shares of ``parts`` (name: substring of the kernel names)
    and of the rest, as one report string."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, union_us, n_device = device_profile(prof)
    busy_us = sum(by_name.values())
    if busy_us <= 0:
        return prof, busy_us, (f"{label}: the profiler recorded no device "
                               "time: shares not measured")
    shares = []
    for name, part in parts.items():
        t = sum(v for k, v in by_name.items() if part in k)
        shares.append(f"{name} {t:.1f} us = {t / busy_us:.2%}")
    rest = busy_us - sum(v for k, v in by_name.items()
                         if any(p in k for p in parts.values()))
    shares.append(f"the rest {rest:.1f} us = {rest / busy_us:.2%}")
    return prof, busy_us, (
        f"{label}: {n} steps, device busy {union_us:.1f} us of "
        f"{wall_us:.1f} us wall (idle share {1 - union_us / wall_us:.4f}); "
        f"{n_device} kernels and copies, {busy_us:.1f} us: "
        + ", ".join(shares))


def gradients(loss, params):
    """The value and gradients of ``loss`` at detached copies of
    ``params``."""
    import torch

    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    value = loss(leaves)
    return value.detach(), torch.autograd.grad(value, leaves)


# the search wrappers that a main path reaches through its module, by
# kernel: (module under ops, the wrappers' common stem)
SEARCH_WRAPPERS = {"K1": ("triangle_kernels", "nearest_hit_triangles"),
                   "K5": ("segment_kernels", "nearest_hit_segments"),
                   "K6": ("arc_kernels", "nearest_hit_arcs")}


def search_module(kernel):
    """The ops module of ``kernel`` (a key of SEARCH_WRAPPERS) and its
    wrappers' stem."""
    import importlib

    name, stem = SEARCH_WRAPPERS[kernel]
    return importlib.import_module(
        f"tensorflowraytrace_tpu_torch.ops.{name}"), stem


@contextlib.contextmanager
def logged_searches(logs, plain=False):
    """A context in which the search wrapper of each kernel in ``logs``
    (kernel: list) is logged call by call into its list, or its plain
    version is logged in its place and K2's plain version runs for K2
    where ``plain``."""
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    with contextlib.ExitStack() as stack:
        for kernel, log in logs.items():
            mod, stem = search_module(kernel)
            fn = getattr(mod, f"{stem}_plain" if plain else f"{stem}_kernel")
            stack.enter_context(override(
                mod, **{f"{stem}_kernel": logged(fn, log)}))
        if plain:
            stack.enter_context(override(
                sk, segment_sum_kernel=sk.segment_sum_plain))
        yield


def replayed_plain(label, kernel, log, stride=1):
    """Each logged call of ``kernel``'s wrapper replayed through its plain
    version on the same surfaces and epsilons and on every ``stride``-th
    ray of the same rays (a search answers each ray alone): the outputs
    bit for bit.  Returns the number of calls."""
    import torch

    mod, stem = search_module(kernel)
    plain = getattr(mod, f"{stem}_plain")
    check(len(log) > 0, f"{label}: no {kernel} call to replay")
    for k, (args, out) in enumerate(log):
        rays = [a[::stride].contiguous() for a in args[:2]]
        ref = plain(*rays, *args[2:])
        diffs = [int((a[::stride] != b).sum()) for a, b in zip(out, ref)]
        check(not any(diffs), f"{label}: {kernel} call {k}: the outputs "
              f"differ from the plain version's in {diffs} rays")
    torch.cuda.synchronize()
    return len(log)


def kernel_and_plain(label, loss, params, searches=("K5",)):
    """One forward + backward of ``loss`` at ``params`` with the kernels,
    then with their plain versions (the ``searches`` and K2): each search
    call bit for bit with the plain call, the loss equal, the gradients bit
    for bit.  Returns the number of search calls compared."""
    log_k = {k: [] for k in searches}
    log_p = {k: [] for k in searches}
    with logged_searches(log_k):
        v_k, g_k = gradients(loss, params)
    with logged_searches(log_p, plain=True):
        v_p, g_p = gradients(loss, params)
    calls = sum(calls_equal(f"{label} {k}", log_k[k], log_p[k])
                for k in searches)
    check(bool(v_k == v_p), f"{label}: loss {float(v_k)!r} with the kernels, "
          f"{float(v_p)!r} with the plain versions")
    gmax = max(float(g.abs().max()) for g in g_p)
    gdiff = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p))
    check(gmax > 0 and grads_same_bits(g_k, g_p),
          f"{label}: the gradient through K2 differs from the plain one by "
          f"{gdiff} (max {gmax})")
    return calls


def launches_of(run):
    """Zero K1's to K6's launch counts, call ``run``, and return its result
    and the counts just after it."""
    import torch

    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    mods = {k: search_module(k)[0] for k in SEARCH_WRAPPERS}
    mods["K2"] = sk
    for mod in mods.values():
        mod.LAUNCHES = 0
    tk.LAUNCHES_CULLED = tk.LAUNCHES_TWOLEVEL = 0
    out = run()
    torch.cuda.synchronize()
    counts = {k: mods[k].LAUNCHES for k in ("K1", "K2", "K5", "K6")}
    counts.update(K3=tk.LAUNCHES_CULLED, K4=tk.LAUNCHES_TWOLEVEL)
    return out, counts


def phase_18(device):
    """The asphere singlet, BASELINE config 2, the Strehl lens, the
    hexalens's image quality through STL and the remesh, at the examples'
    sizes, through the entry points that pick the kernels on the card.
    Returns the main paths' launches."""
    import numpy as np
    import torch

    from tensorflowraytrace_tpu_torch import FINISHED, hexalens, scenes2d
    from tensorflowraytrace_tpu_torch import scenes3d, trace
    from tensorflowraytrace_tpu_torch.models import boundaries as bd
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
    from tensorflowraytrace_tpu_torch.optim import Optimizer

    f32 = torch.float32
    t_phase = time.perf_counter()
    k5_name = cuda_kernel_name("segment", "brute")
    parts = {"K5": k5_name, "K2": "segment_sum"}
    out = {}

    # ---- 18a. the asphere singlet: a probe of its step, the main path (cut
    # in steps), then its steps
    spot_sq, start = scenes2d.asphere_problem(ASPHERE_RES, ASPHERE_RAYS, f32,
                                              device)
    check(spot_sq.cfg.use_kernel and not spot_sq.cfg.cull,
          f"asphere config {spot_sq.cfg}")
    opt = scenes2d.asphere_optimizer(spot_sq, start, scenes2d.ASPHERE_MASK,
                                     ASPHERE_CUT_STEPS, 6e-3)

    def step():
        opt.single_step(sync=False)

    steps = 2 * ASPHERE_CUT_STEPS
    step_ms = event_step_ms(step, ASPHERE_TIMED)
    cut_probe("asphere_singlet", step_ms, steps)
    gk.LAUNCHES = sk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = scenes2d.asphere_singlet(steps=ASPHERE_CUT_STEPS,
                                   resolution=ASPHERE_RES,
                                   n_rays=ASPHERE_RAYS, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["asphere"] = {"K5": gk.LAUNCHES, "K2": sk.LAUNCHES}
    _, per_step = launches_of(step)
    bounces = scenes2d.ASPHERE_BOUNCES
    # every step, and the three spot evaluations (start, sphere, asphere)
    check(per_step["K5"] == bounces and out["asphere"] == {
        "K5": bounces * (steps + 3), "K2": per_step["K2"] * steps},
          f"asphere launches {out['asphere']}, {per_step} a step")
    for label in ("sphere", "asphere"):
        check(bool(np.all(np.isfinite(res[f"errors_{label}"]))),
              f"asphere {label} errors are not finite")
    _, _, shares = profiled_steps(step, ASPHERE_PROFILED, "profiled", parts)
    print(f"phase 18a asphere singlet: {ASPHERE_RES} segments a surface, "
          f"{ASPHERE_RAYS} rays, {bounces} bounces, float32, two designs of "
          f"{ASPHERE_CUT_STEPS} steps (the example's {ASPHERE_STEPS} cut; "
          f"Adam, cosine LambdaLR, optax_tx) in "
          f"{wall:.3f} s (sphere {res['seconds_sphere']:.3f} s, asphere "
          f"{res['seconds_asphere']:.3f} s = "
          f"{res['seconds_asphere'] / ASPHERE_CUT_STEPS * 1e3:.3f} ms a "
          f"step); "
          f"launches {out['asphere']}, {per_step} a step; rms spot start "
          f"{res['rms_start']!r}, sphere {res['rms_sphere']!r}, asphere "
          f"{res['rms_asphere']!r}: asphere < sphere / 3 "
          f"({res['rms_sphere'] / res['rms_asphere']:.2f}x) and < start / 5 "
          f"({res['rms_start'] / res['rms_asphere']:.2f}x); front (c, k, a4) "
          f"{res['params_asphere'][:3].tolist()}, back "
          f"{res['params_asphere'][3:].tolist()}", flush=True)
    print(f"phase 18a asphere steps (before the design): median "
          f"{statistics.median(step_ms):.3f} ms a step by CUDA events over "
          f"{ASPHERE_TIMED} (min {min(step_ms):.3f}, max {max(step_ms):.3f}); "
          f"{shares}", flush=True)
    calls = 0
    for _ in range(PLAIN_STEPS):
        calls += kernel_and_plain(
            "phase 18a asphere", lambda p: spot_sq(p), opt.parameters)
        step()
    print(f"phase 18a against the plain versions: {PLAIN_STEPS} steps, "
          f"{calls} K5 calls bit for bit with the plain K5, the losses "
          f"equal, the gradients through K2 bit for bit", flush=True)
    del opt, res

    # ---- 18b. BASELINE config 2
    gk.LAUNCHES = sk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = scenes2d.multisegment_lens(steps=CONFIG2_STEPS, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["config2"] = {"K5": gk.LAUNCHES, "K2": sk.LAUNCHES}
    lens, rays, trace_fn, loss = scenes2d.multisegment_problem(f32, device)
    check(loss.cfg.use_kernel, f"config 2 config {loss.cfg}")
    opt = Optimizer(loss, lens.init_params(), learning_rate=1.0,
                    grad_clip=5e-3)

    def step():
        opt.single_step(None, lr_scale=2e-3, momentum=0.8, sync=False)

    _, per_step = launches_of(step)
    steps = CONFIG2_STEPS + 1
    bounces = scenes2d.CONFIG2_BOUNCES
    check(per_step["K5"] == bounces and out["config2"] == {
        "K5": bounces * (steps + 1), "K2": per_step["K2"] * steps},
          f"config 2 launches {out['config2']}, {per_step} a step")
    step_ms = event_step_ms(step, 20)
    calls = kernel_and_plain(
        "phase 18b config 2", lambda p: loss(p), lens.init_params())
    k = min(len(res["reds"]), len(res["blues"]))
    apart = float(np.abs(np.sort(res["reds"])[:k]
                         - np.sort(res["blues"])[:k]).max())
    print(f"phase 18b config 2: {rays.n_rays} rays (60 RAINBOW_6 + 8), "
          f"{lens.surfaces[0].n_params} base points a surface, {bounces} "
          f"bounces, float32, {steps} steps in {wall:.3f} s; median "
          f"{statistics.median(step_ms):.3f} ms a step by CUDA events over "
          f"20; launches {out['config2']}, {per_step} a step; error "
          f"{res['e0']!r} -> {float(res['errors'][-1])!r} "
          f"({res['errors'][-1] / res['e0']:.4f}, below 0.5); the 680 nm "
          f"and 400 nm landings (sorted) apart by up to {apart!r}; least "
          f"thickness "
          f"{res['thickness']!r} >= 0.15 - 1e-6; one step against the plain "
          f"versions: {calls} K5 calls bit for bit, the gradient through K2 "
          f"bit for bit", flush=True)
    del opt, res

    # ---- 18c. the Strehl lens: a probe of a first stage's step, the main
    # path (cut in steps), then the last stage's steps
    strehl, ys = scenes2d.strehl_problem(STREHL_SEGMENTS, STREHL_RAYS, f32,
                                         device)
    check(strehl.cfg.use_kernel, f"Strehl config {strehl.cfg}")
    lam, lr, _ = scenes2d.strehl_stages(STREHL_CUT_STEPS)[0]
    opt = scenes2d.strehl_optimizer(strehl, torch.as_tensor(
        scenes2d.strehl_sphere_x(ys), dtype=f32, device=device), lam, lr)
    cut_probe("strehl_lens", event_step_ms(
        lambda: opt.single_step(sync=False), 20), 3 * STREHL_CUT_STEPS)
    gk.LAUNCHES = sk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = scenes2d.strehl_lens(steps=STREHL_CUT_STEPS,
                               n_segments=STREHL_SEGMENTS,
                               n_rays=STREHL_RAYS, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["strehl"] = {"K5": gk.LAUNCHES, "K2": sk.LAUNCHES}
    lam, lr, _ = scenes2d.strehl_stages(STREHL_CUT_STEPS)[-1]
    opt = scenes2d.strehl_optimizer(strehl, res["xs"], lam, lr)

    def step():
        opt.single_step(sync=False)

    _, per_step = launches_of(step)
    steps = 3 * STREHL_CUT_STEPS
    bounces = scenes2d.STREHL_BOUNCES
    # every step, and the three Strehl evaluations (start, design, hyperbola)
    check(per_step["K5"] == bounces and out["strehl"] == {
        "K5": bounces * (steps + 3), "K2": per_step["K2"] * steps},
          f"Strehl launches {out['strehl']}, {per_step} a step")
    prof, busy_us, shares = profiled_steps(step, STREHL_PROFILED, "profiled",
                                           parts)
    psf_us = range_device_us(prof, "strehl_psf")
    psf = (f"the PSF's forward (range strehl_psf) {psf_us:.1f} us = "
           f"{psf_us / busy_us:.2%} of the device time" if busy_us > 0
           else "the PSF's share not measured")
    calls = 0
    for _ in range(PLAIN_STEPS):
        calls += kernel_and_plain(
            "phase 18c Strehl", lambda p: -strehl(p[0], lam), opt.parameters)
        step()
    print(f"phase 18c Strehl lens: {STREHL_SEGMENTS} segments, "
          f"{STREHL_RAYS} rays, {bounces} bounces, float32, 3 stages of "
          f"{STREHL_CUT_STEPS} Adam steps (the example's {STREHL_STEPS} "
          f"cut) in {wall:.3f} s ("
          + ", ".join(f"{t / STREHL_CUT_STEPS * 1e3:.3f}"
                      for t in res["stage_seconds"])
          + f" ms a step); launches {out['strehl']}, {per_step} a step; "
          f"Strehl at 550 nm: start {res['strehl_start']!r}, design "
          f"{res['strehl']!r}, discretised hyperbola "
          f"{res['strehl_hyperbola']!r} (design > 0.8 x hyperbola and > 0.5); "
          f"each stage's last {res['stages']}; {shares}; {psf}; against the "
          f"plain versions: {PLAIN_STEPS} steps, {calls} K5 calls bit for "
          f"bit with the plain K5, the losses equal, the gradients through "
          f"K2 bit for bit", flush=True)
    del opt, res, prof

    # ---- 18d. the hexalens's image quality through STL
    t0 = time.perf_counter()
    _, params = hexalens.train(device=device)
    first, second, built = scenes3d.hexalens_stls(params, device=device)
    diffs, worst = 0, 0.0
    for path, surf in zip((first, second), built):
        back = bd.manual_triangle_boundary(file_name=path, mat_in=1,
                                           mat_out=0, device=device)
        check(back.n_surfaces == surf.n_surfaces,
              f"{path}: {back.n_surfaces} faces, not {surf.n_surfaces}")
        for name in ("vp", "v1", "v2"):
            got = getattr(back, name).cpu().numpy()
            want = getattr(surf, name).detach().cpu().numpy()
            # the reader merges corners rounded to 7 decimals (the JAX
            # package's rule): face for face it gives exactly those values
            rounded = want.astype(np.float64).round(7).astype(np.float32)
            check(np.array_equal(got, rounded),
                  f"{path} {name}: not the 7-decimal rounding of the built "
                  "surface")
            diffs += int((got != want).sum())
            worst = max(worst, float(np.abs(got - want).max()))
    tk.LAUNCHES = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img = scenes3d.image_quality_3d(IMAGE_BATCHES, IMAGE_RAYS,
                                    first_stl=first, second_stl=second,
                                    device=device)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t1
    out["image_quality"] = tk.LAUNCHES
    cfg = img["cfg"]
    check(cfg.use_kernel and not cfg.cull, f"image-quality config {cfg}")
    check(out["image_quality"] == IMAGE_BATCHES * scenes3d.IMAGE_BOUNCES,
          f"image quality launched K1 {out['image_quality']} times")
    check(img["central"] > 0 and img["displaced"] > 0,
          f"image fluxes {img['central']}, {img['displaced']}")
    source = scenes3d.image_quality_source(IMAGE_RAYS)
    batch = source.sample(torch.Generator(device).manual_seed(8), f32, device)
    log_k, log_p = [], []
    with torch.no_grad():
        with override(tk, nearest_hit_triangles_kernel=logged(
                tk.nearest_hit_triangles_kernel, log_k)):
            r_k = trace(batch, img["scene"], scenes3d.MATERIALS, cfg)
        with override(tk, nearest_hit_triangles_kernel=logged(
                tk.nearest_hit_triangles_plain, log_p)):
            r_p = trace(batch, img["scene"], scenes3d.MATERIALS, cfg)
    calls = calls_equal("phase 18d image quality", log_k, log_p)
    check(torch.equal(r_k.rays.state, r_p.rays.state)
          and torch.equal(r_k.rays.p1, r_p.rays.p1),
          "image quality: K1 and its plain version land differently")
    print(f"phase 18d image quality: the hexalens trained and exported as "
          f"STL ({[s.n_surfaces for s in built]} faces), reloaded with "
          f"manual_triangle_boundary: face for face the 7-decimal rounding "
          f"of lens.build(params) exactly ({diffs} coordinates differ from "
          f"it, by at most {worst!r}); "
          f"{img['scene'].triangles.n_surfaces} triangles, "
          f"{IMAGE_BATCHES} batches of {IMAGE_RAYS} rays in {image_s:.3f} s "
          f"(training and export {t1 - t0:.3f} s); K1 launched "
          f"{out['image_quality']} times; landed {img['landed']} rays, "
          f"central image {img['central']:.4f}, displaced image "
          f"{img['displaced']:.4f} of the flux; one batch: {calls} K1 calls "
          f"bit for bit with the plain version, "
          f"{int((r_k.rays.state == FINISHED).sum())} finished", flush=True)

    # ---- 18e. the remesh
    rm = scenes3d.remesh(device=device)
    check(abs(rm["initial"].max() - 0.4) < 0.02
          and abs(rm["peak"] - rm["initial"].max()) < 1e-6,
          f"remesh peak {rm['initial'].max()}, built {rm['peak']}")
    print(f"phase 18e remesh: {rm['initial'].shape[0]} vertices, initial "
          f"peak {float(rm['initial'].max())!r} (within 0.02 of 0.4), built "
          f"on the "
          f"card {rm['peak']!r}; phase 18 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def close_to(label, got, want, rtol=0.0, atol=0.0):
    """``got`` (the card's float32) within ``atol + rtol |want|`` of
    ``want`` (the CPU's float64), elementwise; returns the largest
    difference."""
    import numpy as np

    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    diff = np.abs(got - want)
    check(bool(np.all(diff <= atol + rtol * np.abs(want))),
          f"{label}: {got.tolist()} against the CPU's float64 "
          f"{want.tolist()} (rtol {rtol}, atol {atol})")
    return float(diff.max())


def svm_first_bounce(rays, tri):
    """K1, K3 and K4 at the singlet's first bounce (the rays in the
    re-sort's Morton order): K3 and K4 against K1 and their plain versions,
    bit for bit.  These launches are comparisons, not the main path."""
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    args = first_bounce_3d(rays, tri)
    ref = tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
    report = []
    for name, fn, plain in (
            ("K3", tk.nearest_hit_triangles_culled_kernel,
             tk.nearest_hit_triangles_culled_plain),
            ("K4", tk.nearest_hit_triangles_twolevel_kernel,
             tk.nearest_hit_triangles_twolevel_plain)):
        report.append(culled_agreement(name, fn(*args, EPS, EPS, EPS),
                                       plain(*args, EPS, EPS, EPS), ref)[1])
    return int(ref[0].sum()), report


def phase_19(device):
    """The classical lens design: the sequential-against-mesh singlet on
    K4, K3 and K1, the Cooke triplet, the first-order analysis and the
    lens report, and the best-form singlet's damped least squares.
    Returns the main path's launches."""
    import numpy as np
    import torch

    from tensorflowraytrace_tpu_torch import FINISHED, TraceConfig, classical
    from tensorflowraytrace_tpu_torch import trace
    from tensorflowraytrace_tpu_torch.engine import CULL_3D_MIN_TRIANGLES
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    f32 = torch.float32
    t_phase = time.perf_counter()

    # ---- 19a. sequential against mesh
    scene = classical.svm_mesh_scene(device=device)
    m = scene.triangles.n_surfaces
    check(m == SVM_TRIANGLES, f"the singlet mesh has {m} triangles")
    cfg_grid = classical.svm_config(device)
    check(cfg_grid.use_kernel and cfg_grid.cull == "grid"
          and cfg_grid.resort_rays, f"the example's config {cfg_grid}")
    cfg_rec = TraceConfig.recommended(scene, max_bounces=classical.SVM_BOUNCES)
    check(m >= CULL_3D_MIN_TRIANGLES and cfg_rec.use_kernel
          and cfg_rec.cull is True and cfg_rec.resort_rays,
          f"recommended for the singlet mesh: {cfg_rec}")
    bounces = classical.SVM_BOUNCES

    def counts():
        return {"K1": tk.LAUNCHES, "K3": tk.LAUNCHES_CULLED,
                "K4": tk.LAUNCHES_TWOLEVEL}

    # the main path: the example's 512-ray check through K4 and through
    # recommended's K3, each kernel's calls logged, and one bounce through
    # brute K1
    launched, checks = {"K1": 0, "K3": 0, "K4": 0}, {}
    searches = {"K4": ("nearest_hit_triangles_twolevel_kernel",
                       tk.nearest_hit_triangles_twolevel_plain),
                "K3": ("nearest_hit_triangles_culled_kernel",
                       tk.nearest_hit_triangles_culled_plain)}
    logs = {"K4": [], "K3": []}
    for label, cfg, kernel in (("grid+resort", cfg_grid, "K4"),
                               ("recommended", cfg_rec, "K3")):
        tk.LAUNCHES = tk.LAUNCHES_CULLED = tk.LAUNCHES_TWOLEVEL = 0
        name = searches[kernel][0]
        with override(tk, **{name: logged(getattr(tk, name), logs[kernel])}):
            checks[label] = classical.svm_check(scene, cfg, device=device)
        torch.cuda.synchronize()
        got = counts()
        want = {k: bounces if k == kernel else 0 for k in got}
        check(got == want, f"19a {label} check: launches {got}, not {want}")
        launched[kernel] += got[kernel]
    p, d = classical.svm_bundle(SVM_RAYS, f32, device)
    rays = classical.svm_rays(p, d, f32)
    cfg_brute = TraceConfig(max_bounces=1, use_kernel=True,
                            ray_start_epsilon=cfg_rec.ray_start_epsilon)
    tk.LAUNCHES = tk.LAUNCHES_CULLED = tk.LAUNCHES_TWOLEVEL = 0
    with torch.no_grad():
        brute = trace(rays, scene, classical.SVM_MATERIALS, cfg_brute)
    torch.cuda.synchronize()
    check(counts() == {"K1": 1, "K3": 0, "K4": 0},
          f"19a one brute bounce: launches {counts()}")
    launched["K1"] += 1

    # every K4 and K3 call of the 512-ray checks against its plain version,
    # bit for bit
    n_logged = {}
    for kernel, (_, plain) in searches.items():
        for k, (args, out) in enumerate(logs[kernel]):
            diffs = [int((a != b).sum()) for a, b in zip(out, plain(*args))]
            check(not any(diffs), f"19a {kernel} call {k} of the check "
                  f"differs from the plain {kernel} in {diffs} rays")
        n_logged[kernel] = len(logs[kernel])
        check(n_logged[kernel] == bounces,
              f"19a {n_logged[kernel]} {kernel} calls logged in the check")
    del logs
    # the first bounce at 2^20 rays: K3 and K4 against K1 bit for bit
    hits, report = svm_first_bounce(rays, scene.triangles)
    brute_states = state_counts(brute.rays.state)
    del brute

    # timed through the example's own entry point: the analytic trace and
    # the two mesh paths at 2^20 rays
    configs = {"grid+resort": cfg_grid, "recommended": cfg_rec}
    kernel_of = {"grid+resort": "K4", "recommended": "K3"}
    tk.LAUNCHES = tk.LAUNCHES_CULLED = tk.LAUNCHES_TWOLEVEL = 0
    timed = classical.sequential_vs_mesh(SVM_RAYS, configs=configs,
                                         device=device)
    torch.cuda.synchronize()
    med = timed["seconds"]
    per_trace = {k: v / (classical.SVM_REPS + 1)
                 for k, v in counts().items()}
    check(per_trace == {"K1": 0, "K3": bounces, "K4": bounces},
          f"19a launches a trace of the mesh paths {per_trace}, not K4 "
          f"{bounces} under grid+resort and K3 {bounces} under recommended")
    runs = classical.svm_traces(SVM_RAYS, scene, configs, f32, device)
    with torch.no_grad():
        exact = runs["analytic"]()
        landed = {}
        for label in ("grid+resort", "recommended"):
            res = runs[label]()
            fin = res.rays.state == FINISHED
            landed[label] = (float(fin.double().mean()), float(
                (res.rays.p1[:, :2] - exact.p[:, :2]).abs()[fin].max()))
            del res
        shares = {}
        for label, parts in (("analytic", {}),
                             ("grid+resort", {"K4": "triangle_search_twolevel"}),
                             ("recommended", {"K3": "triangle_search_culled"})):
            _, _, shares[label] = profiled_steps(runs[label], 1, "one trace",
                                                 parts)
    for label in ("grid+resort", "recommended"):
        check(landed[label][0] > classical.SVM_FINISHED_MIN
              and landed[label][1] < classical.SVM_MAX_DEV,
              f"19a {label} at {SVM_RAYS} rays: finished "
              f"{landed[label][0]}, largest landing gap {landed[label][1]}")
    print(f"phase 19a sequential vs mesh: the singlet (c {classical.SVM_C}, "
          f"k {classical.SVM_K}, plane back at {classical.SVM_Z_BACK}, image "
          f"at {classical.SVM_Z_IMG}, glass 1.5) as a 2-surface stack and "
          f"as {m} triangles at edge {classical.SVM_EDGE}, float32, "
          f"{bounces} bounces; the 512-ray check (finished, largest landing "
          f"gap; more than 0.9 and below 0.02 required): "
          + "; ".join(f"{k} {v['finished']!r}, {v['max_dev']!r}"
                      for k, v in checks.items())
          + f"; main-path launches {launched} (K4 {bounces} in the grid "
          f"check, K3 {bounces} in the recommended one, K1 one brute bounce "
          f"of {SVM_RAYS} rays, states[active,finished,stopped,dead] after "
          f"it {brute_states}); "
          f"{n_logged['K4']} K4 and {n_logged['K3']} K3 calls of the checks "
          f"bit for bit with the plain K4 and K3; "
          f"the first bounce at {SVM_RAYS} x {m} ({hits} hits): "
          + "; ".join(report), flush=True)
    for label in runs:
        print(f"phase 19a {label} at {SVM_RAYS} rays: median "
              f"{med[label] * 1e3:.3f} ms over {classical.SVM_REPS} "
              f"synchronised runs = {SVM_RAYS / med[label]:.4e} rays/s"
              + (f"; {kernel_of[label]} launched {bounces} times a trace; "
                 f"finished {landed[label][0]!r}, largest landing gap to "
                 f"the analytic trace {landed[label][1]!r}"
                 if label in landed else "")
              + f"; {shares[label]}", flush=True)
    del rays, p, d, exact, runs, scene

    # ---- 19b. the Cooke triplet: one step measured, then the cut design
    _, probe, _ = classical.cooke_design(COOKE_CUT_STEPS, device=device)
    step_ms = event_step_ms(probe, COOKE_TIMED)
    probe_ms = statistics.median(step_ms)
    mean_s = statistics.fmean(step_ms) * 1e-3
    steps = COOKE_CUT_STEPS
    check(mean_s * steps <= COOKE_BUDGET_S,
          f"19b a step takes {mean_s * 1e3:.3f} ms: {steps} steps would "
          f"take more than {COOKE_BUDGET_S:.0f} s")
    prof, _, cooke_shares = profiled_steps(probe, COOKE_PROFILED,
                                           "profiled", {})
    per_step = device_profile(prof)[2] / COOKE_PROFILED
    del probe, prof
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cooke = classical.cooke_triplet(steps=steps, device=device)
    torch.cuda.synchronize()
    cooke_s = time.perf_counter() - t0
    check(cooke["rms1"] < 0.5 * cooke["rms0"],
          f"19b rms {cooke['rms0']} -> {cooke['rms1']}")
    print(f"phase 19b Cooke triplet: 6 surfaces, 3 lines x 3 fields x 48 "
          f"rays, float32, Adam under the cosine schedule; one step "
          f"{probe_ms:.3f} ms (median by CUDA events over {COOKE_TIMED}, "
          f"mean {mean_s * 1e3:.3f}, min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}); {steps} steps "
          f"(the example's {COOKE_STEPS} cut) in {cooke_s:.3f} s = "
          f"{cooke['seconds'] / steps * 1e3:.3f} ms a step; {per_step:.1f} kernels and copies a step; "
          f"{cooke_shares}; mean RMS spot rms0 "
          f"{cooke['rms0']!r} -> rms1 {cooke['rms1']!r} (below half: "
          f"{cooke['rms1'] < 0.5 * cooke['rms0']}); curvatures "
          f"{cooke['params'].cpu().tolist()}; loss "
          f"{ {k: round(v, 9) for k, v in cooke['losses'].items()} }",
          flush=True)

    # ---- 19c. the first-order analysis and the lens report, the card's
    # float32 against the CPU's float64
    t0 = time.perf_counter()
    pa = classical.paraxial_analysis(device=device)
    pa_s = time.perf_counter() - t0
    pa64 = classical.paraxial_analysis(dtype=torch.float64, device="cpu")
    worst = {}
    for k in ("efl", "bfp", "ffp", "front_principal", "back_principal",
              "z_cross", "axial_color", "efl_solved", "petzval"):
        worst[k] = close_to(f"19c {k}", pa[k], pa64[k], rtol=FIRST_ORDER_RTOL)
    for k in ("S1", "S2", "S3", "S4", "S5", "C1", "C2", "per_surface"):
        want = pa64["seidel"][k]
        worst[k] = close_to(f"19c {k}", pa["seidel"][k], want,
                            atol=SEIDEL_SHARE * float(np.abs(want).max()))
    print(f"phase 19c paraxial analysis: float32 on the card in {pa_s:.3f} s, "
          f"its three checks held; EFL {float(pa['efl'])!r}, BFP "
          f"{float(pa['bfp'])!r} (real ray {float(pa['z_cross'])!r}), "
          f"Petzval {float(pa['petzval'])!r}, axial colour F/d/C "
          f"{pa['axial_color'].tolist()}, Seidel S1..S5 "
          f"{[float(pa['seidel'][k]) for k in ('S1', 'S2', 'S3', 'S4', 'S5')]}"
          f", C1 {float(pa['seidel']['C1'])!r}, EFL solve "
          f"{float(pa['efl_solved'])!r}; largest differences from the CPU's "
          f"float64 {worst}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = classical.lens_report(device=device)
    torch.cuda.synchronize()
    rep_s = time.perf_counter() - t0
    rep64 = classical.lens_report(dtype=torch.float64, device="cpu")
    worst = {}
    for k in ("efl", "bfp", "f_no", "entrance_pupil", "exit_pupil",
              "axial_color", "lateral_color"):
        worst[k] = close_to(f"19c report {k}", rep[k], rep64[k],
                            rtol=FIRST_ORDER_RTOL)
    for k in ("S1", "S2", "S3", "S4", "S5", "C1", "C2", "per_surface"):
        want = getattr(rep64["seidel"], k).numpy()
        worst[k] = close_to(f"19c report {k}",
                            getattr(rep["seidel"], k).cpu().numpy(), want,
                            atol=SEIDEL_SHARE * float(np.abs(want).max()))
    fc, fc64 = rep["field_curves"], rep64["field_curves"]
    for k, tol in (("tangential", {"atol": FOCUS_ATOL}),
                   ("sagittal", {"atol": FOCUS_ATOL}),
                   ("chief_height", {"rtol": FIRST_ORDER_RTOL}),
                   ("paraxial_height", {"rtol": FIRST_ORDER_RTOL}),
                   ("distortion", {"atol": DISTORTION_ATOL})):
        worst[k] = close_to(f"19c report {k}", getattr(fc, k).cpu().numpy(),
                            getattr(fc64, k).numpy(), **tol)
    worst["spots"] = close_to(
        "19c report spots", [rep["spots"][k] for k in sorted(rep["spots"])],
        [rep64["spots"][k] for k in sorted(rep64["spots"])], rtol=SPOT_RTOL)
    worst["mtf"] = close_to("19c report MTF", rep["mtf"][1][:8],
                            rep64["mtf"][1][:8], atol=MTF_ATOL)
    print(f"phase 19c lens report: float32 on the card in {rep_s:.3f} s "
          f"(2000 rays a field, 5 fields, a 2048-ray PSF on a 101^2 grid); "
          f"EFL {rep['efl']!r}, BFP {rep['bfp']!r}, f/{rep['f_no']:.4f}, "
          f"pupils {rep['entrance_pupil']!r}, {rep['exit_pupil']!r}; Seidel "
          f"S1..S5, C1, C2 "
          f"{[float(getattr(rep['seidel'], k)) for k in ('S1', 'S2', 'S3', 'S4', 'S5', 'C1', 'C2')]}"
          f"; tangential foci {fc.tangential.cpu().tolist()}, sagittal "
          f"{fc.sagittal.cpu().tolist()}; spots {rep['spots']}; MTF at "
          f"{rep['mtf'][0][:4].tolist()} cycles/mm: "
          f"{rep['mtf'][1][:4].tolist()} (|mtf[0] - 1| < 1e-9 held); "
          f"largest differences from the CPU's float64 {worst}", flush=True)

    # ---- 19d. the best-form singlet, float64 on the card and on the CPU
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bf = classical.best_form_singlet(device=device)
    torch.cuda.synchronize()
    bf_s = time.perf_counter() - t0
    bf_cpu = classical.best_form_singlet(device="cpu")
    hist = bf["result"].cost_history.cpu().numpy()
    hist_cpu = bf_cpu["result"].cost_history.numpy()
    acc = bf["result"].accepted.cpu().numpy()
    check(np.array_equal(acc, bf_cpu["result"].accepted.numpy()),
          f"19d accepted {acc.tolist()} against the CPU's "
          f"{bf_cpu['result'].accepted.tolist()}")
    hist_err = float(np.max(np.abs(hist - hist_cpu) / np.abs(hist_cpu)))
    check(hist_err <= LSQ_RTOL, f"19d cost history {hist.tolist()} against "
          f"the CPU's {hist_cpu.tolist()}")
    check(bool(acc.any()) and float(bf["result"].cost) < 1e-2 * bf["cost0"]
          and abs(bf["efl"] - classical.SINGLET_EFL) < 1e-3,
          f"19d cost {float(bf['result'].cost)} (start {bf['cost0']}), EFL "
          f"{bf['efl']}")
    print(f"phase 19d best-form singlet: lm_solve, 25 iterations, float64 "
          f"on the card in {bf_s:.3f} s; accepted {int(acc.sum())} of "
          f"{acc.size}, equal to the CPU's; cost history within "
          f"{hist_err:.3e} of the CPU's (rtol limit {LSQ_RTOL}); cost "
          f"{float(bf['result'].cost)!r} = {float(bf['result'].cost) / bf['cost0']:.4e} "
          f"of the start {bf['cost0']!r}; EFL {bf['efl']!r}; shape factor q "
          f"{bf['q']!r} (the stall of the fixed damping; the thin-lens "
          f"optimum is not reached, as in the JAX package); phase 19 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


def interleaved_ms(runs, n=FACADE_TIMED):
    """Median ms of each of ``runs`` (name: callable) over ``n``
    synchronised calls, after one each, taken in turns so that a drift of
    the shared host falls on all of them alike."""
    import torch

    times = {name: [] for name in runs}
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(n):
        for name, fn in runs.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def facade_traces(label, system, engine, bounces, kernels, plain_stride,
                  profiled):
    """20a on one scene: the facade's ``ray_trace`` against the functional
    trace of the same rays and scene, each of its K5 and K6 calls against
    the plain version (on every ``plain_stride``-th ray), the ray views,
    the launches of the facade's trace, the three ways timed, and
    ``profiled`` functional traces profiled.  Returns the launches."""
    import torch

    from tensorflowraytrace_tpu_torch import trace

    cfg = engine.trace_config(bounces)
    rays, scene = system.sources, system.scene
    materials = system.material_callables()
    check(cfg.use_kernel and not cfg.cull,
          f"20a {label}: recommended chose {cfg}")
    logs = {k: [] for k in kernels}
    with logged_searches(logs):
        res, launches = launches_of(lambda: engine.ray_trace(bounces))
    for k in ("K5", "K6"):
        want = bounces if k in kernels else 0
        check(launches[k] == want, f"20a {label}: the facade's trace "
              f"launched {k} {launches[k]} times, not {want}")
    t0 = time.perf_counter()
    replayed = {k: replayed_plain(f"20a {label}", k, logs[k], plain_stride)
                for k in kernels}
    replay_s = time.perf_counter() - t0
    del logs
    with torch.no_grad():
        ref = trace(rays, scene, materials, cfg)
    got, want = res.rays, ref.rays
    check(torch.equal(got.state, want.state) and torch.equal(got.p1, want.p1)
          and torch.equal(got.p0, want.p0),
          f"20a {label}: the facade's trace differs from engine.trace")
    counts = state_counts(got.state)
    check(counts == state_counts(want.state), f"20a {label}: state counts")
    views = [engine.finished_rays.n_rays, engine.stopped_rays.n_rays,
             engine.dead_rays.n_rays, engine.active_rays.n_rays]
    check(sum(views) == got.n_rays and views == [counts[1], counts[2],
                                                  counts[3], counts[0]],
          f"20a {label}: the ray views {views} do not partition "
          f"{got.n_rays} slots ({counts})")

    def functional():
        with torch.no_grad():
            trace(rays, scene, materials, cfg)

    def step():
        system.update()
        engine.ray_trace(bounces)

    ms = interleaved_ms({"functional": functional,
                         "ray_trace": lambda: engine.ray_trace(bounces),
                         "update": step})
    parts = {k: cuda_kernel_name(kind, "brute")
             for k, kind in (("K5", "segment"), ("K6", "arc"))}
    _, _, shares = profiled_steps(functional, profiled,
                                  "the functional trace profiled", parts)
    t_fn = ms["functional"]
    print(f"phase 20a {label}: {got.n_rays} rays x {bounces} bounces, "
          f"state counts (active, finished, stopped, dead) {counts}; the "
          f"facade's ray_trace equals engine.trace bit for bit (states, "
          f"counts, p0, p1) and its four views partition the slots; "
          f"its calls {replayed} bit for bit with the plain versions on "
          f"the same inputs (every {plain_stride} ray(s), "
          f"{replay_s:.1f} s); launches of one facade trace {launches}; "
          f"median of "
          f"{FACADE_TIMED} in turns: functional {t_fn:.3f} ms, facade "
          f"ray_trace {ms['ray_trace']:.3f} ms "
          f"({ms['ray_trace'] / t_fn:.3f}x), update() + ray_trace "
          f"{ms['update']:.3f} ms ({ms['update'] / t_fn:.3f}x); {shares}",
          flush=True)
    return launches


def phase_20(device):
    """The stateful facade, the goals and the checkpoint on the card.
    Returns the facade's launches of K1, K2, K5 and K6."""
    import os
    import tempfile

    import numpy as np
    import torch

    from tensorflowraytrace_tpu_torch import facade, scenes2d
    from tensorflowraytrace_tpu_torch.optim import Optimizer
    from tensorflowraytrace_tpu_torch.system import SGD_Optimizer

    t_phase = time.perf_counter()
    total = collections.Counter()
    laps = {}

    def lap(name):
        laps[name] = time.perf_counter() - t_phase - sum(laps.values())

    # ---- 20a. the facade's traces
    system, engine = facade.tax_bench_system(device=device)
    total.update(facade_traces("facade_tax_bench scene", system, engine,
                               facade.TAX_BOUNCES, ("K5",), 1, 2))
    del system, engine
    lap("20a facade-tax")
    system, engine = facade.guide_system(device=device)
    total.update(facade_traces("2D light guide", system, engine,
                               scenes2d.GUIDE_BOUNCES, ("K5", "K6"),
                               GUIDE_PLAIN_STRIDE, 1))
    del system, engine
    torch.cuda.empty_cache()
    lap("20a guide")

    # ---- 20b. the flagship design through OpticalSystem3D
    problem = facade.flagship_system(device=device)
    kw = dict(learning_rate=1.0, grad_clip=1e-3)
    sgd = SGD_Optimizer(problem["engine"], trace_depth=TRAIN_BOUNCES,
                        error_function=problem["error_function"],
                        generator=torch.Generator(device).manual_seed(0),
                        **kw)
    ref = Optimizer(problem["loss"], problem["init_params"],
                    generator=torch.Generator(device).manual_seed(0), **kw)
    accumulators = [problem["accumulator"]] * 2
    phase = dict(lr_scale=2e-4, momentum=0.8,
                 smoothers=[problem["smoother"]] * 2)
    sgd_errors, launches = launches_of(lambda: [
        sgd.single_step(accumulators, **phase)
        for _ in range(FACADE_STEPS)])
    total.update(launches)
    for k in ("K1", "K2"):
        check(launches[k] == TRAIN_BOUNCES * FACADE_STEPS,
              f"20b SGD_Optimizer launched {k} {launches[k]} times in "
              f"{FACADE_STEPS} steps")
    ref_errors = [ref.single_step(accumulators, **phase)
                  for _ in range(FACADE_STEPS)]
    check(sgd_errors == ref_errors,
          f"20b losses {sgd_errors!r} through the facade, {ref_errors!r} "
          f"functionally")
    pmax = max(float(p.abs().max()) for p in ref.parameters)
    pdiff = max(float((a - b).abs().max())
                for a, b in zip(sgd.parameters, ref.parameters))
    # the same arithmetic, and K2 in a fixed order: the same bits
    check(grads_same_bits(sgd.parameters, ref.parameters),
          f"20b parameters after {FACADE_STEPS} steps differ by {pdiff} "
          f"(max {pmax})")
    lens = problem["system"].optical[0]._obj
    check(all(torch.equal(a.detach(), b)
              for a, b in zip(lens.param_list(), sgd.parameters)),
          "20b SGD_Optimizer did not write its parameters back")
    steps = {name: (lambda opt=opt: opt.single_step(accumulators, **phase))
             for name, opt in (("SGD_Optimizer", sgd), ("Optimizer", ref))}
    ms = interleaved_ms(steps, FACADE_STEPS)
    parts = {"K1": "triangle_search", "K2": "segment_sum"}
    timed = {name: (ms[name], profiled_steps(step, FACADE_PROFILED,
                                             "profiled", parts)[2])
             for name, step in steps.items()}
    facade_loss, _ = problem["engine"].make_loss(problem["error_function"],
                                                 TRAIN_BOUNCES)
    plain_calls = kernel_and_plain(
        "phase 20b flagship", lambda p: facade_loss(
            p, torch.Generator(device).manual_seed(0)), sgd.parameters,
        ("K1",))
    print(f"phase 20b flagship through OpticalSystem3D: "
          f"{problem['system'].sources.n_rays} rays, "
          f"{problem['system'].scene.triangles.n_surfaces} triangles, "
          f"{TRAIN_BOUNCES} bounces; every step's loss equal through the "
          f"facade and functionally ({sgd_errors[0]!r} -> "
          f"{sgd_errors[-1]!r}), the parameters after {FACADE_STEPS} steps "
          f"bit for bit (max {pmax:.3e}); one forward + backward of the "
          f"facade's loss against the plain versions: {plain_calls} K1 calls "
          f"bit for bit, the loss equal, the gradient through K2 bit for "
          f"bit; "
          f"launches of the facade's steps "
          f"{launches}; ms a step (median of {FACADE_STEPS} synchronised "
          f"steps, in turns): "
          + "; ".join(f"{name} {ms:.3f} ms, {shares}"
                      for name, (ms, shares) in timed.items()), flush=True)
    del problem, sgd, ref, lens, facade_loss
    lap("20b")

    # ---- 20c. checkpoint and resume of the single arc, K5, K6 and K2
    arc_loss, _ = scenes2d.single_arc(dtype=torch.float32, device=device,
                                      use_kernel=True)
    with tempfile.TemporaryDirectory() as tmp:
        for label, tx in (("Nesterov", None), ("Adam + LambdaLR",
                                               facade.adam_lambda())):
            out, launches = launches_of(lambda: facade.stepwise_optimize(
                os.path.join(tmp, "stepwise"), device=device,
                use_kernel=True, optax_tx=tx))
            total.update(launches)
            check(all(launches[k] > 0 for k in ("K5", "K6", "K2")),
                  f"20c {label}: launches {launches}")
            at = out["saved"]["iterations"]
            check(facade.states_equal(out["restored"], out["saved"]),
                  f"20c {label}: the restored state differs from the saved")
            check(out["resumed_errors"][0] == out["errors"][at],
                  f"20c {label}: the first resumed loss "
                  f"{out['resumed_errors'][0]!r}, uninterrupted "
                  f"{out['errors'][at]!r}")
            plain_calls = kernel_and_plain(
                f"phase 20c {label}", arc_loss, out["saved"]["parameters"],
                ("K5", "K6"))
            drift = out["drift"]
            check(drift < STEPWISE_DRIFT,
                  f"20c {label}: the final radius drifted {drift!r}")
            print(f"phase 20c stepwise single arc, {label}: checkpoint at "
                  f"step {at} restored bit for bit (parameters, momentum, "
                  f"generator, iterations"
                  f"{', torch optimizer and scheduler' if tx else ''}); "
                  f"first resumed loss {out['resumed_errors'][0]!r} equal "
                  f"to the uninterrupted run's; final radius "
                  f"{out['param']!r}: "
                  f"{'EXACT' if drift == 0 else f'drift {drift!r}'}; loss "
                  f"{out['errors'][0]!r} -> {out['errors'][-1]!r}; "
                  f"launches {launches}; at the checkpoint's parameters "
                  f"one forward + backward against the plain versions: "
                  f"{plain_calls} K5 and K6 calls bit for bit, the loss "
                  f"equal, the gradient through K2 bit for bit",
                  flush=True)

        lap("20c")
        # ---- 20d. the goal pipeline: offline on the host, per step on
        # the card
        cpu = facade.precompile_pipeline(os.path.join(tmp), device="cpu")
        card = facade.precompile_pipeline(
            os.path.join(tmp), device=device,
            generator=torch.Generator(device).manual_seed(0))
    gap = abs(card["mean_distance"] - cpu["mean_distance"])
    check(gap <= PIPELINE_ATOL, f"20d mean distance {card['mean_distance']!r}"
          f" on the card's run, {cpu['mean_distance']!r} on the CPU's")
    rows = {tuple(r) for r in card["matched"].tolist()}
    for points, ranks in card["samples"]:
        check(points.device.type == "cuda" and points.shape == (64, 2)
              and bool(torch.isfinite(points).all())
              and {tuple(r) for r in ranks.cpu().tolist()} <= rows,
              "20d a per-step sample is not drawn from the cache")
    print(f"phase 20d precompile pipeline: {card['goal_points'].shape[0]} "
          f"goals matched to {card['source_points'].shape[0]} sources "
          f"(Hungarian), mean distance {card['mean_distance']!r} (the CPU "
          f"run's {cpu['mean_distance']!r}, gap {gap!r}); cache pickled and "
          f"reloaded; {len(card['samples'])} per-step samples of 64 drawn "
          f"on the card from a CUDA generator", flush=True)
    lap("20d")
    print(f"phase 20 in {time.perf_counter() - t_phase:.1f} s: "
          + ", ".join(f"{name} {t:.1f} s" for name, t in laps.items()),
          flush=True)
    return dict(total)


def export_counts():
    """Every kernel's launch count, K1 to K10."""
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    return {"K1": tk.LAUNCHES, "K2": sk.LAUNCHES, "K3": tk.LAUNCHES_CULLED,
            "K4": tk.LAUNCHES_TWOLEVEL, **launches_2d()}


def reset_counts():
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

    tk.LAUNCHES = tk.LAUNCHES_CULLED = tk.LAUNCHES_TWOLEVEL = sk.LAUNCHES = 0
    reset_2d_launches()


def opcheck_inputs(kernel, device):
    """Small float32 inputs of each operator on the card: 300 rays against
    600 surfaces (three 256-chunks, two of K4's 512), some missing."""
    import numpy as np
    import torch

    rng = np.random.default_rng(int(kernel[1:]))

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    n, m = 300, 600
    if kernel == "K2":
        return (t(rng.normal(size=(4, n))),
                t(rng.integers(0, 50, n), torch.int32), 50)
    if kernel in ("K1", "K3", "K4"):
        p0 = rng.uniform(-1, 1, (n, 3))
        vp = rng.uniform(-2, 2, (m, 3))
        return (t(p0), t(p0 + rng.normal(size=(n, 3))), t(vp),
                t(vp + rng.normal(0, 0.3, (m, 3))),
                t(vp + rng.normal(0, 0.3, (m, 3))), EPS, EPS, EPS)
    p0 = rng.uniform(-1, 1, (n, 2))
    p1 = p0 + rng.normal(size=(n, 2))
    if kernel in ("K5", "K7", "K9"):
        sp0 = rng.uniform(-3, 3, (m, 2))
        return (t(p0), t(p1), t(sp0), t(sp0 + rng.normal(0, 0.4, (m, 2))),
                EPS, EPS, EPS)
    a0 = rng.uniform(-np.pi, np.pi, m)
    return (t(p0), t(p1), t(rng.uniform(-3, 3, (m, 2))), t(a0),
            t(a0 + rng.uniform(0.1, 6.0, m)), t(rng.uniform(0.1, 0.5, m)),
            EPS, EPS)


def same_rays(label, got, want):
    """The loaded program's rays against the live trace's: bit for bit."""
    import torch

    for name in ("state", "p0", "p1"):
        a, b = getattr(got, name), getattr(want, name)
        check(torch.equal(a, b), f"{label}: the loaded program's {name} "
              f"differs from the live trace's in "
              f"{int((a != b).reshape(a.shape[0], -1).any(1).sum())} rays")


def served(label, folder, blob, call, live, compare, kernels):
    """Save ``blob`` under ``folder``, load it from the file, run it on
    ``call``'s arguments with the launch counts reset, hold its result
    against ``live()`` (``compare``) and time the two in turns.  Fails
    unless each of ``kernels`` launched from the loaded program.  Returns
    the counts of that run and a report."""
    import torch

    from tensorflowraytrace_tpu_torch.utils import export as ex

    path = folder / f"{label}.pt2"
    path.write_bytes(blob)
    t0 = time.perf_counter()
    program = ex.load_exported(str(path))
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counts()
    got = program(*call)
    torch.cuda.synchronize()
    counts = export_counts()
    for k in kernels:
        check(counts[k] > 0, f"{label}: the loaded program launched no {k}")
    compare(got, live())
    ms = interleaved_ms({"served": lambda: program(*call), "live": live},
                        n=EXPORT_TIMED)
    return counts, program, (
        f"{len(blob)} bytes, loaded in {load_s:.2f} s; launches from the "
        f"artifact "
        + ", ".join(f"{k} {counts[k]}" for k in kernels)
        + f"; served {ms['served']:.3f} ms, live {ms['live']:.3f} ms "
        f"(median of {EXPORT_TIMED} in turns)")


def export_dir():
    """The folder of phase 21b's programs: build/export/."""
    from tensorflowraytrace_tpu_torch.ops import cuda_build

    return cuda_build.BUILD_DIR / "export"


def export_programs(device):
    """Phase 21b's programs, in order: yields ``(label, make, serve)``.
    ``make()`` exports the program and returns its bytes; ``serve`` holds
    what ``served`` runs the loaded program on (``call``) and against
    (``live``, ``compare``, ``kernels``), the line's ``text``, and
    ``program``: None, or a further check of the loaded program that
    returns its words for the line.  The inputs are made here from seeds,
    the same in every process, so that the exporter (``export_all``)
    exports what phase 21b serves."""
    import torch

    from tensorflowraytrace_tpu_torch import (
        Scene3D, TraceConfig, flagship, scenes2d, trace,
    )
    from tensorflowraytrace_tpu_torch.engine import start_epsilon
    from tensorflowraytrace_tpu_torch.ops import materials as mats
    from tensorflowraytrace_tpu_torch.scenes3d import structured_guide
    from tensorflowraytrace_tpu_torch.utils import export as ex

    f32 = torch.float32
    # ---- the flagship forward and its loss's value and gradient
    lens, source, loss = flagship._flagship(f32, TRAIN_BP, TRAIN_RINGS,
                                            TRAIN_BOUNCES, True, device)
    rays = source.sample(torch.Generator(device).manual_seed(0), f32, device)
    with torch.no_grad():
        scene = Scene3D.build(optical=lens.build(),
                              targets=[flagship.target_plane(f32, device)])
    cfg = TraceConfig(max_bounces=TRAIN_BOUNCES, use_kernel=True,
                      ray_start_epsilon=start_epsilon(scene))
    materials = (mats.vacuum, mats.acrylic)

    def half_refused(program):
        half = dataclasses.replace(
            rays, **{f: getattr(rays, f)[::2] for f in
                     ("p0", "p1", "wavelength", "state")},
            fields={k: v[::2] for k, v in rays.fields.items()})
        try:
            program(half)
        except Exception as e:  # noqa: BLE001 (any refusal will do)
            refusal = f"{type(e).__name__}"
        else:
            refusal = None
        check(refusal is not None, "21b: the flagship program ran on half "
              "the rays")
        return f"state, p0, p1 bit for bit; half the rays refused ({refusal})"

    yield "flagship_forward", (
        lambda: ex.export_trace(scene, materials, cfg, rays)), {
        "call": (rays,), "live": lambda: trace(rays, scene, materials,
                                               cfg).rays,
        "compare": lambda got, want: same_rays("21b flagship forward", got,
                                               want),
        "kernels": ("K1",), "program": half_refused,
        "text": f"flagship forward ({rays.n_rays} rays, "
                f"{scene.triangles.n_surfaces} triangles, {TRAIN_BOUNCES} "
                f"bounces)"}

    sizes = [p.numel() for p in lens.init_params()]
    shapes = [p.shape for p in lens.init_params()]

    def flat_loss(x, r):
        return loss([c.reshape(s) for c, s in zip(x.split(sizes), shapes)], r)

    x0 = torch.cat([p.detach().reshape(-1) for p in lens.init_params()])
    vag = ex.value_and_grad(flat_loss)
    grad_gap = []

    def same_value_and_grad(got, want):
        gmax = float(want[1].abs().max())
        gdiff = float((got[1] - want[1]).abs().max())
        check(bool(got[0] == want[0]), f"21b flagship loss {float(got[0])!r} "
              f"served, {float(want[0])!r} live")
        # the triangle normals' cross product is written out
        # (models/surfaces.py), so the joint program's backward and eager
        # autograd's add in one order
        check(gmax > 0 and torch.equal(got[1], want[1]),
              f"21b flagship gradient differs by {gdiff} (max {gmax})")
        grad_gap.append((gdiff, gmax))

    yield "flagship_value_and_grad", (lambda: ex.export_fn(vag, x0, rays)), {
        "call": (x0, rays), "live": lambda: vag(x0, rays),
        "compare": same_value_and_grad, "kernels": ("K1", "K2"),
        "program": lambda _: (f"loss and gradient bit for bit (max "
                              f"|g_served - g_live| {grad_gap[0][0]!r} of "
                              f"max |g| {grad_gap[0][1]!r})"),
        "text": "flagship value and gradient (a joint program)"}

    # ---- the 2D guide at full width, and the 3D guide
    g_rays, g_scene, g_mats = scenes2d.light_guide(device=device)
    for label, bounces, cull, kernels in (
            ("guide2d_brute", EXPORT_GUIDE2D_BOUNCES, False, ("K5", "K6")),
            ("guide2d_cull", EXPORT_SHALLOW_BOUNCES, True, ("K7", "K8")),
            ("guide2d_grid", EXPORT_SHALLOW_BOUNCES, "grid", ("K9", "K10"))):
        g_cfg = scenes2d.guide_config(g_scene, max_bounces=bounces,
                                      use_kernel=True, cull=cull)
        yield label, (lambda c=g_cfg: ex.export_trace(g_scene, g_mats, c,
                                                      g_rays)), {
            "call": (g_rays,),
            "live": lambda c=g_cfg: trace(g_rays, g_scene, g_mats, c).rays,
            "compare": lambda got, want, lb=label: same_rays(f"21b {lb}", got,
                                                             want),
            "kernels": kernels, "program": lambda _: "bit for bit",
            "text": f"2D guide ({g_rays.n_rays} rays, "
                    f"{g_scene.segments.n_surfaces} segments, "
                    f"{g_scene.arcs.n_surfaces} arcs, {bounces} bounces, "
                    f"cull={cull!r})"}
    del g_rays, g_scene
    torch.cuda.empty_cache()

    t_rays, t_scene = structured_guide(GUIDE_RAYS, device=device)
    t_mats = (mats.vacuum, mats.acrylic)
    for label, t_cfg, kernels in (
            ("guide3d_recommended", TraceConfig.recommended(
                t_scene, max_bounces=EXPORT_SHALLOW_BOUNCES), ("K3",)),
            ("guide3d_grid", dataclasses.replace(TraceConfig.recommended(
                t_scene, max_bounces=EXPORT_SHALLOW_BOUNCES), cull="grid",
                resort_rays=False), ("K4",))):
        check(t_cfg.use_kernel, f"21b {label}: no kernel under {t_cfg}")
        yield label, (lambda c=t_cfg: ex.export_trace(t_scene, t_mats, c,
                                                      t_rays)), {
            "call": (t_rays,),
            "live": lambda c=t_cfg: trace(t_rays, t_scene, t_mats, c).rays,
            "compare": lambda got, want, lb=label: same_rays(f"21b {lb}", got,
                                                             want),
            "kernels": kernels, "program": lambda _: "bit for bit",
            "text": f"3D guide ({t_rays.n_rays} rays, "
                    f"{t_scene.triangles.n_surfaces} triangles, "
                    f"{EXPORT_SHALLOW_BOUNCES} bounces, cull={t_cfg.cull!r}, "
                    f"resort_rays={t_cfg.resort_rays})"}
    del t_rays, t_scene
    torch.cuda.empty_cache()


def export_all(device):
    """``--export-programs``: every program of ``export_programs``
    exported and written under ``export_dir()`` (``<label>.pt2``, and its
    export's seconds in ``<label>.json``) for phase 21b to load.  The
    script starts it as a process of its own before phase 19, so that the
    exports' host tracing runs beside phases 19 and 20."""
    for label, make, _ in export_programs(device):
        t0 = time.perf_counter()
        blob = make()
        sec = time.perf_counter() - t0
        (export_dir() / f"{label}.pt2").write_bytes(blob)
        (export_dir() / f"{label}.json").write_text(
            json.dumps({"seconds": sec}))
        print(f"exported {label} in {sec:.2f} s, {len(blob)} bytes",
              flush=True)


def start_exporter():
    """``chip_smoke.py --export-programs`` started as a process of its
    own, its output in ``export_dir()``/exporter.log, the folder's earlier
    programs removed first."""
    export_dir().mkdir(parents=True, exist_ok=True)
    for old in export_dir().glob("*.pt2"):
        old.unlink()
    with open(export_dir() / "exporter.log", "w") as log:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--export-programs"],
            stdout=log, stderr=subprocess.STDOUT)


def phase_21(device, exporter):
    """Export, profiling and drawing on the card; ``exporter`` is the
    process ``start_exporter`` started.  Returns each kernel's launches
    from the loaded programs of 21b."""
    import importlib.util

    import torch

    from tensorflowraytrace_tpu_torch import drawing, flagship, scenes2d, trace
    from tensorflowraytrace_tpu_torch.ops import cuda_build, custom_ops
    from tensorflowraytrace_tpu_torch.optim import Optimizer
    from tensorflowraytrace_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    f32 = torch.float32

    # ---- 21a. each operator's fake implementation against its CUDA one
    for kernel, op in custom_ops.OPS.items():
        torch.library.opcheck(op, opcheck_inputs(kernel, device))
    ct, idx, m = opcheck_inputs("K2", device)
    table = torch.randn((m, ct.shape[0]), device=device, requires_grad=True)
    torch.library.opcheck(custom_ops.gather_rows_t, (table, idx, True))
    torch.cuda.synchronize()
    print(f"phase 21a opcheck: all {len(custom_ops.OPS)} kernel operators "
          f"and the gather (its backward K2's operator) on CUDA inputs pass "
          f"(schema, autograd registration, fake against CUDA, AOT "
          f"dispatch) in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # ---- 21b. the programs the exporter wrote beside phases 19 and 20
    t_wait = time.perf_counter()
    try:
        rc = exporter.wait(timeout=EXPORTER_WAIT_S)
    except subprocess.TimeoutExpired:
        exporter.kill()
        exporter.wait()
        rc = "killed"
    wait_s = time.perf_counter() - t_wait
    log = (export_dir() / "exporter.log").read_text()
    check(rc == 0, f"21b: the exporter ended with {rc}:\n{log[-4000:]}")
    print(f"phase 21b exporter (chip_smoke.py --export-programs, started "
          f"before phase 19) done; waited {wait_s:.2f} s for it", flush=True)
    launched = collections.Counter()
    for label, _, serve in export_programs(device):
        blob = (export_dir() / f"{label}.pt2").read_bytes()
        sec = json.loads((export_dir() / f"{label}.json").read_text())[
            "seconds"]
        counts, program, report = served(
            label, export_dir(), blob, serve["call"], serve["live"],
            serve["compare"], serve["kernels"])
        launched.update(counts)
        extra = serve["program"](program) if serve["program"] else ""
        print(f"phase 21b {serve['text']}: exported in {sec:.2f} s (by the "
              f"exporter), {report}; {extra}", flush=True)
        del program, blob
    torch.cuda.empty_cache()
    missing = [k for k in custom_ops.OPS if launched[k] == 0]
    check(not missing, f"21b: no loaded program launched {missing}")
    t_b = time.perf_counter() - t_phase

    # ---- 21c. three flagship steps under profile_trace
    vum, acc, smoother = flagship.training_tools(TRAIN_RINGS)
    lens, source, step_loss = flagship._flagship(
        f32, TRAIN_BP, TRAIN_RINGS, TRAIN_BOUNCES, True, device, vum)
    opt = Optimizer(lambda p, g: step_loss(p, source.sample(g, f32, device)),
                    lens.init_params(), learning_rate=1.0, grad_clip=1e-3,
                    generator=torch.Generator(device).manual_seed(0))
    accs = [torch.as_tensor(acc, dtype=f32, device=device)] * 2
    smoothers = [torch.as_tensor(smoother, dtype=f32, device=device)] * 2
    timer = profiling.StepTimer()
    logdir = cuda_build.BUILD_DIR / "profile"
    with profiling.profile_trace(str(logdir)):
        for _ in range(3):
            with timer:
                opt.run_phase(1, accs, lr_scale=1.0, momentum=0.8,
                              smoothers=smoothers)
                torch.cuda.synchronize()
    files = sorted(logdir.glob("*.pt.trace.json"),
                   key=lambda p: p.stat().st_mtime)
    check(len(files) > 0, f"21c: no trace under {logdir}")
    events = json.loads(files[-1].read_text())["traceEvents"]
    kernel_names = {e.get("name", "") for e in events
                    if e.get("cat") == "kernel"}
    named = {k: sorted(n for n in kernel_names if part in n)
             for k, part in (("K1", "triangle_search"),
                             ("K2", "segment_sum"))}
    check(all(named.values()), f"21c: the trace names no K1 or K2 kernel: "
          f"{named}")
    # an operator is a host range; on the device timeline it would be
    # counted as a kernel by device_profile
    on_device = sum(1 for e in events if e.get("cat") != "cpu_op"
                    and str(e.get("name", "")).startswith("tfrt_torch::"))
    print(f"phase 21c profile_trace: {files[-1].name} "
          f"({files[-1].stat().st_size} bytes, {len(kernel_names)} kernel "
          f"names) names K1 {named['K1']} and K2 {named['K2']}; "
          f"{on_device} tfrt_torch events off the host's op list; "
          f"StepTimer: {timer.report()}", flush=True)

    # ---- 21d. drawing straight from CUDA tensors
    if importlib.util.find_spec("matplotlib") is None:
        print("phase 21d drawing: matplotlib is not installed on this "
              "machine; 21d did not run", flush=True)
    else:
        d_rays, d_scene, d_mats = scenes2d.light_guide(DRAW_RAYS,
                                                       device=device)
        res = trace(d_rays, d_scene, d_mats, scenes2d.guide_config(
            d_scene, max_bounces=DRAW_BOUNCES, use_kernel=True,
            keep_history=True))
        flat = drawing.history_rays(res)
        fig = drawing.figure(figsize=(12, 4))
        ax = fig.subplots()
        drawing.SegmentDrawer(ax, d_scene.segments,
                              draw_norm_arrows=False).draw()
        drawing.ArcDrawer(ax, d_scene.arcs, draw_norm_arrows=False).draw()
        drawing.RayDrawer2D(ax, flat).draw()
        ax.set_xlim(-1, 41)
        ax.set_ylim(-1.1, 1.1)
        png = cuda_build.BUILD_DIR / "guide_2d.png"
        fig.savefig(png, dpi=100)
        check(png.stat().st_size > 0, "21d: the PNG is empty")
        print(f"phase 21d drawing: {len(flat['x_start'])} ray segments of "
              f"{d_rays.n_rays} rays x {DRAW_BOUNCES} bounces drawn from "
              f"CUDA tensors with RayDrawer2D, SegmentDrawer and ArcDrawer "
              f"into {png.name} ({png.stat().st_size} bytes)", flush=True)
    t_phase = time.perf_counter() - t_phase
    print(f"phase 21 in {t_phase:.1f} s (21a + 21b {t_b:.1f} s)", flush=True)
    return launched


def phase_22(device):
    """The last examples at their defaults in float32, each through its
    port function, with its checks, wall seconds and launches.  Returns
    the launches by example."""
    import importlib.util
    import math

    import torch

    from tensorflowraytrace_tpu_torch import physics2d, populations
    from tensorflowraytrace_tpu_torch import scenes3d, source_demos
    from tensorflowraytrace_tpu_torch.ops import cuda_build

    t_phase = time.perf_counter()
    parts = {"K5": cuda_kernel_name("segment", "brute"),
             "K6": cuda_kernel_name("arc", "brute"), "K2": "segment_sum"}
    launched = {}

    def run(label, fn, kernels):
        """``fn()`` timed, its launches counted: each of ``kernels`` must
        launch, no other kernel may."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts = launches_of(fn)
        wall = time.perf_counter() - t0
        launched[label] = counts
        ran = {k for k, n in counts.items() if n}
        check(ran == set(kernels), f"phase 22 {label}: launched {counts}, "
              f"not exactly {sorted(kernels)}")
        return out, wall, counts

    def timed_steps(label, step, profiled=EXAMPLE_PROFILED):
        ms = event_step_ms(step, EXAMPLE_TIMED)
        _, _, shares = profiled_steps(step, profiled, "profiled", parts)
        return ms, (f"phase 22 {label} steps: median "
                    f"{statistics.median(ms):.3f} ms a step by CUDA events "
                    f"over {EXAMPLE_TIMED} (min {min(ms):.3f}, max "
                    f"{max(ms):.3f}); {shares}")

    def probe(label, step, steps):
        """One design step timed and profiled before the cut design runs:
        ``steps`` of them must fit ``CUT_BUDGET_S[label]``."""
        ms, report = timed_steps(label, step)
        print(report, flush=True)
        cut_probe(label, ms, steps)

    # ---- 22a. the source demos: the host and the sources, no kernel
    out, wall, _ = run("source_rotation_roll", lambda: (
        source_demos.source_rotation_roll(device=device, verbose=False)), ())
    print(f"phase 22a source_rotation_roll: worst roll vector aiming "
          f"{out['worst_vector']!r} deg (> 1), quaternion aiming "
          f"{out['worst_quaternion']!r} deg (< 1e-5), in {wall:.3f} s",
          flush=True)
    out, wall, _ = run("cdf_demo", lambda: source_demos.cdf_demo(
        verbose=False), ())
    print(f"phase 22a cdf_demo: forward std {out['mapped_std'].tolist()}, "
          f"inverse cv {float(out['icdf_cv'])!r}, flatten cv "
          f"{float(out['flatten_cv'])!r} "
          f"in {wall:.3f} s", flush=True)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    png = cuda_build.BUILD_DIR / "source_gallery.png" if has_mpl else None
    out, wall, _ = run("source_gallery", lambda: source_demos.source_gallery(
        png=png, device=device, verbose=False), ())
    print(f"phase 22a source_gallery: {out['angular_rays']} rays of the "
          f"dense AngularSource, circle density uniformity "
          f"{out['uniformity']!r}, aimed mean direction "
          f"{out['mean_direction'].tolist()}, in {wall:.3f} s; "
          + (f"figure {png.name} ({png.stat().st_size} bytes)" if has_mpl
             else "matplotlib is not installed on this machine: the figure "
             "was not drawn"), flush=True)

    # ---- 22b. the 2D reaction examples and the populations
    out, wall, n = run("fresnel_intensity", lambda: (
        physics2d.fresnel_intensity(device=device, verbose=False)),
        ("K5", "K6", "K2"))
    mid = len(out["ratio"]) // 2
    print(f"phase 22b fresnel_intensity: 2000 rays, {out['finished']} land "
          f"carrying {out['power']!r} of the power; power/count centre, "
          f"edges {out['ratio'][[mid, 0, -1]].tolist()}; d(power)/d(radius) "
          f"{out['grad']!r}; in "
          f"{wall:.3f} s, launches {n}", flush=True)
    out, wall, n = run("fresnel_rhomb", lambda: physics2d.fresnel_rhomb(
        device=device, verbose=False), ("K5", "K2"))
    print(f"phase 22b fresnel_rhomb: 150 steps, theta "
          f"{math.degrees(out['theta'])!r} deg, TIR phase "
          f"{math.degrees(out['delta'])!r} deg, Stokes {out['stokes']}; in "
          f"{wall:.3f} s ({wall / 150 * 1e3:.3f} ms a step), launches {n}",
          flush=True)
    wavefront, _, _ = physics2d.wavefront_problem(device=device)
    check(wavefront.cfg.use_kernel, f"wavefront config {wavefront.cfg}")
    opt = physics2d.adam_design(physics2d.wavefront_loss(wavefront),
                                torch.zeros(65, device=device), 1e-2)
    probe("wavefront_lens", lambda: opt.single_step(sync=False),
          WAVEFRONT_CUT_STEPS)
    del opt, wavefront
    steps = WAVEFRONT_CUT_STEPS
    out, wall, n = run("wavefront_lens", lambda: physics2d.wavefront_lens(
        steps, device=device, verbose=False), ("K5", "K2"))
    print(f"phase 22b wavefront_lens: {steps} steps (the example's "
          f"{WAVEFRONT_STEPS} cut), 64 segments, 192 rays: RMS "
          f"wavefront {out['rms_wf0']!r} -> {out['rms_wf']!r}, spot "
          f"{out['rms_spot0']!r} -> {out['rms_spot']!r}, surface off the "
          f"hyperbola by {out['hyperbola_dev']!r}, (Z4, Z11) "
          f"{out['zernike0'][[3, 10]].tolist()} -> "
          f"{out['zernike'][[3, 10]].tolist()}; in {wall:.3f} s (design "
          f"{out['seconds'] / steps * 1e3:.3f} ms a step), launches {n}",
          flush=True)
    del out
    rays = physics2d.achromat_rays(device=device)
    opt, cfg = physics2d.achromat_design(
        physics2d.build_doublet, physics2d.DOUBLET_START, rays, 4, 2e-3,
        10.0)
    check(cfg.use_kernel, f"achromat config {cfg}")
    probe("achromat", lambda: opt.single_step(None, momentum=0.9,
                                              sync=False),
          2 * ACHROMAT_CUT_STEPS)
    del opt, rays
    steps = ACHROMAT_CUT_STEPS
    out, wall, n = run("achromat", lambda: physics2d.achromat(
        steps, device=device, verbose=False), ("K5", "K6", "K2"))
    print(f"phase 22b achromat: 21 heights x 3 lines, {steps} steps a lens "
          f"(the example's {ACHROMAT_STEPS} cut): "
          f"chromatic shift C - F singlet {out['singlet_shift']!r}, doublet "
          f"{out['doublet_shift']!r} ({out['improvement']:.2f}x), errors "
          f"{out['singlet_error']!r} / {out['doublet_error']!r}; in "
          f"{wall:.3f} s ({wall / (2 * steps) * 1e3:.3f} ms a step), "
          f"launches {n}",
          flush=True)
    out, wall, n = run("ar_coating", lambda: physics2d.ar_coating(
        device=device, verbose=False), ("K5", "K6"))
    print(f"phase 22b ar_coating: mean R bare {out['r_bare']!r}, start "
          f"{out['r_start']!r}, designed {out['r_designed']!r} (quarter-wave "
          f"{out['r_quarter_wave']!r}), d {out['thickness'].tolist()} nm; "
          f"512 rays, {out['landed']} land: power bare "
          f"{out['power_bare']!r}, coated {out['power_coated']!r}; in "
          f"{wall:.3f} s, launches {n}", flush=True)
    out, wall, n = run("spectrometer", lambda: physics2d.spectrometer(
        device=device, verbose=False), ("K5", "K2"))
    print(f"phase 22b spectrometer: 400 steps: spacing {out['spacing']!r} "
          f"nm, detector {out['dist']!r}, anchor loss "
          f"{out['anchor_loss']!r}; band relative error "
          f"{out['band_rel_err']!r}, throughput relative error "
          f"{out['throughput_rel_err']!r}; in {wall:.3f} s, launches {n}",
          flush=True)
    landings, _ = physics2d.hybrid_problem(device=device)
    check(landings.cfg.use_kernel, f"hybrid config {landings.cfg}")
    opt = physics2d.hybrid_design(landings, True, device=device)
    probe("hybrid_achromat", lambda: opt.single_step(sync=False),
          2 * HYBRID_CUT_STEPS)
    steps = HYBRID_CUT_STEPS
    out, wall, n = run("hybrid_achromat", lambda: physics2d.hybrid_achromat(
        steps, device=device, verbose=False), ("K5", "K6", "K2"))
    print(f"phase 22b hybrid_achromat: 13 heights, {steps} steps a design "
          f"(the example's {HYBRID_STEPS} cut): "
          f"polychromatic RMS {out['refractive_rms']!r} -> "
          f"{out['hybrid_rms']!r} ({out['gain']:.3f}x, above 2); per line "
          f"{out['refractive_spots']} -> {out['hybrid_spots']}; in "
          f"{wall:.3f} s (refractive {out['refractive_seconds']:.3f} s, "
          f"hybrid {out['hybrid_seconds']:.3f} s = "
          f"{out['hybrid_seconds'] / steps * 1e3:.3f} ms a step), launches "
          f"{n}", flush=True)
    opt = physics2d.hybrid_design(landings, True, torch.as_tensor(
        out["hybrid_q"], device=device), device=device)
    calls = kernel_and_plain(
        "phase 22 hybrid", opt.loss_fn, opt.parameters, searches=("K5", "K6"))
    print(f"phase 22b hybrid against the plain versions: {calls} K5 and K6 "
          f"calls bit for bit, the loss equal, the gradient through K2 "
          f"bit for bit", flush=True)
    del opt, out
    out, wall, n = run("tolerancing", lambda: populations.tolerancing(
        design_steps=TOL_DESIGN_CUT_STEPS, device=device, verbose=False),
        ("K5", "K6", "K2"))
    print(f"phase 22b tolerancing: {TOL_DESIGN_CUT_STEPS} design steps (the "
          f"example's {populations.TOL_DESIGN_STEPS} cut), nominal spot "
          f"{out['nominal']!r} (c1, c2 "
          f"{out['params'][:2]}), sensitivities "
          f"{out['sensitivities'].tolist()}; 512 builds: median "
          f"{out['median']!r}, 95th {out['p95']!r}, yield "
          f"{out['yield']!r} at {out['spec']!r}; linear sigma "
          f"{out['linear_sigma']!r}, MC sigma {out['mc_sigma']!r}; in "
          f"{wall:.3f} s (design {out['design_seconds']:.3f} s, "
          f"Monte-Carlo {out['mc_seconds']:.3f} s = "
          f"{out['mc_seconds'] / 512 * 1e3:.3f} ms a build), launches {n}",
          flush=True)
    out, wall, n = run("design_sweep", lambda: populations.design_sweep(
        device=device, verbose=False), ("K5", "K6", "K2"))
    print(f"phase 22b design_sweep: 64 candidates ({out['sweep_seconds']:.3f}"
          f" s), best coarse r {out['coarse_radius']!r} loss "
          f"{out['coarse_loss']!r}; 60 steps of the best 8 "
          f"({out['refine_seconds']:.3f} s = "
          f"{out['refine_seconds'] / 60 * 1e3:.3f} ms a step): best r "
          f"{out['best_radius']!r} loss {out['best_loss']!r}; in "
          f"{wall:.3f} s, launches {n}", flush=True)
    loss = populations.sweep_problem(device=device)
    pop = populations.MomentumPopulation(loss, torch.as_tensor(
        out["pool"][:-1], device=device))
    print(timed_steps("design_sweep", pop.step, 1)[1], flush=True)
    del pop, out

    # ---- 22c. guide_trace_bench: the 3D guide through K4, K3 and K1
    out, wall, n = run("guide_trace_bench", lambda: (
        scenes3d.guide_trace_bench(device=device, verbose=False)),
        ("K1", "K3", "K4"))
    b = out["bounces"]
    check(n == {"K1": 4 * b, "K2": 0, "K3": 8 * b, "K4": 4 * b, "K5": 0,
                "K6": 0}, f"phase 22c launches {n}")
    print(f"phase 22c guide_trace_bench: {out['n_rays']} rays x "
          f"{out['triangles']} triangles x {b} bounces: " + "; ".join(
              f"{name} {v['ms']:.3f} ms = {v['equiv_per_s']:.4e} equivalent "
              f"intersections/s" for name, v in out["modes"].items())
          + f"; every checksum {out['modes']['brute']['checksum']!r}; in "
          f"{wall:.3f} s, launches {n}", flush=True)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter() - t_phase
    print(f"phase 22 in {t_phase:.1f} s", flush=True)
    return launched


def differing(a, b, path="result"):
    """The places where ``a`` and ``b`` (tensors, NumPy arrays, numbers,
    strings, or dicts, lists and tuples of them) do not hold the same
    bits: a list of paths, empty where every leaf is bit for bit."""
    import numpy as np
    import torch

    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{path} keys"]
        return [d for k in a for d in differing(a[k], b[k], f"{path}[{k!r}]")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differing(x, y, f"{path}[{i}]")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return [] if same_bits(a, b) else [path]
    if isinstance(a, (np.ndarray, np.generic, float, int, bool)) \
            and isinstance(b, (np.ndarray, np.generic, float, int, bool)):
        x, y = np.asarray(a), np.asarray(b)
        same = (x.dtype == y.dtype and x.shape == y.shape
                and x.tobytes() == y.tobytes())
        return [] if same else [path]
    return [] if a == b else [path]


def phase_23(device):
    """Every design path run twice from the same seeds and generators, in
    one process: every step's loss, the final parameters (or the image)
    bit for bit.  ``REPEAT_STEPS`` steps a path, the whole path where it
    is shorter.  Returns K2's launches and the seconds by path."""
    import torch

    from tensorflowraytrace_tpu_torch import (
        TraceConfig, classical, facade, flagship, hexalens,
        landing_histogram_fold, physics2d, populations, scenes2d, scenes3d,
        streamed, trace,
    )
    from tensorflowraytrace_tpu_torch.models import distributions as dist
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.operations import (
        thin_film_intensity_reaction,
    )
    from tensorflowraytrace_tpu_torch.optim import Optimizer

    f32 = torch.float32
    t_phase = time.perf_counter()
    n = REPEAT_STEPS
    seconds, k2 = {}, {}

    def twice(label, run):
        """``run()`` twice, the global generator seeded alike before each:
        its two results must hold the same bits."""
        t0 = time.perf_counter()
        sk.LAUNCHES = 0
        results = []
        for _ in range(2):
            torch.manual_seed(0)
            results.append(run())
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        k2[label] = sk.LAUNCHES
        diff = differing(*results)
        check(not diff, f"phase 23 {label}: the second run differs from the "
              f"first in {diff}")
        return results[0]

    def steps_of(opt, **kw):
        return {"losses": [opt.single_step(None, sync=False, **kw)
                           for _ in range(n)],
                "params": list(opt.parameters)}

    # ---- the 3D designs and their images
    twice("flagship", lambda: flagship.train(
        steps=n, bp_count=TRAIN_BP, mesh_steps=TRAIN_RINGS,
        max_bounces=TRAIN_BOUNCES, device=device))

    def hexalens_run():
        errors, params = hexalens.train(steps=n, ray_count=HEX_RAYS,
                                        mesh_step=HEX_MESH_STEP, device=device)
        _, source, loss = hexalens.problem(HEX_RAYS, HEX_MESH_STEP, f32,
                                           device)
        init, fold = landing_histogram_fold(hexalens.IMAGE_RANGE, 96, 64,
                                            axes=(1, 2), device=device)
        batch = source.sample(torch.Generator(device).manual_seed(7), f32,
                              device)
        with torch.no_grad():
            image = loss.trace(params, batch, fold_fn=fold,
                               fold_init=init).fold
        check(float(image.sum()) > 0, "phase 23: the hexalens image is empty")
        return {"errors": errors, "params": params, "image": image}

    twice("hexalens", hexalens_run)

    render = scenes3d.CausticRender(CAUSTIC_BLOCK, CAUSTIC_RES,
                                    CAUSTIC_MESH_STEPS, device=device)
    check(render.fold[0].dtype == f32, "the caustic image is not float32")

    def caustic_run():
        init, fn = render.fold
        with torch.no_grad():
            res = trace(render.block(0), render.scene,
                        scenes3d.CAUSTIC_MATERIALS, render.cfg,
                        reaction=render.reaction, fold_fn=fn, fold_init=init,
                        fold_fields=True)
        return {"image": res.fold, "state": res.rays.state}

    image = twice("caustic block image", caustic_run)["image"]
    check(k2["caustic block image"] == 2 * CAUSTIC_BOUNCES,
          f"phase 23: the caustic block's folds launched K2 "
          f"{k2['caustic block image']} times, not {CAUSTIC_BOUNCES} a trace")
    del render

    # ---- the 2D guide's design and the streamed training
    def guide_run():
        loss, params, scene = scenes2d.guide_design(GUIDE2D_RAYS,
                                                    device=device)
        cfg = TraceConfig.recommended(
            scene, max_bounces=scenes2d.GUIDE_BOUNCES,
            dead_ray_length=scenes2d.DEAD_RAY_LENGTH)
        value = loss(params, cfg)
        return {"loss": value.detach(),
                "grad": torch.autograd.grad(value, params)}

    twice("guide design", guide_run)
    twice("streamed training", lambda: streamed.train_guide(
        TRAIN_STREAM_RAYS, TRAIN_STREAM_BLOCK, TRAIN_STREAM_STEPS,
        TRAIN_STREAM_BOUNCES, device=device, verbose=False)[:2])

    # ---- phase 18's designs, a Cooke step, the stepwise single arc
    def asphere_run():
        spot_sq, start = scenes2d.asphere_problem(ASPHERE_RES, ASPHERE_RAYS,
                                                  f32, device)
        return steps_of(scenes2d.asphere_optimizer(
            spot_sq, start, scenes2d.ASPHERE_MASK, ASPHERE_STEPS, 6e-3))

    def config2_run():
        lens, _, _, loss = scenes2d.multisegment_problem(f32, device)
        return steps_of(Optimizer(loss, lens.init_params(), learning_rate=1.0,
                                  grad_clip=5e-3), lr_scale=2e-3,
                        momentum=0.8)

    def strehl_run():
        strehl, ys = scenes2d.strehl_problem(STREHL_SEGMENTS, STREHL_RAYS,
                                             f32, device)
        xs = torch.as_tensor(scenes2d.strehl_sphere_x(ys), dtype=f32,
                             device=device)
        lam, lr, _ = scenes2d.strehl_stages(STREHL_STEPS)[-1]
        return steps_of(scenes2d.strehl_optimizer(strehl, xs, lam, lr))

    def cooke_run():
        params, step, _ = classical.cooke_design(COOKE_STEPS, device=device)
        return {"losses": [step() for _ in range(n)], "params": params}

    def stepwise_run():
        arc_loss, params = scenes2d.single_arc(device=device, use_kernel=True)
        opt = facade.single_arc_optimizer(arc_loss, params, device)
        return {"losses": [facade.self_scaling_step(opt) for _ in range(n)],
                "params": list(opt.parameters)}

    for label, run in (("asphere singlet", asphere_run),
                       ("config 2", config2_run), ("Strehl lens", strehl_run),
                       ("Cooke triplet", cooke_run),
                       ("stepwise single arc", stepwise_run)):
        twice(label, run)

    # ---- phase 22b's designs
    def rhomb_run():
        stokes = physics2d.rhomb_problem(f32, device)
        theta = torch.tensor(0.80, dtype=f32, device=device)
        losses = []
        for _ in range(n):
            t = theta.detach().requires_grad_(True)
            loss = physics2d.rhomb_loss(stokes, t)
            g, = torch.autograd.grad(loss, t)
            losses.append(loss.detach())
            theta = (t - 0.03 * g).detach()
        return {"losses": losses, "theta": theta}

    def wavefront_run():
        wavefront, _, _ = physics2d.wavefront_problem(device=device)
        return steps_of(physics2d.adam_design(
            physics2d.wavefront_loss(wavefront),
            torch.zeros(65, device=device), 1e-2))

    def achromat_run():
        rays = physics2d.achromat_rays(device=device)
        opt, _ = physics2d.achromat_design(
            physics2d.build_doublet, physics2d.DOUBLET_START, rays, 4, 2e-3,
            10.0)
        return steps_of(opt, momentum=0.9)

    def coating_run():
        d, *rs = physics2d.design_coating(n, f32, device)
        scene, materials = physics2d.coated_lens(f32, device)
        cfg = physics2d._config(scene, 3, device)
        fan = physics2d.white_fan(512, f32, device)
        stack = [(physics2d.N_MGF2, d[0]), (physics2d.N_AL2O3, d[1])]
        with torch.no_grad():
            coated = trace(fan, scene, materials, cfg,
                           reaction=thin_film_intensity_reaction(
                               [stack], {"arcs": torch.tensor(
                                   [0, 0], device=device)}))
        return {"thickness": d, "reflectance": rs,
                "state": coated.rays.state,
                "intensity": coated.rays.fields["intensity"]}

    def spectrometer_run():
        landings = physics2d.spectrometer_problem(f32, device)
        _, opt = physics2d.spectrometer_design(landings, f32, device)
        return steps_of(opt)

    def hybrid_run():
        landings, _ = physics2d.hybrid_problem(device=device)
        return steps_of(physics2d.hybrid_design(landings, True,
                                                device=device))

    def tolerancing_run():
        spot = populations.tolerancing_problem(64, f32, device)
        params = populations.tolerance_design(spot, torch.tensor(
            populations.TOL_START, dtype=f32, device=device), n)
        return {"params": params, "spot_and_gradient":
                populations._gradient(spot, params)}

    def sweep_run():
        loss = populations.sweep_problem(device=device)
        radii = dist._linspace(2.0, 12.0, 64, f32, device)
        losses = populations.population_losses(loss, radii)
        order = torch.argsort(losses, stable=True)
        pop = populations.MomentumPopulation(loss, radii[order[:8]])
        history = []
        for _ in range(n):
            pop.step()
            history.append(pop.params)
        return {"coarse": losses, "params": history}

    for label, run in (("fresnel_rhomb", rhomb_run),
                       ("wavefront_lens", wavefront_run),
                       ("achromat", achromat_run),
                       ("ar_coating", coating_run),
                       ("spectrometer", spectrometer_run),
                       ("hybrid_achromat", hybrid_run),
                       ("tolerancing design", tolerancing_run),
                       ("design_sweep refinement", sweep_run)):
        twice(label, run)

    total = time.perf_counter() - t_phase
    print(f"phase 23 every design path run twice ({n} steps a path, the "
          f"streamed training's {TRAIN_STREAM_STEPS} whole): every step's "
          f"loss, the final parameters, the float32 caustic block image "
          f"(landed {float(image.sum())!r}) and the hexalens image bit for "
          f"bit; K2 launches by path {k2}; seconds by path "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; phase 23 in {total:.1f} s", flush=True)
    return {"K2": sum(k2.values()), "seconds": seconds}


def caustic_block(device, reps=5):
    """One caustic block (``CAUSTIC_BLOCK`` rays, ``CAUSTIC_BOUNCES``
    bounces, the float32 intensity image folded): the median ms of
    ``reps`` synchronised traces after a warm-up, printed with K2's
    launches and the landed sum.  Runs in any checkout that has
    ``scenes3d.CausticRender``, so that a call can time an earlier tree
    beside this one (copied into its root)."""
    import torch

    from tensorflowraytrace_tpu_torch import scenes3d, trace
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

    render = scenes3d.CausticRender(CAUSTIC_BLOCK, CAUSTIC_RES,
                                    CAUSTIC_MESH_STEPS, device=device)
    init, fn = render.fold
    block = render.block(0)
    times = []
    sk.LAUNCHES = 0
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            res = trace(block, render.scene, scenes3d.CAUSTIC_MATERIALS,
                        render.cfg, reaction=render.reaction, fold_fn=fn,
                        fold_init=init, fold_fields=True)
        torch.cuda.synchronize()
        if rep:
            times.append((time.perf_counter() - t0) * 1e3)
    check(float(res.fold.sum()) > 0, "the caustic block landed nothing")
    print(f"caustic block: median {statistics.median(times):.3f} ms over "
          f"{reps} traces {[round(t, 3) for t in times]}; K2 launches "
          f"{sk.LAUNCHES} in {reps + 1} traces; landed "
          f"{float(res.fold.sum())!r}", flush=True)


def dispatch_cost(device):
    """The facade-tax trace (2^17 rays, 12 bounces, K5: launch-bound) and
    one flagship step (2025 rays, K1 and K2) timed by ``interleaved_ms``;
    one JSON line.  Runs in any checkout that has ``facade.py``, so that a
    call can time an earlier tree beside this one (copied into its root)."""
    import torch

    from tensorflowraytrace_tpu_torch import facade, flagship, trace
    from tensorflowraytrace_tpu_torch.optim import Optimizer

    f32 = torch.float32
    system, engine = facade.tax_bench_system(device=device)
    cfg = engine.trace_config(facade.TAX_BOUNCES)
    materials = system.material_callables()

    def tax():
        trace(system.sources, system.scene, materials, cfg)

    vum, acc, smoother = flagship.training_tools(TRAIN_RINGS)
    lens, source, step_loss = flagship._flagship(
        f32, TRAIN_BP, TRAIN_RINGS, TRAIN_BOUNCES, True, device, vum)
    opt = Optimizer(lambda p, g: step_loss(p, source.sample(g, f32, device)),
                    lens.init_params(), learning_rate=1.0, grad_clip=1e-3,
                    generator=torch.Generator(device).manual_seed(0))
    accs = [torch.as_tensor(acc, dtype=f32, device=device)] * 2
    smoothers = [torch.as_tensor(smoother, dtype=f32, device=device)] * 2

    def step():
        opt.run_phase(1, accs, lr_scale=1.0, momentum=0.8,
                      smoothers=smoothers)

    rounds = []
    for _ in range(DISPATCH_ROUNDS):
        rounds.append(interleaved_ms({"tax": tax, "step": step},
                                     n=DISPATCH_TIMED))
    print(json.dumps({"dispatch_cost": {
        name: {"median_ms": statistics.median(r[name] for r in rounds),
               "rounds_ms": [r[name] for r in rounds]}
        for name in ("tax", "step")},
        "root": os.path.dirname(os.path.abspath(__file__))}), flush=True)


def main():
    import torch

    wall_t0 = time.perf_counter()
    phase_s = {}
    phase_end = [wall_t0]

    def done(label):
        """The seconds since the last phase ended, printed and kept."""
        now = time.perf_counter()
        phase_s[label] = round(now - phase_end[0], 1)
        phase_end[0] = now
        print(f"phase {label} seconds {phase_s[label]}", flush=True)
    # ---- phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    device = card()
    print(f"phase 1 device: nvidia-smi: {smi} | torch: {kind} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # imported only now: a directory holding this script alone fails here
    import numpy as np

    from tensorflowraytrace_tpu_torch import FINISHED, Scene3D, TraceConfig, trace
    from tensorflowraytrace_tpu_torch import flagship
    from tensorflowraytrace_tpu_torch.engine import start_epsilon
    from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
    from tensorflowraytrace_tpu_torch.ops import cuda_build
    from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
    from tensorflowraytrace_tpu_torch.ops import materials as mats
    from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
    from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
    from tensorflowraytrace_tpu_torch.optim import Optimizer
    from tensorflowraytrace_tpu_torch.scenes3d import structured_guide

    # ---- phase 2: build, one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = [tk.SOURCE, tk.SOURCE_CULLED, tk.SOURCE_TWOLEVEL, sk.SOURCE,
               gk.SOURCE, gk.SOURCE_CULLED, gk.SOURCE_TWOLEVEL, ak.SOURCE,
               ak.SOURCE_CULLED, ak.SOURCE_TWOLEVEL]
    reports = cuda_build.build(sources, verbose=True)
    for source, report in reports.items():
        print(f"phase 2 nvcc {source}:\n{report.strip()}", flush=True)
    for mod in (tk, gk, ak):
        mod.load_library()
        mod.load_culled_library()
        mod.load_twolevel_library()
    sk.load_library()
    print(f"phase 2 build: "
          + " ".join(cuda_build.library_path(s).name for s in sources)
          + f" in {time.perf_counter() - t0:.2f} s", flush=True)
    done("1-2")
    if "--tune" in sys.argv[1:]:
        segsum_variants(device)
        tune_brute(device)
        tune_twolevel(device)
        tune_culled_2d(device)
        tune_twolevel_2d(device)
        return 0
    if "--tune-rows" in sys.argv[1:]:
        segsum_variants(device, SEGSUM_ROW_VARIANTS, SEGSUM_ROW_TIMED)
        return 0
    if "--arcs-alone" in sys.argv[1:]:
        arcs_alone(device)
        return 0
    if "--segsum-alone" in sys.argv[1:]:
        segsum_alone(device)
        return 0
    if "--export-programs" in sys.argv[1:]:
        export_all(device)
        return 0
    if "--caustic-block" in sys.argv[1:]:
        caustic_block(device)
        return 0
    if "--dispatch-cost" in sys.argv[1:]:
        dispatch_cost(device)
        return 0

    # ---- phase 3: K1 against its plain version
    rays, scene = soup_scene(K1_RAYS, device)
    tri = scene.triangles
    check(tri.n_surfaces == N_SOUP_TRIS + 2, "soup size")
    k1_err = compare_k1("soup", rays.p0, rays.p1, tri.vp, tri.v1, tri.v2)
    compare_k1("ragged", rays.p0[:1000], rays.p1[:1000], tri.vp[:333],
               tri.v1[:333], tri.v2[:333])
    far = torch.full_like(rays.p0[:4096], 1000.0)
    compare_k1("all-miss", far, far + 1.0, tri.vp, tri.v1, tri.v2)
    f_lens, f_source, _ = flagship._flagship(
        torch.float32, 32, 8, 4, True, device)
    f_rays = f_source.sample(torch.Generator(device=device).manual_seed(0),
                             torch.float32, device)
    f_tri = Scene3D.build(optical=f_lens.build(),
                          targets=[flagship.target_plane(torch.float32,
                                                         device)]).triangles
    compare_k1("flagship", f_rays.p0, f_rays.p1, f_tri.vp, f_tri.v1, f_tri.v2)
    # every third ray parked (p0 = 1e30, as the engine parks terminated
    # rays), the count cut to no multiple of a block's rays
    for label, r0, r1, t, n_cut in (
            ("flagship", f_rays.p0, f_rays.p1, f_tri, 1021),
            ("soup", rays.p0, rays.p1, tri, K1_RAYS - 37)):
        third = (torch.arange(r0.shape[0], device=device) % 3 == 0)[:, None]
        q0 = torch.where(third, torch.full_like(r0, 1e30), r0)
        q1 = torch.where(third, torch.full_like(r1, 1e30 * (1 + 1e-6)), r1)
        compare_k1(f"{label} parked and ragged", q0[:n_cut], q1[:n_cut],
                   t.vp, t.v1, t.v2)
    parked = torch.full_like(rays.p0[:4096], 1e30)
    compare_k1("parked", parked, torch.full_like(parked, 1e30 * (1 + 1e-6)),
               tri.vp, tri.v1, tri.v2)

    # K3 and K4 against their plain versions and K1
    rays, scene = soup_scene(K1_RAYS, device, sort=True)
    tri = scene.triangles
    compare_culled("sorted soup", rays.p0, rays.p1, tri.vp, tri.v1, tri.v2)
    g_rays, g_scene = structured_guide(GUIDE_RAYS, device=device)
    g_tri = g_scene.triangles
    check(g_tri.n_surfaces == 16386, f"guide has {g_tri.n_surfaces} triangles")
    compare_culled("guide first bounce", g_rays.p0[:CULL_RAYS],
                   g_rays.p1[:CULL_RAYS], g_tri.vp, g_tri.v1, g_tri.v2)
    compare_culled("ragged", rays.p0[:1000], rays.p1[:1000], tri.vp[:333],
                   tri.v1[:333], tri.v2[:333])
    far = torch.full_like(rays.p0[:4096], 1000.0)
    compare_culled("all-miss", far, far + 1.0, tri.vp, tri.v1, tri.v2)
    parked = torch.full_like(rays.p0[:4096], 1e30)
    compare_culled("parked", parked,
                   torch.full_like(parked, 1e30 * (1 + 1e-6)), tri.vp, tri.v1,
                   tri.v2)
    cap, tk.TWOLEVEL_MAX_CAND = tk.TWOLEVEL_MAX_CAND, 1  # every block sweeps
    try:
        compare_culled("forced overflow", g_rays.p0[:CULL_RAYS],
                       g_rays.p1[:CULL_RAYS], g_tri.vp, g_tri.v1, g_tri.v2)
    finally:
        tk.TWOLEVEL_MAX_CAND = cap
    del rays, scene, tri

    done("3")

    # ---- phase 4: the flagship forward, through the kernel
    forward, (params, generator) = flagship.entry(device=device)
    tk.LAUNCHES = 0
    loss = forward(params, generator)
    torch.cuda.synchronize()
    forward_launches = tk.LAUNCHES
    check(forward_launches == 4,
          f"flagship launched the kernel {forward_launches} times, not 4")
    check(bool(torch.isfinite(loss)), f"flagship loss is {loss.item()}")
    loss.backward()
    check(all(bool(torch.isfinite(p.grad).all()) for p in params),
          "flagship gradient is not finite")
    forward_p, (params_p, generator_p) = flagship.entry(device=device,
                                                        use_kernel=False)
    loss_p = forward_p(params_p, generator_p)
    rel = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
    check(rel <= 1e-4, f"flagship loss {loss.item()} vs plain {loss_p.item()}")
    print(f"phase 4 flagship: loss={loss.item()!r} plain_loss={loss_p.item()!r} "
          f"rel_diff={rel:.3e} launches={forward_launches}", flush=True)

    done("4")

    # ---- phase 5: the bench-scale trace
    rays, scene = soup_scene(BENCH_RAYS, device)
    n, m = rays.n_rays, scene.triangles.n_surfaces
    materials = (mats.vacuum, mats.reflective)
    cfgs = {"kernel": TraceConfig(max_bounces=BENCH_BOUNCES, use_kernel=True),
            "plain": TraceConfig(max_bounces=BENCH_BOUNCES)}
    times = {k: [] for k in cfgs}
    counts = {}
    tk.LAUNCHES = 0
    reps = {"kernel": 5, "plain": PLAIN_TRACE_TIMED}
    for rep in range(6):  # rep 0 warms up and gives the state counts
        for name, cfg in cfgs.items():
            if rep > reps[name]:
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = trace(rays, scene, materials, cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if rep == 0:
                counts[name] = state_counts(res.rays.state)
                check(bool(torch.isfinite(res.rays.p1).all()),
                      f"{name} trace has non-finite endpoints")
            else:
                times[name].append(dt)
    check(tk.LAUNCHES == 6 * BENCH_BOUNCES,
          f"bench trace launched the kernel {tk.LAUNCHES} times")
    worst = max(abs(a - b) for a, b in zip(counts["kernel"], counts["plain"]))
    check(worst <= 1e-3 * n,
          f"state counts differ: kernel {counts['kernel']} plain {counts['plain']}")
    pairs = n * m * BENCH_BOUNCES
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"phase 5 trace: N={n} M={m} bounces={BENCH_BOUNCES} "
          f"states[active,finished,stopped,dead] kernel={counts['kernel']} "
          f"plain={counts['plain']} finished={counts['kernel'][FINISHED]}",
          flush=True)
    for k in cfgs:
        print(f"phase 5 {k} path: median {med[k] * 1e3:.3f} ms over "
              f"{reps[k]} runs "
              f"{[round(t * 1e3, 3) for t in times[k]]} = "
              f"{pairs / med[k]:.4e} intersections/s", flush=True)

    # K1 alone at the bench shape (the first bounce's search)
    args = [t.contiguous() for t in (rays.p0, rays.p1, scene.triangles.vp,
                                     scene.triangles.v1, scene.triangles.v2)]
    k1_ms = cuda_ms(lambda: tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS), 20)
    k1_plain_ms = cuda_ms(lambda: tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS), 3)
    k1_flat_ms, k1_bound_ms, k1_tu_out = k1_bounds(*args)
    rpt = tk.brute_rays_per_thread(n, device)
    branch, ray_half = k1_branch_shares(*args, rpt)
    print(f"phase 5 K1 search {n}x{m}: kernel {k1_ms:.4f} ms at "
          f"{rpt} rays a thread (its branch taken on {branch:.4%} of "
          f"(warp, triangle) steps, a ray's second half run on "
          f"{ray_half:.4%}), plain "
          f"{k1_plain_ms:.4f} ms; bound {k1_bound_ms:.4f} ms (operations; "
          f"{k1_tu_out} of {n * m} pairs, {k1_tu_out / (n * m):.4%}, out on "
          f"tu; without FMAs {2 * k1_bound_ms:.4f} ms), flat "
          f"{K1_FLOPS_PER_PAIR}-operation bound {k1_flat_ms:.4f} ms (without "
          f"FMAs {2 * k1_flat_ms:.4f} ms)", flush=True)
    del rays, scene, res, args

    done("5")

    # ---- phase 6: K2 against its plain version, float32 and float64
    k2 = phase_6(device)
    done("6")

    # ---- phase 7: the flagship's training routine, example scale
    tk.LAUNCHES = sk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errors, trained = flagship.train(steps=TRAIN_STEPS, bp_count=TRAIN_BP,
                                     mesh_steps=TRAIN_RINGS,
                                     max_bounces=TRAIN_BOUNCES, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {"K1": tk.LAUNCHES, "K2": sk.LAUNCHES}
    for name, count in train_launches.items():
        check(count == TRAIN_BOUNCES * TRAIN_STEPS,
              f"training launched {name} {count} times, not "
              f"{TRAIN_BOUNCES} per step")
    check(len(errors) == TRAIN_STEPS and np.all(np.isfinite(errors)),
          "training errors are not finite")
    check(all(bool(torch.isfinite(p).all()) for p in trained),
          "trained parameters are not finite")
    first, last = float(np.mean(errors[:10])), float(np.mean(errors[-10:]))
    check(last < first, f"training error did not fall: {first} -> {last}")
    print(f"phase 7 train: {TRAIN_STEPS} steps of {TRAIN_BP ** 2} rays, "
          f"{TRAIN_BOUNCES} bounces, in {train_s:.3f} s = "
          f"{train_s / TRAIN_STEPS * 1e3:.3f} ms/step; launches "
          f"{train_launches}; mean error first 10 {first!r} last 10 {last!r}",
          flush=True)
    print("phase 7 error every 10 steps: "
          + " ".join(f"{i}:{errors[i]:.6g}" for i in range(0, TRAIN_STEPS, 10))
          + f" {TRAIN_STEPS - 1}:{errors[-1]:.6g}", flush=True)

    done("7")

    # ---- phase 8: one training step at bench width
    f32 = torch.float32
    vum, acc, smoother = flagship.training_tools(TRAIN_RINGS)
    lens, source, wide_loss = flagship._flagship(
        f32, WIDE_BP, TRAIN_RINGS, TRAIN_BOUNCES, True, device, vum)

    def error(params, gen):
        return wide_loss(params, source.sample(gen, f32, device))

    opt = Optimizer(error, lens.init_params(), learning_rate=1.0,
                    grad_clip=1e-3,
                    generator=torch.Generator(device).manual_seed(0))
    accs = [torch.as_tensor(acc, dtype=f32, device=device)] * 2
    smoothers = [torch.as_tensor(smoother, dtype=f32, device=device)] * 2

    def step():
        return opt.run_phase(1, accs, lr_scale=1.0, momentum=0.8,
                             smoothers=smoothers)

    step()  # warm-up
    step_s = []
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    step_med = statistics.median(step_s)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    by_name, union_us, n_device = device_profile(prof)
    busy_us = sum(by_name.values())

    def busy(part):
        return sum(t for name, t in by_name.items() if part in name)

    if busy_us > 0:
        shares = (f"device busy {union_us:.1f} us of {prof_wall_us:.1f} us wall "
                  f"(idle share {1 - union_us / prof_wall_us:.4f}); "
                  f"{n_device} kernels and copies, {busy_us:.1f} us; K2 "
                  f"{busy('segment_sum'):.1f} us = "
                  f"{busy('segment_sum') / busy_us:.4%}, K1 "
                  f"{busy('triangle_search'):.1f} us = "
                  f"{busy('triangle_search') / busy_us:.4%}; top: "
                  + "; ".join(f"{name[:60]} {t:.1f} us"
                              for name, t in by_name.most_common(6)))
    else:
        shares = "the profiler recorded no device time: shares not measured"

    # host synchronisations in one step (the step's final read of its error
    # is one of them) and in the ray sampling it starts with
    syncs = count_syncs(step)
    sample_syncs = count_syncs(lambda: source.sample(opt.generator, f32, device))

    # the gradient through K2 against the plain backward of the same forward
    rays = source.sample(torch.Generator(device).manual_seed(1), f32, device)

    def value_and_grad():
        leaves = [p.detach().clone().requires_grad_(True) for p in opt.parameters]
        value = wide_loss(leaves, rays)
        return value.detach(), torch.autograd.grad(value, leaves)

    sk.LAUNCHES = 0
    loss_k, grad_k = value_and_grad()
    check(sk.LAUNCHES == TRAIN_BOUNCES, f"K2 launched {sk.LAUNCHES} times")
    kernel_backward = sk.segment_sum_kernel
    sk.segment_sum_kernel = sk.segment_sum_plain  # the same forward, plain backward
    try:
        loss_p, grad_p = value_and_grad()
    finally:
        sk.segment_sum_kernel = kernel_backward
    check(sk.LAUNCHES == TRAIN_BOUNCES, "the plain backward launched K2")
    gmax = max(float(g.abs().max()) for g in grad_p)
    gdiff = max(float((a - b).abs().max()) for a, b in zip(grad_k, grad_p))
    # K2 adds in its plain version's order: the same bits
    check(gmax > 0 and bool(loss_k == loss_p)
          and grads_same_bits(grad_k, grad_p),
          f"K2 gradient differs from the plain backward by {gdiff} (max {gmax})")
    _, _, plain_loss = flagship._flagship(f32, WIDE_BP, TRAIN_RINGS,
                                          TRAIN_BOUNCES, False, device, vum)
    with torch.no_grad():
        loss_all_plain = plain_loss(opt.parameters, rays)
    rel = abs(float(loss_k) - float(loss_all_plain)) / abs(float(loss_all_plain))
    check(rel <= 1e-4, f"bench-width loss {float(loss_k)} vs all-plain "
          f"{float(loss_all_plain)}")
    print(f"phase 8 bench-width step: {WIDE_BP ** 2} rays, {TRAIN_BOUNCES} "
          f"bounces: median {step_med * 1e3:.3f} ms over 5 steps "
          f"{[round(t * 1e3, 3) for t in step_s]}; peak device memory "
          f"{peak_gib:.3f} GiB; {syncs} synchronising calls per step, "
          f"{sample_syncs} of them in the ray sampling; "
          f"{shares}", flush=True)
    print(f"phase 8 gradient: through K2 and through the plain backward bit "
          f"for bit (max |g_K2 - g_plain| = {gdiff!r}), max |g_plain| = "
          f"{gmax!r}; loss {float(loss_k)!r}, "
          f"all-plain loss {float(loss_all_plain)!r}, rel {rel:.3e}", flush=True)

    done("8")

    # ---- phase 9: the sorted soup through the accelerated paths
    launched = {}
    rays, scene = soup_scene(BENCH_RAYS, device, sort=True)
    soup_med, _ = accel_paths("phase 9 soup", rays, scene,
                              (mats.vacuum, mats.reflective), BENCH_BOUNCES,
                              launched)
    del rays, scene

    done("9")

    # ---- phase 10: the structured guide, children starting the card's
    # float32 ray_start_epsilon past their surface (TraceConfig.recommended)
    g_mats = (mats.vacuum, mats.acrylic)
    g_med, g_states = accel_paths("phase 10 guide", g_rays, g_scene, g_mats,
                                  GUIDE_BOUNCES, launched)
    n, m = g_rays.n_rays, g_tri.n_surfaces
    print(f"phase 10 ray_start_epsilon {start_epsilon(g_scene)!r}; table "
          "(median ms per "
          "trace): " + "; ".join(f"{k}: soup {soup_med[k] * 1e3:.3f}, guide "
                                 f"{g_med[k] * 1e3:.3f}" for k in g_med),
          flush=True)

    # K1, K3 and K4 alone at the guide's first bounce, the rays in the
    # Morton order the re-sort gives them
    args = first_bounce_3d(g_rays, g_tri)
    k1_out = tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
    u_final = k1_out[2]
    brute_bound_ms = n * m * K1_FLOPS_PER_PAIR / PEAK_FP32_FLOP_S * 1e3
    # K4's kernel alone, after its inputs are prepared
    prepared = tk.twolevel_prepare(*args, EPS, EPS)
    k4_kernel_ms = cuda_ms(lambda: tk.twolevel_launch(
        args[0], args[1], m, prepared, EPS, EPS, EPS), 10)
    prepare_ms = cuda_ms(lambda: tk.twolevel_prepare(*args, EPS, EPS), 10)
    counts = prepared[2]
    print(f"phase 10 K4 at the first bounce: kernel alone {k4_kernel_ms:.4f} "
          f"ms, its input preparation (boxes, candidates, table) "
          f"{prepare_ms:.4f} ms; ray block {tk.TWOLEVEL_RAY_BLOCK}, fine "
          f"chunk {tk.FINE_CHUNK}, cap {prepared[4]}: {counts.shape[0]} "
          f"blocks, {int((counts == prepared[1].shape[0]).sum())} overflow, "
          f"mean count {float(counts.float().mean()):.2f}", flush=True)
    del prepared, counts
    k1_guide_ms = cuda_ms(
        lambda: tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS), 10)
    _, k1_guide_bound_ms, k1_guide_tu_out = k1_bounds(*args)
    rpt = tk.brute_rays_per_thread(n, device)
    branch, ray_half = k1_branch_shares(*args, rpt)
    print(f"phase 10 K1 alone at the first bounce {n}x{m}: kernel "
          f"{k1_guide_ms:.4f} ms at {rpt} rays a thread (its branch taken "
          f"on {branch:.4%} of (warp, triangle) steps, a ray's second half "
          f"run on {ray_half:.4%}); bound {k1_guide_bound_ms:.4f} ms "
          f"(operations; "
          f"{k1_guide_tu_out} of {n * m} pairs, "
          f"{k1_guide_tu_out / (n * m):.4%}, out on tu; without FMAs "
          f"{2 * k1_guide_bound_ms:.4f} ms), flat {K1_FLOPS_PER_PAIR}-"
          f"operation bound {brute_bound_ms:.4f} ms (without FMAs "
          f"{2 * brute_bound_ms:.4f} ms)", flush=True)
    # one bound for K3 and K4: the pairs these inputs need, at the finer of
    # their chunks, those refused on tu at their cost so far
    bound_chunk = min(tk.CULL_CHUNK, tk.FINE_CHUNK)
    pairs, tu_out = triangle_pairs(*args, u_final, bound_chunk)
    culled_bound_ms = ((pairs - tu_out) * K1_FLOPS_PER_PAIR
                       + tu_out * TU_FLOPS_PER_PAIR) / PEAK_FP32_FLOP_S * 1e3
    alone = {}
    for name, fn, plain in (
            ("K3", tk.nearest_hit_triangles_culled_kernel,
             tk.nearest_hit_triangles_culled_plain),
            ("K4", tk.nearest_hit_triangles_twolevel_kernel,
             tk.nearest_hit_triangles_twolevel_plain)):
        out = {}
        ms = cuda_ms(lambda: out.update(got=fn(*args, EPS, EPS, EPS)), 10)
        plain_ms = cuda_ms(lambda: out.update(plain=plain(*args, EPS, EPS, EPS)),
                           1)
        err, report = culled_agreement(name, out["got"], out["plain"], k1_out)
        alone[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
        print(f"phase 10 {name} alone at the first bounce {n}x{m}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms; {report}; admitted "
              f"pairs {pairs} at {bound_chunk}-triangle chunks "
              f"({pairs / (n * m):.4%} of brute; {tu_out / pairs:.4%} of "
              f"them out on tu), bound "
              f"{culled_bound_ms:.4f} ms (operations; without FMAs "
              f"{2 * culled_bound_ms:.4f} ms; brute bound "
              f"{brute_bound_ms:.4f} ms)", flush=True)
    del args, u_final, k1_out, out

    # the cull=True + re-sort trace (recommended's) and the grid + re-sort
    # trace: device time, memory and syncs
    g_cfgs = accel_configs(GUIDE_BOUNCES, g_scene)
    for label, kernel in (("cull+resort", "triangle_search_culled"),
                          ("grid+resort", "triangle_search_twolevel")):
        profile_guide3d(label, kernel, g_rays, g_scene, g_mats, g_cfgs[label],
                        device)

    done("10")

    # ---- phases 11-14: the 2D path
    phase_11(device)
    done("11")
    arc_train = phase_12(device)
    done("12")
    k2d = phase_13(device)
    done("13")
    design = phase_14(device)
    done("14")
    k2_device_times(k2, device)
    done("6 device times")

    # ---- phase 15: the point-source trace and the hexalens, K1 and K2
    hexa = phase_15(device)
    done("15")

    # ---- phase 16: streaming and data parallelism
    stream16 = phase_16(device)
    done("16")

    # ---- phase 17: the reactions (caustic, stray light, ghosts)
    react17 = phase_17(device)
    done("17")

    # ---- phase 18: the designs (asphere singlet, config 2, Strehl lens),
    # the image quality through STL, the remesh
    design18 = phase_18(device)
    done("18")

    # phase 21b's programs are exported by a process of its own, whose
    # host tracing runs beside phases 19 and 20
    exporter = start_exporter()
    try:
        # ---- phase 19: the classical lens design (sequential against
        # mesh, the Cooke triplet, the lens report, the best-form singlet)
        classical19 = phase_19(device)
        done("19")

        # ---- phase 20: the stateful facade, the checkpoint and the goals
        facade20 = phase_20(device)
        done("20")

        # ---- phase 21: export (every kernel through its tfrt_torch
        # operator from a loaded program), profiling, drawing
        export21 = phase_21(device, exporter)
        done("21")
    finally:
        if exporter.poll() is None:
            exporter.kill()
            exporter.wait()

    # ---- phase 22: the last examples (the reaction designs, tolerancing
    # and the design sweep, the source demos, guide_trace_bench)
    examples22 = phase_22(device)
    done("22")

    # ---- phase 23: every design path run twice, bit for bit
    repeat23 = phase_23(device)
    done("23")

    def by_example(key):
        per = {k: v[key] for k, v in examples22.items() if v[key]}
        return {"launches_examples": sum(per.values()),
                "launches_examples_by_example": per}

    main_k2 = k2["flagship_bench"]
    print(f"chip_smoke wall time {time.perf_counter() - wall_t0:.1f} s; "
          f"seconds by phase {json.dumps(phase_s)}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "triangle_search", "route": "cuda",
        "source": "tensorflowraytrace_tpu_torch/csrc/triangle_search.cu",
        "replaces": "tensorflowraytrace_tpu/ops/pallas_kernels.py:76",
        "launches": train_launches["K1"], "launches_forward": forward_launches,
        "launches_hexalens": hexa["K1"], "launches_trace_3d": hexa["K1_trace_3d"],
        "launches_streamed_training": stream16["K1_train"],
        "launches_sharded": stream16["K1_sharded"],
        "launches_caustic": react17["K1_caustic"],
        "launches_image_quality": design18["image_quality"],
        "launches_sequential_vs_mesh": classical19["K1"],
        "launches_facade": facade20["K1"],
        "launches_export": export21["K1"], **by_example("K1"),
        "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound_ms, "bound_by": "operations", "library_ms": None,
        "floor_no_fma_ms": 2 * k1_bound_ms, "pairs_out_on_tu": k1_tu_out,
        "flat_bound_ms": k1_flat_ms, "flat_floor_no_fma_ms": 2 * k1_flat_ms,
        "shape": f"{BENCH_RAYS}x{N_SOUP_TRIS + 2}",
        "guide_ms": k1_guide_ms, "guide_bound_ms": k1_guide_bound_ms,
        "guide_flat_bound_ms": brute_bound_ms,
        "guide_pairs_out_on_tu": k1_guide_tu_out,
        "guide_shape": f"{n}x{m} (first bounce of the guide)",
    }, {
        "name": "segment_sum", "route": "cuda",
        "source": "tensorflowraytrace_tpu_torch/csrc/segment_sum.cu",
        "replaces": "tensorflowraytrace_tpu/ops/pallas_kernels.py:1664",
        "launches": train_launches["K2"], "launches_hexalens": hexa["K2"],
        "launches_streamed_training": stream16["K2_train"],
        "launches_sharded": stream16["K2_sharded"],
        **{f"launches_{k}": design18[k]["K2"]
           for k in ("asphere", "config2", "strehl")},
        "launches_facade": facade20["K2"],
        "launches_export": export21["K2"], **by_example("K2"),
        "launches_caustic_histograms": react17["K2_caustic"],
        "launches_repeat": repeat23["K2"],
        "max_abs_err": main_k2["max_abs_err"], "ms": main_k2["ms"],
        "device_ms": main_k2["device_ms"],
        "plain_ms": main_k2["plain_ms"], "bound_ms": main_k2["bound_ms"],
        "bound_by": main_k2["bound_by"], "library_ms": main_k2["library_ms"],
        "shape": f"{main_k2['k']}x{main_k2['n']}->{main_k2['m']}x"
                 f"{main_k2['k']}",
        "library_deterministic_ms": main_k2["library_deterministic_ms"],
        "order": "fixed: tiles of 1024 rays, each row's rays in order, "
                 "then its tile sums in order; bit for bit with the plain "
                 "version and from launch to launch, float32 and float64",
        "timed": {label: {key: f[key] for key in (
            "n", "m", "k", "ms", "device_ms", "plain_ms", "library_ms",
            "library_deterministic_ms", "bound_ms", "bound_by",
            "max_abs_err", "dtype")}
            for label, f in k2.items()},
    }] + [{
        "name": name, "route": "cuda",
        "source": f"tensorflowraytrace_tpu_torch/csrc/{source}",
        "replaces": f"tensorflowraytrace_tpu/ops/pallas_kernels.py:{line}",
        "launches": launched[key], "max_abs_err": alone[key]["max_abs_err"],
        "ms": k4_kernel_ms if key == "K4" else alone[key]["ms"],
        "wrapper_ms": alone[key]["ms"], "plain_ms": alone[key]["plain_ms"],
        "bound_ms": culled_bound_ms, "bound_by": "operations",
        "floor_no_fma_ms": 2 * culled_bound_ms,
        "brute_bound_ms": brute_bound_ms, "library_ms": None,
        "shape": f"{n}x{m} (first bounce of the guide)",
        "pairs": pairs, "pairs_out_on_tu": tu_out,
        **({"launches_streamed_trace": stream16["K3_stream"],
            "caustic_ms": react17["K3_caustic_ms"],
            "caustic_bound_ms": react17["K3_caustic_bound_ms"],
            "caustic_pairs": react17["K3_caustic_pairs"],
            "caustic_shape": f"{CAUSTIC_BLOCK}x{CAUSTIC_TRIANGLES} (first "
                             f"bounce of a caustic block)"}
           if key == "K3" else {}),
        "launches_caustic": react17[f"{key}_caustic"],
        "launches_sequential_vs_mesh": classical19[key],
        "launches_export": export21[key], **by_example(key),
    } for name, source, line, key in (
        ("triangle_search_culled", tk.SOURCE_CULLED, 144, "K3"),
        ("triangle_search_twolevel", tk.SOURCE_TWOLEVEL, 979, "K4"))] + [{
        "name": name, "route": "cuda",
        "source": f"tensorflowraytrace_tpu_torch/csrc/{source}",
        "replaces": f"tensorflowraytrace_tpu/ops/pallas_kernels.py:{line}",
        **k2d[key], "library_ms": None, "launches_export": export21[key],
        **({"launches_training": arc_train[key]} if key in arc_train else {}),
        **({"launches_design": design[key]} if key in design else {}),
        **({"launches_stray_light": react17[f"{key}_stray"],
            "launches_ghost": react17[f"{key}_ghost"],
            "launches_facade": facade20[key]}
           if key in ("K5", "K6") else {}),
        **({f"launches_{k}": design18[k]["K5"]
            for k in ("asphere", "config2", "strehl")}
           if key == "K5" else {}),
        **(by_example(key) if key in ("K5", "K6") else {}),
    } for name, source, line, key in (
        ("segment_search", gk.SOURCE, 705, "K5"),
        ("arc_search", ak.SOURCE, 367, "K6"),
        ("segment_search_culled", gk.SOURCE_CULLED, 745, "K7"),
        ("arc_search_culled", ak.SOURCE_CULLED, 454, "K8"),
        ("segment_search_twolevel", gk.SOURCE_TWOLEVEL, 1230, "K9"),
        ("arc_search_twolevel", ak.SOURCE_TWOLEVEL, 1322, "K10"))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
