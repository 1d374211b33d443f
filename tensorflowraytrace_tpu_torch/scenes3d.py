"""The 3D scenes of the examples: the point source through a curved lens
and past a mirror sphere onto a target plane, and the pool caustic.

Counterpart of ``examples/trace_3d.py`` (the reference's dev/3d_trace.py),
without its drawing: 200 rays of a ``StaticUniformSphere`` cap of half-angle
pi/24 from (-3, 0, 0) along +x at 575 nm, through a lens on a 6-ring
hexagonal mesh of radius 1 at x = 0 bent to the profile 0.3 (1 - r^2)
(acrylic inside), past a 12-ring mirror sphere of radius 0.5 at (2, 0, 2)
(acrylic inside, as in the example), onto a 40 x 40 target at x = 6;
4 bounces with the per-bounce history kept.

    res = trace_3d()                  # engine.TraceResult

It runs on CUDA unless given ``device=``, with the CUDA kernels there
(``use_kernel=None``), and in float32 unless given ``dtype=``.

The pool caustic, ``examples/caustic_render.py`` at its defaults:
collimated sunlight (2^27 rays in blocks of 2^22, 550 nm, over a 6.4 x
6.4 square at z = 1, straight down) refracts through a wavy air -> water
surface (``hexagonal_mesh(4.6, 144)`` lifted by three plane waves of
amplitude 0.08: 124,416 triangles, Morton-sorted) onto the pool floor at
z = -3 (2 triangles), 2 bounces in float32 under
``TraceConfig.recommended`` (on the card: ``cull=True`` with the re-sort,
K3).  Each landing is weighted by its Fresnel transmission
(``operations.fresnel_intensity_reaction``) into a 512 x 512 image
(``landing_histogram_fold(weight_field="intensity")``) streamed by
``trace_streamed``; the mean landed weight must lie within 0.02 of the
normal-incidence transmission 1 - (1/7)^2.

    out = caustic_render()            # image, state counts, seconds

The image-quality test of a finished lens, ``examples/image_quality_3d.py``:
the hexalens's two designed surfaces (``hexalens.train``) exported as STL
(``export_boundary_stl``, under build/ unless told otherwise), loaded back
as static surfaces (``manual_triangle_boundary``) in front of a 100 x 100
target at x = 10, and ``analysis.imaging_test`` of 20 batches of 4000
rays from the object disk to the lens wedge (575 nm, 3 bounces,
``TraceConfig.recommended``): the landing histogram and the flux of its
two images.

    out = image_quality_3d()          # histogram, landed rays, fluxes

And ``examples/remesh.py``: a bumpy coarse mesh re-meshed onto a regular
one on the host (``planar_interpolated_remesh``), the flattened mesh and
its initial parameters built into a ``ParametricTriangleBoundary`` on the
device.

And ``examples/mesh_graph_tools.py``: a hexagonal mesh's vertex
relationships from its centre, its breadth-first generations, the
gradient accumulator (a unit gradient on the centre reaches every vertex,
one on the rim only itself) and the smoother (a spike relaxes), on the
host; the four panels drawn when given a path.

    out = mesh_graph_tools("mesh_graph_tools.png")

And ``examples/guide_trace_bench.py``: ``bench.py``'s structured guide
(``structured_guide``: 16,386 triangles, 2^20 rays) traced 24 bounces
deep through the ``"grid"`` + re-sort (K4), ``cull=True`` ± re-sort (K3)
and brute (K1) searches, each timed, their checksums equal.

    out = guide_trace_bench()         # ms, rates and checksums by mode
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from tensorflowraytrace_tpu_torch import analysis
from tensorflowraytrace_tpu_torch.drawing import figure, host_array
from tensorflowraytrace_tpu_torch.config import FINISHED, resolve_device
from tensorflowraytrace_tpu_torch.engine import (
    TraceConfig, landing_histogram_fold, start_epsilon, trace, trace_streamed,
)
from tensorflowraytrace_tpu_torch.models import boundaries as bd
from tensorflowraytrace_tpu_torch.models import distributions as dist
from tensorflowraytrace_tpu_torch.models import mesh as mt
from tensorflowraytrace_tpu_torch.models import sources as src
from tensorflowraytrace_tpu_torch.models.acceleration import morton_sort_triangles
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import Scene3D, TriangleSet
from tensorflowraytrace_tpu_torch.operations import fresnel_intensity_reaction
from tensorflowraytrace_tpu_torch.ops import materials as mats
from tensorflowraytrace_tpu_torch.ops.spectrum import YELLOW
from tensorflowraytrace_tpu_torch.streamed import fold_in

PI = math.pi
MATERIALS = (mats.vacuum, mats.acrylic)
SAMPLE_COUNT = 200


def sphere_mesh(center, radius, n=12) -> mt.TriMesh:
    """A UV sphere: n - 1 rings of 2n points between two poles on the x
    axis, the poles fanned to the first and last rings."""
    pts = []
    faces = []
    for i in range(1, n):
        phi = PI * i / n
        for j in range(2 * n):
            theta = PI * j / n
            pts.append([radius * math.cos(phi),
                        radius * math.sin(phi) * math.cos(theta),
                        radius * math.sin(phi) * math.sin(theta)])
    top = len(pts)
    pts.append([radius, 0.0, 0.0])
    bot = len(pts)
    pts.append([-radius, 0.0, 0.0])
    ring = 2 * n
    for j in range(ring):
        faces.append([top, j, (j + 1) % ring])
        base = (n - 2) * ring
        faces.append([bot, base + (j + 1) % ring, base + j])
    for i in range(n - 2):
        for j in range(ring):
            a = i * ring + j
            b = i * ring + (j + 1) % ring
            c = (i + 1) * ring + j
            d = (i + 1) * ring + (j + 1) % ring
            faces.append([a, b, c])
            faces.append([b, d, c])
    return mt.TriMesh(np.asarray(pts) + np.asarray(center), np.asarray(faces))


def point_source_scene(max_bounces=4, keep_history=True, dtype=torch.float32,
                       device=None, use_kernel=None):
    """The scene, its rays and its trace configuration:
    ``(rays, scene, cfg)``.  ``use_kernel=None`` takes the CUDA kernels on
    a CUDA device; a float32 scene on the card starts children
    ``engine.start_epsilon`` past their surface."""
    device = resolve_device(device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    disk = mt.hexagonal_mesh(1.0, 6)
    disk.points = disk.points[:, [2, 0, 1]]
    lens_b = bd.ParametricTriangleBoundary(
        disk, bd.FromVectorVG((1.0, 0.0, 0.0)), mat_in=1, mat_out=0,
        dtype=dtype, device=device)
    r2 = np.linalg.norm(lens_b.zero.cpu().numpy()[:, 1:], axis=1) ** 2
    lens = lens_b.build(torch.as_tensor(0.3 * (1 - r2), dtype=dtype,
                                        device=device))  # a convex profile

    mirror_mesh = sphere_mesh((2.0, 0.0, 2.0), 0.5)
    corners = mirror_mesh.points[mirror_mesh.faces]
    mirror = TriangleSet.make(corners[:, 0], corners[:, 1], corners[:, 2],
                              mat_in=1, mat_out=0, dtype=dtype, device=device)

    half = 20.0
    target = TriangleSet.make(
        [[6.0, -half, -half], [6.0, half, half]],
        [[6.0, half, -half], [6.0, -half, half]],
        [[6.0, half, half], [6.0, -half, -half]], dtype=dtype, device=device)
    scene = Scene3D.build(optical=[lens, mirror], targets=[target])

    source = src.PointSource(3, (-3.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                             dist.StaticUniformSphere(PI / 24, SAMPLE_COUNT),
                             [YELLOW])
    rays = source.sample(dtype=dtype, device=device)
    cfg = TraceConfig(max_bounces=max_bounces, keep_history=keep_history,
                      use_kernel=use_kernel,
                      ray_start_epsilon=start_epsilon(scene))
    return rays, scene, cfg


def trace_3d(max_bounces=4, keep_history=True, dtype=torch.float32,
             device=None, use_kernel=None):
    """Trace the scene of :func:`point_source_scene`; returns the
    ``engine.TraceResult``."""
    rays, scene, cfg = point_source_scene(max_bounces, keep_history, dtype,
                                          device, use_kernel)
    return trace(rays, scene, MATERIALS, cfg)


# ======================================================================
# examples/caustic_render.py
# ======================================================================

N_WATER = 4.0 / 3.0
CAUSTIC_SEED = 20260818
CAUSTIC_MATERIALS = (mats.vacuum, mats.build_constant_material(N_WATER))
# the square of the sun's rays, and the image's extent
SUN_HALF = 3.2
POOL_HALF = 3.6
# the Fresnel transmission of water at normal incidence, 1 - (1/7)^2
T_NORMAL = 1.0 - ((N_WATER - 1.0) / (N_WATER + 1.0)) ** 2


def water_surface(mesh_steps, amp, dtype=torch.float32,
                  device=None) -> TriangleSet:
    """A wavy air -> water interface: the hexagonal mesh of radius 4.6
    lifted by a sum of three plane waves of incommensurate directions (an
    aperiodic caustic network, like real chop); water is ``mat_in``.  It
    is Morton-sorted, so culling has compact chunks to skip (the image
    does not depend on the order)."""
    m = mt.hexagonal_mesh(4.6, mesh_steps)
    x, y = m.points[:, 0], m.points[:, 1]
    z = (amp * np.sin(2.6 * x + 0.8 * y + 0.3)
         + 0.75 * amp * np.sin(1.1 * x - 3.1 * y + 1.7)
         + 0.55 * amp * np.sin(4.3 * x + 2.2 * y + 4.0))
    pts = np.stack([x, y, z], axis=1)
    f = m.faces
    tri = TriangleSet.make(pts[f[:, 0]], pts[f[:, 1]], pts[f[:, 2]],
                           mat_in=1, mat_out=0, dtype=dtype,
                           device=resolve_device(device))
    return morton_sort_triangles(tri)[0]


def pool_floor(half, depth, dtype=torch.float32, device=None) -> TriangleSet:
    """The target: a 2 half x 2 half square at z = -depth."""
    return TriangleSet.make(
        [[-half, -half, -depth], [half, half, -depth]],
        [[half, -half, -depth], [-half, half, -depth]],
        [[half, half, -depth], [-half, -half, -depth]], dtype=dtype,
        device=resolve_device(device))


def sun_block(generator, block, half_src, dtype=torch.float32,
              device=None) -> RaySet:
    """One block of collimated rays drawn from ``generator``: uniform over
    the square |x|, |y| <= half_src at z = 1, travelling straight down at
    550 nm, with unit ``intensity``."""
    device = resolve_device(device)
    xy = torch.rand((block, 2), generator=generator, dtype=dtype,
                    device=device) * (2.0 * half_src) - half_src
    ones = torch.ones((block, 1), dtype=dtype, device=device)
    p0 = torch.cat([xy, ones], dim=1)
    p1 = torch.cat([xy, ones - 1.0], dim=1)   # p0 + (0, 0, -1)
    return RaySet.make(p0, p1, 550.0, dtype=dtype, device=device).with_field(
        "intensity", ones[:, 0])


def caustic_scene(mesh_steps=144, depth=3.0, amp=0.08, dtype=torch.float32,
                  device=None) -> Scene3D:
    """The water surface over the pool floor (half-width 4.6)."""
    return Scene3D.build(
        optical=[water_surface(mesh_steps, amp, dtype, device)],
        targets=[pool_floor(POOL_HALF + 1.0, depth, dtype, device)])


class CausticRender:
    """The streamed caustic of ``examples/caustic_render.py``: ``self(n)``
    traces ``n`` blocks of ``block`` rays (block ``i`` drawn from a
    generator seeded ``fold_in(CAUSTIC_SEED, i)``), or a given RaySet in
    blocks,
    under ``torch.no_grad()``, and returns the ``engine.StreamedResult`` of
    the (res, res) landing image and the state counts.

    The image accumulates in ``image_dtype`` (the rays' dtype by default,
    as the example).  float64 sums float32 weights exactly, so its image
    does not depend on the order of the additions: a stream and one trace
    of the same rays then give the same image bit for bit."""

    def __init__(self, block=1 << 22, res=512, mesh_steps=144, depth=3.0,
                 amp=0.08, dtype=torch.float32, device=None,
                 image_dtype=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.block_size = block
        self.scene = caustic_scene(mesh_steps, depth, amp, dtype, self.device)
        self.cfg = TraceConfig.recommended(self.scene, max_bounces=2)
        extent = ((-SUN_HALF, SUN_HALF), (-SUN_HALF, SUN_HALF))
        self.fold = landing_histogram_fold(extent, res,
                                           dtype=image_dtype or dtype,
                                           axes=(0, 1),
                                           weight_field="intensity",
                                           device=self.device)
        self.reaction = fresnel_intensity_reaction()

    def block(self, i):
        """Block ``i`` of the stream."""
        gen = torch.Generator(self.device).manual_seed(
            fold_in(CAUSTIC_SEED, i))
        return sun_block(gen, self.block_size, SUN_HALF, self.dtype,
                         self.device)

    def __call__(self, n_blocks=None, rays=None):
        init, fn = self.fold
        with torch.no_grad():
            return trace_streamed(
                self.block if rays is None else rays, self.scene,
                CAUSTIC_MATERIALS, self.cfg, reaction=self.reaction,
                fold_fn=fn, fold_init=init, fold_fields=True,
                block_size=self.block_size, n_blocks=n_blocks,
                remat_blocks=False)


def mean_transmission(result):
    """The mean landed weight of a caustic stream: the image's sum over
    the finished rays."""
    finished = int(result.state_counts[FINISHED])
    return float(result.fold.sum()) / max(finished, 1)


def caustic_render(n_rays=1 << 27, block=1 << 22, res=512, mesh_steps=144,
                   depth=3.0, amp=0.08, dtype=torch.float32, device=None,
                   rays=None, verbose=True, png=None):
    """Render the caustic (``rays`` given: trace those, in blocks of
    ``block``; else ``n_rays // block`` generated blocks), check the mean
    landed weight against the normal-incidence transmission (within 0.02,
    the example's test) and return ``{"image", "state_counts", "n_rays",
    "seconds", "rays_per_s", "equiv_per_s", "mean_transmission"}``
    (equivalent intersections/s: rays x triangles x bounces over the
    wall time, the stream's first block's set-up included).  ``png``: a
    path to write the example's figure to (the image, gamma-compressed)."""
    render = CausticRender(block, res, mesh_steps, depth, amp, dtype,
                           device)
    n_blocks = None if rays is not None else max(1, n_rays // block)
    n = rays.n_rays if rays is not None else n_blocks * block
    if render.device.type == "cuda":
        torch.cuda.synchronize(render.device)
    t0 = time.perf_counter()
    out = render(n_blocks, rays)
    image = out.fold.cpu()
    counts = out.state_counts.tolist()
    seconds = time.perf_counter() - t0
    mean_t = mean_transmission(out)
    m = render.scene.triangles.n_surfaces
    if verbose:
        print(f"caustic render: {m} triangles, {n:,} rays -> {res}x{res} "
              f"image in {seconds:.3f} s ({n / seconds / 1e6:.2f} M rays/s); "
              f"landed power {float(image.sum()):,.1f} over {counts[FINISHED]:,}"
              f" finished rays (mean transmission {mean_t:.5f})", flush=True)
    if not abs(mean_t - T_NORMAL) < 0.02:
        raise RuntimeError(f"caustic render: mean landed weight {mean_t} is "
                           f"not within 0.02 of {T_NORMAL}")
    if png is not None:
        fig = figure(figsize=(7, 7))
        axp = fig.subplots()
        # gamma-compressed: the caustic's peaks are ~50x the mean
        axp.imshow(image.numpy() ** 0.45, origin="lower", cmap="cividis",
                   extent=(-SUN_HALF, SUN_HALF, -SUN_HALF, SUN_HALF))
        axp.set_title(f"pool-floor caustics, {n:,} rays")
        axp.set_xlabel("x")
        axp.set_ylabel("y")
        fig.tight_layout()
        fig.savefig(png, dpi=140)
    return {"image": image, "state_counts": counts, "n_rays": n,
            "seconds": seconds, "rays_per_s": n / seconds,
            "equiv_per_s": n * m * render.cfg.max_bounces / seconds,
            "mean_transmission": mean_t}


# ----------------------------------------------------------------------
# the image quality of the finished hexalens
# ----------------------------------------------------------------------

IMAGE_SOURCE_DISTANCE = 10.0
IMAGE_OBJECT_SIZE = 0.2
IMAGE_LENS_APERATURE = 1.0
IMAGE_THETA = (0.0, PI / 6)
IMAGE_BOUNCES = 3
IMAGE_EXTENT = 1.2
IMAGE_BINS = 96
IMAGE_SEED = 7


def _out_dir(out_dir):
    """``out_dir``, by default the repository's build/ directory."""
    from pathlib import Path

    from tensorflowraytrace_tpu_torch.ops import cuda_build

    path = Path(cuda_build.BUILD_DIR if out_dir is None else out_dir)
    path.mkdir(parents=True, exist_ok=True)
    return path


def hexalens_stls(params=None, mesh_step=0.08, out_dir=None, device=None):
    """Export the hexalens's two surfaces at ``params`` (None: designed by
    ``hexalens.train()``) after its thickness constraints, as
    ``examples/hexalens.py`` does, to ``hexalens_first.stl`` and
    ``hexalens_second.stl`` in ``out_dir``.  Returns ``(first, second,
    surfaces)``: the two paths and ``lens.build(params)``."""
    from tensorflowraytrace_tpu_torch import hexalens
    from tensorflowraytrace_tpu_torch.utils.checkpoint import (
        export_boundary_stl,
    )

    device = resolve_device(device)
    if params is None:
        _, params = hexalens.train(mesh_step=mesh_step, device=device)
    lens, _, _ = hexalens.problem(mesh_step=mesh_step, device=device)
    out = _out_dir(out_dir)
    paths = []
    with torch.no_grad():
        for surface, p, name in zip(lens.surfaces, lens.constrain(params),
                                    ("first", "second")):
            paths.append(export_boundary_stl(
                surface, p, str(out / f"hexalens_{name}.stl")))
        surfaces = lens.build(params)
    return paths[0], paths[1], surfaces


def image_quality_scene(first_stl, second_stl, dtype=torch.float32,
                        device=None):
    """The two STL surfaces (glass inside) and the target: ``(scene,
    cfg)``, the config ``TraceConfig.recommended``'s."""
    device = resolve_device(device)
    first = bd.manual_triangle_boundary(file_name=first_stl, mat_in=1,
                                        mat_out=0, dtype=dtype, device=device)
    second = bd.manual_triangle_boundary(file_name=second_stl, mat_in=1,
                                         mat_out=0, dtype=dtype,
                                         device=device)
    half, td = 50.0, IMAGE_SOURCE_DISTANCE
    target = TriangleSet.make(
        [[td, -half, -half], [td, half, half]],
        [[td, half, -half], [td, -half, half]],
        [[td, half, half], [td, -half, -half]], dtype=dtype, device=device)
    scene = Scene3D.build(optical=[first, second], targets=[target])
    return scene, TraceConfig.recommended(scene, max_bounces=IMAGE_BOUNCES)


def image_quality_source(rays):
    """``rays`` rays from the object disk 10 before the lens to its wedge
    aperture, 575 nm."""
    start_points = dist.RandomUniformCircle(rays, IMAGE_OBJECT_SIZE)
    end_points = dist.RandomUniformCircle(
        rays, 0.98 * IMAGE_LENS_APERATURE, theta_start=IMAGE_THETA[0],
        theta_end=IMAGE_THETA[1])
    return src.AperatureSource(
        3,
        dist.BasePointTransformation(
            start_points, translation=(-IMAGE_SOURCE_DISTANCE, 0.0, 0.0),
            lift_to_3d=True),
        dist.BasePointTransformation(end_points, lift_to_3d=True),
        [575.0] * rays, dense=False)


def image_fluxes(h, xedges):
    """The landed rays and the shares of flux within 0.25 of the central
    image and of the one displaced by 0.6 in +y (the example's report)."""
    total = h.sum()
    centers = 0.5 * (np.asarray(xedges)[:-1] + np.asarray(xedges)[1:])
    near = np.abs(centers) < 0.25
    central = h[near][:, near].sum()
    displaced = h[np.abs(centers - 0.6) < 0.25][:, near].sum()
    return int(total), float(central / total), float(displaced / total)


def image_quality_3d(batches=20, rays=4000, params=None, first_stl=None,
                     second_stl=None, dtype=torch.float32, device=None):
    """``examples/image_quality_3d.py``: the two hexalens surfaces (the
    given STL files, or those ``hexalens_stls(params)`` writes to build/)
    traced in ``batches`` batches of ``rays`` rays from one generator
    seeded ``IMAGE_SEED``, the finished rays' (y, z) histogrammed by
    ``analysis.imaging_test`` into 96 x 96 bins over |y|, |z| <= 1.2.
    Returns a dict of the histogram and its edges, the landed rays, the
    two images' flux shares, the STL paths, the scene and the config."""
    device = resolve_device(device)
    if first_stl is None:
        first_stl, second_stl, _ = hexalens_stls(params, device=device)
    scene, cfg = image_quality_scene(first_stl, second_stl, dtype, device)
    source = image_quality_source(rays)
    generator = torch.Generator(device).manual_seed(IMAGE_SEED)

    def get_samples():
        res = trace(source.sample(generator, dtype, device), scene,
                    MATERIALS, cfg)
        return res.rays.p1[res.rays.state == FINISHED][:, 1:]

    h, xedges, yedges, _ = analysis.imaging_test(
        get_samples, [[-IMAGE_EXTENT, IMAGE_EXTENT]] * 2,
        batch_count=batches, bins=IMAGE_BINS, verbose=False)
    total, central, displaced = image_fluxes(h, xedges)
    return {"histogram": h, "xedges": xedges, "yedges": yedges,
            "landed": total, "central": central, "displaced": displaced,
            "first_stl": first_stl, "second_stl": second_stl,
            "scene": scene, "cfg": cfg}


def remesh(out_dir=None, dtype=torch.float32, device=None):
    """``examples/remesh.py``: a 5-ring hexagonal mesh bent to the bump
    0.4 exp(-3 r^2), re-meshed on the host onto a regular 12-ring one
    (``planar_interpolated_remesh``); the example's check (the initial
    parameters' peak within 0.02 of 0.4); the flat mesh and its initial
    parameters built into a ``ParametricTriangleBoundary`` along +z on the
    device; the re-inflated mesh saved as ``remeshed.stl`` in ``out_dir``
    (by default build/).  Returns a dict of the initial parameters, the
    built surface's peak height, the boundary and the STL path."""
    device = resolve_device(device)
    bumpy = mt.hexagonal_mesh(1.0, 5)
    r2 = np.sum(bumpy.points[:, :2] ** 2, axis=1)
    bumpy.points[:, 2] = 0.4 * np.exp(-3 * r2)
    base = mt.hexagonal_mesh(1.0, 12)
    flat, initial = mt.planar_interpolated_remesh(bumpy, base)
    if not abs(initial.max() - 0.4) < 0.02:
        raise AssertionError(f"remesh: initial peak {initial.max()}, not "
                             "within 0.02 of 0.4")
    boundary = bd.ParametricTriangleBoundary(
        flat, bd.FromVectorVG((0.0, 0.0, 1.0)), initial_parameters=0.0,
        dtype=dtype, device=device)
    with torch.no_grad():
        surface = boundary.build(boundary.init_params() + torch.as_tensor(
            initial, dtype=dtype, device=device))
        peak = float(surface.vp[:, 2].max())
    path = str(_out_dir(out_dir) / "remeshed.stl")
    mt.planar_interpolated_remesh(bumpy, base, flatten=False).save(path)
    return {"initial": initial, "peak": peak, "boundary": boundary,
            "surface": surface, "stl": path}


# ----------------------------------------------------------------------
# the mesh-graph tools (examples/mesh_graph_tools.py)
# ----------------------------------------------------------------------

def mesh_graph_tools(png=None):
    """Run ``examples/mesh_graph_tools.py`` on the hexagonal mesh of radius
    1 and 4 steps, with its checks (every vertex reached by the
    generations; the accumulator's reach from the centre and from a rim
    vertex; the smoothed spike falling after one and three passes).
    Returns the example's printed values: ``top``, ``children`` (the
    parent-to-child edges), ``generations``, ``reached``, ``n_points``,
    ``reach_top``, ``reach_rim``, ``spike_1`` and ``spike_3``.  ``png``: a
    path to write the four panels to (``models/mesh.visualize_*``)."""
    mesh = mt.hexagonal_mesh(1.0, 4)
    top = mt.get_closest_point(mesh, (0.0, 0.0, 0.0))
    generations = mt.find_generations(mesh, top)
    _, children, _, _ = mt.find_all_relationships(mesh, top)
    _, accumulator = mt.mesh_parametrization_tools(mesh, top)
    smoother = host_array(mt.mesh_smoothing_tool(mesh,
                                                 mt.gaussian_weights(0.5, 3)))
    reached = sum(len(w) for w in generations)
    acc = host_array(accumulator)
    reach_top = int((acc[:, top] != 0).sum())
    rim = int(next(iter(generations[-1])))
    reach_rim = int((acc[:, rim] != 0).sum())
    z = np.zeros(mesh.n_points)
    z[top] = 1.0
    z1 = smoother @ z
    z3 = np.linalg.matrix_power(smoother, 3) @ z
    out = {"top": top, "children": sum(len(v) for v in children),
           "generations": len(generations), "reached": reached,
           "n_points": mesh.n_points, "reach_top": reach_top,
           "reach_rim": reach_rim, "spike_1": float(z1[top]),
           "spike_3": float(z3[top])}
    if not (reached == mesh.n_points and reach_top == acc.shape[0]
            and reach_rim == 1 and z3[top] < z1[top] < 1.0):
        raise RuntimeError(f"mesh graph tools: the checks fail on {out}")
    if png is not None:
        fig = figure(figsize=(14, 14))
        ax1 = fig.add_subplot(2, 2, 1, projection="3d")
        ax2 = fig.add_subplot(2, 2, 2, projection="3d")
        ax3 = fig.add_subplot(2, 2, 3)
        ax4 = fig.add_subplot(2, 2, 4)
        ax1.set_title("vertex relationships (BFS from the center vertex)")
        mt.visualize_connections(ax1, mesh, children)
        ax2.set_title("BFS generations")
        mt.visualize_generations(ax2, mesh, generations)
        ax3.set_title("gradient accumulator (ancestor matrix)")
        ax3.imshow(acc, cmap="Blues", interpolation="nearest")
        ax4.set_title("smoother: spiked vertex after 0/1/3 passes")
        level = np.zeros(mesh.n_points, dtype=int)
        for g, wave in enumerate(generations):
            for v in wave:
                level[v] = g
        order = np.argsort(level, kind="stable")
        ax4.plot(z[order], label="spike")
        ax4.plot(z1[order], label="1 pass")
        ax4.plot(z3[order], label="3 passes")
        ax4.legend()
        fig.savefig(png, dpi=100)
    return out


# ----------------------------------------------------------------------
# the structured guide of bench.py and examples/guide_trace_bench.py
# ----------------------------------------------------------------------

GUIDE_MODES = (("grid+resort", dict(cull="grid", resort_rays=True)),
               ("block+resort", dict(cull=True, resort_rays=True)),
               ("block", dict(cull=True, resort_rays=False)),
               ("brute", dict(cull=False, resort_rays=False)))


def structured_guide(n_rays=1 << 20, theta_res=64, z_res=128,
                     dtype=torch.float32, device=None):
    """``bench.py``'s and ``examples/guide_trace_bench.py``'s structured
    scene: a cylindrical light guide from z = 0 to 40 (radius tapering
    0.7 -> 0.3; ``theta_res`` x ``z_res`` facets, capped: 16,386
    triangles at the defaults), Morton-sorted, acrylic inside, a
    0.7 x 0.7 target at z = 40.05, and ``n_rays`` rays from a disc of
    radius 0.2 at z = 0.1, forward-biased down the guide (575 nm; numpy
    seed 0).  Returns ``(rays, scene)``."""
    device = resolve_device(device)
    guide = bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 40.0), minimum_radius=0.3,
        theta_res=theta_res, z_res=z_res, rotationally_symmetric=True,
        initial_taper=(0.7, 0.0), mat_in=1, mat_out=0, dtype=dtype,
        device=device)
    with torch.no_grad():
        surf, _ = morton_sort_triangles(guide.build())
    half = 0.35
    target = TriangleSet.make(
        [[-half, -half, 40.05], [half, half, 40.05]],
        [[half, -half, 40.05], [-half, half, 40.05]],
        [[half, half, 40.05], [-half, -half, 40.05]], dtype=dtype,
        device=device)
    scene = Scene3D.build(optical=[surf], targets=[target])
    rng = np.random.default_rng(0)
    r = 0.2 * np.sqrt(rng.uniform(0, 1, n_rays))
    th = rng.uniform(0, 2 * math.pi, n_rays)
    p0 = np.stack([r * np.cos(th), r * np.sin(th), np.full(n_rays, 0.1)],
                  1).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3))
    d[:, 2] = np.abs(d[:, 2]) * 3 + 1   # forward-biased: down the guide
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = RaySet.make(p0, p0 + d.astype(np.float32), 575.0, dtype=dtype,
                       device=device)
    return rays, scene


def guide_trace_bench(n_rays=1 << 20, bounces=24, theta_res=64, z_res=128,
                      reps=3, use_kernel=None, dtype=torch.float32,
                      device=None, verbose=True):
    """``examples/guide_trace_bench.py``: the structured guide traced to
    ``bounces`` under each of ``GUIDE_MODES`` (``"grid"`` + re-sort: K4;
    ``cull=True`` ± re-sort: K3; brute: K1; the kernels where
    ``use_kernel``, by default exactly on the card), each timed by the
    median of ``reps`` synchronised traces after one, and the example's
    check: the four checksums (the sum of the final endpoints, at full
    precision) equal.  Children start ``start_epsilon`` past their surface.
    Returns ``{mode: {"ms", "equiv_per_s", "checksum"}}`` and the
    scene's size."""
    device = resolve_device(device)
    rays, scene = structured_guide(n_rays, theta_res, z_res, dtype, device)
    m = scene.triangles.n_surfaces
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    eps = start_epsilon(scene)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {"n_rays": n_rays, "triangles": m, "bounces": bounces, "modes": {}}
    with torch.no_grad():
        for name, kw in GUIDE_MODES:
            cfg = TraceConfig(max_bounces=bounces, use_kernel=use_kernel,
                              ray_start_epsilon=eps, **kw)
            times = []
            for rep in range(reps + 1):   # the first is not timed
                sync()
                t0 = time.perf_counter()
                checksum = float(trace(rays, scene, MATERIALS,
                                       cfg).rays.p1.sum())
                times.append(time.perf_counter() - t0)
            per = float(np.median(times[1:])) if reps else times[0]
            out["modes"][name] = {"ms": per * 1e3, "checksum": checksum,
                                  "equiv_per_s": n_rays * m * bounces / per}
            if verbose:
                print(f"{name:14s}: {per * 1e3:9.3f} ms -> "
                      f"{n_rays * m * bounces / per / 1e9:7.2f} G equiv int/s "
                      f"(checksum {checksum!r})", flush=True)
    checksums = {repr(v["checksum"]) for v in out["modes"].values()}
    if len(checksums) != 1:
        raise AssertionError(f"guide_trace_bench: modes disagree: "
                             f"{checksums}")
    return out
