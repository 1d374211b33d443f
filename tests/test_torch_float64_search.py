"""The float64 searches (K1, K3, K5, K6) of the PyTorch port against the JAX
package, on the CPU, and the dtype rules of all nine.

The JAX package's Pallas searches compute in their inputs' dtype; every
search of the port has a float64 instance on the card, which runs its
plain version's float64 arithmetic (K4 and K7-K10:
tests/test_torch_float64_culled.py).  Here, with small sizes:

* the plain K1, K3, K5 and K6 in float64 against the Pallas kernels in
  interpret mode in float64: equal ``valid``, ``ray_u`` within rtol 1e-12,
  ``idx`` (and an arc's ``branch``) equal except at a tie, where the other
  surface gives the same ``ray_u`` within that rtol;
* the plain K3 against the plain K1 in float64, bit for bit, with parked
  rays and rays that miss;
* every ray-triangle pair the float64 pair test accepts passes the slab
  gate of its chunk's widened float64 box (``culled_boxes``), and its
  point lies inside the box;
* float64 ``use_kernel=True`` traces (a sorted soup brute and culled; a 2D
  lens of arcs and segments) against the JAX package's ``use_pallas=True``
  float64 traces; ``TraceConfig.recommended`` picks the kernels for a
  float64 scene on the card;
* the wrappers' dtype rules: every search takes float32 or float64 and
  refuses mixed dtypes and float16; every ``ctypes`` declaration of a
  launch, float32 and float64, matches its C signature in the source;
* float64 traces exported through the ``tfrt_torch`` operators, on every
  search path.

The kernels themselves run on the card: tests/test_torch_kernels.py,
test_torch_culled_kernels.py, test_torch_2d_kernels.py and
test_torch_twolevel2d_kernels.py, over float32 and float64, and phases 24
and 25 of chip_smoke.py.
"""

import ctypes
import math
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import ArcSet as JArcSet
from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu.ops import pallas_kernels as pk
from tensorflowraytrace_tpu_torch import (
    ArcSet, RaySet, Scene2D, Scene3D, SegmentSet, TraceConfig, config,
    scenes2d, streamed, trace,
)
from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
from tensorflowraytrace_tpu_torch.ops import cuda_build
from tensorflowraytrace_tpu_torch.ops import materials as t_mats
from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from tensorflowraytrace_tpu_torch.utils.convert import triangles_from_numpy
from torch_export_common import check_exported_kernel_trace
from torch_float64_common import (
    T, arcs, assert_hits, rays, segments, sorted_soup,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

EPS = 1e-6
PI = math.pi
F64 = torch.float64


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


# ----------------------------------------------------------------------
# the plain versions against the Pallas kernels, float64
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cull", [False, True], ids=["K1", "K3"])
def test_plain_triangles_match_pallas_f64(rng, cull):
    jt, tris, p0, p1 = sorted_soup(rng, 300, 700)
    want = pk.nearest_hit_triangles_pallas(
        jnp.asarray(p0), jnp.asarray(p1), jt, EPS, EPS, EPS, ray_block=256,
        tri_block=64, interpret=True, cull=cull)
    assert np.asarray(want[2]).dtype == np.float64
    search = (tk.nearest_hit_triangles_culled_plain if cull
              else tk.nearest_hit_triangles_plain)
    args = [T(a) for a in (p0, p1, *tris)]
    o, d = args[0], args[1] - args[0]

    def pair_u(rows, idx):
        a, e1, e2 = (t[idx].T for t in (args[2], args[3] - args[2],
                                        args[4] - args[2]))
        return tk._moller_trumbore(*o[rows].T, *d[rows].T, a, e1, e2,
                                   *tk._thresholds(EPS, EPS, EPS))

    assert_hits(search(*args, EPS, EPS, EPS), want, pair_u)


@pytest.mark.parametrize("shape", [(700, 300), (257, 33)])
def test_plain_k5_matches_pallas_f64(rng, shape):
    n, m = shape
    p0, p1 = rays(rng, n, 2)
    js = JSegmentSet.make(*segments(rng, m), mat_in=1, dtype=jnp.float64)
    want = pk.nearest_hit_segments_pallas(
        jnp.asarray(p0), jnp.asarray(p1), js, EPS, EPS, EPS, ray_block=128,
        seg_block=32, interpret=True)
    args = [T(a) for a in (p0, p1, js.p0, js.p1)]
    o, d = args[0], args[1] - args[0]

    def pair_u(rows, idx):
        start = args[2][idx]
        return gk._segment_pairs(*o[rows].T, *d[rows].T, *start.T,
                                 *(args[3][idx] - start).T,
                                 *tk._thresholds(EPS, EPS, EPS))

    assert_hits(gk.nearest_hit_segments_plain(*args, EPS, EPS, EPS), want,
                pair_u)


@pytest.mark.parametrize("full", [False, True], ids=["windows", "circles"])
def test_plain_k6_matches_pallas_f64(rng, full):
    p0, p1 = rays(rng, 800, 2)
    ja = JArcSet.make(*arcs(rng, 45, full), mat_in=1, dtype=jnp.float64)
    want = pk.nearest_hit_arcs_pallas(
        jnp.asarray(p0), jnp.asarray(p1), ja, EPS, EPS, ray_block=128,
        arc_block=32, interpret=True)
    surf = [T(getattr(ja, k)) for k in ("center", "angle_start", "angle_end",
                                        "radius")]
    o, d = T(p0), T(p1) - T(p0)
    table = ak.arc_table(*surf)

    def pair_u(rows, idx):
        cols = ak._arc_columns(table[idx], 0, len(idx))
        return ak._arc_pairs(*o[rows].T, *d[rows].T,
                             *(c[0] for c in cols), EPS, EPS)[0]

    got = ak.nearest_hit_arcs_plain(T(p0), T(p1), *surf, EPS, EPS)
    assert_hits(got, want, pair_u)
    assert got[3][got[0]].any() and not got[3][got[0]].all()


# ----------------------------------------------------------------------
# K3 against K1, and the float64 gate boxes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1500, 2000), (1000, 333), (33, 1)])
def test_plain_k3_equals_plain_k1_f64(rng, shape):
    """Bit for bit, with a third of the rays parked (p0 = 1e30, as the
    engine parks terminated rays) and some pointing away from the soup."""
    n, m = shape
    _, tris, p0, p1 = sorted_soup(rng, m, n)
    p1[::5] = 2 * p0[::5] - p1[::5]          # reversed
    p0[::3], p1[::3] = 1e30, 1e30 * (1 + 1e-6)
    args = [T(a) for a in (p0, p1, *tris)]
    want = tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS)
    got = tk.nearest_hit_triangles_culled_plain(*args, EPS, EPS, EPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not want[0][::3].any()
    if m > 1:
        assert want[0].any()


@pytest.mark.parametrize("size_eps", [EPS, 1e-2])
def test_accepted_points_inside_k3_boxes_f64(rng, size_eps):
    """Every pair the float64 pair test accepts: its ray passes the slab
    gate of its chunk's box with its own hit as the best so far, and its
    point o + u d lies inside the box (K3's boxes, float64 here, widened by
    float32's rounding margin)."""
    _, tris, p0, p1 = sorted_soup(rng, 700, 2000)
    vp, v1, v2 = (T(a) for a in tris)
    o, d = T(p0), T(p1) - T(p0)
    eps = tk._thresholds(EPS, size_eps, EPS)
    u = tk._moller_trumbore(*o[:, :, None].unbind(1), *d[:, :, None].unbind(1),
                            vp.T[:, None], (v1 - vp).T[:, None],
                            (v2 - vp).T[:, None], *eps)          # (N, M)
    rows, cols = torch.nonzero(u < tk.BIG, as_tuple=True)
    assert rows.numel() > 1000
    boxes = tk.culled_boxes(vp, v1, v2, size_eps)[cols // tk.CULL_CHUNK]
    assert boxes.dtype == F64
    hit = u[rows, cols]
    gate = tk._slab_gate(o[rows].T, tk._inverse_direction(d[rows]).T,
                         boxes[:, :3].T, boxes[:, 3:].T, eps[3], hit)
    assert bool(gate.all())
    point = o[rows] + hit[:, None] * d[rows]
    assert bool(((point >= boxes[:, :3]) & (point <= boxes[:, 3:])).all())


# ----------------------------------------------------------------------
# traces through the kernels' plain versions, float64
# ----------------------------------------------------------------------

def quad(x, half):
    """Two triangles covering x = const."""
    a, b = -half, half
    return [np.array(v, dtype=np.float64) for v in
            ([[x, a, a], [x, b, b]], [[x, b, a], [x, a, b]],
             [[x, b, b], [x, a, a]])]


@pytest.mark.parametrize("cull", [False, True], ids=["K1", "K3"])
def test_soup_trace_matches_jax_pallas_f64(rng, cull):
    """512 rays, 3 bounces through a 600-triangle sorted mirror soup and
    a target: the port's use_kernel=True (the plain K1 or K3) against
    JAX's use_pallas=True, float64: states equal, endpoints within 1e-9."""
    jt, tris, p0, p1 = sorted_soup(rng, 600, 512)
    target = quad(20.0, 50.0)
    j_scene = JScene3D.build(optical=[jt], targets=[JTriangleSet.make(
        *target, dtype=jnp.float64)])
    t_scene = Scene3D.build(
        optical=[triangles_from_numpy(*tris, mat_in=1, dtype=F64)],
        targets=[triangles_from_numpy(*target, dtype=F64)])
    acc = dict(max_bounces=3, cull=cull)
    j_res = j_engine.trace(
        JRaySet.make(jnp.asarray(p0), jnp.asarray(p1), 575.0,
                     dtype=jnp.float64), j_scene,
        (j_mats.vacuum, j_mats.reflective),
        JTraceConfig(use_pallas=True, **acc))
    t_res = trace(RaySet.make(T(p0), T(p1), 575.0, dtype=F64), t_scene,
                  (t_mats.vacuum, t_mats.reflective),
                  TraceConfig(use_kernel=True, **acc))
    np.testing.assert_array_equal(t_res.rays.state.numpy(),
                                  np.asarray(j_res.rays.state))
    np.testing.assert_allclose(t_res.rays.p1.numpy(),
                               np.asarray(j_res.rays.p1), atol=1e-9)
    assert t_res.rays.p1.dtype == F64
    assert (t_res.rays.state == 1).any() and (t_res.rays.state != 1).any()


def lens_2d(rng, dtype):
    """A biconvex lens of two arcs (radius 5, vertices at x = 0 and 2), an
    acrylic slab of three segments behind it, a target at x = 12, and 512
    rays of a beam at x = -2, each tilted by up to 0.05 rad."""
    w = math.acos(0.8)   # the arcs meet at (1, +-3)
    lens = ([[5.0, 0.0], [-3.0, 0.0]], [PI - w, -w], [PI + w, w], [5.0, 5.0])
    slab = ([[5.0, -2.0], [7.0, -2.0], [6.0, 2.0]],
            [[7.0, -2.0], [6.0, 2.0], [5.0, -2.0]])
    target = ([[12.0, -20.0]], [[12.0, 20.0]])
    n = 512
    h = rng.uniform(-2.8, 2.8, n)
    tilt = rng.uniform(-0.05, 0.05, n)
    p0 = np.stack([np.full(n, -2.0), h], 1)
    p1 = p0 + np.stack([np.cos(tilt), np.sin(tilt)], 1)
    if dtype == "jax":
        scene = JScene2D.build(
            optical_arcs=[JArcSet.make(*lens, mat_in=1, mat_out=0,
                                       dtype=jnp.float64)],
            optical_segments=[JSegmentSet.make(*slab, mat_in=1, mat_out=0,
                                               dtype=jnp.float64)],
            target_segments=[JSegmentSet.make(*target, dtype=jnp.float64)])
        return (JRaySet.make(jnp.asarray(p0), jnp.asarray(p1), 575.0,
                             dtype=jnp.float64), scene)
    scene = Scene2D.build(
        optical_arcs=[ArcSet.make(*lens, mat_in=1, mat_out=0, dtype=F64)],
        optical_segments=[SegmentSet.make(*slab, mat_in=1, mat_out=0,
                                          dtype=F64)],
        target_segments=[SegmentSet.make(*target, dtype=F64)])
    return RaySet.make(T(p0), T(p1), 575.0, dtype=F64), scene


def test_lens_2d_trace_matches_jax_pallas_f64():
    """The 2D lens through the plain K5 and K6 (use_kernel=True) against
    JAX's use_pallas=True, 3 bounces, float64."""
    j_rays, j_scene = lens_2d(np.random.default_rng(3), "jax")
    t_rays, t_scene = lens_2d(np.random.default_rng(3), "torch")
    j_res = j_engine.trace(j_rays, j_scene, (j_mats.vacuum, j_mats.acrylic),
                           JTraceConfig(max_bounces=3, use_pallas=True))
    t_res = trace(t_rays, t_scene, (t_mats.vacuum, t_mats.acrylic),
                  TraceConfig(max_bounces=3, use_kernel=True))
    np.testing.assert_array_equal(t_res.rays.state.numpy(),
                                  np.asarray(j_res.rays.state))
    for name in ("p0", "p1"):
        np.testing.assert_allclose(getattr(t_res.rays, name).numpy(),
                                   np.asarray(getattr(j_res.rays, name)),
                                   atol=1e-9)
    # every ray crossed both arcs; some reached the slab's segments
    assert (t_res.rays.p0[:, 0] > 4.9).any()


@pytest.mark.parametrize("scene", ["soup", "guide"])
def test_recommended_takes_the_kernels_for_float64_on_the_card(rng, scene):
    """On the card a float64 scene gets the CUDA searches as a float32 one
    does (K1 below 4096 triangles, K3 + re-sort from 4096), with the
    dtype's default start epsilon; nothing here touches a card."""
    if scene == "soup":
        _, tris, _, _ = sorted_soup(rng, 600, 1)
        s = Scene3D.build(optical=[triangles_from_numpy(*tris, mat_in=1,
                                                        dtype=F64)])
        culled = False
    else:
        s = streamed.long_guide_scene(64, 128, F64, "cpu")
        culled = True
    assert (s.triangles.n_surfaces >= 4096) == culled
    cfg = TraceConfig.recommended(s, max_bounces=24, device="cuda")
    assert cfg.use_kernel and cfg.cull == culled
    assert cfg.resort_rays == culled and cfg.ray_start_epsilon is None


# ----------------------------------------------------------------------
# the wrappers' dtype rules and the launches' C signatures
# ----------------------------------------------------------------------

def triangle_args(dtype=F64):
    rng = np.random.default_rng(0)
    _, tris, p0, p1 = sorted_soup(rng, 20, 32)
    return [T(a).to(dtype) for a in (p0, p1, *tris)]


def segment_args(dtype=F64):
    rng = np.random.default_rng(1)
    return [T(a).to(dtype) for a in (*rays(rng, 32, 2), *segments(rng, 20))]


def arc_args(dtype=F64):
    rng = np.random.default_rng(2)
    return [T(a).to(dtype) for a in (*rays(rng, 32, 2), *arcs(rng, 20))]


# every search's input checks, what its CUDA operator runs first
ACCEPTS = {"K1": (tk._check_cuda_inputs, triangle_args),
           "K3": (tk._check_cuda_inputs, triangle_args),
           "K4": (tk._check_cuda_inputs, triangle_args),
           "K5": (gk._check_segments, segment_args),
           "K6": (ak._check_arcs, arc_args),
           "K7": (gk._check_segments, segment_args),
           "K8": (ak._check_arcs, arc_args),
           "K9": (gk._check_segments, segment_args),
           "K10": (ak._check_arcs, arc_args)}
# every search's CUDA operator, with its inputs
CUDA_OPS = {"K1": (tk.triangle_search_cuda, triangle_args, 3),
            "K3": (tk.triangle_search_culled_cuda, triangle_args, 3),
            "K4": (tk.triangle_search_twolevel_cuda, triangle_args, 3),
            "K5": (gk.segment_search_cuda, segment_args, 3),
            "K6": (ak.arc_search_cuda, arc_args, 2),
            "K7": (gk.segment_search_culled_cuda, segment_args, 3),
            "K8": (ak.arc_search_culled_cuda, arc_args, 2),
            "K9": (gk.segment_search_twolevel_cuda, segment_args, 3),
            "K10": (ak.arc_search_twolevel_cuda, arc_args, 2)}


@pytest.mark.parametrize("kernel", sorted(ACCEPTS))
def test_float64_searches_accept_float64(kernel):
    check, make = ACCEPTS[kernel]
    for dtype in (torch.float32, F64):
        assert check(*make(dtype)) is None


@pytest.mark.parametrize("kernel", sorted(CUDA_OPS))
def test_searches_refuse_mixed_dtypes_and_float16(kernel):
    """Checked before anything is built or launched, so on the CPU too."""
    op, make, n_eps = CUDA_OPS[kernel]
    args = make(F64)
    mixed = [args[0]] + [a.float() for a in args[1:]]
    with pytest.raises(TypeError, match="one dtype"):
        op(*mixed, *[EPS] * n_eps)
    with pytest.raises(TypeError, match="takes float32"):
        op(*make(torch.float16), *[EPS] * n_eps)


_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "double": ctypes.c_double}


def c_signature(source, name):
    """The ctypes argument types of ``extern "C" int name(...)`` in
    ``csrc/source``: every pointer a c_void_p."""
    text = (cuda_build.CSRC_DIR / source).read_text()
    found = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert found, name
    types_ = []
    for param in found.group(1).split(","):
        words = param.replace("const ", "").split()
        ctype = " ".join(words[:-1])
        types_.append(ctypes.c_void_p if "*" in param
                      else _CTYPES[ctype])
    return types_


@pytest.mark.parametrize("module,loader", [
    (tk, "load_library"), (tk, "load_culled_library"),
    (tk, "load_twolevel_library"), (gk, "load_library"),
    (gk, "load_culled_library"), (gk, "load_twolevel_library"),
    (ak, "load_library"), (ak, "load_culled_library"),
    (ak, "load_twolevel_library")],
    ids=lambda x: x if isinstance(x, str) else x.__name__.split(".")[-1])
def test_launch_declarations_match_the_sources(monkeypatch, module, loader):
    """What each loader declares for each of its launches, float32 and
    float64, against the C signature in the source, read on the CPU: a
    float64 threshold declared c_float would reach the kernel as
    garbage."""
    fake = types.SimpleNamespace()

    def load(source):
        fake.source = source
        return fake

    class Fn:
        pass

    for name in ("triangle_search", "segment_search", "arc_search"):
        for suffix in ("", "_culled", "_twolevel"):
            for dt in ("", "_f64"):
                setattr(fake, f"{name}{suffix}_launch{dt}", Fn())
    monkeypatch.setattr(cuda_build, "load", load)
    getattr(module, loader)()
    declared = {k: v for k, v in vars(fake).items()
                if isinstance(v, Fn) and hasattr(v, "argtypes")}
    assert sorted(declared) == sorted(
        name for name, _ in getattr(module, {
            "load_library": "LAUNCH", "load_culled_library": "LAUNCH_CULLED",
            "load_twolevel_library": "LAUNCH_TWOLEVEL"}[loader]).values())
    assert len(declared) == 2     # float32 and float64
    for name, fn in declared.items():
        assert fn.argtypes == c_signature(fake.source, name), name
        assert fn.restype == ctypes.c_int


# ----------------------------------------------------------------------
# export
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dim,cull", [("2d", False), ("3d", False),
                                      ("3d", True), ("3d", "grid"),
                                      ("2d", True), ("2d", "grid")],
                         ids=["K5-K6", "K1", "K3", "K4", "K7-K8", "K9-K10"])
def test_exported_float64_trace(dim, cull):
    """A 2-bounce float64 trace exported through the operators (their fake
    implementations give the rays' dtype): the graph calls the searches,
    and the loaded program equals the live trace bit for bit."""
    if dim == "2d":
        rays, scene, materials = scenes2d.light_guide(512, 300, 64, dtype=F64,
                                                      device="cpu")
    else:
        scene = streamed.long_guide_scene(12, 24, F64, "cpu")
        rays = streamed.entrance_block(torch.Generator().manual_seed(0), 512,
                                       F64, "cpu")
        materials = (t_mats.vacuum, t_mats.acrylic)
    assert rays.p0.dtype == F64
    check_exported_kernel_trace(dim, cull, rays, scene, materials)
