"""The culled and two-level searches (K4, K7, K8, K9, K10) of the PyTorch
port in float64, against the JAX package and their brute forms, on the
CPU.

The JAX package's Pallas searches compute in their inputs' dtype, their
culled (``cull=True``) and two-level (``cull="grid"``) forms too; each of
the port's searches has a float64 instance on the card that runs its plain
version's float64 arithmetic.  Here, at small sizes:

* the plain K4, K7, K8, K9 and K10 in float64 against the Pallas kernels in
  interpret mode in float64 under the same ``cull``: equal ``valid``,
  ``ray_u`` within rtol 1e-12, ``idx`` (and an arc's ``branch``) equal
  except at a tie, where JAX's surface gives the port's ``ray_u`` within
  that rtol (the criteria of tests/test_torch_float64_search.py);
* each plain version equal to its float64 brute plain version (K1's for
  K4, K5's for K7 and K9, K6's for K8 and K10) bit for bit, also with
  every third ray parked (p0 = 1e30) and the candidate lists' cap lowered
  to 2, so that blocks overflow and sweep every chunk;
* every pair the float64 pair test accepts passes the slab gate of its
  chunk's float64 box with its own hit as the best so far, and its point
  lies inside the box (K4's ``culled_boxes`` at ``FINE_CHUNK``, K7's and
  K9's ``twolevel_boxes`` at size_eps 1e-6 and 1e-2, K8's and K10's on
  random arcs and on the tangent pairs of ``scenes2d.gate_edge_cases``):
  the boxes keep float32's rounding margin ``GATE_PAD`` in float64;
* K10's table holds its flags as the bits of an integer of the table's
  width, int64 in float64 and int32 in float32, exactly;
* a small 2D light guide (258 segments, 32 lenslets, 512 rays) under
  ``cull=True`` (K7, K8) and ``"grid"`` (K9, K10), and a small 3D guide
  (1538 triangles, 1024 rays) under ``"grid"`` (K4), each with the
  re-sort, against the JAX package's float64 ``use_pallas=True`` trace
  under the same ``cull`` (states equal, endpoints within 1e-9), and bit
  for bit against the port's brute kernel-path trace; each search's
  wrapper runs once a bounce.

The kernels run on the card: tests/test_torch_culled_kernels.py,
test_torch_2d_kernels.py and test_torch_twolevel2d_kernels.py over float32
and float64, and phase 25 of chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu.models import acceleration as j_acc
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.models import surfaces as j_surf
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu.ops import pallas_kernels as pk
from tensorflowraytrace_tpu_torch import (
    RaySet, TraceConfig, config, scenes2d, streamed, trace,
)
from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
from tensorflowraytrace_tpu_torch.ops import materials as t_mats
from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from torch_float64_common import (
    T, arcs, assert_hits, rays, segments, sorted_soup,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

EPS = 1e-6
PI = math.pi
F64 = torch.float64
J_MATS = (j_mats.vacuum, j_mats.acrylic)
T_MATS = (t_mats.vacuum, t_mats.acrylic)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def triangle_pair_u(args):
    """The port's ray parameter of rows' pairs with triangles idx."""
    o, d = args[0], args[1] - args[0]

    def pair_u(rows, idx):
        a, e1, e2 = (t[idx].T for t in (args[2], args[3] - args[2],
                                        args[4] - args[2]))
        return tk._moller_trumbore(*o[rows].T, *d[rows].T, a, e1, e2,
                                   *tk._thresholds(EPS, EPS, EPS))
    return pair_u


def segment_pair_u(args):
    o, d = args[0], args[1] - args[0]

    def pair_u(rows, idx):
        start = args[2][idx]
        return gk._segment_pairs(*o[rows].T, *d[rows].T, *start.T,
                                 *(args[3][idx] - start).T,
                                 *tk._thresholds(EPS, EPS, EPS))
    return pair_u


def arc_pair_u(args):
    o, d = args[0], args[1] - args[0]
    table = ak.arc_table(*args[2:])

    def pair_u(rows, idx):
        cols = ak._arc_columns(table[idx], 0, len(idx))
        return ak._arc_pairs(*o[rows].T, *d[rows].T,
                             *(c[0] for c in cols), EPS, EPS)[0]
    return pair_u


# ----------------------------------------------------------------------
# the plain versions against the Pallas kernels, float64
# ----------------------------------------------------------------------

def test_plain_k4_matches_pallas_f64(rng):
    """1200 triangles (3 fine chunks of 512), 700 rays (2 ray blocks)."""
    jt, tris, p0, p1 = sorted_soup(rng, 1200, 700)
    want = pk.nearest_hit_triangles_pallas(
        jnp.asarray(p0), jnp.asarray(p1), jt, EPS, EPS, EPS, ray_block=256,
        tri_block=64, interpret=True, cull="grid")
    assert np.asarray(want[2]).dtype == np.float64
    args = [T(a) for a in (p0, p1, *tris)]
    assert_hits(tk.nearest_hit_triangles_twolevel_plain(*args, EPS, EPS, EPS),
                want, triangle_pair_u(args))


@pytest.mark.parametrize("cull", [True, "grid"], ids=["K7", "K9"])
def test_plain_segments_match_pallas_f64(rng, cull):
    p0, p1 = rays(rng, 700, 2)
    js = JSegmentSet.make(*segments(rng, 600), mat_in=1, dtype=jnp.float64)
    want = pk.nearest_hit_segments_pallas(
        jnp.asarray(p0), jnp.asarray(p1), js, EPS, EPS, EPS, ray_block=128,
        seg_block=32, interpret=True, cull=cull)
    args = [T(a) for a in (p0, p1, js.p0, js.p1)]
    plain = (gk.nearest_hit_segments_culled_plain if cull is True
             else gk.nearest_hit_segments_twolevel_plain)
    assert_hits(plain(*args, EPS, EPS, EPS), want, segment_pair_u(args))


@pytest.mark.parametrize("cull", [True, "grid"], ids=["K8", "K10"])
def test_plain_arcs_match_pallas_f64(rng, cull):
    p0, p1 = rays(rng, 800, 2)
    ja = j_surf.ArcSet.make(*arcs(rng, 300), mat_in=1, dtype=jnp.float64)
    want = pk.nearest_hit_arcs_pallas(
        jnp.asarray(p0), jnp.asarray(p1), ja, EPS, EPS, ray_block=128,
        arc_block=32, interpret=True, cull=cull)
    args = [T(a) for a in (p0, p1)] + [
        T(getattr(ja, k)) for k in ("center", "angle_start", "angle_end",
                                    "radius")]
    plain = (ak.nearest_hit_arcs_culled_plain if cull is True
             else ak.nearest_hit_arcs_twolevel_plain)
    got = plain(*args, EPS, EPS)
    assert_hits(got, want, arc_pair_u(args))
    assert got[3][got[0]].any() and not got[3][got[0]].all()


# ----------------------------------------------------------------------
# each plain version against its brute form, float64
# ----------------------------------------------------------------------

def triangle_args(rng):
    """2000 triangles (4 fine chunks), 1500 rays (3 ray blocks)."""
    _, tris, p0, p1 = sorted_soup(rng, 2000, 1500)
    return [p0, p1, *tris]


def segment_args(rng):
    """1200 segments (5 chunks), 1500 rays (6 ray blocks)."""
    return [*rays(rng, 1500, 2), *segments(rng, 1200)]


def arc_args(rng):
    """600 arcs, 40 of them full circles (3 chunks), 1500 rays."""
    parts = zip(arcs(rng, 560), arcs(rng, 40, full=True))
    return [*rays(rng, 1500, 2), *(np.concatenate(p) for p in parts)]


# kernel: (its plain version, the brute plain version, its arguments, its
# epsilons, the module of its cap, its preparation without the rays)
SEARCHES = {
    "K4": (tk.nearest_hit_triangles_twolevel_plain,
           tk.nearest_hit_triangles_plain, triangle_args, (EPS,) * 3, tk,
           lambda a: tk.twolevel_prepare(*a, EPS, EPS)),
    "K7": (gk.nearest_hit_segments_culled_plain, gk.nearest_hit_segments_plain,
           segment_args, (EPS,) * 3, None, None),
    "K8": (ak.nearest_hit_arcs_culled_plain, ak.nearest_hit_arcs_plain,
           arc_args, (EPS,) * 2, None, None),
    "K9": (gk.nearest_hit_segments_twolevel_plain,
           gk.nearest_hit_segments_plain, segment_args, (EPS,) * 3, gk,
           lambda a: gk.twolevel_prepare(*a, EPS, EPS)),
    "K10": (ak.nearest_hit_arcs_twolevel_plain, ak.nearest_hit_arcs_plain,
            arc_args, (EPS,) * 2, gk,
            lambda a: ak.twolevel_prepare(*a, EPS)),
}


@pytest.mark.parametrize("parked", [False, True],
                         ids=["lists", "parked, cap 2"])
@pytest.mark.parametrize("kernel", list(SEARCHES))
def test_plain_equals_brute_f64(rng, monkeypatch, kernel, parked):
    """Bit for bit, every output; with ``parked`` every third ray parked
    and every fifth reversed, and the two-level searches' cap lowered to 2,
    so that some blocks overflow their lists and sweep every chunk."""
    plain, brute, make, eps, cap_module, prepare = SEARCHES[kernel]
    a = make(rng)
    if parked:
        a[1][::5] = 2 * a[0][::5] - a[1][::5]
        a[0][::3], a[1][::3] = 1e30, 1e30 * (1 + 1e-6)
        if cap_module is not None:
            monkeypatch.setattr(cap_module, "TWOLEVEL_MAX_CAND", 2)
    args = [T(x) for x in a]
    assert args[0].dtype == F64
    want = brute(*args, *eps)
    got = plain(*args, *eps)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert want[2].dtype == F64 and want[0].any()
    if parked:
        assert not want[0][::3].any()
    if prepare is not None:
        _, boxes, counts, _, cap = prepare(args)
        assert cap == (2 if parked else min(32, boxes.shape[0]))
        if parked:
            assert (counts == boxes.shape[0]).any()


# ----------------------------------------------------------------------
# the float64 gate boxes hold every accepted point
# ----------------------------------------------------------------------

def accepted_inside(o, d, u, boxes, r_eps):
    """Every accepted pair (rows, cols) of the (N, M) ray parameters ``u``:
    its ray passes the slab gate of its box (``boxes``, one row a pair)
    with its own hit as its best, and its point o + u d lies in the box."""
    rows, cols = torch.nonzero(u < tk.BIG, as_tuple=True)
    assert rows.numel() > 1000
    box = boxes(cols)
    assert box.dtype == F64
    dim = o.shape[1]
    hit = u[rows, cols]
    gate = tk._slab_gate(o[rows].T, tk._inverse_direction(d[rows]).T,
                         box[:, :dim].T, box[:, dim:].T, r_eps, hit)
    assert bool(gate.all())
    point = o[rows] + hit[:, None] * d[rows]
    assert bool(((point >= box[:, :dim]) & (point <= box[:, dim:])).all())


@pytest.mark.parametrize("size_eps", [EPS, 1e-2])
def test_accepted_points_inside_k4_boxes_f64(rng, size_eps):
    _, tris, p0, p1 = sorted_soup(rng, 1500, 2000)
    vp, v1, v2 = (T(a) for a in tris)
    o, d = T(p0), T(p1) - T(p0)
    eps = tk._thresholds(EPS, size_eps, EPS)
    u = tk._moller_trumbore(*o[:, :, None].unbind(1), *d[:, :, None].unbind(1),
                            vp.T[:, None], (v1 - vp).T[:, None],
                            (v2 - vp).T[:, None], *eps)
    boxes = tk.culled_boxes(vp, v1, v2, size_eps, tk.FINE_CHUNK)
    accepted_inside(o, d, u, lambda cols: boxes[cols // tk.FINE_CHUNK],
                    eps[3])


@pytest.mark.parametrize("size_eps", [EPS, 1e-2])
def test_accepted_points_inside_k7_k9_boxes_f64(rng, size_eps):
    p0, p1 = (T(a) for a in rays(rng, 2000, 2))
    sp0, sp1 = (T(a) for a in segments(rng, 1200))
    o, d = p0, p1 - p0
    eps = tk._thresholds(EPS, size_eps, EPS)
    u = gk._segment_pairs(*o[:, :, None].unbind(1), *d[:, :, None].unbind(1),
                          *gk._segment_columns(sp0, sp1, 0, sp0.shape[0]),
                          *eps)
    boxes = gk.twolevel_boxes(sp0, sp1, size_eps)
    accepted_inside(o, d, u, lambda cols: boxes[cols // gk.CULL_CHUNK],
                    eps[3])


@pytest.mark.parametrize("case", ["random", "tangent snap"])
def test_accepted_points_inside_k8_k10_boxes_f64(rng, case):
    """Random arcs, and the tangent pairs whose discriminant snaps to 0,
    whose points lie up to 0.134 radii off the circle (``SNAP_REACH``)."""
    if case == "random":
        p0, p1, *surf = (T(a) for a in arc_args(rng))
    else:
        p0, p1, arc_set, _ = {c[0]: c[1:] for c in scenes2d.gate_edge_cases(
            dtype=F64, device="cpu")}[case]
        surf = [arc_set.center, arc_set.angle_start, arc_set.angle_end,
                arc_set.radius]
    o, d = p0, p1 - p0
    table = ak.arc_table(*surf)
    u, _ = ak._arc_pairs(*o[:, :, None].unbind(1), *d[:, :, None].unbind(1),
                         *ak._arc_columns(table, 0, table.shape[0]), EPS, EPS)
    boxes = ak.twolevel_boxes(*surf)
    accepted_inside(o, d, u, lambda cols: boxes[cols // gk.CULL_CHUNK], EPS)


# ----------------------------------------------------------------------
# K10's float64 table
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_k10_table_holds_the_flags_bits(rng, dtype):
    """The flags of 560 arcs (windows narrower and wider than pi) and 40
    full circles as the bits of an int64 (float64) or int32 (float32) in
    their slot, zero past M; every other slot as ``arc_chunk_table``
    holds it."""
    surf = [T(a).to(dtype) for a in arc_args(rng)[2:]]
    m, chunk = surf[0].shape[0], gk.CULL_CHUNK
    table = ak.twolevel_table(*surf)
    values = ak.arc_chunk_table(*surf, chunk)
    assert table.dtype == dtype and table.shape == values.shape
    bits = table[:, 0, :, 3].contiguous().view(ak.FLAG_BITS[dtype]) \
        .reshape(-1)
    flags = ak.arc_table(*surf)[:, 7]
    assert torch.equal(bits[:m], flags.to(ak.FLAG_BITS[dtype]))
    assert not bits[m:].any()
    assert {0.0, 1.0} <= set(flags.tolist())
    # float32 may round a full circle's sweep below its threshold
    assert 3.0 in flags.tolist() or dtype == torch.float32
    other = torch.ones_like(table, dtype=torch.bool)
    other[:, 0, :, 3] = False
    assert torch.equal(table[other], values[other])


# ----------------------------------------------------------------------
# small guides traced through the plain versions, float64
# ----------------------------------------------------------------------

WRAPPERS = {
    ("2d", True): ((gk, "nearest_hit_segments_culled_kernel"),
                   (ak, "nearest_hit_arcs_culled_kernel")),
    ("2d", "grid"): ((gk, "nearest_hit_segments_twolevel_kernel"),
                     (ak, "nearest_hit_arcs_twolevel_kernel")),
    ("3d", "grid"): ((tk, "nearest_hit_triangles_twolevel_kernel"),),
}
GUIDE_2D = dict(n_wall=128, n_lenslets=32)
GUIDE_3D = dict(theta_res=32, z_res=24)


def guide_2d(n, key):
    """scenes2d.light_guide at GUIDE_2D in float64 and its JAX counterpart
    (the same surfaces Morton-sorted by JAX, the rays JAX samples from
    ``key``): ``(port rays, port scene, JAX rays, JAX scene)``."""
    ka, kb = jax.random.split(key)
    uniforms = {k: np.asarray(jax.random.uniform(kk, (n,), jnp.float64))[None]
                for k, kk in (("angle", ka), ("base_point", kb))}
    t_rays, t_scene, _ = scenes2d.light_guide(n, dtype=F64, device="cpu",
                                              uniforms=uniforms, **GUIDE_2D)
    (p0, p1), target, lenslets = scenes2d.guide_surfaces(**GUIDE_2D)
    f64 = jnp.float64
    scene = JScene2D.build(
        optical_segments=[JSegmentSet.make(p0, p1, mat_in=1, mat_out=0,
                                           dtype=f64)],
        target_segments=[JSegmentSet.make(*target, dtype=f64)],
        optical_arcs=[j_surf.ArcSet.make(*lenslets, mat_in=1, mat_out=0,
                                         dtype=f64)])
    j_scene = JScene2D(segments=j_acc.morton_sort_segments(scene.segments)[0],
                       arcs=j_acc.morton_sort_arcs(scene.arcs)[0])
    j_rays = j_src.AngularSource(
        2, (-0.001, 0.0), 0.0,
        j_dist.RandomLambertianAngularDistribution(-0.4 * PI, 0.4 * PI, n),
        j_dist.RandomUniformBeam(-0.95, 0.95, n), [575.0] * n,
        dense=False).sample(key, f64)
    return t_rays, t_scene, j_rays, j_scene


def guide_3d(n):
    """streamed.long_guide_scene at GUIDE_3D in float64, its JAX
    counterpart (tests/test_torch_streamed.py's), and the same entrance
    rays for both: ``(port rays, port scene, JAX rays, JAX scene)``."""
    t_scene = streamed.long_guide_scene(**GUIDE_3D, dtype=F64, device="cpu")
    guide = j_bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 40.0), minimum_radius=0.3,
        rotationally_symmetric=True, initial_taper=(0.7, 0.0), mat_in=1,
        mat_out=0, dtype=jnp.float64, **GUIDE_3D)
    surf, _ = j_acc.morton_sort_triangles(guide.build(guide.init_params()))
    half, z = 0.35, 40.05
    target = JTriangleSet.make(
        [[-half, -half, z], [half, half, z]],
        [[half, -half, z], [-half, half, z]],
        [[half, half, z], [-half, -half, z]], dtype=jnp.float64)
    j_scene = JScene3D.build(optical=[surf], targets=[target])
    p0, p1 = streamed.entrance_rays_np(n, 0)
    return (RaySet.make(p0, p1, 575.0, dtype=F64), t_scene,
            JRaySet.make(jnp.asarray(p0), jnp.asarray(p1), 575.0,
                         dtype=jnp.float64), j_scene)


@pytest.mark.parametrize("dim,cull,bounces", [("2d", True, 6),
                                              ("2d", "grid", 6),
                                              ("3d", "grid", 4)],
                         ids=["K7-K8", "K9-K10", "K4"])
def test_guide_trace_matches_jax_pallas_and_brute_f64(monkeypatch, dim, cull,
                                                      bounces):
    if dim == "2d":
        t_rays, t_scene, j_rays, j_scene = guide_2d(512, jax.random.PRNGKey(5))
        assert (t_scene.segments.n_surfaces, t_scene.arcs.n_surfaces) == (258,
                                                                         32)
        extra = dict(dead_ray_length=10.0)
    else:
        t_rays, t_scene, j_rays, j_scene = guide_3d(1024)
        assert t_scene.triangles.n_surfaces == 1538
        extra = {}
    calls = []
    for mod, name in WRAPPERS[dim, cull]:
        wrapper = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, w=wrapper, n=name: (
            calls.append(n), w(*a))[1])
    acc = dict(max_bounces=bounces, cull=cull, resort_rays=True, **extra)
    got = trace(t_rays, t_scene, T_MATS,
                TraceConfig(use_kernel=True, **acc)).rays
    assert sorted(calls) == sorted(n for _, n in WRAPPERS[dim, cull]
                                   for _ in range(bounces))
    brute = trace(t_rays, t_scene, T_MATS, TraceConfig(
        use_kernel=True, max_bounces=bounces, **extra)).rays
    for name in ("state", "p0", "p1"):
        assert torch.equal(getattr(got, name), getattr(brute, name)), name
    want = j_engine.trace(j_rays, j_scene, J_MATS,
                          JTraceConfig(use_pallas=True, **acc)).rays
    np.testing.assert_array_equal(got.state.numpy(), np.asarray(want.state))
    for name in ("p0", "p1"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=1e-9)
    assert got.p1.dtype == F64
    assert (got.state == 0).any() and (got.state != 0).any()
