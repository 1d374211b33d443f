"""Parity of the port's acceleration path with the JAX package.

* ``models/acceleration``: host and device Morton codes, the triangle sort's
  permutation and the chunk boxes equal JAX's exactly.
* ``models/mesh.cylindrical_mesh`` and ``models/boundaries.FromAxisVG``
  equal JAX's exactly; ``ParametricCylindricalGuide.build`` agrees within
  rtol 1e-12 in float64 (one rounding of the linear taper apart).
* ``ops/triangle_kernels``: the candidate precompute of K4 equals JAX's
  ``_twolevel_candidates`` (same ray block and cap, ray counts a multiple of
  the block, where the TPU version's zero padding does not vote); the plain
  versions of K3 and K4 meet tests/test_pallas.py's criteria against the
  Pallas kernels in interpret mode (equal ``valid``, ``ray_u`` within rtol
  1e-5, > 99% equal ``idx``: XLA:CPU rounds the interpreted kernels
  differently in the last bit) and equal the plain K1 bit for bit,
  including K4's overflow sweep; both gate each ray on its own, on widened
  boxes, and so do the walks of the plain versions, ``twolevel_walk`` (K4,
  K9, K10) and ``segment_kernels.culled_walk`` (K7, K8).
* ``engine``: traces with ``cull=True`` and with ``cull="grid",
  resort_rays=True`` equal the ``cull=False`` trace exactly, and the
  accelerated trace agrees with JAX's ``use_pallas=True`` trace.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu.models import acceleration as j_acc
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.models import mesh as j_mesh
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu.ops import pallas_kernels as pk
from tensorflowraytrace_tpu_torch import (
    Scene3D, TraceConfig, config, scenes2d, trace,
)
from tensorflowraytrace_tpu_torch import engine as t_engine
from tensorflowraytrace_tpu_torch.models import acceleration as t_acc
from tensorflowraytrace_tpu_torch.models import boundaries as t_bd
from tensorflowraytrace_tpu_torch.models import mesh as t_mesh
from tensorflowraytrace_tpu_torch.ops import materials as t_mats
from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from tensorflowraytrace_tpu_torch.utils.convert import (
    guide_params_from_numpy, rayset_from_numpy, triangles_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

EPS = 1e-6
GUIDE = dict(minimum_radius=0.3, theta_res=8, z_res=6, mat_in=1, mat_out=0)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def soup(rng, n_tris, n_rays, dtype=np.float32):
    """tests/test_pallas.py's random soup and rays."""
    center = rng.uniform(-3, 3, (n_tris, 3))
    tris = [(center + rng.normal(0, 0.4, (n_tris, 3))).astype(dtype)
            for _ in range(3)]
    p0 = rng.uniform(-4, 4, (n_rays, 3)).astype(dtype)
    d = rng.normal(0, 1, (n_rays, 3)).astype(dtype)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tris, p0, p0 + d


def sorted_soup(rng, n_tris, n_rays):
    """The soup Morton-sorted (by the JAX package) as numpy arrays."""
    tris, p0, p1 = soup(rng, n_tris, n_rays)
    jt, _ = j_acc.morton_sort_triangles(JTriangleSet.make(*tris, mat_in=1,
                                                          dtype=jnp.float32))
    return [np.array(a) for a in (jt.vp, jt.v1, jt.v2)], p0, p1


def guides(dtype, **kw):
    """The same guide in both packages; the port loads JAX's parameters."""
    jg = j_bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 4.0),
        dtype={np.float32: jnp.float32, np.float64: jnp.float64}[dtype],
        **GUIDE, **kw)
    tg = t_bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 4.0),
        dtype={np.float32: torch.float32, np.float64: torch.float64}[dtype],
        **GUIDE, **kw)
    return jg, guide_params_from_numpy(tg, np.asarray(jg.init_params()))


def torch_args(p0, p1, tris):
    return [torch.as_tensor(a) for a in (p0, p1, *tris)]


# ----------------------------------------------------------------------
# models/acceleration, mesh, boundaries
# ----------------------------------------------------------------------

def test_morton_codes_match_jax(rng):
    pts = rng.normal(0, 2, (3000, 3))
    np.testing.assert_array_equal(t_acc._morton_codes(pts),
                                  j_acc._morton_codes(pts))


def test_morton_codes_device_match_jax(rng):
    lo, hi = np.array([-3.0, -1.0, 0.0]), np.array([3.0, 2.0, 40.0])
    pts = rng.uniform(lo, hi, (3000, 3)).astype(np.float32)
    want = j_acc.morton_codes_device(jnp.asarray(pts), jnp.asarray(lo, jnp.float32),
                                     jnp.asarray(hi, jnp.float32))
    got = t_acc.morton_codes_device(torch.as_tensor(pts),
                                    torch.as_tensor(lo, dtype=torch.float32),
                                    torch.as_tensor(hi, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_morton_codes_device_park_sorts_last():
    """Points far outside the box (parked rays) clamp to the largest code;
    points below it to the smallest."""
    lo, hi = torch.zeros(3), torch.ones(3)
    pts = torch.tensor([[1e30, 1e30, 1e30], [-5.0, -5.0, -5.0], [0.5, 0.5, 0.5]])
    codes = t_acc.morton_codes_device(pts, lo, hi)
    assert codes[0] == (1 << 30) - 1 and codes[1] == 0
    assert 0 < codes[2] < codes[0]


@pytest.mark.parametrize("scene", ["soup", "guide"])
def test_morton_sort_permutation_matches_jax(rng, scene):
    if scene == "soup":
        tris = soup(rng, 500, 1)[0]
        jt = JTriangleSet.make(*tris, mat_in=1, dtype=jnp.float32)
        tt = triangles_from_numpy(*tris, mat_in=1, dtype=torch.float32)
    else:
        jg, tg = guides(np.float32, initial_taper=(0.7, 0.0))
        jt, tt = jg.build(jg.init_params()), tg.build()
    tt.fields["w"] = torch.arange(tt.n_surfaces)
    j_sorted, j_perm = j_acc.morton_sort_triangles(jt)
    t_sorted, t_perm = t_acc.morton_sort_triangles(tt)
    np.testing.assert_array_equal(t_perm, j_perm)
    for name in ("vp", "v1", "v2", "norm", "mat_in"):
        np.testing.assert_array_equal(getattr(t_sorted, name).detach().numpy(),
                                      np.asarray(getattr(j_sorted, name)))
    np.testing.assert_array_equal(t_sorted.fields["w"].numpy(), t_perm)


@pytest.mark.parametrize("m,chunk", [(600, 64), (333, 256), (256, 256), (5, 2)])
def test_chunk_aabbs_match_jax(rng, m, chunk):
    tris = soup(rng, m, 1)[0]
    want = np.asarray(j_acc.chunk_aabbs(*[jnp.asarray(a) for a in tris], chunk))
    got = t_acc.chunk_aabbs(*[torch.as_tensor(a) for a in tris], chunk)
    assert got.shape == (-(-m // chunk), 6)
    np.testing.assert_array_equal(got.numpy(), want[:6].T)


@pytest.mark.parametrize("kw", [
    dict(), dict(start_cap=False), dict(end_cap=False, use_twist=True),
    dict(start=(1.0, 2.0, 3.0), end=(4.0, 0.0, 3.0), radius=0.5),
])
def test_cylindrical_mesh_matches_jax(kw):
    kw = dict(dict(start=(0.0, 0.0, 0.0), end=(0.0, 0.0, 40.0), theta_res=7,
                   z_res=5), **kw)
    want, got = j_mesh.cylindrical_mesh(**kw), t_mesh.cylindrical_mesh(**kw)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.faces, want.faces)


@pytest.mark.parametrize("axis", [dict(point=(0.0, 0.0, 40.0)),
                                  dict(direction=(1.0, 2.0, -0.5))])
def test_from_axis_vg_matches_jax(rng, axis):
    mesh = j_mesh.cylindrical_mesh((0.0, 0.0, 0.0), (0.0, 0.0, 40.0),
                                   theta_res=8, z_res=4)
    pts = np.concatenate([mesh.points, rng.normal(0, 3, (50, 3))])
    want = np.asarray(j_bd.FromAxisVG((0.0, 0.0, 0.0), **axis)
                      .generate(jnp.asarray(pts)))
    got = t_bd.FromAxisVG((0.0, 0.0, 0.0), **axis).generate(torch.as_tensor(pts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    if "point" in axis:  # the cap centres lie on the axis: exactly zero
        assert (got[[0, mesh.n_points - 1]] == 0).all()


@pytest.mark.parametrize("rot", [True, False])
@pytest.mark.parametrize("taper", [None, (0.7, 0.0)])
def test_guide_build_matches_jax_f64(rot, taper):
    jg = j_bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 4.0), rotationally_symmetric=rot,
        initial_taper=taper, initial_parameters=0.2, dtype=jnp.float64,
        **GUIDE)
    tg = t_bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 4.0), rotationally_symmetric=rot,
        initial_taper=taper, initial_parameters=0.2, dtype=torch.float64,
        **GUIDE)
    assert tg.n_params == jg.n_params
    np.testing.assert_allclose(tg.params.detach().numpy(),
                               np.asarray(jg.init_params()), rtol=1e-12)
    np.testing.assert_array_equal(tg.vertex_update_map.numpy(),
                                  np.asarray(jg.vertex_update_map))
    np.testing.assert_array_equal(tg.accumulator, jg.accumulator)
    js, ts = jg.build(jg.init_params()), tg.build()
    for name in ("vp", "v1", "v2", "norm"):
        np.testing.assert_allclose(getattr(ts, name).detach().numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-12, atol=1e-14)
    # a gradient reaches the parameters through the masked gather
    ts.vp.sum().backward()
    assert torch.isfinite(tg.params.grad).all()


# ----------------------------------------------------------------------
# ops/triangle_kernels: K3 and K4 plain versions, candidate precompute
# ----------------------------------------------------------------------

def rays8(p0, p1):
    r = np.zeros((8, p0.shape[0]), np.float32)
    r[0:3], r[3:6] = p0.T, p1.T
    return jnp.asarray(r)


@pytest.mark.parametrize("case", ["lists", "overflow", "groups"])
def test_twolevel_candidates_match_jax(rng, monkeypatch, case):
    tris, p0, p1 = sorted_soup(rng, 5200, 1536)
    rb, fine, cap = 256, 256, {"lists": 32, "overflow": 3, "groups": 32}[case]
    if case == "groups":  # 21 chunks in groups of 16, in both packages
        monkeypatch.setattr(pk, "CAND_GROUP_BYTES", 1)
        monkeypatch.setattr(tk, "CAND_GROUP_BYTES", 1)
        assert tk._cand_chunk_group(1536, 21) == 16
    want_counts, want_cand = pk._twolevel_candidates(
        rays8(p0, p1), j_acc.chunk_aabbs(*[jnp.asarray(a) for a in tris], fine),
        EPS, rb, cap)
    boxes = t_acc.chunk_aabbs(*[torch.as_tensor(a) for a in tris], fine)
    counts, cand = tk.twolevel_candidates(torch.as_tensor(p0),
                                          torch.as_tensor(p1), boxes, EPS,
                                          rb, cap)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want_cand))
    assert counts.dtype == cand.dtype == torch.int32
    if case == "overflow":
        assert (counts == 21).any()


@pytest.mark.parametrize("cull", [True, "grid"])
def test_plain_culled_matches_pallas_interpret(rng, cull):
    tris, p0, p1 = sorted_soup(rng, 1200, 700)
    jt = JTriangleSet.make(*tris, mat_in=1, dtype=jnp.float32)
    kw = dict(ray_block=256, tri_block=64) if cull is True else {}
    v_ref, i_ref, u_ref = (np.asarray(a) for a in pk.nearest_hit_triangles_pallas(
        jnp.asarray(p0), jnp.asarray(p1), jt, EPS, EPS, EPS, interpret=True,
        cull=cull, **kw))
    search = (tk.nearest_hit_triangles_culled_plain if cull is True
              else tk.nearest_hit_triangles_twolevel_plain)
    valid, idx, u = (a.numpy() for a in search(*torch_args(p0, p1, tris),
                                               EPS, EPS, EPS))
    np.testing.assert_array_equal(valid, v_ref)
    np.testing.assert_allclose(u[v_ref], u_ref[v_ref], rtol=1e-5)
    assert (idx[v_ref] == i_ref[v_ref]).mean() > 0.99
    assert v_ref.any() and not v_ref.all()


@pytest.mark.parametrize("search,kw", [
    ("culled", {}), ("culled", dict(CULL_CHUNK=64)),
    ("twolevel", {}), ("twolevel", dict(TWOLEVEL_MAX_CAND=2)),
    ("twolevel", dict(TWOLEVEL_RAY_BLOCK=64, FINE_CHUNK=128)),
])
@pytest.mark.parametrize("shape", [(1500, 2000), (1000, 333), (33, 1)])
def test_plain_culled_equals_plain_k1(rng, monkeypatch, search, kw, shape):
    """Bit for bit, on a sorted soup with some rays parked (p0 = 1e30, as
    the engine parks terminated rays) and some pointing away from it; ``kw``
    sets the module's chunk, block and cap constants."""
    for name, value in kw.items():
        monkeypatch.setattr(tk, name, value)
    n_rays, n_tris = shape
    tris, p0, p1 = sorted_soup(rng, n_tris, n_rays)
    parked = rng.random(n_rays) < 0.2
    p0[parked], p1[parked] = 1e30, np.float32(1e30 * (1 + 1e-6))
    away = rng.random(n_rays) < 0.1
    p0[away], p1[away] = 100.0, 101.0
    args = torch_args(p0, p1, tris)
    ref = tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS)
    fn = getattr(tk, f"nearest_hit_triangles_{search}_plain")
    got = fn(*args, EPS, EPS, EPS)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert not ref[0][torch.as_tensor(parked | away)].any()
    if n_tris > 1:
        assert ref[0].any()


def small_guide(rng, n_rays):
    """chip_smoke.py's 3D guide, small: a 16 x 32 ring cylindrical guide
    (1024 triangles, taper 0.7 -> 0, Morton-sorted), rays from a disc near
    its start heading down it."""
    guide = t_bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 40.0), minimum_radius=0.3, theta_res=16,
        z_res=32, rotationally_symmetric=True, initial_taper=(0.7, 0.0),
        mat_in=1, mat_out=0, dtype=torch.float32)
    with torch.no_grad():
        surf, _ = t_acc.morton_sort_triangles(guide.build())
    r = 0.2 * np.sqrt(rng.uniform(0, 1, n_rays))
    th = rng.uniform(0, 2 * np.pi, n_rays)
    p0 = np.stack([r * np.cos(th), r * np.sin(th), np.full(n_rays, 0.1)],
                  1).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3))
    d[:, 2] = np.abs(d[:, 2]) * 3 + 1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(p0), torch.as_tensor(p0 + d.astype(np.float32)),
            surf.vp, surf.v1, surf.v2)


@pytest.mark.parametrize("chunk", [256, 64])
def test_plain_culled_gates_each_ray_and_equals_k1_on_a_guide(rng, monkeypatch,
                                                              chunk):
    """K3's plain version gates ray by ray (no warp vote) and still equals
    the plain K1 bit for bit on a small guide, including a ray that grazes
    a triangle s_eps beyond its edge, outside the chunk's raw box: the
    widened box (``culled_boxes``) keeps it."""
    monkeypatch.setattr(tk, "CULL_CHUNK", chunk)
    p0, p1, vp, v1, v2 = small_guide(rng, 2000)
    # the graze: a lone triangle past the guide's end (the last chunk) and
    # a ray along -z through its edge y = 5 at tv ~ -s_eps / 2
    t = vp.shape[0]
    lone = torch.tensor([[5.0, 5.0, 45.0], [6.0, 5.0, 45.0], [5.0, 6.0, 45.0]])
    vp, v1, v2 = (torch.cat([v, lone[k][None]]) for k, v in enumerate((vp, v1,
                                                                       v2)))
    y = np.float32(5.0) - np.float32(5e-7)
    p0 = torch.cat([torch.tensor([[5.5, y, 46.0]]), p0])
    p1 = torch.cat([torch.tensor([[5.5, y, 44.0]]), p1])
    args = (p0, p1, vp, v1, v2)
    ref = tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS)
    got = tk.nearest_hit_triangles_culled_plain(*args, EPS, EPS, EPS)
    for x, w in zip(got, ref):
        assert torch.equal(x, w)
    assert bool(ref[0][0]) and int(ref[1][0]) == t
    assert ref[0].float().mean() > 0.5
    # outside the raw box of its chunk, inside the widened one
    raw = t_acc.chunk_aabbs(vp, v1, v2, chunk)[-1]
    wide = tk.culled_boxes(vp, v1, v2, EPS)[-1]
    assert y < raw[1] and wide[1] <= y


def test_plain_twolevel_gates_each_ray_and_equals_k1_on_a_guide(rng):
    """K4's plain version gates ray by ray, on K3's widened boxes at its
    fine chunk, and equals the plain K1 bit for bit on a small guide with
    the graze of the K3 test above: a ray along -z through a lone
    triangle's edge at tv ~ -s_eps / 2, outside its fine chunk's raw box."""
    p0, p1, vp, v1, v2 = small_guide(rng, 2000)
    t = vp.shape[0]
    lone = torch.tensor([[5.0, 5.0, 45.0], [6.0, 5.0, 45.0], [5.0, 6.0, 45.0]])
    vp, v1, v2 = (torch.cat([v, lone[k][None]]) for k, v in enumerate((vp, v1,
                                                                       v2)))
    y = np.float32(5.0) - np.float32(5e-7)
    p0 = torch.cat([torch.tensor([[5.5, y, 46.0]]), p0])
    p1 = torch.cat([torch.tensor([[5.5, y, 44.0]]), p1])
    args = (p0, p1, vp, v1, v2)
    ref = tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS)
    got = tk.nearest_hit_triangles_twolevel_plain(*args, EPS, EPS, EPS)
    for x, w in zip(got, ref):
        assert torch.equal(x, w)
    assert bool(ref[0][0]) and int(ref[1][0]) == t
    raw = t_acc.chunk_aabbs(vp, v1, v2, tk.FINE_CHUNK)[-1]
    wide = tk.twolevel_prepare(*args, EPS, EPS)[1][-1]
    assert y < raw[1] and wide[1] <= y


def test_twolevel_walk_gate_group(rng):
    """``twolevel_walk`` yields at its first step exactly the rays that pass
    their own gate, as K4, K9 and K10 gate them."""
    tris, p0, p1 = sorted_soup(rng, 2000, 700)
    p0[::3] = 100.0                       # a third of the rays point away
    p1[::3] = 101.0
    p0, p1 = torch.as_tensor(p0), torch.as_tensor(p1)
    vp, v1, v2 = (torch.as_tensor(a) for a in tris)
    _, boxes, counts, cand, cap = tk.twolevel_prepare(p0, p1, vp, v1, v2, EPS,
                                                      EPS)
    best = torch.full((700,), tk.BIG)
    chunk, rows = next(tk.twolevel_walk(p0, p1, boxes, counts, cand, cap,
                                        tk.TWOLEVEL_RAY_BLOCK, EPS, best))
    block = torch.arange(700) // tk.TWOLEVEL_RAY_BLOCK
    first = cand.view(-1, cap)[block, 0].long()
    box = boxes[first].T
    need = tk._slab_gate(p0.unbind(1), tk._inverse_direction(p1 - p0).unbind(1),
                         box[:3], box[3:], EPS, best) & (counts > 0)[block]
    assert torch.equal(rows, torch.nonzero(need)[:, 0])
    assert torch.equal(chunk, first[rows])
    assert rows.numel() > 100 and not need[::3].any()


def test_culled_walk_gates_each_ray(rng):
    """``segment_kernels.culled_walk`` yields at its first step chunk 0
    and exactly the rays that pass their own gate on its box, as K7 and K8
    gate them; a third of the rays point away and none of them is
    yielded."""
    seg = scenes2d.random_segments(rng, 700, device="cpu")
    p0, p1 = scenes2d.random_rays(rng, 2000, device="cpu")
    p0[::3] = 100.0
    p1[::3] = 101.0
    boxes = gk.twolevel_boxes(seg.p0, seg.p1, EPS)
    best = torch.full((2000,), tk.BIG)
    c, rows = next(gk.culled_walk(p0, p1, boxes, EPS, best))
    box = boxes[0]
    need = tk._slab_gate(p0.unbind(1), tk._inverse_direction(p1 - p0).unbind(1),
                         box[:2], box[2:], EPS, best)
    assert c == 0 and torch.equal(rows, torch.nonzero(need)[:, 0])
    assert 100 < rows.numel() < 1300 and not need[::3].any()


@pytest.mark.parametrize("live", [0, 1, 31, 32, 33, 64, 128])
def test_plain_twolevel_with_blocks_that_few_rays_need(rng, monkeypatch,
                                                       live):
    """Blocks of 128 rays in which ``live`` rays point into a sorted soup
    and the rest away or parked: K4's plain version equals the plain K1,
    its lists and gates serving 0, 1, a warp, a warp and one, or every ray
    of a block; a cap of 2 makes the blocks with candidates sweep."""
    monkeypatch.setattr(tk, "TWOLEVEL_RAY_BLOCK", 128)
    tris, p0, p1 = sorted_soup(rng, 1300, 3 * 128)
    dead = (np.arange(3 * 128) % 128) >= live
    p0[dead], p1[dead] = 100.0, 101.0
    p0[dead & (np.arange(3 * 128) % 2 == 0)] = 1e30
    p1[dead & (np.arange(3 * 128) % 2 == 0)] = np.float32(1e30 * (1 + 1e-6))
    args = torch_args(p0, p1, tris)
    ref = tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS)
    for cap in (32, 2):
        monkeypatch.setattr(tk, "TWOLEVEL_MAX_CAND", cap)
        got = tk.nearest_hit_triangles_twolevel_plain(*args, EPS, EPS, EPS)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert not ref[0][torch.as_tensor(dead)].any()
    assert bool(ref[0].any()) == (live > 0)


def test_twolevel_overflow_constant_reaches_the_wrapper(rng, monkeypatch):
    """The cap is read from the module at call time, so a test lowers it
    (as tests/test_pallas.py lowers TWOLEVEL_MAX_CAND) and every block of
    this soup sweeps all chunks."""
    tris, p0, p1 = sorted_soup(rng, 3000, 800)
    args = torch_args(p0, p1, tris)
    monkeypatch.setattr(tk, "TWOLEVEL_MAX_CAND", 2)
    counts, _ = tk.twolevel_candidates(
        args[0], args[1], t_acc.chunk_aabbs(*args[2:], tk.FINE_CHUNK), EPS,
        tk.TWOLEVEL_RAY_BLOCK, 2)
    assert (counts == -(-3000 // tk.FINE_CHUNK)).all()
    got = tk.nearest_hit_triangles_twolevel_kernel(*args, EPS, EPS, EPS)
    for a, b in zip(got, tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["culled", "twolevel"])
def test_wrappers_run_plain_on_cpu_and_refuse_other_devices(rng, name):
    tris, p0, p1 = sorted_soup(rng, 300, 200)
    args = torch_args(p0, p1, tris)
    counter = f"LAUNCHES_{name.upper()}"
    before = getattr(tk, counter)
    fn = getattr(tk, f"nearest_hit_triangles_{name}_kernel")
    got = fn(*args, EPS, EPS, EPS)
    assert getattr(tk, counter) == before  # the CPU path launches nothing
    for a, b in zip(got, getattr(tk, f"nearest_hit_triangles_{name}_plain")(
            *args, EPS, EPS, EPS)):
        assert torch.equal(a, b)
    t = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no triangle search"):
        fn(t, t, t, t, t, EPS, EPS, EPS)


# ----------------------------------------------------------------------
# engine: parking, re-sort and the accelerated traces
# ----------------------------------------------------------------------

def quad(x, half, z=None):
    """Two triangles covering x = const (or z = const when ``z``)."""
    a, b = -half, half
    pts = [[[x, a, a], [x, b, b]], [[x, b, a], [x, a, b]], [[x, b, b], [x, a, a]]]
    if z is not None:
        pts = [[[p[1], p[2], z] for p in tri] for tri in pts]
    return pts


def soup_case(rng, dt):
    tris, p0, p1 = sorted_soup(rng, 1500, 1000)
    optical = [([t.astype(dt) for t in tris], dict(mat_in=1, mat_out=0))]
    targets = [(quad(20.0, 50.0), {})]
    return optical, targets, p0.astype(dt), p1.astype(dt), ("vacuum",
                                                            "reflective")


def guide_case(rng, dt):
    """A small guide (Morton-sorted) of acrylic with a target past its end;
    rays from near the axis at the start, as bench.py's structured scene."""
    jg, _ = guides(dt, rotationally_symmetric=True, initial_taper=(0.7, 0.0))
    jt, _ = j_acc.morton_sort_triangles(jg.build(jg.init_params()))
    half, n = 0.35, 1200
    optical = [([np.asarray(a) for a in (jt.vp, jt.v1, jt.v2)],
                dict(mat_in=1, mat_out=0))]
    targets = [(quad(0.0, half, z=4.05), {})]
    r = 0.2 * np.sqrt(rng.uniform(0, 1, n))
    th = rng.uniform(0, 2 * np.pi, n)
    p0 = np.stack([r * np.cos(th), r * np.sin(th), np.full(n, 0.1)], 1)
    d = rng.normal(0, 1, (n, 3))
    d[:, 2] = np.abs(d[:, 2]) * 3 + 1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return optical, targets, p0.astype(dt), (p0 + d).astype(dt), ("vacuum",
                                                                  "acrylic")


def build_both(case):
    optical, targets, p0, p1, mats = case
    dt = p0.dtype
    jdt = {np.float32: jnp.float32, np.float64: jnp.float64}[dt.type]
    tdt = {np.float32: torch.float32, np.float64: torch.float64}[dt.type]
    j_scene = JScene3D.build(
        optical=[JTriangleSet.make(*v, dtype=jdt, **o) for v, o in optical],
        targets=[JTriangleSet.make(*np.asarray(v, dt), dtype=jdt)
                 for v, _ in targets])
    t_scene = Scene3D.build(
        optical=[triangles_from_numpy(*v, dtype=tdt, **o) for v, o in optical],
        targets=[triangles_from_numpy(*np.asarray(v, dt), dtype=tdt)
                 for v, _ in targets])
    j_rays = JRaySet.make(jnp.asarray(p0), jnp.asarray(p1), 575.0, dtype=jdt)
    t_rays = rayset_from_numpy(p0, p1, np.full(len(p0), 575.0), dtype=tdt)
    return ((j_rays, j_scene, tuple(getattr(j_mats, k) for k in mats)),
            (t_rays, t_scene, tuple(getattr(t_mats, k) for k in mats)))


@pytest.mark.parametrize("make_case", [soup_case, guide_case])
def test_accelerated_traces_equal_brute(rng, make_case):
    _, (rays, scene, mats) = build_both(make_case(rng, np.float32))
    kw = dict(max_bounces=5, use_kernel=True)
    ref = trace(rays, scene, mats, TraceConfig(**kw)).rays
    assert (ref.state != 0).any() and (ref.state == 1).any()
    for acc in (dict(cull=True), dict(cull="grid"),
                dict(cull="grid", resort_rays=True),
                dict(cull=True, resort_rays=True)):
        got = trace(rays, scene, mats, TraceConfig(**kw, **acc)).rays
        assert torch.equal(got.state, ref.state), acc
        assert torch.equal(got.p1, ref.p1), acc
        assert torch.equal(got.p0, ref.p0), acc


def test_resort_scatters_the_hits_back(rng):
    """project_3d with the re-sort returns the hits in slot order: the same
    projection as without it."""
    _, (rays, scene, mats) = build_both(soup_case(rng, np.float32))
    rays = rayset_from_numpy(rays.p0, rays.p1, rays.wavelength,
                             np.where(rng.random(rays.n_rays) < 0.3, 3, 0),
                             dtype=torch.float32)
    base = dict(max_bounces=1, use_kernel=True, cull="grid")
    a = t_engine.project_3d(rays, scene, mats, TraceConfig(**base))
    b = t_engine.project_3d(rays, scene, mats,
                            TraceConfig(resort_rays=True, **base))
    active = rays.state == 0
    for name in ("hit_valid", "surf_idx", "point"):
        assert torch.equal(getattr(a, name)[active], getattr(b, name)[active])
    assert not a.hit_valid[~active].any()  # parked rays hit nothing


@pytest.mark.parametrize("make_case", [soup_case, guide_case])
def test_grid_resort_trace_matches_jax_pallas_f64(rng, make_case):
    """The same scene through JAX's use_pallas=True, cull="grid",
    resort_rays=True (the Pallas kernels in interpret mode) and the port's
    use_kernel=True with the same settings (K4's plain version), in
    float64: state equal, endpoints within atol 1e-9."""
    (jr, js, jm), (tr, ts, tm) = build_both(make_case(rng, np.float64))
    acc = dict(max_bounces=3, cull="grid", resort_rays=True)
    j_res = j_engine.trace(jr, js, jm, JTraceConfig(use_pallas=True, **acc))
    t_res = t_engine.trace(tr, ts, tm, TraceConfig(use_kernel=True, **acc))
    np.testing.assert_array_equal(t_res.rays.state.numpy(),
                                  np.asarray(j_res.rays.state))
    np.testing.assert_allclose(t_res.rays.p1.numpy(), np.asarray(j_res.rays.p1),
                               atol=1e-9)
    assert (t_res.rays.state == 1).any()
