"""The 2D search of the PyTorch port against the JAX package, on the CPU.

* ``models/acceleration`` (2D): host and device Morton codes, the segment
  and arc sorts' permutations, ``arc_aabbs``, ``chunk_aabbs_2d`` and
  ``chunk_aabbs_arcs`` equal JAX's exactly.
* The XLA path (``use_kernel=False``) of ``nearest_hit_segments``,
  ``nearest_hit_arcs`` and ``nearest_hit_2d``, and both refines, in
  float64: ``valid``, ``idx``, ``kind`` and ``branch`` exactly, ``ray_u``
  within rtol 1e-12.
* The plain versions of K5-K8 against the Pallas kernels in interpret mode
  (``ray_block=128``, ``seg_block``/``arc_block`` 32), with
  tests/test_pallas.py's criteria: equal ``valid``, ``ray_u`` within rtol
  1e-5 (for arcs plus atol 2e-6: the discriminant is evaluated without the
  TPU form's cancellation), > 99% equal ``idx`` and equal ``branch`` where
  ``idx`` is equal.
* The plain culled K7 and K8 equal the plain K5 and K6 bit for bit, parked
  rays, rays that miss, full circles and the rounding margin of the gate's
  boxes included.
* No silent fallback: the wrappers run their plain versions only on CPU
  tensors and refuse other devices; ``cull="grid"`` on a 2D scene runs K9
  and K10 and returns the brute hits; no module of the port imports JAX or the JAX package; every header a
  kernel source includes ships with the package.
"""

import ast
import glob
import math
import re
import subprocess
import sys
import tomllib
from fnmatch import fnmatch
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import acceleration as j_acc
from tensorflowraytrace_tpu.models import surfaces as j_surf
from tensorflowraytrace_tpu.ops import intersect as j_isect
from tensorflowraytrace_tpu.ops import pallas_kernels as pk
from tensorflowraytrace_tpu_torch import config, scenes2d
from tensorflowraytrace_tpu_torch.models import acceleration as t_acc
from tensorflowraytrace_tpu_torch.models import surfaces as t_surf
from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
from tensorflowraytrace_tpu_torch.ops import intersect as t_isect
from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
from tensorflowraytrace_tpu_torch.utils.convert import (
    arcs_from_numpy, segments_from_numpy,
)

EPS = 1e-6
PI = math.pi
REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tensorflowraytrace_tpu_torch"


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def segments(rng, m, dtype=np.float32):
    """tests/test_pallas.py's random segments: (p0, p1)."""
    mid = rng.uniform(-3, 3, (m, 2))
    return [(mid + rng.normal(0, 0.5, (m, 2))).astype(dtype) for _ in range(2)]


def arcs(rng, m, dtype=np.float32, full=False):
    """Random arcs: centres in [-3, 3]^2, signed radii, windows sweeping
    0.3-5.8 rad (or the full circle), ends wrapped to [-pi, pi)."""
    center = rng.uniform(-3, 3, (m, 2))
    a1 = rng.uniform(-PI, PI, m)
    sweep = np.full(m, 2 * PI) if full else rng.uniform(0.3, 5.8, m)
    a2 = (a1 + sweep + PI) % (2 * PI) - PI if not full else a1 + sweep
    radius = rng.uniform(0.3, 1.5, m) * rng.choice([-1.0, 1.0], m)
    return [a.astype(dtype) for a in (center, a1, a2, radius)]


def rays(rng, n, dtype=np.float32):
    p0 = rng.uniform(-4, 4, (n, 2))
    d = rng.normal(0, 1, (n, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p0.astype(dtype), (p0 + d).astype(dtype)


def both_segments(arrays, jdt=jnp.float32, tdt=torch.float32):
    return (j_surf.SegmentSet.make(*arrays, mat_in=1, dtype=jdt),
            segments_from_numpy(*arrays, mat_in=1, dtype=tdt))


def both_arcs(arrays, jdt=jnp.float32, tdt=torch.float32):
    return (j_surf.ArcSet.make(*arrays, mat_in=1, dtype=jdt),
            arcs_from_numpy(*arrays, mat_in=1, dtype=tdt))


def T(a):
    return torch.as_tensor(np.array(a))


# ----------------------------------------------------------------------
# models/acceleration (2D)
# ----------------------------------------------------------------------

def test_morton_codes_2d_match_jax(rng):
    pts = rng.normal(0, 2, (3000, 2))
    np.testing.assert_array_equal(t_acc._morton_codes(pts),
                                  j_acc._morton_codes(pts))
    lo, hi = np.array([0.0, -1.0]), np.array([50.0, 1.0])
    pts = rng.uniform(lo, hi, (3000, 2)).astype(np.float32)
    want = j_acc.morton_codes_device(jnp.asarray(pts),
                                     jnp.asarray(lo, jnp.float32),
                                     jnp.asarray(hi, jnp.float32))
    got = t_acc.morton_codes_device(T(pts), T(lo).float(), T(hi).float())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    # a parked ray takes the largest code (32 bits), one below the box 0
    park = t_acc.morton_codes_device(torch.tensor([[1e30, 1e30], [-5.0, -5.0]]),
                                     T(lo).float(), T(hi).float())
    assert park.tolist() == [(1 << 32) - 1, 0]


def test_morton_sorts_match_jax(rng):
    js, ts = both_segments(segments(rng, 700))
    ts.fields["w"] = torch.arange(700)
    j_sorted, j_perm = j_acc.morton_sort_segments(js)
    t_sorted, t_perm = t_acc.morton_sort_segments(ts)
    np.testing.assert_array_equal(t_perm, j_perm)
    for name in ("p0", "p1", "mat_in", "category"):
        np.testing.assert_array_equal(getattr(t_sorted, name).numpy(),
                                      np.asarray(getattr(j_sorted, name)))
    np.testing.assert_array_equal(t_sorted.fields["w"].numpy(), t_perm)

    ja, ta = both_arcs(arcs(rng, 500))
    j_sorted, j_perm = j_acc.morton_sort_arcs(ja)
    t_sorted, t_perm = t_acc.morton_sort_arcs(ta)
    np.testing.assert_array_equal(t_perm, j_perm)
    for name in ("center", "angle_start", "angle_end", "radius"):
        np.testing.assert_array_equal(getattr(t_sorted, name).numpy(),
                                      np.asarray(getattr(j_sorted, name)))


@pytest.mark.parametrize("m,chunk", [(600, 64), (333, 256), (256, 256), (5, 2)])
def test_chunk_boxes_2d_match_jax(rng, m, chunk):
    sp0, sp1 = segments(rng, m)
    want = np.asarray(j_acc.chunk_aabbs_2d(jnp.asarray(sp0), jnp.asarray(sp1),
                                           chunk))
    got = t_acc.chunk_aabbs_2d(T(sp0), T(sp1), chunk)
    assert got.shape == (-(-m // chunk), 4)
    np.testing.assert_array_equal(got.numpy(), want[:4].T)

    # the arcs' boxes take cos and sin, which XLA and torch round apart by
    # an ulp: compared within 4 ulps, in float32 and float64
    for dtype, rtol in ((np.float32, 5e-7), (np.float64, 1e-15)):
        a = arcs(rng, m, dtype)
        for t, j in zip(t_acc.arc_aabbs(*map(T, a)),
                        j_acc.arc_aabbs(*map(jnp.asarray, a))):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                                       atol=4 * rtol)
        want = np.asarray(j_acc.chunk_aabbs_arcs(*map(jnp.asarray, a), chunk))
        got = t_acc.chunk_aabbs_arcs(*map(T, a), chunk)
        assert got.shape == (-(-m // chunk), 4) and got.dtype == T(a[0]).dtype
        np.testing.assert_allclose(got.numpy(), want[:4].T, rtol=rtol,
                                   atol=4 * rtol)


# ----------------------------------------------------------------------
# the XLA path and the refines, float64
# ----------------------------------------------------------------------

def hits_match(got, want, branch=True):
    for name in ("valid", "idx", "kind") + (("branch",) if branch else ()):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    v = np.asarray(want.valid)
    np.testing.assert_allclose(got.ray_u.numpy()[v], np.asarray(want.ray_u)[v],
                               rtol=1e-12)


@pytest.mark.parametrize("ray_block", [32768, 96])
def test_xla_search_matches_jax_f64(rng, ray_block):
    """Segments, arcs and the combined search in float64, one ray block and
    several (96 rays each, the last one padded)."""
    p0, p1 = rays(rng, 400, np.float64)
    js, ts = both_segments(segments(rng, 90, np.float64), jnp.float64,
                           torch.float64)
    ja, ta = both_arcs(arcs(rng, 70, np.float64), jnp.float64, torch.float64)
    kw = dict(surf_chunk=32, ray_block=ray_block)
    hits_match(t_isect.nearest_hit_segments(T(p0), T(p1), ts, EPS, EPS, EPS,
                                            **kw),
               j_isect.nearest_hit_segments(jnp.asarray(p0), jnp.asarray(p1),
                                            js, EPS, EPS, EPS, **kw))
    want = j_isect.nearest_hit_arcs(jnp.asarray(p0), jnp.asarray(p1), ja, EPS,
                                    EPS, EPS, **kw)
    hits_match(t_isect.nearest_hit_arcs(T(p0), T(p1), ta, EPS, EPS, EPS, **kw),
               want)
    assert np.asarray(want.branch).any() and np.asarray(want.valid).any()
    want = j_isect.nearest_hit_2d(jnp.asarray(p0), jnp.asarray(p1),
                                  j_surf.Scene2D(js, ja), EPS, EPS, EPS, **kw)
    hits_match(t_isect.nearest_hit_2d(T(p0), T(p1), t_surf.Scene2D(ts, ta),
                                      EPS, EPS, EPS, **kw), want)
    kinds = np.asarray(want.kind)[np.asarray(want.valid)]
    assert (kinds == 0).any() and (kinds == 1).any()


def test_refines_match_jax_f64(rng):
    n = 60
    p0, p1 = rays(rng, n, np.float64)
    sp0, sp1 = segments(rng, n, np.float64)
    for t, j in zip(t_isect.refine_segment_hit_from(T(p0), T(p1), T(sp0),
                                                    T(sp1), EPS),
                    j_isect.refine_segment_hit_from(*map(jnp.asarray,
                                                         (p0, p1, sp0, sp1)),
                                                    EPS)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-14)
    center, _, _, radius = arcs(rng, n, np.float64)
    branch = rng.random(n) < 0.5
    for t, j in zip(t_isect.refine_arc_hit_from(T(p0), T(p1), T(center),
                                                T(radius), T(branch), EPS),
                    j_isect.refine_arc_hit_from(*map(jnp.asarray,
                                                     (p0, p1, center, radius,
                                                      branch)), EPS)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-14)


# ----------------------------------------------------------------------
# the plain versions of K5-K8
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cull", [False, True])
def test_plain_segments_match_pallas_interpret(rng, cull):
    p0, p1 = rays(rng, 500)
    js, ts = both_segments(segments(rng, 77))
    js, _ = j_acc.morton_sort_segments(js)
    v_ref, i_ref, u_ref = (np.asarray(a) for a in pk.nearest_hit_segments_pallas(
        jnp.asarray(p0), jnp.asarray(p1), js, EPS, EPS, EPS, ray_block=128,
        seg_block=32, interpret=True, cull=cull))
    search = (gk.nearest_hit_segments_culled_plain if cull
              else gk.nearest_hit_segments_plain)
    valid, idx, u = (a.numpy() for a in search(T(p0), T(p1), T(js.p0),
                                               T(js.p1), EPS, EPS, EPS))
    np.testing.assert_array_equal(valid, v_ref)
    np.testing.assert_allclose(u[v_ref], u_ref[v_ref], rtol=1e-5)
    assert (idx[v_ref] == i_ref[v_ref]).mean() > 0.99
    assert v_ref.any() and not v_ref.all()


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("full", [False, True])
def test_plain_arcs_match_pallas_interpret(rng, cull, full):
    p0, p1 = rays(rng, 800)
    ja, _ = both_arcs(arcs(rng, 45, full=full))
    ja, _ = j_acc.morton_sort_arcs(ja)
    v_ref, i_ref, u_ref, b_ref = (np.asarray(a) for a in
                                  pk.nearest_hit_arcs_pallas(
                                      jnp.asarray(p0), jnp.asarray(p1), ja, EPS,
                                      EPS, ray_block=128, arc_block=32,
                                      interpret=True, cull=cull))
    search = (ak.nearest_hit_arcs_culled_plain if cull
              else ak.nearest_hit_arcs_plain)
    valid, idx, u, branch = (a.numpy() for a in search(
        T(p0), T(p1), *(T(getattr(ja, k)) for k in ("center", "angle_start",
                                                     "angle_end", "radius")),
        EPS, EPS))
    np.testing.assert_array_equal(valid, v_ref)
    # K6 evaluates the discriminant without the TPU form's cancellation, so
    # near hits (small u) differ by float32 noise: both forms lie up to
    # ~2e-6 from the float64 solution of the same pair
    np.testing.assert_allclose(u[v_ref], u_ref[v_ref], rtol=1e-5, atol=2e-6)
    assert (idx[v_ref] == i_ref[v_ref]).mean() > 0.99
    same = v_ref & (idx == i_ref)
    np.testing.assert_array_equal(branch[same], b_ref[same])
    assert v_ref.any() and b_ref[v_ref].any() and not b_ref[v_ref].all()


@pytest.mark.parametrize("chunk", [256, 64])
@pytest.mark.parametrize("shape", [(1500, 2000), (1000, 333), (33, 1)])
def test_plain_culled_equals_plain_brute(rng, monkeypatch, chunk, shape):
    """Bit for bit, on Morton-sorted sets with some rays parked (p0 = 1e30,
    as the engine parks terminated rays) and some pointing away; ``chunk``
    sets the culling chunk of K7 and K8."""
    monkeypatch.setattr(gk, "CULL_CHUNK", chunk)
    n, m = shape
    p0, p1 = rays(rng, n)
    parked = rng.random(n) < 0.2
    p0[parked], p1[parked] = 1e30, np.float32(1e30 * (1 + 1e-6))
    away = rng.random(n) < 0.1
    p0[away], p1[away] = 100.0, 101.0
    _, ts = both_segments(segments(rng, m))
    ts, _ = t_acc.morton_sort_segments(ts)
    args = [T(p0), T(p1), ts.p0, ts.p1]
    ref = gk.nearest_hit_segments_plain(*args, EPS, EPS, EPS)
    for a, b in zip(gk.nearest_hit_segments_culled_plain(*args, EPS, EPS, EPS),
                    ref):
        assert torch.equal(a, b)
    assert not ref[0][torch.as_tensor(parked | away)].any()
    for full in (False, True):
        _, ta = both_arcs(arcs(rng, m, full=full))
        ta, _ = t_acc.morton_sort_arcs(ta)
        args = [T(p0), T(p1), ta.center, ta.angle_start, ta.angle_end,
                ta.radius]
        ref = ak.nearest_hit_arcs_plain(*args, EPS, EPS)
        for a, b in zip(ak.nearest_hit_arcs_culled_plain(*args, EPS, EPS), ref):
            assert torch.equal(a, b)
        if m > 1:
            assert ref[0].any()


def test_gate_margin_keeps_a_hit_at_a_chunk_joint(monkeypatch):
    """A ray starting on the light guide's exit face at the joint of its two
    chunks of lenslets hits lenslet 256 at a point float32 puts 3.6e-7
    outside chunk 1's box: without the gate's rounding margin the culled
    search would miss it (the ray is from the 2D guide's 18th bounce on the
    card)."""
    _, scene, _ = scenes2d.light_guide(32, device="cpu")
    arc = scene.arcs
    o = torch.tensor([[39.99999237060547, 1.0311603546142578e-05]])
    d = torch.tensor([[0.531158447265625, -0.8472734093666077]])
    args = [o, o + d, arc.center, arc.angle_start, arc.angle_end, arc.radius]
    ref = ak.nearest_hit_arcs_plain(*args, EPS, EPS)
    assert int(ref[1]) == 256
    for a, b in zip(ak.nearest_hit_arcs_culled_plain(*args, EPS, EPS), ref):
        assert torch.equal(a, b)
    monkeypatch.setattr(gk, "GATE_PAD", 0.0)
    assert int(ak.nearest_hit_arcs_culled_plain(*args, EPS, EPS)[1]) == 255


# ----------------------------------------------------------------------
# no silent fallback
# ----------------------------------------------------------------------

def test_wrappers_run_plain_on_cpu_and_refuse_other_devices(rng):
    p0, p1 = rays(rng, 200)
    seg = [T(a) for a in segments(rng, 50)]
    arc = [T(a) for a in arcs(rng, 50)]
    before = (gk.LAUNCHES, gk.LAUNCHES_CULLED, ak.LAUNCHES, ak.LAUNCHES_CULLED)
    for name in ("", "_culled"):
        got = getattr(gk, f"nearest_hit_segments{name}_kernel")(
            T(p0), T(p1), *seg, EPS, EPS, EPS)
        for a, b in zip(got, getattr(gk, f"nearest_hit_segments{name}_plain")(
                T(p0), T(p1), *seg, EPS, EPS, EPS)):
            assert torch.equal(a, b)
        got = getattr(ak, f"nearest_hit_arcs{name}_kernel")(T(p0), T(p1), *arc,
                                                            EPS, EPS)
        for a, b in zip(got, getattr(ak, f"nearest_hit_arcs{name}_plain")(
                T(p0), T(p1), *arc, EPS, EPS)):
            assert torch.equal(a, b)
    # the CPU path launches nothing
    assert before == (gk.LAUNCHES, gk.LAUNCHES_CULLED, ak.LAUNCHES,
                      ak.LAUNCHES_CULLED)
    t = torch.empty((4, 2), device="meta")
    r = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="no segment search"):
        gk.nearest_hit_segments_kernel(t, t, t, t, EPS, EPS, EPS)
    with pytest.raises(ValueError, match="no arc search"):
        ak.nearest_hit_arcs_culled_kernel(t, t, t, r, r, r, EPS, EPS)


def test_grid_cull_on_2d_raises(rng, monkeypatch):
    """cull="grid" on a 2D scene no longer raises: under use_kernel it runs
    the two-level K9 and K10 (their plain versions on the CPU) and returns
    the brute-force hits, on segments alone, arcs alone and both."""
    p0, p1 = rays(rng, 300)
    _, ts = both_segments(segments(rng, 600))
    _, ta = both_arcs(arcs(rng, 300))
    ts, ta = t_acc.morton_sort_segments(ts)[0], t_acc.morton_sort_arcs(ta)[0]
    called = []
    for mod, name in ((gk, "nearest_hit_segments_twolevel_kernel"),
                      (ak, "nearest_hit_arcs_twolevel_kernel")):
        wrapper = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, w=wrapper, n=name: (
            called.append(n), w(*a))[1])
    for scene in (t_surf.Scene2D(ts, None), t_surf.Scene2D(None, ta),
                  t_surf.Scene2D(ts, ta)):
        got = t_isect.nearest_hit_2d(T(p0), T(p1), scene, EPS, EPS, EPS,
                                     use_kernel=True, cull="grid")
        ref = t_isect.nearest_hit_2d(T(p0), T(p1), scene, EPS, EPS, EPS,
                                     use_kernel=True)
        for name in ("valid", "idx", "ray_u", "kind", "branch"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        assert ref.valid.any()
    assert called.count("nearest_hit_segments_twolevel_kernel") == 2
    assert called.count("nearest_hit_arcs_twolevel_kernel") == 2


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port (nor chip_smoke.py) imports JAX or the JAX
    package, by its source and in a fresh interpreter."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "tensorflowraytrace_tpu"), (
                f"{path.relative_to(REPO)} imports {name}")
    modules = [".".join(p.relative_to(REPO).with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'tensorflowraytrace_tpu')]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)


def test_every_included_header_ships_with_the_package():
    """Each ``#include "..."`` of a kernel source names a file that the
    package-data globs of pyproject.toml match, so an installed copy of the
    port can build its kernels."""
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"][PORT.name]
    csrc = PORT / "csrc"
    sources = sorted(glob.glob(str(csrc / "*.cu")))
    assert len(sources) >= 8
    for src in sources:
        assert any(fnmatch(f"csrc/{Path(src).name}", g) for g in globs)
        for name in re.findall(r'^#include "([^"]+)"', Path(src).read_text(),
                               re.MULTILINE):
            assert (csrc / name).exists(), name
            assert any(fnmatch(f"csrc/{name}", g) for g in globs), (
                f"{name}, included by {Path(src).name}, is not package data")
