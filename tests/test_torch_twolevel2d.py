"""The two-level 2D searches of the PyTorch port (K9 segments, K10 arcs)
against the JAX package and against the brute searches, on the CPU.

* The candidate precompute (``triangle_kernels.twolevel_candidates``, which
  also serves K4 in 3D) equals ``_twolevel_candidates_2d`` on the same
  boxes, ray block and cap, with lists, forced overflow and chunk groups.
* The plain K9 and K10 equal the plain K5 and K6 bit for bit: parked rays,
  rays that miss, full circles, forced overflow (cap 2), another ray block,
  and the light guide's chunk-joint ray that the gate boxes' rounding
  margin keeps.
* The plain K9 and K10 against the Pallas kernels in interpret mode
  (``cull="grid"``): tests/test_pallas.py's criteria for segments (equal
  ``valid``, ``ray_u`` within rtol 1e-5 with an atol of 1e-8 for hits
  near their ray's start, > 99% equal ``idx``); arcs as in
  tests/test_torch_search2d.py (rtol 1e-5 + atol 2e-6, for the
  discriminant's form).
* A small 2D light guide traced with ``cull="grid"``, with and without the
  re-sort, equals the brute trace bit for bit, and K9 and K10 run once a
  bounce.
* The wrappers run their plain versions only on CPU tensors and refuse
  other devices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import surfaces as j_surf
from tensorflowraytrace_tpu.ops import pallas_kernels as pk
from tensorflowraytrace_tpu_torch import config, scenes2d
from tensorflowraytrace_tpu_torch import engine as t_engine
from tensorflowraytrace_tpu_torch.models import acceleration as t_acc
from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from tensorflowraytrace_tpu_torch.utils.convert import (
    arcs_from_numpy, segments_from_numpy,
)

EPS = 1e-6
PI = np.pi


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def rays(rng, n):
    p0 = rng.uniform(-4, 4, (n, 2))
    d = rng.normal(0, 1, (n, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p0.astype(np.float32), (p0 + d).astype(np.float32)


def sorted_segments(rng, m):
    mid = rng.uniform(-3, 3, (m, 2))
    ends = [(mid + rng.normal(0, 0.5, (m, 2))).astype(np.float32)
            for _ in range(2)]
    return t_acc.morton_sort_segments(segments_from_numpy(*ends, mat_in=1))[0]


def sorted_arcs(rng, m, full=False):
    center = rng.uniform(-3, 3, (m, 2))
    a1 = rng.uniform(-PI, PI, m)
    sweep = np.full(m, 2 * PI) if full else rng.uniform(0.3, 5.8, m)
    a2 = a1 + sweep if full else (a1 + sweep + PI) % (2 * PI) - PI
    radius = rng.uniform(0.3, 1.5, m) * rng.choice([-1.0, 1.0], m)
    arcs = arcs_from_numpy(*(a.astype(np.float32)
                             for a in (center, a1, a2, radius)), mat_in=1)
    return t_acc.morton_sort_arcs(arcs)[0]


def arc_args(p0, p1, arc):
    return [p0, p1, arc.center, arc.angle_start, arc.angle_end, arc.radius]


def assert_same(got, ref):
    for a, b in zip(got, ref, strict=True):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the candidate precompute
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["lists", "overflow", "groups"])
def test_twolevel_candidates_2d_match_jax(rng, monkeypatch, case):
    """On K9's widened boxes of 5200 sorted segments (21 chunks of 256),
    1536 rays, 256-ray blocks."""
    seg = sorted_segments(rng, 5200)
    p0, p1 = rays(rng, 1536)
    rb, cap = 256, {"lists": 32, "overflow": 3, "groups": 32}[case]
    if case == "groups":  # 21 chunks in groups of 16, in both packages
        monkeypatch.setattr(pk, "CAND_GROUP_BYTES", 1)
        monkeypatch.setattr(tk, "CAND_GROUP_BYTES", 1)
    boxes = gk.gate_boxes(t_acc.chunk_aabbs_2d(seg.p0, seg.p1, 256))
    rays8 = np.zeros((8, 1536), np.float32)
    rays8[0:2], rays8[2:4] = p0.T, p1.T
    want_counts, want_cand = pk._twolevel_candidates_2d(
        jnp.asarray(rays8), jnp.asarray(boxes.numpy().T), EPS, rb, cap)
    counts, cand = tk.twolevel_candidates(torch.as_tensor(p0),
                                          torch.as_tensor(p1), boxes, EPS,
                                          rb, cap)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want_cand))
    assert counts.dtype == cand.dtype == torch.int32
    if case == "overflow":
        assert (counts == 21).any()


# ----------------------------------------------------------------------
# the plain K9 and K10 against the plain K5 and K6
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(TWOLEVEL_MAX_CAND=2),
                                dict(TWOLEVEL_RAY_BLOCK=64, CULL_CHUNK=64)])
@pytest.mark.parametrize("shape", [(800, 1100), (1000, 333), (33, 1)])
def test_plain_twolevel_equals_plain_brute(rng, monkeypatch, kw, shape):
    """Bit for bit, on Morton-sorted sets with some rays parked (p0 = 1e30,
    as the engine parks terminated rays) and some pointing away; ``kw`` sets
    segment_kernels' cap, ray block and chunk."""
    for name, value in kw.items():
        monkeypatch.setattr(gk, name, value)
    n, m = shape
    p0, p1 = rays(rng, n)
    parked = rng.random(n) < 0.2
    p0[parked], p1[parked] = 1e30, np.float32(1e30 * (1 + 1e-6))
    away = rng.random(n) < 0.1
    p0[away], p1[away] = 100.0, 101.0
    p0, p1 = torch.as_tensor(p0), torch.as_tensor(p1)
    seg = sorted_segments(rng, m)
    args = [p0, p1, seg.p0, seg.p1]
    ref = gk.nearest_hit_segments_plain(*args, EPS, EPS, EPS)
    assert_same(gk.nearest_hit_segments_twolevel_plain(*args, EPS, EPS, EPS),
                ref)
    assert not ref[0][torch.as_tensor(parked | away)].any()
    for full in (False, True):
        args = arc_args(p0, p1, sorted_arcs(rng, m, full))
        ref = ak.nearest_hit_arcs_plain(*args, EPS, EPS)
        assert_same(ak.nearest_hit_arcs_twolevel_plain(*args, EPS, EPS), ref)
        if m > 1:
            assert ref[0].any() and ref[3][ref[0]].any()


def test_twolevel_keeps_the_hit_at_a_chunk_joint(monkeypatch):
    """tests/test_torch_search2d.py's ray from the guide's exit face: its
    hit on lenslet 256 lies 3.6e-7 outside chunk 1's raw box.  K10's
    candidate list and gate use the widened boxes and keep it, also when the
    list overflows (cap 1); with the raw boxes (GATE_PAD 0) it is lost."""
    _, scene, _ = scenes2d.light_guide(32, device="cpu")
    o = torch.tensor([[39.99999237060547, 1.0311603546142578e-05]])
    d = torch.tensor([[0.531158447265625, -0.8472734093666077]])
    args = arc_args(o, o + d, scene.arcs)
    ref = ak.nearest_hit_arcs_plain(*args, EPS, EPS)
    assert int(ref[1]) == 256
    for cap in (32, 1):
        monkeypatch.setattr(gk, "TWOLEVEL_MAX_CAND", cap)
        assert_same(ak.nearest_hit_arcs_twolevel_plain(*args, EPS, EPS), ref)
    monkeypatch.setattr(gk, "TWOLEVEL_MAX_CAND", 32)
    monkeypatch.setattr(gk, "GATE_PAD", 0.0)
    assert int(ak.nearest_hit_arcs_twolevel_plain(*args, EPS, EPS)[1]) == 255


# ----------------------------------------------------------------------
# against the Pallas kernels in interpret mode
# ----------------------------------------------------------------------

def test_plain_segments_match_pallas_interpret(rng):
    p0, p1 = rays(rng, 500)
    seg = sorted_segments(rng, 600)
    js = j_surf.SegmentSet.make(seg.p0.numpy(), seg.p1.numpy(), mat_in=1,
                                dtype=jnp.float32)
    v_ref, i_ref, u_ref = (np.asarray(a) for a in pk.nearest_hit_segments_pallas(
        jnp.asarray(p0), jnp.asarray(p1), js, EPS, EPS, EPS, interpret=True,
        cull="grid"))
    valid, idx, u = (a.numpy() for a in gk.nearest_hit_segments_twolevel_plain(
        torch.as_tensor(p0), torch.as_tensor(p1), seg.p0, seg.p1, EPS, EPS,
        EPS))
    np.testing.assert_array_equal(valid, v_ref)
    # XLA:CPU rounds the interpreted kernel differently in the last bit; a
    # hit near its ray's start (u ~ 6e-4 here) loses relative precision to
    # the numerator's cancellation, so an absolute 1e-8 (a tenth of a
    # float32 ulp of the unit-scale inputs) stands beside rtol 1e-5
    np.testing.assert_allclose(u[v_ref], u_ref[v_ref], rtol=1e-5, atol=1e-8)
    assert (idx[v_ref] == i_ref[v_ref]).mean() > 0.99
    assert v_ref.any() and not v_ref.all()


def test_plain_arcs_match_pallas_interpret(rng):
    p0, p1 = rays(rng, 800)
    arc = sorted_arcs(rng, 300)
    ja = j_surf.ArcSet.make(*(a.numpy() for a in arc_args(None, None, arc)[2:]),
                            mat_in=1, dtype=jnp.float32)
    v_ref, i_ref, u_ref, b_ref = (np.asarray(a) for a in
                                  pk.nearest_hit_arcs_pallas(
                                      jnp.asarray(p0), jnp.asarray(p1), ja, EPS,
                                      EPS, interpret=True, cull="grid"))
    valid, idx, u, branch = (a.numpy() for a in ak.nearest_hit_arcs_twolevel_plain(
        *arc_args(torch.as_tensor(p0), torch.as_tensor(p1), arc), EPS, EPS))
    np.testing.assert_array_equal(valid, v_ref)
    # the discriminant's form: see tests/test_torch_search2d.py
    np.testing.assert_allclose(u[v_ref], u_ref[v_ref], rtol=1e-5, atol=2e-6)
    assert (idx[v_ref] == i_ref[v_ref]).mean() > 0.99
    same = v_ref & (idx == i_ref)
    np.testing.assert_array_equal(branch[same], b_ref[same])
    assert v_ref.any() and b_ref[v_ref].any() and not b_ref[v_ref].all()


# ----------------------------------------------------------------------
# the trace, and the wrappers
# ----------------------------------------------------------------------

def test_small_guide_grid_traces_equal_brute(monkeypatch):
    """chip_smoke.py's 2D guide, small (258 segments, 32 lenslets, 4096
    rays, 3 bounces), through the plain searches."""
    rays_, scene, mats = scenes2d.light_guide(4096, n_wall=128, n_lenslets=32,
                                              device="cpu")
    calls = []
    for mod, name in ((gk, "nearest_hit_segments_twolevel_kernel"),
                      (ak, "nearest_hit_arcs_twolevel_kernel")):
        wrapper = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, w=wrapper, n=name: (
            calls.append(n), w(*a))[1])
    ref = t_engine.trace(rays_, scene, mats, scenes2d.guide_config(
        max_bounces=3, use_kernel=True)).rays
    assert not calls
    for resort in (False, True):
        got = t_engine.trace(rays_, scene, mats, scenes2d.guide_config(
            max_bounces=3, use_kernel=True, cull="grid",
            resort_rays=resort)).rays
        for name in ("state", "p0", "p1"):
            assert torch.equal(getattr(got, name), getattr(ref, name))
    assert sorted(calls) == sorted(
        ["nearest_hit_segments_twolevel_kernel",
         "nearest_hit_arcs_twolevel_kernel"] * 6)
    assert (ref.state == 0).any()


def test_wrappers_run_plain_on_cpu_and_refuse_other_devices(rng):
    p0, p1 = (torch.as_tensor(a) for a in rays(rng, 200))
    seg, arc = sorted_segments(rng, 300), sorted_arcs(rng, 300)
    before = (gk.LAUNCHES_TWOLEVEL, ak.LAUNCHES_TWOLEVEL)
    assert_same(gk.nearest_hit_segments_twolevel_kernel(
        p0, p1, seg.p0, seg.p1, EPS, EPS, EPS),
        gk.nearest_hit_segments_twolevel_plain(p0, p1, seg.p0, seg.p1, EPS,
                                               EPS, EPS))
    args = arc_args(p0, p1, arc)
    assert_same(ak.nearest_hit_arcs_twolevel_kernel(*args, EPS, EPS),
                ak.nearest_hit_arcs_twolevel_plain(*args, EPS, EPS))
    # the CPU path launches nothing
    assert before == (gk.LAUNCHES_TWOLEVEL, ak.LAUNCHES_TWOLEVEL)
    t = torch.empty((4, 2), device="meta")
    r = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="no segment search"):
        gk.nearest_hit_segments_twolevel_kernel(t, t, t, t, EPS, EPS, EPS)
    with pytest.raises(ValueError, match="no arc search"):
        ak.nearest_hit_arcs_twolevel_kernel(t, t, t, r, r, r, EPS, EPS)
