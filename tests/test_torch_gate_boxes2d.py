"""The boxes of the 2D searches that gate each ray on its own (K7-K10), on
the CPU: every point the pair tests accept must lie in its chunk's box.

* ``scenes2d.gate_edge_cases`` (hits up to size_eps past a segment's ends,
  tangent pairs whose discriminant snaps to 0, hits at a window's float32
  end points seen from near and from ~13000 radii away, parked and
  all-miss batches): the plain K7 and K9 equal the plain K5, and the plain
  K10 and K8 the plain K6, bit for bit in float32 (``valid``, ``idx``,
  ``ray_u`` and ``branch``).
* Against the JAX package: the plain K7 and K9 equal the Pallas kernels in
  interpret mode (``cull=True`` and ``"grid"``) bit for bit on the segment
  ends.  The Pallas arc kernel evaluates b^2 - 4 a c, float32 noise for
  rays far from an arc (tests/test_torch_search2d.py), and here it finds
  tangent hits on lenslets ~500 radii down the ray that no exact
  arithmetic finds, so the tangent pairs are held to it in float64:
  equal ``valid``, ``idx`` and ``branch``, ``ray_u`` within rtol 1e-4 (a
  snapped hit's u is the closest point's, -b / 2a, which float32 rounds
  from a ~ 1e-6), for K10 and K8 against the Pallas kernel of the same
  culling; K8's parked and all-miss batches bit for bit in float32.  The
  window-end cases aim rays at float32 window ends, where float32 and
  float64 decide differently by construction, and the far ends lie ~13000
  radii down the ray, where the Pallas kernel's float32 b^2 - 4 a c is
  noise: both are held to the plain K6 only.
* The old boxes lose hits under a per-ray gate: boxes with the rounding
  margin alone (K7's before) at size_eps 1e-2, and the arc boxes without
  the tangent snap's reach (K10's and K8's before).
* Every accepted ray-arc pair's point lies in its chunk's box.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import surfaces as j_surf
from tensorflowraytrace_tpu.ops import pallas_kernels as pk
from tensorflowraytrace_tpu_torch import config, scenes2d
from tensorflowraytrace_tpu_torch.models import acceleration as t_acc
from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

EPS = 1e-6
LABELS = ["segment ends", "segment ends, small size_eps", "tangent snap",
          "window ends", "far ends", "parked segments", "parked arcs",
          "all-miss segments", "all-miss arcs"]


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def case(label):
    p0, p1, surfaces, size_eps = {c[0]: c[1:] for c in
                                  scenes2d.gate_edge_cases(device="cpu")}[label]
    if hasattr(surfaces, "p0"):
        return "segment", [p0, p1, surfaces.p0, surfaces.p1], size_eps
    return "arc", [p0, p1, surfaces.center, surfaces.angle_start,
                   surfaces.angle_end, surfaces.radius], size_eps


def searches(kind, size_eps):
    """The brute, culled and two-level plain searches of ``kind`` with
    their epsilons bound."""
    mod, name, eps = ((gk, "segments", (EPS, size_eps, EPS))
                      if kind == "segment" else (ak, "arcs", (EPS, EPS)))
    return {v: (lambda *a, f=getattr(mod, f"nearest_hit_{name}{v}_plain"):
                f(*a, *eps)) for v in ("", "_culled", "_twolevel")}


def differing(got, ref):
    return sum(int((a != b).sum()) for a, b in zip(got, ref, strict=True))


def test_gate_edge_cases_are_complete():
    assert [c[0] for c in scenes2d.gate_edge_cases(device="cpu")] == LABELS


@pytest.mark.parametrize("label", LABELS)
def test_per_ray_gates_equal_brute(label):
    kind, args, size_eps = case(label)
    fns = searches(kind, size_eps)
    ref = fns[""](*args)
    for variant in ("_culled", "_twolevel"):
        assert differing(fns[variant](*args), ref) == 0, variant
    hits = ref[0]
    assert bool(hits.any()) == (label.split()[0] not in ("parked", "all-miss"))
    if label in ("tangent snap", "window ends"):  # both branches win
        assert ref[3][hits].any() and not ref[3][hits].all()


@pytest.mark.parametrize("cull", [True, "grid"])
def test_segment_ends_match_pallas_interpret(cull):
    """Hits up to 0.01 past an end under size_eps 1e-2, bit for bit with
    the Pallas kernel of the same culling."""
    _, args, size_eps = case("segment ends")
    p0, p1, sp0, sp1 = (a.numpy() for a in args)
    js = j_surf.SegmentSet.make(sp0, sp1, mat_in=1, dtype=jnp.float32)
    ref = pk.nearest_hit_segments_pallas(jnp.asarray(p0), jnp.asarray(p1), js,
                                         EPS, size_eps, EPS, interpret=True,
                                         cull=cull)
    plain = (gk.nearest_hit_segments_culled_plain if cull is True
             else gk.nearest_hit_segments_twolevel_plain)
    got = plain(*args, EPS, size_eps, EPS)
    for a, b in zip(got, ref, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].float().mean() > 0.8


def test_tangent_snap_matches_pallas_in_float64():
    _, args, _ = case("tangent snap")
    f64 = [a.numpy().astype(np.float64) for a in args]
    ja = j_surf.ArcSet.make(*f64[2:], mat_in=1, dtype=jnp.float64)
    v_ref, i_ref, u_ref, b_ref = (np.asarray(a) for a in
                                  pk.nearest_hit_arcs_pallas(
                                      jnp.asarray(f64[0]), jnp.asarray(f64[1]),
                                      ja, EPS, EPS, interpret=True,
                                      cull="grid"))
    valid, idx, u, branch = (a.numpy() for a in
                             ak.nearest_hit_arcs_twolevel_plain(*args, EPS,
                                                                EPS))
    np.testing.assert_array_equal(valid, v_ref)
    np.testing.assert_array_equal(idx[valid], i_ref[valid])
    np.testing.assert_array_equal(branch[valid], b_ref[valid])
    np.testing.assert_allclose(u[valid], u_ref[valid], rtol=1e-4)
    assert valid.mean() > 0.5


@pytest.mark.parametrize("label,dtype", [("tangent snap", np.float64),
                                         ("parked arcs", np.float32),
                                         ("all-miss arcs", np.float32)])
def test_plain_culled_arcs_match_pallas_interpret(label, dtype):
    """The per-ray plain K8 against the Pallas ``_arc_kernel_culled`` in
    interpret mode (``cull=True``): the tangent pairs in float64 as K10's
    above, the parked and all-miss batches bit for bit in float32."""
    _, args, _ = case(label)
    a = [x.numpy().astype(dtype) for x in args]
    ja = j_surf.ArcSet.make(*a[2:], mat_in=1, dtype=jnp.dtype(dtype))
    v_ref, i_ref, u_ref, b_ref = (np.asarray(x) for x in
                                  pk.nearest_hit_arcs_pallas(
                                      jnp.asarray(a[0]), jnp.asarray(a[1]),
                                      ja, EPS, EPS, interpret=True,
                                      cull=True))
    valid, idx, u, branch = (x.numpy() for x in
                             ak.nearest_hit_arcs_culled_plain(*args, EPS,
                                                              EPS))
    np.testing.assert_array_equal(valid, v_ref)
    if dtype == np.float32:
        for got, ref in ((idx, i_ref), (u, u_ref), (branch, b_ref)):
            np.testing.assert_array_equal(got, ref)
        assert not valid.any()
        return
    np.testing.assert_array_equal(idx[valid], i_ref[valid])
    np.testing.assert_array_equal(branch[valid], b_ref[valid])
    np.testing.assert_allclose(u[valid], u_ref[valid], rtol=1e-4)
    assert valid.mean() > 0.5


def test_old_boxes_lose_hits_under_a_per_ray_gate(monkeypatch):
    """Boxes with the rounding margin alone lose the hits past a segment's
    ends at size_eps 1e-2 (K7's boxes before), and arc boxes without the
    tangent snap's reach lose snapped hits under K10's and K8's per-ray
    gates."""
    kind, args, size_eps = case("segment ends")
    fns = searches(kind, size_eps)
    ref = fns[""](*args)
    monkeypatch.setattr(gk, "twolevel_boxes", lambda sp0, sp1, _: (
        tk.widen_boxes(t_acc.chunk_aabbs_2d(sp0, sp1, gk.CULL_CHUNK), 0.0)))
    lost = fns["_culled"](*args)
    assert (ref[0] & ~lost[0]).sum() > 500

    kind, args, _ = case("tangent snap")
    fns = searches(kind, None)
    ref = fns[""](*args)
    monkeypatch.setattr(ak, "SNAP_REACH", 0.0)
    assert (ref[0] & ~fns["_twolevel"](*args)[0]).sum() > 100
    assert (ref[0] & ~fns["_culled"](*args)[0]).sum() > 100


@pytest.mark.parametrize("label", ["tangent snap", "window ends",
                                   "far ends"])
def test_arc_boxes_hold_every_accepted_point(label, monkeypatch):
    """Every ray-arc pair the plain arithmetic accepts, nearest or not, has
    its hit o + u d (in float64 from the float32 u) inside the box of its
    arc's chunk; without the snap's reach, the tangent pairs' do not."""
    _, args, _ = case(label)
    p0, p1, *arcs = args
    table = ak.arc_table(*arcs)
    o, d = p0[:, :, None], (p1 - p0)[:, :, None]
    u, _ = ak._arc_pairs(*o.unbind(1), *d.unbind(1),
                         *ak._arc_columns(table, 0, table.shape[0]), EPS, EPS)
    ray, arc = torch.nonzero(u < tk.BIG * 0.5, as_tuple=True)
    point = (p0[ray].double()
             + u[ray, arc].double()[:, None] * (p1 - p0)[ray].double())
    chunk = arc // gk.CULL_CHUNK

    def outside():
        box = ak.twolevel_boxes(*arcs).double()[chunk]
        return int(((point < box[:, :2]) | (point > box[:, 2:])).any(1).sum())

    assert ray.numel() > 1000
    assert outside() == 0
    monkeypatch.setattr(ak, "SNAP_REACH", 0.0)
    assert (outside() > 0) == (label == "tangent snap")
