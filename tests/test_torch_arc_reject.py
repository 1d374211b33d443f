"""The arc searches' exact reject and the kernels' table layouts, on the CPU.

* ``ops/arc_kernels.arc_pair_admits``, the predicate the arc kernels (K6,
  K8, K10: ``search2d::ArcPair``) reject a pair by before its square root
  and division: every pair it refuses has no valid branch in the plain
  arithmetic (``_arc_pairs``), on random sets and on
  ``scenes2d.arc_edge_cases`` (tangent rays, a discriminant or |a| within
  float32 steps of ``intersect_eps``, rays 13000 radii away, full circles,
  windows wider than pi, ties, parked rays), and the edge sets do reach
  both sides of it.  ``admitted_arc_pairs`` counts what it admits.
* The chunk-major tables K4 and K10 copy whole into shared memory: K4's
  (C, 3, F, 4) float4 rows of (v0, E1, E2) and K10's (C, 2, F, 4) rows of
  (centre, 1 / r, flags) and window edges hold the columns they replace.
"""

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu_torch import config, scenes2d
from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

EPS = 1e-6
EDGE_LABELS = ["tangent", "small a", "far", "wide windows", "ties", "parked"]


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def pairs(p0, p1, arc):
    """Every pair's plain ``(u, minus)`` and the predicate, (N, M) each."""
    table = ak.arc_table(arc.center, arc.angle_start, arc.angle_end,
                         arc.radius)
    o, d = p0[:, :, None], (p1 - p0)[:, :, None]
    cols = ak._arc_columns(table, 0, table.shape[0])
    u, minus = ak._arc_pairs(*o.unbind(1), *d.unbind(1), *cols, EPS, EPS)
    admit = ak.arc_pair_admits(*o.unbind(1), *d.unbind(1), *cols[:3], EPS)
    return u, admit


def random_case(kind):
    rng = np.random.default_rng(7)
    if kind == "guide":
        rays, scene, _ = scenes2d.light_guide(4096, device="cpu")
        return rays.p0, rays.p1, scene.arcs
    arc = scenes2d.random_arcs(rng, 555 if kind == "sets" else 300,
                               device="cpu", full=kind == "full circles")
    return (*scenes2d.random_rays(rng, 2000, device="cpu"), arc)


@pytest.mark.parametrize("kind", ["sets", "full circles", "guide"])
def test_refused_pairs_have_no_valid_branch_on_random_sets(kind):
    """tpu_kernel_check's 555 arcs, 300 full circles and the 2D guide's
    first bounce (4096 rays, 512 lenslets)."""
    p0, p1, arc = random_case(kind)
    u, admit = pairs(p0, p1, arc)
    assert (u[~admit] == ak.BIG).all()
    assert (u < ak.BIG).any() and (~admit).any()
    if kind == "guide":  # a ray's line meets few of the lenslets' circles
        assert admit.float().mean() < 0.05


@pytest.mark.parametrize("label", EDGE_LABELS)
def test_refused_pairs_have_no_valid_branch_at_the_edges(label):
    cases = {c[0]: c[1:] for c in scenes2d.arc_edge_cases(device="cpu")}
    p0, p1, arc = cases[label]
    u, admit = pairs(p0, p1, arc)
    assert (u[~admit] == ak.BIG).all()
    if label == "parked":
        assert not (u < ak.BIG).any()
    else:
        assert (u < ak.BIG).any()


@pytest.mark.parametrize("label", ["tangent", "small a"])
def test_edge_sets_reach_both_sides_of_the_reject(label):
    """Against the full unit circle (arc 2), the rays of the step sweeps
    are admitted on one side of the edge and refused on the other; on the
    tangent sweep the discriminant reaches +-i_eps within a few steps."""
    cases = {c[0]: c[1:] for c in scenes2d.arc_edge_cases(device="cpu")}
    p0, p1, arc = cases[label]
    _, admit = pairs(p0, p1, arc)
    full = admit[:, 2]
    assert full.any() and not full.all()
    if label == "tangent":
        # heights along x: 161 steps around 1, then 161 around -1
        hy = p0[:161, 1].double()
        disc = 4.0 * (1.0 - hy * hy)
        admitted = full[:161]
        assert admitted[disc > 0].all()
        assert not admitted[disc < -2 * EPS].any()
        assert ((disc.abs() > 0.5 * EPS) & (disc.abs() < 2 * EPS)).sum() >= 2
    else:
        # |d| in steps up through sqrt(i_eps) along x: a = |d|^2 crosses
        # i_eps once, refused below and admitted above
        admitted = full[:129].int()
        assert admitted[0] == 0 and admitted[-1] == 1
        assert (admitted[1:] >= admitted[:-1]).all()


@pytest.mark.parametrize("piece", [7, 1 << 24])
def test_admitted_arc_pairs_counts_the_predicate(piece):
    p0, p1, arc = random_case("sets")
    _, admit = pairs(p0, p1, arc)
    got = ak.admitted_arc_pairs(p0, p1, arc.center, arc.radius, EPS,
                                piece=piece)
    assert got == int(admit.sum()) > 0


@pytest.mark.parametrize("m,chunk", [(555, 256), (256, 256), (3, 128)])
def test_arc_chunk_table_rows(m, chunk):
    """K10's table: chunk c's first row holds (centre x, centre y, 1 / r,
    flags) of its arcs, its second their window edges, zero past M."""
    rng = np.random.default_rng(3)
    arc = scenes2d.random_arcs(rng, m, device="cpu")
    cols = (arc.center, arc.angle_start, arc.angle_end, arc.radius)
    flat = ak.arc_table(*cols)
    table = ak.arc_chunk_table(*cols, chunk)
    c = -(-m // chunk)
    assert table.shape == (c, 2, chunk, 4) and table.is_contiguous()
    head = table[:, 0].reshape(-1, 4)
    edge = table[:, 1].reshape(-1, 4)
    assert torch.equal(head[:m, :2], flat[:, :2])
    assert torch.equal(head[:m, 2], 1.0 / flat[:, 2])
    assert torch.equal(head[:m, 3], flat[:, 7])
    assert torch.equal(edge[:m], flat[:, 3:7])
    assert not head[m:].any() and not edge[m:].any()


@pytest.mark.parametrize("m,fine", [(1000, 512), (512, 512), (5, 512)])
def test_triangle_chunk_table_rows(m, fine):
    """K4's table is K3's tile: three float4 rows (v0x, v0y, v0z, E1x),
    (E1y, E1z, E2x, E2y), (E2z, 0, 0, 0) a triangle; ``table_rows`` reads
    it back as the nine rows v0, E1, E2."""
    rng = np.random.default_rng(4)
    vp, v1, v2 = (torch.as_tensor(rng.normal(0, 1, (m, 3)), dtype=torch.float32)
                  for _ in range(3))
    table = tk.chunk_major_table(vp, v1, v2, fine)
    c = -(-m // fine)
    assert table.shape == (c, 3, fine, 4) and table.is_contiguous()
    rows = table.reshape(c, 3, fine, 4).transpose(1, 2).reshape(-1, 12)
    want = torch.cat([vp, v1 - vp, v2 - vp], dim=1)
    assert torch.equal(rows[:m, :9], want)
    assert not rows[:m, 9:].any() and not rows[m:].any()
    soa = tk.table_rows(table)
    assert soa.shape == (c, 9, fine)
    assert torch.equal(soa.transpose(1, 2).reshape(-1, 9)[:m], want)
