"""The 2D search kernels on the card: K5 (segments) and K6 (arcs) bit for
bit against their plain PyTorch versions, and the culled K7 and K8 bit for
bit against theirs and against K5 and K6.  The pytest form of
chip_smoke.py's phase 11, plus the first bounce of the 2D light guide, the
edges of the arc kernels' exact reject (scenes2d.arc_edge_cases), the hits
a per-ray gate's boxes must hold (scenes2d.gate_edge_cases), and ray
blocks of which every ray, one ray or no ray needs a chunk, over ragged
chunk counts.

Every test here needs an NVIDIA GPU with CUDA and nvcc: they are marked
``cuda`` and skip without one.  Run them on the card with
``python -m pytest tests/test_torch_2d_kernels.py -m cuda --noconftest
-o addopts=""`` (this file imports no JAX).

The kernels are built with --fmad=false and evaluate their plain versions'
float32 operations in the same order, and the culled kernels' gate only
skips pairs that cannot give a nearer hit, so every output is equal
exactly.
"""

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu_torch import scenes2d
from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
from tensorflowraytrace_tpu_torch.ops import segment_kernels as sk

pytestmark = pytest.mark.cuda
EPS = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def seg_args(p0, p1, seg):
    return [t.detach().contiguous() for t in (p0, p1, seg.p0, seg.p1)]


def arc_args(p0, p1, arc):
    return [t.detach().contiguous() for t in (p0, p1, arc.center,
                                              arc.angle_start, arc.angle_end,
                                              arc.radius)]


def check(args, kind, size_eps=EPS):
    """The brute and culled kernels of ``kind`` against their plain
    versions and each other, bit for bit; returns the brute ``valid``."""
    mod, name, eps = ((sk, "segments", (EPS, size_eps, EPS))
                      if kind == "segment" else (ak, "arcs", (EPS, EPS)))
    before = (mod.LAUNCHES, mod.LAUNCHES_CULLED)
    brute = getattr(mod, f"nearest_hit_{name}_kernel")(*args, *eps)
    culled = getattr(mod, f"nearest_hit_{name}_culled_kernel")(*args, *eps)
    torch.cuda.synchronize()
    assert (mod.LAUNCHES, mod.LAUNCHES_CULLED) == (before[0] + 1,
                                                   before[1] + 1)
    plain = getattr(mod, f"nearest_hit_{name}_plain")(*args, *eps)
    plain_culled = getattr(mod, f"nearest_hit_{name}_culled_plain")(*args, *eps)
    for got in (culled, plain, plain_culled):
        for a, b in zip(got, brute):
            assert torch.equal(a, b)
    return brute[0]


@pytest.mark.parametrize("n_rays,m", [(200000, None), (1000, 333), (1, 257)])
def test_kernels_equal_plain_on_random_sets(cuda, n_rays, m):
    """tpu_kernel_check's sets (777 segments, 555 arcs; seed 7), a ragged
    tile and a single ray."""
    rng = np.random.default_rng(7)
    seg = scenes2d.random_segments(rng, m or 777, device=cuda)
    valid = check(seg_args(*scenes2d.random_rays(rng, n_rays, device=cuda),
                           seg), "segment")
    arc = scenes2d.random_arcs(rng, m or 555, device=cuda)
    valid_a = check(arc_args(*scenes2d.random_rays(rng, n_rays, device=cuda),
                             arc), "arc")
    if n_rays > 1:
        assert valid.any() and valid_a.any()


def test_full_circle_arcs(cuda):
    rng = np.random.default_rng(8)
    arc = scenes2d.random_arcs(rng, 300, device=cuda, full=True)
    assert check(arc_args(*scenes2d.random_rays(rng, 50000, device=cuda), arc),
                 "arc").any()


def test_all_miss_and_parked(cuda):
    rng = np.random.default_rng(9)
    seg = scenes2d.random_segments(rng, 500, device=cuda)
    arc = scenes2d.random_arcs(rng, 500, device=cuda)
    p0, p1 = scenes2d.random_rays(rng, 5000, device=cuda)
    far = torch.full_like(p0, 100.0)
    parked = torch.full_like(p0, 1e30)
    parked1 = torch.full_like(p0, 1e30 * (1 + 1e-6))
    # a mix: every third ray parked
    third = (torch.arange(5000, device=cuda) % 3 == 0)[:, None]
    mix0, mix1 = torch.where(third, parked, p0), torch.where(third, parked1, p1)
    for r0, r1, hits in ((far, far + 1.0, False), (parked, parked1, False),
                         (mix0, mix1, True)):
        assert bool(check(seg_args(r0, r1, seg), "segment").any()) == hits
        assert bool(check(arc_args(r0, r1, arc), "arc").any()) == hits


def test_guide_first_bounce(cuda):
    """The 2D light guide's first search at 131072 rays: 4098 segments and
    512 lenslet arcs."""
    rays, scene, _ = scenes2d.light_guide(131072, device=cuda)
    assert scene.segments.n_surfaces == 4098 and scene.arcs.n_surfaces == 512
    assert check(seg_args(rays.p0, rays.p1, scene.segments), "segment").any()
    check(arc_args(rays.p0, rays.p1, scene.arcs), "arc")


def around(x):
    """float32 x and its two neighbours."""
    x = np.float32(x)
    return [np.nextafter(x, np.float32(-np.inf)), x,
            np.nextafter(x, np.float32(np.inf))]


def segment_case(rays, segments, cuda):
    """(rays (n, 4) as p0 xy, p1 xy; segments (m, 4) as sp0 xy, sp1 xy) as
    K5's arguments."""
    r = torch.as_tensor(np.asarray(rays, np.float32), device=cuda)
    s = torch.as_tensor(np.asarray(segments, np.float32), device=cuda)
    return [t.contiguous() for t in (r[:, :2], r[:, 2:], s[:, :2], s[:, 2:])]


def test_segment_kernels_at_the_reject_tests_edges(cuda):
    """K5 (and K7) bit for bit with the plain version where its reject test
    has least room: |den| at i_eps, seg_u at s_lo and s_hi, ray_u at r_eps,
    each a float32 step either side; equal u on two segments (the first
    index wins); parked rays; ragged last tiles and ray counts that are not
    a multiple of a block's rays."""
    s_lo, s_hi = np.float32(-EPS), np.float32(1.0 + EPS)
    # |den| = dy2 for a ray along +x from x = -0.5 and a segment (0, 0) ->
    # (1, dy2); the ray crosses it at seg_u = 0.5
    for e in around(EPS):
        args = segment_case([[-0.5, e / 2, 0.5, e / 2]], [[0, 0, 1, e]], cuda)
        check(args, "segment")
    # seg_u = oy on the segment x = 0, y in [0, 1] (den = 1)
    ys = around(s_lo) + around(s_hi) + around(0.0)
    args = segment_case([[-0.5, y, 0.5, y] for y in ys], [[0, 0, 0, 1]], cuda)
    valid = check(args, "segment").cpu().numpy()
    assert valid[1] and valid[4] and not valid[0] and not valid[5]
    # ray_u = r at the segment x = 0: rays start r before it
    rs = around(EPS) + around(2 * EPS) + around(0.0)
    args = segment_case([[-r, 0.5, 1 - r, 0.5] for r in rs], [[0, 0, 0, 1]],
                        cuda)
    valid = check(args, "segment").cpu().numpy()
    assert valid[4] and not valid[7]
    # equal u = 2 on five segments through (1, 0.5), one of them twice, for
    # the second ray (the first index wins); the first ray meets segment 4
    # first, at u = 1.75
    args = segment_case([[-1, 0.25, 0, 0.25], [-1, 0.5, 0, 0.5]],
                        [[2, 0, 2, 1], [1, -1, 1, 2], [1, 0, 1, 1],
                         [1, 0, 1, 1], [0.5, 0, 1.5, 1], [0.5, 1, 1.5, 0]],
                        cuda)
    check(args, "segment")
    _, idx, u = sk.nearest_hit_segments_kernel(*args, EPS, EPS, EPS)
    assert idx.tolist() == [4, 1] and u.tolist() == [1.75, 2.0]
    # parked rays among live ones; tiles and blocks left ragged
    rng = np.random.default_rng(11)
    for n, m in ((1000, 1025), (1025, 2049), (3000, 4097)):
        seg = scenes2d.random_segments(rng, m, device=cuda)
        p0, p1 = scenes2d.random_rays(rng, n, device=cuda)
        third = (torch.arange(n, device=cuda) % 3 == 0)[:, None]
        p0 = torch.where(third, torch.full_like(p0, 1e30), p0)
        p1 = torch.where(third, torch.full_like(p1, 1e30 * (1 + 1e-6)), p1)
        valid = check(seg_args(p0, p1, seg), "segment")
        assert valid.any() and not valid[third[:, 0]].any()


@pytest.mark.parametrize("label", ["tangent", "small a", "far",
                                   "wide windows", "ties", "parked"])
def test_arc_kernels_at_the_reject_edges(cuda, label):
    """K6 and K8 bit for bit, branch flag included, with their plain
    versions on scenes2d.arc_edge_cases: the discriminant and |a| within
    float32 steps of i_eps, tangent rays, rays 13000 radii from the
    lenslets, windows wider than pi, exact ties between arcs in different
    tiles, parked rays."""
    cases = {c[0]: c[1:] for c in scenes2d.arc_edge_cases(device=cuda)}
    p0, p1, arc = cases[label]
    valid = check(arc_args(p0, p1, arc), "arc")
    assert bool(valid.any()) == (label != "parked")


def test_arc_kernels_on_a_ragged_guide(cuda):
    """K6 and K8 on the 2D guide's first search at a ray count that leaves
    K6's last block of 1024 rays (4 a thread) ragged."""
    rays, scene, _ = scenes2d.light_guide(100003, device=cuda)
    check(arc_args(rays.p0, rays.p1, scene.arcs), "arc")


GATE_LABELS = ["segment ends", "segment ends, small size_eps", "tangent snap",
               "window ends", "far ends", "parked segments", "parked arcs",
               "all-miss segments", "all-miss arcs"]


def gate_case(label, cuda):
    """scenes2d.gate_edge_cases' case ``label``: ``(kind, args, size_eps)``."""
    p0, p1, surfaces, size_eps = {c[0]: c[1:] for c in
                                  scenes2d.gate_edge_cases(device=cuda)}[label]
    if hasattr(surfaces, "p0"):
        return "segment", seg_args(p0, p1, surfaces), size_eps
    return "arc", arc_args(p0, p1, surfaces), size_eps


@pytest.mark.parametrize("label", GATE_LABELS)
def test_gate_edge_cases(cuda, label):
    """K7 against K5 and K8 against K6 where the accepted hits lie at the
    edge of the chunk boxes: past a segment's ends under size_eps 1e-2, a
    tangent pair's snapped point off its circle, window ends from near and
    far; parked and all-miss batches."""
    kind, args, size_eps = gate_case(label, cuda)
    valid = check(args, kind, size_eps)
    assert bool(valid.any()) == (label.split()[0] not in ("parked",
                                                          "all-miss"))


@pytest.mark.parametrize("m", [300, 100])
def test_blocks_that_every_one_or_no_ray_needs(cuda, m):
    """K7 and K8 over blocks of ``sk.CULLED_RAY_BLOCK`` rays: a block whose
    every ray is aimed at a surface, one with a single such ray, one with
    none and a ragged last block; m = 300 leaves the second chunk ragged,
    m = 100 is one chunk short of 256."""
    rng = np.random.default_rng(12)
    block = sk.CULLED_RAY_BLOCK
    for kind, make, to_args in (
            ("segment", scenes2d.random_segments, seg_args),
            ("arc", scenes2d.random_arcs, arc_args)):
        surfaces = make(rng, m, device=cuda)
        p0, p1 = scenes2d.block_rays(rng, surfaces, block, device=cuda)
        valid = check(to_args(p0, p1, surfaces), kind)
        assert valid[:block].float().mean() > 0.5
        assert not valid[block + 1:3 * block].any()


@pytest.mark.parametrize("block", [128, 256, 512, 1024])
def test_k8_at_every_ray_block(cuda, monkeypatch, block):
    """K8's listed walk at each ray block it launches, against its plain
    version and K6 (``check``): blocks of which every ray, one ray or no
    ray needs a chunk, over 300 arcs (a ragged second chunk), 100 (one
    chunk short of 256) and 255."""
    monkeypatch.setattr(sk, "CULLED_RAY_BLOCK", block)
    rng = np.random.default_rng(13)
    for m in (300, 100, 255):
        arc = scenes2d.random_arcs(rng, m, device=cuda)
        p0, p1 = scenes2d.block_rays(rng, arc, block, device=cuda)
        valid = check(arc_args(p0, p1, arc), "arc")
        assert valid[:block].float().mean() > 0.5
        assert not valid[block + 1:3 * block].any()


def test_kernels_refuse_what_they_cannot_take(cuda, monkeypatch):
    rng = np.random.default_rng(10)
    p0, p1 = scenes2d.random_rays(rng, 32, device=cuda)
    seg = seg_args(p0, p1, scenes2d.random_segments(rng, 16, device=cuda))
    arc = arc_args(p0, p1, scenes2d.random_arcs(rng, 16, device=cuda))
    searches = [(sk.nearest_hit_segments_kernel, seg, (EPS, EPS, EPS)),
                (sk.nearest_hit_segments_culled_kernel, seg, (EPS, EPS, EPS)),
                (ak.nearest_hit_arcs_kernel, arc, (EPS, EPS)),
                (ak.nearest_hit_arcs_culled_kernel, arc, (EPS, EPS))]
    for fn, args, eps in searches:
        with pytest.raises(TypeError):
            fn(args[0].double(), *args[1:], *eps)
        with pytest.raises(ValueError, match="contiguous"):
            fn(args[0].T.contiguous().T, *args[1:], *eps)
        with pytest.raises(ValueError, match="is on"):
            fn(args[0], args[1].cpu(), *args[2:], *eps)
        with pytest.raises(ValueError, match="detached"):
            fn(*args[:2], args[2].clone().requires_grad_(), *args[3:], *eps)
    for rb in (96, 2048):
        monkeypatch.setattr(sk, "CULLED_RAY_BLOCK", rb)
        for fn, args, eps in (searches[1], searches[3]):
            with pytest.raises(ValueError, match="CULLED_RAY_BLOCK"):
                fn(*args, *eps)
    monkeypatch.setattr(sk, "CULLED_RAY_BLOCK", 256)
    # the culled kernels are compiled for one chunk width
    monkeypatch.setattr(sk, "CULL_CHUNK", 128)
    for fn, args, eps in (searches[1], searches[3]):
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(*args, *eps)
