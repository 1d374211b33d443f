"""The two-level 2D search kernels on the card: K9 (segments) and K10 (arcs)
bit for bit against their plain PyTorch versions and against the brute
K5 and K6, with forced candidate-list overflow, and what their wrappers
refuse.  The pytest form of chip_smoke.py's phase-11 K9/K10 checks, plus the
first bounce of the 2D light guide.

Every test here needs an NVIDIA GPU with CUDA and nvcc: they are marked
``cuda`` and skip without one.  Run them on the card with
``python -m pytest tests/test_torch_twolevel2d_kernels.py -m cuda
--noconftest -o addopts=""`` (this file imports no JAX).

K9 and K10 run K5's and K6's tile searches (csrc/search2d_common.cuh) with
the same float32 operations as the plain versions, and their gate only
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


def check(args, kind):
    """The two-level kernel of ``kind`` against its plain version and the
    brute kernel, bit for bit; returns the brute ``valid``."""
    mod, name, eps = ((sk, "segments", (EPS, EPS, EPS)) if kind == "segment"
                      else (ak, "arcs", (EPS, EPS)))
    before = mod.LAUNCHES_TWOLEVEL
    got = getattr(mod, f"nearest_hit_{name}_twolevel_kernel")(*args, *eps)
    brute = getattr(mod, f"nearest_hit_{name}_kernel")(*args, *eps)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_TWOLEVEL == before + 1
    plain = getattr(mod, f"nearest_hit_{name}_twolevel_plain")(*args, *eps)
    for ref in (brute, plain):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    return brute[0]


@pytest.mark.parametrize("cap", [None, 1])
@pytest.mark.parametrize("n_rays,m", [(200000, None), (1000, 333), (1, 257)])
def test_kernels_equal_plain_on_random_sets(cuda, monkeypatch, n_rays, m,
                                            cap):
    """tpu_kernel_check's sets (777 segments, 555 arcs; seed 7), a ragged
    tile and a single ray; ``cap`` 1 makes every block with more than one
    candidate chunk overflow and sweep every chunk."""
    if cap is not None:
        monkeypatch.setattr(sk, "TWOLEVEL_MAX_CAND", cap)
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


@pytest.mark.parametrize("cap", [None, 1])
def test_guide_first_bounce(cuda, monkeypatch, cap):
    """The 2D light guide's first search at 131072 rays: 4098 segments (17
    chunks) and 512 lenslet arcs (2 chunks); with ``cap`` 1 the blocks
    overflow and sweep."""
    if cap is not None:
        monkeypatch.setattr(sk, "TWOLEVEL_MAX_CAND", cap)
    rays, scene, _ = scenes2d.light_guide(131072, device=cuda)
    assert scene.segments.n_surfaces == 4098 and scene.arcs.n_surfaces == 512
    assert check(seg_args(rays.p0, rays.p1, scene.segments), "segment").any()
    check(arc_args(rays.p0, rays.p1, scene.arcs), "arc")


def test_chunk_joint_ray(cuda):
    """The ray of tests/test_torch_search2d.py's chunk-joint case: it hits
    lenslet 256 just outside chunk 1's raw box, and keeps it because the
    candidate lists and the gate use the widened boxes."""
    _, scene, _ = scenes2d.light_guide(32, device=cuda)
    o = torch.tensor([[39.99999237060547, 1.0311603546142578e-05]],
                     device=cuda)
    d = torch.tensor([[0.531158447265625, -0.8472734093666077]], device=cuda)
    args = arc_args(o, o + d, scene.arcs)
    check(args, "arc")
    assert int(ak.nearest_hit_arcs_twolevel_kernel(*args, EPS, EPS)[1]) == 256


def test_kernels_refuse_what_they_cannot_take(cuda, monkeypatch):
    rng = np.random.default_rng(10)
    p0, p1 = scenes2d.random_rays(rng, 32, device=cuda)
    seg = seg_args(p0, p1, scenes2d.random_segments(rng, 16, device=cuda))
    arc = arc_args(p0, p1, scenes2d.random_arcs(rng, 16, device=cuda))
    searches = [(sk.nearest_hit_segments_twolevel_kernel, seg, (EPS, EPS, EPS)),
                (ak.nearest_hit_arcs_twolevel_kernel, arc, (EPS, EPS))]
    for fn, args, eps in searches:
        with pytest.raises(TypeError):
            fn(args[0].double(), *args[1:], *eps)
        with pytest.raises(ValueError, match="contiguous"):
            fn(args[0].T.contiguous().T, *args[1:], *eps)
        with pytest.raises(ValueError, match="is on"):
            fn(args[0], args[1].cpu(), *args[2:], *eps)
        with pytest.raises(ValueError, match="detached"):
            fn(*args[:2], args[2].clone().requires_grad_(), *args[3:], *eps)
    monkeypatch.setattr(sk, "TWOLEVEL_RAY_BLOCK", 1024)
    for fn, args, eps in searches:
        with pytest.raises(ValueError, match="TWOLEVEL_RAY_BLOCK"):
            fn(*args, *eps)
    monkeypatch.setattr(sk, "TWOLEVEL_RAY_BLOCK", 256)
    # the kernels are compiled for one fine chunk
    monkeypatch.setattr(sk, "CULL_CHUNK", 128)
    for fn, args, eps in searches:
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(*args, *eps)
