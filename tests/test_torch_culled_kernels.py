"""The culled (K3) and two-level (K4) triangle-search kernels on the card,
bit for bit against K1 and against their own plain PyTorch versions.  The
pytest form of chip_smoke.py's K3/K4 comparisons.

Every test here needs an NVIDIA GPU with CUDA and nvcc: they are marked
``cuda`` and skip without one.  Run them on the card with
``python -m pytest tests/test_torch_culled_kernels.py -m cuda --noconftest
-o addopts=""`` (this file imports no JAX).

The kernels are built with --fmad=false and evaluate K1's operations in
K1's order, and their gate only skips pairs that cannot give a nearer hit,
so ``valid``, ``idx`` and ``u`` equal K1's exactly.  K3 and K4 run in
float32 and in float64 (``DTYPES``), each dtype's instance against K1's of
the same dtype.
"""

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu_torch.models.acceleration import morton_sort_triangles
from tensorflowraytrace_tpu_torch.models.boundaries import ParametricCylindricalGuide
from tensorflowraytrace_tpu_torch.models.surfaces import TriangleSet
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

pytestmark = pytest.mark.cuda
EPS = 1e-6
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                                 ids=["f32", "f64"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def sorted_soup(n_tris, n_rays, device, seed=0, dtype=torch.float32):
    """A Morton-sorted random soup and rays from inside it."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-3, 3, (n_tris, 3))
    tris = [center + rng.normal(0, 0.5, (n_tris, 3)) for _ in range(3)]
    tri, _ = morton_sort_triangles(TriangleSet.make(*tris, dtype=dtype,
                                                    device=device))
    p0 = rng.uniform(-4, 4, (n_rays, 3))
    d = rng.normal(0, 1, (n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = [torch.as_tensor(a, dtype=dtype, device=device)
            for a in (p0, p0 + d)]
    return rays + [tri.vp, tri.v1, tri.v2]


def guide_slice(n_rays, device, seed=0, dtype=torch.float32):
    """The first bounce of bench.py's structured scene at 64 x 32 rings."""
    guide = ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 40.0), minimum_radius=0.3, theta_res=64,
        z_res=32, rotationally_symmetric=True, initial_taper=(0.7, 0.0),
        mat_in=1, mat_out=0, dtype=dtype, device=device)
    with torch.no_grad():
        tri, _ = morton_sort_triangles(guide.build())
    rng = np.random.default_rng(seed)
    r = 0.2 * np.sqrt(rng.uniform(0, 1, n_rays))
    th = rng.uniform(0, 2 * np.pi, n_rays)
    p0 = np.stack([r * np.cos(th), r * np.sin(th), np.full(n_rays, 0.1)], 1)
    d = rng.normal(0, 1, (n_rays, 3))
    d[:, 2] = np.abs(d[:, 2]) * 3 + 1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = [torch.as_tensor(a, dtype=dtype, device=device)
            for a in (p0, p0 + d)]
    return rays + [tri.vp.detach(), tri.v1.detach(), tri.v2.detach()]


def check(args):
    """K3 and K4 against K1 and against their plain versions, bit for bit,
    in the dtype of ``args``.  Returns K1's ``valid``."""
    ref = tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
    before = (tk.LAUNCHES_CULLED, tk.LAUNCHES_TWOLEVEL)
    got = [tk.nearest_hit_triangles_culled_kernel(*args, EPS, EPS, EPS),
           tk.nearest_hit_triangles_twolevel_kernel(*args, EPS, EPS, EPS)]
    torch.cuda.synchronize()
    assert (tk.LAUNCHES_CULLED, tk.LAUNCHES_TWOLEVEL) == (before[0] + 1,
                                                          before[1] + 1)
    assert ref[2].dtype == got[0][2].dtype == got[1][2].dtype == args[0].dtype
    got.append(tk.nearest_hit_triangles_culled_plain(*args, EPS, EPS, EPS))
    got.append(tk.nearest_hit_triangles_twolevel_plain(*args, EPS, EPS, EPS))
    for out in got:
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    return ref[0]


@DTYPES
@pytest.mark.parametrize("n_rays,n_tris", [(131072, 4096), (1000, 333),
                                           (256, 1), (1, 257)])
def test_culled_kernels_equal_k1_on_a_sorted_soup(cuda, n_rays, n_tris,
                                                  dtype):
    valid = check(sorted_soup(n_tris, n_rays, cuda, dtype=dtype))
    if n_tris > 1 and n_rays > 1:
        assert valid.any()


@DTYPES
def test_culled_kernels_equal_k1_on_a_guide_slice(cuda, dtype):
    assert check(guide_slice(65536, cuda, dtype=dtype)).any()


@DTYPES
def test_culled_kernels_all_miss_and_parked(cuda, dtype):
    p0, p1, vp, v1, v2 = sorted_soup(512, 5000, cuda, dtype=dtype)
    far = torch.full_like(p0, 100.0)
    assert not check([far, far + 1.0, vp, v1, v2]).any()
    parked = torch.full_like(p0, 1e30)
    assert not check([parked, torch.full_like(p0, 1e30 * (1 + 1e-6)), vp, v1,
                      v2]).any()
    # a mix: every third ray parked, in no order
    mix0 = torch.where((torch.arange(5000, device=cuda) % 3 == 0)[:, None],
                       parked, p0)
    mix1 = torch.where((torch.arange(5000, device=cuda) % 3 == 0)[:, None],
                       torch.full_like(p0, 1e30 * (1 + 1e-6)), p1)
    assert check([mix0, mix1, vp, v1, v2]).any()


@DTYPES
def test_culled_blocks_parked_full_and_single(cuda, dtype):
    """K3 against its plain version and K1: a block whose rays are all
    parked, a block in which every ray needs every tile (rays along the
    plane of edge-on triangles: no hit, so no ray's best ever culls a box
    its line crosses), and a block in which one ray needs a tile (the
    others point away from the soup)."""
    ray_block = 256                  # kBlock in csrc/triangle_search_culled.cu
    p0, p1, vp, v1, v2 = sorted_soup(2000, 3 * ray_block, cuda, dtype=dtype)
    b = slice(0, ray_block)
    p0[b], p1[b] = 1e30, 1e30 * (1 + 1e-6)              # all parked
    one = slice(ray_block, 2 * ray_block)
    p0[one], p1[one] = 100.0, 101.0                     # all away ...
    p0[ray_block], p1[ray_block] = p0[-1], p1[-1]        # ... but one
    valid = check([p0, p1, vp, v1, v2])
    assert not valid[b].any() and valid.any()

    # edge-on triangles in the plane y = 0 strung along x: every chunk box
    # contains the rays' lines, and every pair has det == 0
    rng = np.random.default_rng(1)
    m = 1100
    x = np.sort(rng.uniform(0, 100, m))
    tri = [np.stack([x + rng.uniform(-1, 1, m), np.zeros(m),
                     rng.uniform(-1, 1, m)], 1) for _ in range(3)]
    tri = [torch.as_tensor(t, dtype=dtype, device=cuda) for t in tri]
    n = 2 * ray_block + 7
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, n), dtype=dtype, device=cuda)
    q0 = torch.stack([torch.full_like(z, -1.0), torch.zeros_like(z), z], 1)
    q1 = q0 + torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=cuda)
    assert not check([q0, q1, *tri]).any()


@DTYPES
@pytest.mark.parametrize("twolevel", [dict(TWOLEVEL_MAX_CAND=2),
                                      dict(TWOLEVEL_MAX_CAND=1,
                                           TWOLEVEL_RAY_BLOCK=64),
                                      dict(TWOLEVEL_RAY_BLOCK=1024)])
def test_twolevel_overflow_and_block_shapes(cuda, monkeypatch, twolevel,
                                            dtype):
    """A cap of 1 or 2 makes every block sweep all chunks; other ray blocks
    give the same hits (``twolevel`` sets the module constants)."""
    for name, value in twolevel.items():
        monkeypatch.setattr(tk, name, value)
    assert check(sorted_soup(3000, 20000, cuda, dtype=dtype)).any()


@DTYPES
@pytest.mark.parametrize("ray_block", [64, 128, 256, 512, 1024])
def test_twolevel_blocks_that_few_rays_need(cuda, monkeypatch, ray_block,
                                            dtype):
    """K4 at every ray block the tune tries, against K1 and its plain
    version: consecutive blocks in which 0, 1, 31, 32, 33 and all rays
    point into a sorted soup of 3000 triangles (a ragged last chunk) and
    the others away or parked, so that a chunk is
    needed by none, one, a warp less one, a warp, a warp and one, or every
    ray of a block; then with a cap of 1, so that every block with more
    than one candidate sweeps."""
    monkeypatch.setattr(tk, "TWOLEVEL_RAY_BLOCK", ray_block)
    lives = [0, 1, 31, 32, 33, ray_block]
    p0, p1, vp, v1, v2 = sorted_soup(3000, len(lives) * ray_block, cuda,
                                     dtype=dtype)
    slot = torch.arange(p0.shape[0], device=cuda) % ray_block
    live = slot < torch.tensor(lives, device=cuda).repeat_interleave(ray_block)
    away = (~live & (slot % 2 == 0))[:, None]
    parked = (~live & (slot % 2 == 1))[:, None]
    p0 = torch.where(away, torch.full_like(p0, 100.0), p0)
    p1 = torch.where(away, torch.full_like(p1, 101.0), p1)
    p0 = torch.where(parked, torch.full_like(p0, 1e30), p0)
    p1 = torch.where(parked, torch.full_like(p1, 1e30 * (1 + 1e-6)), p1)
    for cap in (32, 1):
        monkeypatch.setattr(tk, "TWOLEVEL_MAX_CAND", cap)
        valid = check([p0, p1, vp, v1, v2])
        assert valid.any() and not valid[~live].any()


def test_culled_kernels_refuse_what_they_cannot_take(cuda, monkeypatch):
    p0, p1, vp, v1, v2 = sorted_soup(16, 32, cuda)
    for fn in (tk.nearest_hit_triangles_culled_kernel,
               tk.nearest_hit_triangles_twolevel_kernel):
        with pytest.raises(TypeError, match="one dtype"):
            fn(p0.double(), p1, vp, v1, v2, EPS, EPS, EPS)
        with pytest.raises(TypeError, match="takes float32"):
            fn(*(t.half() for t in (p0, p1, vp, v1, v2)), EPS, EPS, EPS)
        with pytest.raises(ValueError, match="contiguous"):
            fn(p0.T.contiguous().T, p1, vp, v1, v2, EPS, EPS, EPS)
        with pytest.raises(ValueError, match="is on"):
            fn(p0, p1.cpu(), vp, v1, v2, EPS, EPS, EPS)
        with pytest.raises(ValueError, match="detached"):
            fn(p0, p1, vp.clone().requires_grad_(), v1, v2, EPS, EPS, EPS)
    # K3 and K4 are compiled for one chunk width each, in both dtypes
    for name, fn in (("CULL_CHUNK", tk.nearest_hit_triangles_culled_kernel),
                     ("FINE_CHUNK", tk.nearest_hit_triangles_twolevel_kernel)):
        with monkeypatch.context() as m:
            m.setattr(tk, name, 128)
            for args in ((p0, p1, vp, v1, v2),
                         [t.double() for t in (p0, p1, vp, v1, v2)]):
                with pytest.raises(RuntimeError, match="launch failed"):
                    fn(*args, EPS, EPS, EPS)
    monkeypatch.setattr(tk, "TWOLEVEL_RAY_BLOCK", 100)
    with pytest.raises(ValueError, match="TWOLEVEL_RAY_BLOCK"):
        tk.nearest_hit_triangles_twolevel_kernel(p0, p1, vp, v1, v2, EPS, EPS,
                                                 EPS)
