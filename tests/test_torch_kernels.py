"""The CUDA triangle-search kernel (K1) against its plain PyTorch version, on
the card.  The pytest form of phase 3 of chip_smoke.py.

Every test here needs an NVIDIA GPU with CUDA and nvcc: they are marked
``cuda`` and skip without one.  Run them on the card with
``python -m pytest tests/test_torch_kernels.py -m cuda -p no:xdist``.

The kernel is built with --fmad=false and evaluates the plain version's
operations in the plain version's order (float32 behind a reject test that
refuses only pairs the exact arithmetic refuses; float64 without one), so
the two are compared bit for bit (``valid``, ``idx`` and ``ray_u``), at
the rays a thread the launch chooses for the ray count and at each the
kernel is compiled for, in float32 and in float64.
"""

import numpy as np
import pytest
import torch

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


def soup(n_tris, n_rays, device, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    center = rng.uniform(-3, 3, (n_tris, 3))
    tris = [center + rng.normal(0, 0.5, (n_tris, 3)) for _ in range(3)]
    p0 = rng.uniform(-4, 4, (n_rays, 3))
    d = rng.normal(0, 1, (n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.as_tensor(a, dtype=dtype, device=device)
            for a in (p0, p0 + d, *tris)]


def check(args):
    """K1 at the launch's choice of rays a thread and at each of 1 and 4,
    bit for bit against the plain version; returns ``valid``."""
    rv, ri, ru = tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS)
    before = tk.LAUNCHES
    for rpt in (None,) + tk.BRUTE_RAYS_PER_THREAD:
        got = (tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
               if rpt is None else
               tk.brute_launch(*args, EPS, EPS, EPS, rays_per_thread=rpt))
        torch.cuda.synchronize()
        valid, idx, u = got
        assert u.dtype == args[0].dtype
        assert torch.equal(valid, rv)
        assert torch.equal(idx, ri)
        assert torch.equal(u, ru)
    assert tk.LAUNCHES == before + 3
    return rv


def park(p0, p1):
    """Every third ray parked (p0 = 1e30), as the engine parks terminated
    rays."""
    third = (torch.arange(p0.shape[0], device=p0.device) % 3 == 0)[:, None]
    return (torch.where(third, torch.full_like(p0, 1e30), p0),
            torch.where(third, torch.full_like(p1, 1e30 * (1 + 1e-6)), p1))


@DTYPES
@pytest.mark.parametrize("n_rays,n_tris,some_hit", [
    (131072, 4096, True), (1000, 333, True),
    # ragged edges: one triangle, one ray; either may well hit nothing
    (256, 1, False), (1, 257, False),
    # ray counts that are no multiple of a block's rays (256 or 1024)
    (1021, 772, True), (131035, 4096, True),
])
def test_kernel_matches_plain(cuda, n_rays, n_tris, some_hit, dtype):
    valid = check(soup(n_tris, n_rays, cuda, dtype=dtype))
    if some_hit:
        assert valid.any()


@DTYPES
@pytest.mark.parametrize("n_rays", [1024, 131072, 1021, 131035])
def test_kernel_with_parked_rays(cuda, n_rays, dtype):
    """A third of the rays parked: they hit nothing, the others as before."""
    p0, p1, vp, v1, v2 = soup(4096, n_rays, cuda, dtype=dtype)
    q0, q1 = park(p0, p1)
    valid = check([q0, q1, vp, v1, v2])
    assert valid.any() and not valid[::3].any()


@DTYPES
def test_kernel_all_parked(cuda, dtype):
    p0, p1, vp, v1, v2 = soup(4096, 4096, cuda, dtype=dtype)
    q0 = torch.full_like(p0, 1e30)
    assert not check([q0, torch.full_like(q0, 1e30 * (1 + 1e-6)), vp, v1,
                      v2]).any()


def test_launch_choice(cuda):
    """4 rays a thread only where that still gives two blocks an SM."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    edge = 2 * sms * 4 * tk.BRUTE_THREADS
    assert tk.brute_rays_per_thread(1024, cuda) == 1
    assert tk.brute_rays_per_thread(edge - 1024, cuda) == 1
    assert tk.brute_rays_per_thread(edge, cuda) == 4
    assert tk.brute_rays_per_thread(1 << 20, cuda) == 4


@DTYPES
def test_kernel_all_miss(cuda, dtype):
    p0, p1, vp, v1, v2 = soup(64, 5000, cuda, dtype=dtype)
    p0 = torch.full_like(p0, 100.0)
    valid = check([p0, p0 + 1.0, vp, v1, v2])
    assert not valid.any()


def test_kernel_ties_go_to_the_first_triangle(cuda):
    """The same triangle twice, and a copy of the soup after it: every hit
    keeps the first index, in both dtypes (bit for bit with the plain
    version)."""
    for dtype in (torch.float32, torch.float64):
        p0, p1, vp, v1, v2 = soup(300, 5000, cuda, dtype=dtype)
        twice = [torch.cat([t, t]) for t in (vp, v1, v2)]
        valid = check([p0, p1, *twice])
        assert valid.any()
        assert int(tk.nearest_hit_triangles_kernel(
            p0, p1, *twice, EPS, EPS, EPS)[1].max()) < 300


def test_kernel_refuses_what_it_cannot_take(cuda):
    p0, p1, vp, v1, v2 = soup(16, 32, cuda)
    # one dtype, float32 or float64 (a mixed call, and float16, refused)
    with pytest.raises(TypeError, match="one dtype"):
        tk.nearest_hit_triangles_kernel(p0.double(), p1, vp, v1, v2, EPS, EPS, EPS)
    with pytest.raises(TypeError, match="takes float32 or float64"):
        tk.nearest_hit_triangles_kernel(*(t.half() for t in (p0, p1, vp, v1,
                                                             v2)),
                                        EPS, EPS, EPS)
    with pytest.raises(ValueError, match="contiguous"):
        tk.nearest_hit_triangles_kernel(p0.T.contiguous().T, p1, vp, v1, v2,
                                        EPS, EPS, EPS)
    with pytest.raises(ValueError, match="is on"):
        tk.nearest_hit_triangles_kernel(p0, p1.cpu(), vp, v1, v2, EPS, EPS, EPS)
    with pytest.raises(ValueError, match="detached"):
        tk.nearest_hit_triangles_kernel(p0, p1, vp.requires_grad_(), v1, v2,
                                        EPS, EPS, EPS)
    # the kernel is compiled for 1 and 4 rays a thread, in either dtype
    for args in ([p0, p1, vp.detach(), v1, v2],
                 [t.double() for t in (p0, p1, vp.detach(), v1, v2)]):
        with pytest.raises(RuntimeError, match="launch failed"):
            tk.brute_launch(*args, EPS, EPS, EPS, rays_per_thread=2)
