"""The CUDA triangle-search kernel (K1) against its plain PyTorch version, on
the card.  The pytest form of phase 3 of chip_smoke.py.

Every test here needs an NVIDIA GPU with CUDA and nvcc: they are marked
``cuda`` and skip without one.  Run them on the card with
``python -m pytest tests/test_torch_kernels.py -m cuda -p no:xdist``.

The kernel is built with --fmad=false and evaluates the plain version's
float32 operations in the plain version's order, so the two are compared
bit for bit; the criteria of tests/test_pallas.py (equal ``valid``,
``ray_u`` within rtol 1e-5, > 99% equal ``idx``) are the floor it must
never fall below.
"""

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

pytestmark = pytest.mark.cuda
EPS = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def soup(n_tris, n_rays, device, seed=0):
    rng = np.random.default_rng(seed)
    center = rng.uniform(-3, 3, (n_tris, 3))
    tris = [center + rng.normal(0, 0.5, (n_tris, 3)) for _ in range(3)]
    p0 = rng.uniform(-4, 4, (n_rays, 3))
    d = rng.normal(0, 1, (n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (p0, p0 + d, *tris)]


def check(args):
    before = tk.LAUNCHES
    valid, idx, u = tk.nearest_hit_triangles_kernel(*args, EPS, EPS, EPS)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    rv, ri, ru = tk.nearest_hit_triangles_plain(*args, EPS, EPS, EPS)
    assert torch.equal(valid, rv)
    torch.testing.assert_close(u[rv], ru[rv], rtol=1e-5, atol=0)
    if rv.any():
        assert (idx[rv] == ri[rv]).float().mean() > 0.99
    # bit for bit, by construction (see the module docstring)
    assert torch.equal(u, ru) and torch.equal(idx, ri)
    return valid


@pytest.mark.parametrize("n_rays,n_tris,some_hit", [
    (131072, 4096, True), (1000, 333, True),
    # ragged edges: one triangle, one ray; either may well hit nothing
    (256, 1, False), (1, 257, False),
])
def test_kernel_matches_plain(cuda, n_rays, n_tris, some_hit):
    valid = check(soup(n_tris, n_rays, cuda))
    if some_hit:
        assert valid.any()


def test_kernel_all_miss(cuda):
    p0, p1, vp, v1, v2 = soup(64, 5000, cuda)
    p0 = torch.full_like(p0, 100.0)
    valid = check([p0, p0 + 1.0, vp, v1, v2])
    assert not valid.any()


def test_kernel_refuses_what_it_cannot_take(cuda):
    p0, p1, vp, v1, v2 = soup(16, 32, cuda)
    with pytest.raises(TypeError):
        tk.nearest_hit_triangles_kernel(p0.double(), p1, vp, v1, v2, EPS, EPS, EPS)
    with pytest.raises(ValueError, match="contiguous"):
        tk.nearest_hit_triangles_kernel(p0.T.contiguous().T, p1, vp, v1, v2,
                                        EPS, EPS, EPS)
    with pytest.raises(ValueError, match="is on"):
        tk.nearest_hit_triangles_kernel(p0, p1.cpu(), vp, v1, v2, EPS, EPS, EPS)
    with pytest.raises(ValueError, match="detached"):
        tk.nearest_hit_triangles_kernel(p0, p1, vp.requires_grad_(), v1, v2,
                                        EPS, EPS, EPS)
