"""The count of ray-triangle pairs that fail on tu alone
(``triangle_kernels.pairs_out_on_tu``), on the CPU.

The bounds of K1, K3 and K4 in chip_smoke.py charge such a pair the 24
operations before the kernels' reject test refuses it, and the others 46.
The count must be the pairs whose plain float32 tu refuses them: |det| <
i_eps, or tu = (T . P) / det outside [s_lo, s_hi - s_lo], here evaluated
with numpy in float32, one rounding an operation in the kernels' order.
Such a pair is never a valid hit: no tv can bring it back.
"""

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

EPS = 1e-6
F32 = np.float32


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def soup(rng, n_rays, n_tris, parked):
    """bench.py's random soup, small, with a share of the rays parked."""
    center = rng.uniform(-3, 3, (n_tris, 3))
    tris = [(center + rng.normal(0, 0.5, (n_tris, 3))).astype(F32)
            for _ in range(3)]
    p0 = rng.uniform(-4, 4, (n_rays, 3))
    d = rng.normal(0, 1, (n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p1 = (p0 + d).astype(F32)
    p0 = p0.astype(F32)
    park = rng.random(n_rays) < parked
    p0[park], p1[park] = F32(1e30), F32(1e30 * (1 + 1e-6))
    return [p0, p1, *tris]


def numpy_out_on_tu(p0, p1, vp, v1, v2, eps):
    """(N, M) mask of the pairs refused on tu, in numpy float32."""
    with np.errstate(all="ignore"):
        d = (p1 - p0)[:, None, :]                            # (N, 1, 3)
        e1, e2 = (v1 - vp)[None], (v2 - vp)[None]            # (1, M, 3)
        px = d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1]
        py = d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2]
        pz = d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]
        det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
        ok = np.abs(det) >= F32(eps)
        inv = F32(1.0) / np.where(ok, det, F32(1.0))
        t = p0[:, None, :] - vp[None]
        tu = (t[..., 0] * px + t[..., 1] * py + t[..., 2] * pz) * inv
        s_lo, s_hi = -eps, 1.0 + eps
        return ~(ok & (tu >= F32(s_lo)) & (tu <= F32(s_hi - s_lo)))


@pytest.mark.parametrize("n_rays,n_tris,parked,piece", [
    (300, 200, 0.0, 1 << 25),
    (257, 131, 0.3, 1000),      # pieces of 7 rays
    (64, 1, 0.0, 1 << 25),
    (1, 333, 0.0, 1),           # one ray a piece
])
def test_count_equals_numpy_float32(rng, n_rays, n_tris, parked, piece):
    args = soup(rng, n_rays, n_tris, parked)
    want = numpy_out_on_tu(*args, EPS)
    got = tk.pairs_out_on_tu(*(torch.as_tensor(a) for a in args), EPS, EPS,
                             piece=piece)
    assert got == int(want.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_pairs_out_on_tu_are_never_hits(seed):
    """Every pair the count refuses gives BIG in the plain Moller-Trumbore
    (no tv can make it valid), and most pairs of the soup are refused."""
    args = soup(np.random.default_rng(seed), 400, 300, 0.1)
    out = torch.as_tensor(numpy_out_on_tu(*args, EPS))
    p0, p1, vp, v1, v2 = (torch.as_tensor(a) for a in args)
    o = p0[:, :, None]
    a = vp.T[:, None]
    u = tk._moller_trumbore(*o.unbind(1), *(p1[:, :, None] - o).unbind(1), a,
                            v1.T[:, None] - a, v2.T[:, None] - a,
                            *tk._thresholds(EPS, EPS, EPS))
    assert (u[out] == tk.BIG).all()
    assert (u < tk.BIG).any() and out.float().mean() > 0.5
