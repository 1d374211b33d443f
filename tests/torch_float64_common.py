"""What the float64 search tests share: the rays, soups, segments and arcs
they draw with numpy, and the comparison of a plain search with the JAX
package's Pallas kernel (tests/test_torch_float64_search.py,
tests/test_torch_float64_culled.py)."""

import math

import jax.numpy as jnp
import numpy as np
import torch

from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu.models import acceleration as j_acc

RTOL = 1e-12
PI = math.pi


def T(a):
    return torch.as_tensor(np.array(a))


def rays(rng, n, dim):
    p0 = rng.uniform(-4, 4, (n, dim))
    d = rng.normal(0, 1, (n, dim))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p0, p0 + d


def sorted_soup(rng, n_tris, n_rays):
    """tests/test_pallas.py's random soup in float64, Morton-sorted by the
    JAX package: ``(jax triangles, [vp, v1, v2], p0, p1)``."""
    center = rng.uniform(-3, 3, (n_tris, 3))
    tris = [center + rng.normal(0, 0.4, (n_tris, 3)) for _ in range(3)]
    jt, _ = j_acc.morton_sort_triangles(JTriangleSet.make(*tris, mat_in=1,
                                                          dtype=jnp.float64))
    return jt, [np.asarray(a) for a in (jt.vp, jt.v1, jt.v2)], \
        *rays(rng, n_rays, 3)


def segments(rng, m):
    mid = rng.uniform(-3, 3, (m, 2))
    return [mid + rng.normal(0, 0.5, (m, 2)) for _ in range(2)]


def arcs(rng, m, full=False):
    """Random arcs: signed radii, windows sweeping 0.3-5.8 rad (or the full
    circle), ends wrapped to [-pi, pi)."""
    center = rng.uniform(-3, 3, (m, 2))
    a1 = rng.uniform(-PI, PI, m)
    sweep = np.full(m, 2 * PI) if full else rng.uniform(0.3, 5.8, m)
    a2 = a1 + sweep if full else (a1 + sweep + PI) % (2 * PI) - PI
    radius = rng.uniform(0.3, 1.5, m) * rng.choice([-1.0, 1.0], m)
    return center, a1, a2, radius


def assert_hits(got, want, pair_u):
    """``got`` (the port's tensors) against ``want`` (JAX's arrays): equal
    ``valid``, ``ray_u`` within ``RTOL``, ``idx`` (and a branch, last)
    equal except at ties: where the indices differ, ``pair_u(rows, idx)``
    (the port's ray parameter of each row's pair with surface idx) at
    JAX's index equals the port's hit within ``RTOL``."""
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    valid, idx, u = got[:3]
    np.testing.assert_array_equal(valid, want[0])
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(u[valid], want[2][valid], rtol=RTOL)
    assert u.dtype == np.float64
    differ = np.nonzero(valid & (idx != want[1]))[0]
    assert len(differ) <= valid.sum() // 100
    if len(differ):
        other = pair_u(torch.as_tensor(differ), torch.as_tensor(want[1][differ]))
        np.testing.assert_allclose(other.numpy(), u[differ], rtol=RTOL)
    if len(got) == 4:
        same = valid & (idx == want[1])
        np.testing.assert_array_equal(got[3][same], want[3][same])
