"""Parity of the PyTorch port's nearest-hit search with the JAX package.

* K1's plain PyTorch version (float32, Moller-Trumbore) against the Pallas
  kernel in interpret mode, with the criteria of tests/test_pallas.py: equal
  ``valid``, ``ray_u`` within rtol 1e-5 where valid (float32 rounding of two
  differently ordered evaluations), and the same index on more than 99% of
  the valid rays (exact ties may break differently).
* The port's Cramer search (the JAX package's XLA path) against JAX's in
  float64: ``valid`` and ``idx`` exactly equal, ``ray_u`` within rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models.surfaces import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu.ops import intersect as j_isect
from tensorflowraytrace_tpu.ops.pallas_kernels import nearest_hit_triangles_pallas
from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.ops import intersect as t_isect
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from tensorflowraytrace_tpu_torch.utils.convert import triangles_from_numpy

EPS32 = 1e-6
EPS64 = 1e-10


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def soup(rng, n_tris, n_rays, dtype=np.float32):
    """The random triangle soup and rays of tests/test_pallas.py."""
    center = rng.uniform(-3, 3, (n_tris, 3))
    tris = [(center + rng.normal(0, 0.4, (n_tris, 3))).astype(dtype)
            for _ in range(3)]
    p0 = rng.uniform(-4, 4, (n_rays, 3)).astype(dtype)
    d = rng.normal(0, 1, (n_rays, 3)).astype(dtype)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tris, p0, p0 + d


def plain(p0, p1, tris, eps=EPS32, **kw):
    t = [torch.as_tensor(a) for a in (p0, p1, *tris)]
    return tk.nearest_hit_triangles_plain(*t, eps, eps, eps, **kw)


def assert_pallas_criteria(valid, idx, u, v_ref, i_ref, u_ref):
    np.testing.assert_array_equal(valid, v_ref)
    np.testing.assert_allclose(u[v_ref], u_ref[v_ref], rtol=1e-5)
    assert (idx[v_ref] == i_ref[v_ref]).mean() > 0.99


@pytest.mark.parametrize("n_rays,n_tris", [(1000, 333), (300, 40)])
def test_plain_k1_matches_pallas_interpret(rng, n_rays, n_tris):
    tris, p0, p1 = soup(rng, n_tris, n_rays)
    j_tri = JTriangleSet.make(*tris, dtype=jnp.float32)
    v_p, i_p, u_p = nearest_hit_triangles_pallas(
        jnp.asarray(p0), jnp.asarray(p1), j_tri, EPS32, EPS32, EPS32,
        ray_block=256, tri_block=64, interpret=True)
    valid, idx, u = (t.numpy() for t in plain(p0, p1, tris))
    assert_pallas_criteria(valid, idx, u, np.asarray(v_p), np.asarray(i_p),
                           np.asarray(u_p))
    assert valid.any()
    # misses carry the sentinel and index 0, as the TPU kernel writes them
    assert (u[~valid] == np.float32(tk.BIG)).all() and (idx[~valid] == 0).all()


def test_plain_k1_matches_xla_search(rng):
    """test_pallas.py's own comparison, against the Cramer search."""
    tris, p0, p1 = soup(rng, 333, 1000)
    j_tri = JTriangleSet.make(*tris, dtype=jnp.float32)
    ref = j_isect.nearest_hit_triangles(jnp.asarray(p0), jnp.asarray(p1), j_tri,
                                        EPS32, EPS32, EPS32, surf_chunk=64)
    valid, idx, u = (t.numpy() for t in plain(p0, p1, tris))
    assert_pallas_criteria(valid, idx, u, np.asarray(ref.valid),
                           np.asarray(ref.idx), np.asarray(ref.ray_u))


def test_plain_k1_tiling_is_exact(rng):
    """Ragged ray blocks and triangle chunks give bit-identical results."""
    tris, p0, p1 = soup(rng, 333, 1000)
    whole = plain(p0, p1, tris, ray_block=4096, tri_chunk=4096)
    tiled = plain(p0, p1, tris, ray_block=96, tri_chunk=37)
    for a, b in zip(whole, tiled):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_k1_all_miss(rng):
    tris, p0, p1 = soup(rng, 50, 64)
    # rays far away, pointing away from the soup
    p0 = np.full_like(p0, 100.0)
    p1 = p0 + 1.0
    valid, idx, u = plain(p0, p1, tris)
    assert not valid.any()
    assert (idx == 0).all() and (u == np.float32(tk.BIG)).all()


def test_ties_go_to_the_first_index(rng):
    """Duplicate triangles: both searches keep the first, also across chunk
    boundaries (strict < between chunks, first argmin within one)."""
    tris, p0, p1 = soup(rng, 40, 300, dtype=np.float64)
    dup = [np.concatenate([a, a, a]) for a in tris]       # 0..39 == 40..79 == ...
    valid, idx, _ = plain(p0, p1, dup, eps=EPS64, tri_chunk=16)
    assert valid.any() and (idx[valid] < 40).all()
    tri = triangles_from_numpy(*dup, dtype=torch.float64)
    hit = t_isect.nearest_hit_triangles(
        torch.as_tensor(p0), torch.as_tensor(p1), tri, EPS64, EPS64, EPS64,
        surf_chunk=16)
    assert (hit.idx.numpy()[hit.valid.numpy()] < 40).all()


@pytest.mark.parametrize("ray_block", [32768, 256])
def test_cramer_search_matches_jax_f64(rng, ray_block):
    tris, p0, p1 = soup(rng, 333, 1000, dtype=np.float64)
    j_tri = JTriangleSet.make(*tris, dtype=jnp.float64)
    ref = j_isect.nearest_hit_triangles(
        jnp.asarray(p0), jnp.asarray(p1), j_tri, EPS64, EPS64, EPS64,
        surf_chunk=64, ray_block=ray_block)
    hit = t_isect.nearest_hit_triangles(
        torch.as_tensor(p0), torch.as_tensor(p1),
        triangles_from_numpy(*tris, dtype=torch.float64), EPS64, EPS64, EPS64,
        surf_chunk=64, ray_block=ray_block)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(hit.valid.numpy(), valid)
    np.testing.assert_array_equal(hit.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(hit.ray_u.numpy()[valid],
                               np.asarray(ref.ray_u)[valid], rtol=1e-12)
    assert np.isinf(hit.ray_u.numpy()[~valid]).all()
    assert hit.idx.dtype == torch.int32


def test_use_kernel_dispatches_to_plain_on_cpu(rng):
    tris, p0, p1 = soup(rng, 100, 200)
    tri = triangles_from_numpy(*tris, dtype=torch.float32)
    before = tk.LAUNCHES
    hit = t_isect.nearest_hit_triangles(
        torch.as_tensor(p0), torch.as_tensor(p1), tri, EPS32, EPS32, EPS32,
        use_kernel=True)
    assert tk.LAUNCHES == before  # the CPU path launches nothing
    for a, b in zip((hit.valid, hit.idx, hit.ray_u), plain(p0, p1, tris)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_wrapper_refuses_other_devices(rng):
    t = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no triangle search"):
        tk.nearest_hit_triangles_kernel(t, t, t, t, t, EPS32, EPS32, EPS32)


def test_refine_matches_jax_f64(rng):
    tris, p0, p1 = soup(rng, 64, 64, dtype=np.float64)
    j_out = j_isect.refine_triangle_hit_from(
        jnp.asarray(p0), jnp.asarray(p1), *[jnp.asarray(a) for a in tris], EPS64)
    t_out = t_isect.refine_triangle_hit_from(
        torch.as_tensor(p0), torch.as_tensor(p1),
        *[torch.as_tensor(a) for a in tris], EPS64)
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-15)
