"""The triangle normals' cross product written out, on the CPU.

* ``compute_face_normals`` against the JAX package's, values and the
  gradient of a loss on them with respect to the three corners, in float64
  within rtol 1e-12; in float32 bit for bit with the cross product written
  out in numpy and JAX's normalisation (``torch_normals``), and near
  JAX's own float32 normals (``assert_near_jax_normals``).
* The flagship's loss (``flagship._flagship``, 36 rays, 3 bounces,
  float32, the kernels' operators) as ``export.value_and_grad``, exported
  as a joint program, loaded and run: its value and gradient equal the
  live ones bit for bit.  With ``torch.linalg.cross`` the exported
  backward added in another order than eager autograd's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import surfaces as j_surf
from tensorflowraytrace_tpu_torch import config, flagship
from tensorflowraytrace_tpu_torch.models import surfaces as t_surf
from tensorflowraytrace_tpu_torch.utils import export as ex
from torch_normals import assert_near_jax_normals, written_out_normals
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def corners(rng, m=200):
    vp = rng.normal(0, 1, (m, 3))
    return vp, vp + rng.normal(0, 1, (m, 3)), vp + rng.normal(0, 1, (m, 3))


def test_normals_and_their_gradient_match_jax(rng):
    vp, v1, v2 = corners(rng)
    w = rng.normal(0, 1, vp.shape)
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (vp, v1, v2)]
    n_t = t_surf.compute_face_normals(*leaves)
    g_t = torch.autograd.grad(torch.sum(torch.as_tensor(w) * n_t), leaves)

    def j_loss(a, b, c):
        return jnp.sum(jnp.asarray(w) * j_surf.compute_face_normals(a, b, c))

    args = [jnp.asarray(a) for a in (vp, v1, v2)]
    n_j = j_surf.compute_face_normals(*args)
    g_j = jax.grad(j_loss, argnums=(0, 1, 2))(*args)
    np.testing.assert_allclose(n_t.detach().numpy(), np.asarray(n_j),
                               rtol=1e-12, atol=1e-14)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-14)


def test_float32_normals_are_the_written_out_cross_product(rng):
    """Bit for bit with each product and difference rounded on its own
    (numpy float32), normalised as the JAX package normalises."""
    vp, v1, v2 = (a.astype(np.float32) for a in corners(rng))
    got = t_surf.compute_face_normals(*(torch.as_tensor(a)
                                        for a in (vp, v1, v2)))
    assert np.array_equal(got.numpy(), written_out_normals(vp, v1, v2))
    want = j_surf.compute_face_normals(*(jnp.asarray(a) for a in (vp, v1, v2)))
    assert want.dtype == jnp.float32
    assert_near_jax_normals(got.numpy(), want, vp, v1, v2)


def test_exported_flagship_gradient_is_bit_for_bit():
    f32 = torch.float32
    lens, source, loss = flagship._flagship(f32, 6, 3, 3, True, "cpu")
    rays = source.sample(torch.Generator().manual_seed(0), f32, "cpu")
    params = lens.init_params()
    sizes = [p.numel() for p in params]
    shapes = [p.shape for p in params]

    def flat_loss(x, r):
        return loss([c.reshape(s) for c, s in zip(x.split(sizes), shapes)], r)

    x0 = torch.cat([p.detach().reshape(-1) for p in params])
    vag = ex.value_and_grad(flat_loss)
    served = ex.load_fn(ex.export_fn(vag, x0, rays))
    l_srv, g_srv = served(x0, rays)
    l_live, g_live = vag(x0, rays)
    assert float(g_live.abs().max()) > 0
    assert torch.equal(l_srv, l_live)
    assert torch.equal(g_srv, g_live)
