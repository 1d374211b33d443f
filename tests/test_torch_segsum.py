"""K2, the segment sum, and the gather it is the backward of, on the CPU.

* K2's plain version (``index_add_``) against the JAX package's Pallas
  kernel in interpret mode and against its scatter (``.at[idx].add``), at
  the cases of tests/test_pallas.py: k = 13, n = 5000, m in {242, 2048,
  16386}, random and coherent idx; rtol 1e-5 and atol 1e-5 (float32 sums
  taken in different orders).
* ``engine._gather_rows_t`` (the ``tfrt_torch::gather_rows_t`` operator,
  whose registered backward is K2 on the card) against autograd of the plain gather, and against the
  JAX package's custom VJP, in float64: rtol 1e-12.

The kernel itself runs only on the card: tests/test_torch_segsum_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu.ops.pallas_kernels import segment_sum_pallas
from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.engine import _gather_rows_t
from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

K, N = 13, 5000


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def segsum_case(rng, m, coherent, k=K, n=N):
    ct = rng.normal(0, 1, (k, n)).astype(np.float32)
    if coherent:
        # blocks of rays hitting nearby table rows
        base = np.repeat(rng.integers(0, m - 40, n // 100 + 1), 100)[:n]
        idx = (base + rng.integers(0, 40, n)).astype(np.int32)
    else:
        idx = rng.integers(0, m, n).astype(np.int32)
    return ct, idx


@pytest.mark.parametrize("m,coherent", [(242, False), (242, True),
                                        (2048, False), (2048, True),
                                        (16386, False), (16386, True)])
def test_plain_matches_pallas_and_scatter(rng, m, coherent):
    ct, idx = segsum_case(rng, m, coherent)
    got = sk.segment_sum_plain(torch.as_tensor(ct), torch.as_tensor(idx), m)
    assert got.shape == (m, K) and got.dtype == torch.float32
    pallas = segment_sum_pallas(jnp.asarray(ct), jnp.asarray(idx), m,
                                interpret=True)
    scatter = jnp.zeros((m, K), jnp.float32).at[idx].add(jnp.asarray(ct).T)
    for want in (pallas, scatter):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_wrapper_runs_the_plain_version_on_cpu(rng):
    ct, idx = segsum_case(rng, 242, False)
    before = sk.LAUNCHES
    got = sk.segment_sum_kernel(torch.as_tensor(ct), torch.as_tensor(idx), 242)
    assert sk.LAUNCHES == before  # no CUDA kernel on the CPU
    want = sk.segment_sum_plain(torch.as_tensor(ct), torch.as_tensor(idx), 242)
    assert torch.equal(got, want)


def test_wrapper_refuses_other_devices():
    t = torch.empty((13, 4), device="meta")
    with pytest.raises(ValueError, match="no segment sum"):
        sk.segment_sum_kernel(t, torch.empty((4,), dtype=torch.int32,
                                             device="meta"), 3)


@pytest.mark.parametrize("k,n,m", [(1, 1, 1), (13, 1000, 333), (13, 3, 770)])
def test_plain_ragged_shapes_and_empty_rows(rng, k, n, m):
    """Rows no ray lands on and zero cotangents (the packed annotation
    column, which carries no gradient) sum to exact zeros."""
    ct = rng.normal(0, 1, (k, n))
    ct[-1] = 0.0
    idx = rng.integers(0, m, n)
    got = sk.segment_sum_plain(torch.as_tensor(ct),
                               torch.as_tensor(idx, dtype=torch.int32), m)
    want = np.zeros((m, k))
    np.add.at(want, idx, ct.T)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    assert (got[:, -1] == 0).all()
    missed = np.setdiff1d(np.arange(m), idx)
    assert (got[missed] == 0).all()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gather_gradient_matches_plain_gather(rng, use_kernel):
    """As tests/test_pallas.py's test of the JAX custom VJP: the table
    gradient through ``_gather_rows_t`` equals autograd of the plain
    ``table[idx].T`` and JAX's, in float64."""
    m, k, n = 50, 7, 900
    table = rng.normal(0, 1, (m, k))
    idx = rng.integers(0, m, n).astype(np.int32)
    w = rng.normal(0, 1, (k, n))
    t_idx, t_w = torch.as_tensor(idx), torch.as_tensor(w)

    def grad(gather):
        t = torch.as_tensor(table).requires_grad_(True)
        torch.sum(t_w * gather(t) ** 2).backward()
        return t.grad.numpy()

    g1 = grad(lambda t: _gather_rows_t(t, t_idx, use_kernel))
    g2 = grad(lambda t: t[t_idx.long()].T)
    np.testing.assert_allclose(g1, g2, rtol=1e-12)
    g_jax = jax.grad(lambda t: jnp.sum(jnp.asarray(w) * j_engine._gather_rows_t(
        t, jnp.asarray(idx)) ** 2))(jnp.asarray(table))
    np.testing.assert_allclose(g1, np.asarray(g_jax), rtol=1e-12)


def test_gather_forward_is_the_transposed_rows(rng):
    table = torch.as_tensor(rng.normal(0, 1, (20, 13)))
    idx = torch.as_tensor(rng.integers(0, 20, 64), dtype=torch.int32)
    rows = _gather_rows_t(table, idx, True)
    assert rows.shape == (13, 64)
    assert torch.equal(rows, table[idx.long()].T)
    assert not rows.requires_grad
