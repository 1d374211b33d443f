"""K2, the segment sum, and the gather it is the backward of, on the CPU.

* K2's plain version against a numpy model of K2's order, bit for bit in
  float32: ``np.add.at`` (sequential and unbuffered) a tile of
  ``segsum_kernels.TILE`` rays into a zeroed partial, and the partials
  added in tile order; at rays below, at and past a tile, a last tile of
  one ray, one row, empty rows, more rows than a tile's rays, a row in
  every tile, rows in 31-33 tiles, rows descending within tiles, k = 1,
  2, 3, 4 and 13, -0 cotangents, +inf and -inf, and a NaN; two calls give
  the same bits.  The plain version refuses rows out of range.
* K2's plain version against the JAX package's Pallas
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


def tiled_model(ct, idx, m):
    """K2's order in numpy: np.add.at a tile into a zeroed partial, then
    the partials added in tile order from +0."""
    k, n = ct.shape
    out = np.zeros((m, k), ct.dtype)
    for start in range(0, n, sk.TILE):
        part = np.zeros((m, k), ct.dtype)
        np.add.at(part, idx[start:start + sk.TILE],
                  ct[:, start:start + sk.TILE].T)
        out = out + part
    return out


@pytest.mark.parametrize("n,m,k,case", [
    (700, 50, 13, "random"),          # fewer rays than a tile
    (2 * 1024, 50, 13, "random"),     # an exact multiple of a tile
    (5000, 242, 13, "random"),        # ragged
    (3333, 770, 4, "random"),
    (4100, 1, 1, "random"),           # one row
    (3000, 770, 13, "one_row"),       # every ray on one row of many
    (2500, 16386, 13, "random"),      # most rows empty
    (4096, 60, 4, "negative_zero"),   # -0 cotangents
    (2600, 90, 13, "nan"),            # a NaN reaches its row and column
    (3 * 1024 + 1, 40, 4, "random"),  # a last tile of one ray
    (40 * 1024 + 3, 50, 1, "every_tile"),    # a row in each of 41 tiles
    (33 * 1024 + 1, 60, 2, "every_tile"),    # past a bitmap word of tiles
    (34 * 1024, 300, 3, "tile_counts"),      # rows in 31-33 tiles
    (2 * 1024 + 5, 20, 3, "inf"),     # +inf, -inf, and NaN where they meet
    (5 * 1024 + 17, 9000, 1, "random"),      # more rows than a tile's rays
    (4 * 1024, 30, 2, "descending"),  # rows descending within each tile
])
def test_plain_adds_in_the_tiles_order(rng, n, m, k, case):
    ct = rng.normal(0, 1, (k, n)).astype(np.float32)
    idx = rng.integers(0, m, n).astype(np.int32)
    if case == "one_row":
        idx[:] = m // 2
    elif case == "negative_zero":
        ct[:, ::3] = -0.0
        ct[:, idx == 7] = -0.0  # a row of -0 alone sums to +0
    elif case == "nan":
        ct[2, 1500] = np.nan
    elif case == "every_tile":
        idx[5::sk.TILE] = m - 1
    elif case == "tile_counts":
        # row 11 in 31 tiles, 12 in 32, 13 in 33, no other ray on them
        idx[np.isin(idx, (11, 12, 13))] = 0
        for row, tiles in ((11, 31), (12, 32), (13, 33)):
            idx[row::sk.TILE][:tiles] = row
    elif case == "inf":
        ct[1, 100] = ct[1, 1500] = np.inf
        ct[2, 300], ct[2, 301] = np.inf, -np.inf
        idx[301] = idx[300]
    elif case == "descending":
        idx = np.concatenate([np.sort(t)[::-1] for t in
                              np.split(idx, n // sk.TILE)]).astype(np.int32)
    want = tiled_model(ct, idx, m)
    got = sk.segment_sum_plain(torch.as_tensor(ct), torch.as_tensor(idx), m)
    again = sk.segment_sum_plain(torch.as_tensor(ct), torch.as_tensor(idx), m)
    assert got.dtype == torch.float32 and got.shape == (m, k)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert np.array_equal(again.numpy().view(np.uint32),
                          got.numpy().view(np.uint32))
    if case == "negative_zero":
        assert not np.signbit(got.numpy()[7]).any()
    if case == "nan":
        nan = np.zeros((m, k), bool)
        nan[idx[1500], 2] = True
        assert np.array_equal(np.isnan(got.numpy()), nan)
    if case == "inf":
        assert got[idx[100], 1] == np.inf
        assert np.isnan(got[idx[300], 2].item())
    if case == "tile_counts":
        for row in (11, 12, 13):
            np.testing.assert_allclose(got[row].numpy(), want[row])


def test_plain_raises_on_rows_out_of_range(rng):
    """The plain version refuses an idx outside [0, m) (the kernel drops
    such rays; tests/test_torch_segsum_kernel.py holds it to this version
    with their cotangents zeroed)."""
    ct = torch.as_tensor(rng.normal(0, 1, (2, 3000)).astype(np.float32))
    for bad in (-1, 50):
        idx = torch.as_tensor(rng.integers(0, 50, 3000), dtype=torch.int32)
        idx[1234] = bad
        with pytest.raises((IndexError, RuntimeError)):
            sk.segment_sum_plain(ct, idx, 50)


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
