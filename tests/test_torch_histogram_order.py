"""The histograms bin through K2 (``segsum_kernels``), in its fixed order,
on the CPU.

* ``histogram2d`` with float32 weights, on points whose bins several
  tiles of ``segsum_kernels.TILE`` rays share, equals a numpy model of
  K2's order bit for bit: ``np.add.at`` (sequential, unbuffered) a tile
  into a zeroed partial, the partials added in tile order from +0.
* ``soft_histogram2d``'s four splats, laid out corner by corner ((iy, ix),
  (iy, ix1), (iy1, ix), (iy1, ix1)) as one sum over 4N entries, equal the
  same model bit for bit.
* Their gradients with respect to the weights (and the points, for the
  soft one) pass ``torch.autograd.gradcheck`` in float64.
* ``segment_sum_plain`` in float64 equals the model bit for bit, on tables
  of fewer and of more rows than a tile (where only a tile's own rows are
  added).
"""

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch import analysis as t_an
from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
RANGE = ((-0.6, 0.6), (-0.5, 0.7))


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def tiled_model(values, rows, m):
    """K2's order in numpy for k = 1: np.add.at a tile into a zeroed
    partial, then the partials added in tile order from +0."""
    out = np.zeros(m, values.dtype)
    for start in range(0, len(values), sk.TILE):
        part = np.zeros(m, values.dtype)
        np.add.at(part, rows[start:start + sk.TILE],
                  values[start:start + sk.TILE])
        out = out + part
    return out


def mid_bin_points(rng, n, x_bins, y_bins):
    """Points well inside their bins (so that the bin is unambiguous in any
    arithmetic), with their flat bins, drawn at random over the range."""
    (x0, x1), (y0, y1) = RANGE
    ix = rng.integers(0, x_bins, n)
    iy = rng.integers(0, y_bins, n)
    x = x0 + (ix + rng.uniform(0.2, 0.8, n)) * (x1 - x0) / x_bins
    y = y0 + (iy + rng.uniform(0.2, 0.8, n)) * (y1 - y0) / y_bins
    return x.astype(np.float32), y.astype(np.float32), iy * x_bins + ix


@pytest.mark.parametrize("n,x_bins,y_bins", [
    (5000, 6, 5),      # each bin holds rays of all five tiles
    (3100, 64, 48),    # most bins hold a few rays of one or two tiles
    (700, 3, 2),       # fewer rays than a tile
])
def test_histogram2d_adds_in_k2_order(rng, n, x_bins, y_bins):
    x, y, flat = mid_bin_points(rng, n, x_bins, y_bins)
    w = rng.normal(0, 1, n).astype(np.float32)
    got = t_an.histogram2d(torch.as_tensor(x), torch.as_tensor(y), RANGE,
                           x_bins, y_bins, weights=torch.as_tensor(w))
    assert got.dtype == torch.float32 and got.shape == (y_bins, x_bins)
    want = tiled_model(w, flat, x_bins * y_bins).reshape(y_bins, x_bins)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    counts = t_an.histogram2d(torch.as_tensor(x), torch.as_tensor(y), RANGE,
                              x_bins, y_bins)
    assert np.array_equal(counts.numpy().reshape(-1),
                          np.bincount(flat, minlength=x_bins * y_bins))


def soft_splats(x, y, w, x_bins, y_bins):
    """The soft histogram's four corners of each point, as the port
    computes them, laid out corner by corner."""
    (x0, x1), (y0, y1) = RANGE
    fx = torch.clamp((x - x0) / (x1 - x0) * x_bins - 0.5, 0.0, x_bins - 1.0)
    fy = torch.clamp((y - y0) / (y1 - y0) * y_bins - 0.5, 0.0, y_bins - 1.0)
    ix, iy = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - ix, fy - iy
    ix, iy = ix.long(), iy.long()
    ix1 = torch.clamp(ix + 1, max=x_bins - 1)
    iy1 = torch.clamp(iy + 1, max=y_bins - 1)
    flat = torch.cat([iy * x_bins + ix, iy * x_bins + ix1,
                      iy1 * x_bins + ix, iy1 * x_bins + ix1])
    splat = torch.cat([w * (1 - wx) * (1 - wy), w * wx * (1 - wy),
                       w * (1 - wx) * wy, w * wx * wy])
    return splat.numpy(), flat.numpy()


@pytest.mark.parametrize("n,x_bins,y_bins", [(3000, 7, 5), (1500, 40, 30)])
def test_soft_histogram2d_adds_in_k2_order(rng, n, x_bins, y_bins):
    x = torch.as_tensor(rng.uniform(-0.8, 0.8, n).astype(np.float32))
    y = torch.as_tensor(rng.uniform(-0.7, 0.9, n).astype(np.float32))
    w = torch.as_tensor(rng.uniform(0, 2, n).astype(np.float32))
    got = t_an.soft_histogram2d(x, y, RANGE, x_bins, y_bins, weights=w)
    assert got.dtype == torch.float32
    splat, flat = soft_splats(x, y, w, x_bins, y_bins)
    want = tiled_model(splat, flat, x_bins * y_bins).reshape(y_bins, x_bins)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    again = t_an.soft_histogram2d(x, y, RANGE, x_bins, y_bins, weights=w)
    assert torch.equal(again, got)


def test_histogram_gradients_pass_gradcheck(rng):
    n = 300
    x = torch.as_tensor(rng.uniform(-0.7, 0.7, n))
    y = torch.as_tensor(rng.uniform(-0.6, 0.8, n))
    w = torch.as_tensor(rng.uniform(0.5, 1.5, n)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda w: t_an.histogram2d(x, y, RANGE, 6, 5, dtype=F64, weights=w),
        (w,))
    xs, ys = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: t_an.soft_histogram2d(a, b, RANGE, 6, 5, weights=c),
        (xs, ys, w))


def test_segment_sum_op_gradient_is_the_gather(rng):
    """The operator's registered backward: g[idx].T, by gradcheck, over
    rays of several tiles."""
    n, m = 2100, 9
    ct = torch.as_tensor(rng.normal(0, 1, (2, n))).requires_grad_(True)
    idx = torch.as_tensor(rng.integers(0, m, n), dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda c: torch.ops.tfrt_torch.segment_sum(c, idx, m), (ct,))


@pytest.mark.parametrize("n,m,k", [(5000, 30, 1), (4100, 2000, 3),
                                   (3000, 700, 13)])
def test_plain_float64_adds_in_k2_order(rng, n, m, k):
    ct = rng.normal(0, 1, (k, n))
    idx = rng.integers(0, m, n).astype(np.int32)
    got = sk.segment_sum_plain(torch.as_tensor(ct), torch.as_tensor(idx), m)
    assert got.dtype == F64
    want = np.stack([tiled_model(ct[c], idx, m) for c in range(k)], axis=1)
    assert np.array_equal(got.numpy().view(np.uint64), want.view(np.uint64))

