"""Analysis and goal utilities: landing histograms, imaging tests and
histogram losses.

Counterpart of the core of ``tensorflowraytrace_tpu/analysis.py`` (its PSF,
Zernike and MTF code is not ported yet).

* ``histogram2d`` bins by one scatter-add.  y is the first index of the
  output and x the second; a bin index is the scaled coordinate truncated
  toward zero, then clamped into [0, bins - 1], so out-of-range points land
  in the edge bins.
* ``soft_histogram2d`` splats each point bilinearly onto its four
  neighbouring bin centres, so autograd gives d(hist)/d(points).
* ``imaging_test`` traces batches on the host's request and histograms them
  with NumPy: one read-back per batch, by design.
* ``DistributionDifferential`` compares a point cloud with a goal density,
  with an optional penalty for points outside the domain.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a):
    """A NumPy array of ``a`` (a tensor on any device, or array-like)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _bin_index(v, lo, hi, bins):
    """The bin of each coordinate: truncation toward zero, then a clamp into
    [0, bins - 1].  The clamp to [-1, bins] before the cast changes no bin
    and keeps values outside the integer range (far or dead rays) out of
    it."""
    f = torch.clamp((v - lo) / (hi - lo) * bins, -1.0, float(bins))
    return torch.clamp(f.to(torch.int64), 0, bins - 1)


def histogram2d(x, y, value_range, x_bins=100, y_bins=None, dtype=None,
                weights=None):
    """2D histogram by scatter-add: (y_bins, x_bins) counts (or summed
    ``weights``) of the points, y on axis 0.  ``value_range`` is
    ``((x0, x1), (y0, y1))``; points outside it count in the edge bins.
    No gradient reaches the points; one reaches ``weights``."""
    y_bins = y_bins or x_bins
    dtype = dtype or torch.float32
    x = torch.as_tensor(x).detach()
    y = torch.as_tensor(y, device=x.device).detach()
    (x0, x1), (y0, y1) = value_range
    flat = (_bin_index(y, y0, y1, y_bins) * x_bins
            + _bin_index(x, x0, x1, x_bins))
    w = (torch.ones(x.shape, dtype=dtype, device=x.device) if weights is None
         else torch.as_tensor(weights, device=x.device).to(dtype))
    counts = torch.zeros((y_bins * x_bins,), dtype=dtype, device=x.device)
    return counts.index_add(0, flat, w).reshape(y_bins, x_bins)


def soft_histogram2d(x, y, value_range, x_bins=100, y_bins=None,
                     weights=None):
    """Differentiable 2D histogram: each point adds its weight to the four
    bin centres around it, bilinearly; a point outside the range splats onto
    the edge.  Autograd gives the gradient with respect to the points and
    the weights."""
    y_bins = y_bins or x_bins
    (x0, x1), (y0, y1) = value_range
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    if weights is None:
        weights = torch.ones_like(x)

    # continuous bin coordinates of each point (bin centres at .5 offsets)
    fx = torch.clamp((x - x0) / (x1 - x0) * x_bins - 0.5, 0.0, x_bins - 1.0)
    fy = torch.clamp((y - y0) / (y1 - y0) * y_bins - 0.5, 0.0, y_bins - 1.0)
    ix, iy = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - ix, fy - iy
    ix, iy = ix.to(torch.int64), iy.to(torch.int64)
    ix1 = torch.clamp(ix + 1, max=x_bins - 1)
    iy1 = torch.clamp(iy + 1, max=y_bins - 1)

    h = torch.zeros((y_bins * x_bins,), dtype=x.dtype, device=x.device)
    h = h.index_add(0, iy * x_bins + ix, weights * (1 - wx) * (1 - wy))
    h = h.index_add(0, iy * x_bins + ix1, weights * wx * (1 - wy))
    h = h.index_add(0, iy1 * x_bins + ix, weights * (1 - wx) * wy)
    h = h.index_add(0, iy1 * x_bins + ix1, weights * wx * wy)
    return h.reshape(y_bins, x_bins)


def inner_product(first, second):
    """Normalised inner product of two images, in float64 on the host."""
    first = _host(first).astype(np.float64)
    second = _host(second).astype(np.float64)
    first = first / np.linalg.norm(first)
    second = second / np.linalg.norm(second)
    return float(np.sum(first * second))


def imaging_test(get_samples, image_range, batch_count=50, bins=128,
                 verbose=True, display=False, weighted=False):
    """Trace many batches and histogram where the rays land.
    ``get_samples()`` returns (n, 2) landing points (a tensor on any device
    or an array), typically the finished rays' (y, z) of a fresh trace; with
    ``weighted=True`` it returns (n, >= 3) with a per-ray weight in column
    2, giving a radiometric image.  Extra columns are otherwise ignored.
    Each batch is read back to the host.  Returns
    ``(h, xedges, yedges, image)`` (``image`` is matplotlib's, with
    ``display``)."""
    image_samples = []
    for i in range(batch_count):
        image_samples.append(_host(get_samples()))
        if verbose:
            print(f"Sampling step {i}/{batch_count}-{100 * i / batch_count:.2f}%.")
    samples = np.concatenate(image_samples)
    if weighted and samples.shape[1] < 3:
        raise ValueError(
            "imaging_test(weighted=True) needs (n, >=3) samples with the "
            f"weight in column 2; got shape {samples.shape}")
    weights = samples[:, 2] if weighted else None
    if verbose:
        print(f"final sample shape: {samples.shape}")
        print(f"total rays traced: {samples.shape[0]}")

    image = None
    if display:
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 1, figsize=(9, 9))
        ax.set_aspect("equal")
        h, xedges, yedges, image = ax.hist2d(
            samples[:, 0], samples[:, 1], bins=bins, range=image_range,
            weights=weights)
        plt.show()
    else:
        h, xedges, yedges = np.histogram2d(
            samples[:, 0], samples[:, 1], bins=bins, range=image_range,
            weights=weights)
    return h, xedges, yedges, image


class DistributionDifferential:
    """Squared difference between a point cloud's normalised histogram and
    a normalised goal density: hard binning (``soft=False``, a float32
    histogram, for gradient-free search) or the bilinear splat
    (``soft=True``, for gradient descent).

    ``goal`` is a (y_bins, x_bins) image or a callable ``goal(x, y)`` on the
    bin centres.  ``oob_penalty``, optional, maps distances from the
    domain's centre to penalties; points outside the domain are charged
    their mean penalty and left out of the histogram.
    """

    def __init__(self, goal, domain, x_bins=50, y_bins=None, oob_penalty=None,
                 soft=False):
        self._x_bins = x_bins
        self._y_bins = y_bins or x_bins
        self.soft = soft
        try:
            (self._x_start, self._x_end), (self._y_start, self._y_end) = domain
        except (TypeError, ValueError) as e:
            raise ValueError(
                "DistributionDifferential: domain must have shape (2, 2).") from e
        self._domain = ((self._x_start, self._x_end),
                        (self._y_start, self._y_end))

        if callable(goal):
            gx = np.linspace(self._x_start, self._x_end, self._x_bins + 1)
            gy = np.linspace(self._y_start, self._y_end, self._y_bins + 1)
            gx = (gx[:-1] + gx[1:]) / 2.0
            gy = (gy[:-1] + gy[1:]) / 2.0
            gxx, gyy = np.meshgrid(gx, gy)
            goal = goal(gxx, gyy)
        goal = torch.as_tensor(goal)
        if goal.dim() != 2:
            raise ValueError("DistributionDifferential: goal must be 2D.")
        self._x_bins = goal.shape[1]
        self._y_bins = goal.shape[0]
        self._goal = goal / torch.linalg.vector_norm(goal)

        self._oob_penalty = oob_penalty
        if oob_penalty is not None:
            oob_penalty(torch.zeros(5))  # contract check

    def _distance(self, x, y):
        cx = (self._x_start + self._x_end) / 2.0
        cy = (self._y_start + self._y_end) / 2.0
        return torch.sqrt((x - cx) ** 2 + (y - cy) ** 2)

    def __call__(self, x, y):
        x = torch.as_tensor(x)
        y = torch.as_tensor(y, device=x.device)
        penalty = 0.0
        weights = None
        if self._oob_penalty is not None:
            oob = ((x < self._x_start) | (x > self._x_end)
                   | (y < self._y_start) | (y > self._y_end))
            d = self._distance(x, y)
            pen = self._oob_penalty(torch.where(oob, d, torch.zeros_like(d)))
            pen = torch.where(oob, pen, torch.zeros_like(pen))
            penalty = torch.sum(pen) / torch.clamp(torch.sum(oob), min=1)
            weights = (~oob).to(x.dtype)

        binning = soft_histogram2d if self.soft else histogram2d
        histo = binning(x, y, self._domain, x_bins=self._x_bins,
                        y_bins=self._y_bins, weights=weights)
        histo = histo / torch.clamp(torch.linalg.vector_norm(histo), min=1e-30)
        self.saved_histo = histo
        goal = self._goal.to(dtype=histo.dtype, device=histo.device)
        return torch.sum((histo - goal) ** 2) + penalty
