"""Analysis and goal utilities: landing histograms, imaging tests and
histogram losses.

Counterpart of ``tensorflowraytrace_tpu/analysis.py``.

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
* Physical optics: ``huygens_psf`` (the coherent Huygens-Fresnel PSF of
  traced rays, ``psf_from_result`` from a trace with the optical-path
  reaction, ``polychromatic_psf`` over spectral lines), ``zernike_basis``
  and ``zernike_fit``, ``encircled_energy``, ``mtf_from_psf`` and
  ``mtf_at``.  Everything is differentiable; the wavelet sum is a real
  matrix product (``cos(phase) @ amp``) on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.utils.checkpoint

from tensorflowraytrace_tpu_torch.config import FINISHED


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



# ======================================================================
# diffraction-aware imaging: the Huygens-Fresnel PSF
# ======================================================================

def _tiny(dtype):
    return torch.finfo(dtype).tiny


def _phase_refs(src, path, amp):
    """The amplitude-weighted mean source point and mean path, the
    reference wavelet of the phase reduction.  Weighting by |amp| keeps
    dead rays (amplitude 0, stale paths) from moving it."""
    w = torch.abs(amp)
    sw = torch.clamp(torch.sum(w), min=_tiny(src.dtype))
    origin = torch.sum(w[:, None] * src, dim=0) / sw
    path_ref = torch.sum(w * path) / sw
    return origin, path_ref


def _wavelet_phase(src, path, grid, k, medium_n, origin, path_ref):
    """The (G, N) phase of every ray's wavelet at every grid point,
    k (path + n |g - p|), or relative to the reference wavelet when
    ``origin`` is given.  ``k`` is a scalar or a per-ray (N,) row.  The
    distance difference is the cancellation-free dot-product form
    |g-p| - |g-c| = (c-p).((g-p)+(g-c)) / (|g-p|+|g-c|)."""
    tiny = _tiny(src.dtype)
    diff = grid[:, None, :] - src[None, :, :]
    dist = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=tiny))
    if origin is None:
        return k * (path[None, :] + medium_n * dist)
    gdiff = grid - origin[None, :]
    dref = torch.sqrt(torch.clamp(torch.sum(gdiff * gdiff, dim=-1), min=tiny))
    cp = origin[None, :] - src                               # (N, dim)
    rel = torch.einsum("nd,gnd->gn", cp, diff + gdiff[:, None, :])
    delta = rel / (dist + dref[:, None])                     # |g-p| - |g-c|
    return k * ((path - path_ref)[None, :] + medium_n * delta)


def _wavelet_field(src, path, amp, grid, k, medium_n, origin=None,
                   path_ref=None):
    """The (re, im) field ``sum_j a_j exp(i k (path_j + n |g - p_j|))`` on
    the grid, the phase relative to the reference wavelet when ``origin``
    and ``path_ref`` are given (a constant phase a grid point: |E|^2 is
    unchanged, and the trig argument shrinks from k times the whole path
    to k times its spread).  Shared by the dense, the ray-block and the
    ray-sharded (``parallel.sharding.parallel_psf``) sums.  With a (1, N)
    per-ray ``k`` and (N, K) amplitude columns it gives K spectral groups'
    fields in one pass (``polychromatic_psf``): the reference phase is
    constant a grid point within each group, whose PSFs add incoherently,
    so each group's PSF is unchanged."""
    phase = _wavelet_phase(src, path, grid, k, medium_n, origin, path_ref)
    return torch.cos(phase) @ amp, torch.sin(phase) @ amp


def _blocked_field(field, grid_rows, cols, ray_chunk, *per_ray):
    """``field(*per_ray)`` summed over blocks of ``ray_chunk`` rays on the
    host, each block under ``torch.utils.checkpoint`` when autograd
    records, so that the backward keeps one block's (G, ray_chunk) phases
    at a time rather than all of them.  The last block may be short."""
    n = per_ray[0].shape[0]
    shape = (grid_rows,) if cols is None else (grid_rows, cols)
    re = per_ray[0].new_zeros(shape)
    im = per_ray[0].new_zeros(shape)
    for start in range(0, n, ray_chunk):
        block = [a[start:start + ray_chunk] for a in per_ray]
        if torch.is_grad_enabled():
            bre, bim = torch.utils.checkpoint.checkpoint(
                field, *block, use_reentrant=False)
        else:
            bre, bim = field(*block)
        re = re + bre
        im = im + bim
    return re, im


def huygens_psf(sources, opl, wavelength, grid, amplitudes=None,
                medium_n=1.0, ray_chunk=None, phase_reduction=True):
    """Coherent Huygens-Fresnel point-spread function of traced rays.

    Each ray is a spherical wavelet at ``sources`` (its point on the last
    surface before the detector) with phase ``k * opl`` (its optical path,
    ``operations.optical_path_reaction``) and amplitude ``amplitudes``.
    The field at a grid point g is

        E_g = sum_j a_j exp(i k (opl_j + medium_n |g - p_j|))

    and the PSF is |E|^2.  Every input is differentiable, so a Strehl
    ratio or encircled energy made from it can drive a design.

    ``sources`` (N, dim), ``opl`` (N,), ``wavelength`` a scalar vacuum
    wavelength in the scene's units, ``grid`` (G, dim), ``amplitudes``
    (N,) (default 1; 0 masks a ray).  ``ray_chunk``: sum the rays in
    blocks of this size in a host loop (each block checkpointed under
    autograd), so at most G x ray_chunk phases live at once.
    ``phase_reduction``: evaluate the phases relative to the
    amplitude-weighted mean source and path, fixed before any split (|E|^2
    is unchanged; the trig arguments drop from k times the whole path to k
    times its spread, which float32 resolves).  Returns the (G,) PSF.
    """
    sources = torch.as_tensor(sources)
    dtype, device = sources.dtype, sources.device
    grid = torch.as_tensor(grid, dtype=dtype, device=device)
    opl = torch.as_tensor(opl, dtype=dtype, device=device)
    if amplitudes is None:
        amplitudes = torch.ones(sources.shape[0], dtype=dtype, device=device)
    amplitudes = torch.as_tensor(amplitudes, dtype=dtype, device=device)
    k = 2.0 * math.pi / torch.as_tensor(wavelength, dtype=dtype,
                                        device=device)
    medium_n = torch.as_tensor(medium_n, dtype=dtype, device=device)
    origin = path_ref = None
    if phase_reduction:
        origin, path_ref = _phase_refs(sources, opl, amplitudes)

    def field(s, o, a):
        return _wavelet_field(s, o, a, grid, k, medium_n, origin, path_ref)

    if ray_chunk is None:
        e_re, e_im = field(sources, opl, amplitudes)
    else:
        e_re, e_im = _blocked_field(field, grid.shape[0], None, ray_chunk,
                                    sources, opl, amplitudes)
    return e_re * e_re + e_im * e_im


def _finished_amplitudes(rays, use_intensity):
    """1 on finished rays (times sqrt(intensity) where tracked), else 0."""
    ok = rays.state == FINISHED
    amp = ok.to(rays.p0.dtype)
    if use_intensity and "intensity" in rays.fields:
        amp = amp * torch.sqrt(torch.clamp(rays.fields["intensity"], min=0.0))
    return ok, amp


def _mean_medium(rays, ok):
    """The carried index ``cur_n`` averaged over the finished rays."""
    return (torch.sum(torch.where(ok, rays.fields["cur_n"], 0.0))
            / torch.clamp(torch.sum(ok), min=1))


def psf_from_result(result, grid, wavelength, medium_n=None,
                    use_intensity=True, ray_chunk=None,
                    phase_reduction=True):
    """:func:`huygens_psf` of a ``TraceResult`` traced with
    ``operations.optical_path_reaction``: finished rays' final-leg starts
    are the wavelet sources, their ``opl`` the path to them; unfinished
    rays get amplitude 0 (finished ones sqrt(intensity) where it is
    tracked and ``use_intensity``).  ``medium_n`` defaults to the finished
    rays' mean ``cur_n``.  ``wavelength`` is in the scene's units (a ray's
    ``wavelength`` is in nm: pass ``nm * 1e-6`` in a mm scene)."""
    rays = result.rays
    if "opl" not in rays.fields:
        raise ValueError(
            "psf_from_result needs a trace run with optical_path_reaction "
            "(rays carry no 'opl' field)")
    ok, amp = _finished_amplitudes(rays, use_intensity)
    if medium_n is None:
        medium_n = _mean_medium(rays, ok)
    return huygens_psf(rays.p0, rays.fields["opl"], wavelength, grid,
                       amplitudes=amp, medium_n=medium_n,
                       ray_chunk=ray_chunk, phase_reduction=phase_reduction)


def polychromatic_psf(result, grid, wavelengths_nm, unit_scale,
                      weights=None, medium_n=None, use_intensity=True,
                      ray_chunk=None, phase_reduction=True):
    """The incoherent polychromatic PSF: rays are grouped by their (nm)
    ``wavelength``, and each group's coherent PSF is summed with its
    spectral weight.  ``unit_scale`` turns nm into the scene's unit (1e-6
    in a mm scene); ``wavelengths_nm`` lists the lines the sources
    emitted (a ray on no listed line gets k = 0 and amplitude 0).  One
    (G, N) phase evaluation serves every line (per-ray wavenumbers, an
    (N, K) one-hot amplitude matrix).  Returns the (G,) PSF."""
    rays = result.rays
    if "opl" not in rays.fields:
        raise ValueError(
            "polychromatic_psf needs a trace run with "
            "optical_path_reaction (rays carry no 'opl' field)")
    if weights is None:
        weights = [1.0] * len(wavelengths_nm)
    dtype, device = rays.p0.dtype, rays.p0.device
    grid = torch.as_tensor(grid, dtype=dtype, device=device)
    ok, base_amp = _finished_amplitudes(rays, use_intensity)
    if medium_n is None:
        medium_n = _mean_medium(rays, ok)
    medium_n = torch.as_tensor(medium_n, dtype=dtype, device=device)

    wl = rays.wavelength.to(dtype)
    onehot = torch.stack(
        [torch.isclose(wl, torch.as_tensor(w, dtype=dtype, device=device))
         .to(dtype) for w in wavelengths_nm], dim=1)
    k_groups = torch.as_tensor(
        [2.0 * math.pi / (w * unit_scale) for w in wavelengths_nm],
        dtype=dtype, device=device)
    k_ray = onehot @ k_groups
    amp_cols = base_amp[:, None] * onehot
    src, path = rays.p0, rays.fields["opl"]
    origin = path_ref = None
    if phase_reduction:
        origin, path_ref = _phase_refs(src, path, base_amp)

    def field(s, o, a, kk):
        return _wavelet_field(s, o, a, grid, kk[None, :], medium_n, origin,
                              path_ref)

    if ray_chunk is None:
        e_re, e_im = field(src, path, amp_cols, k_ray)
    else:
        e_re, e_im = _blocked_field(field, grid.shape[0], len(wavelengths_nm),
                                    ray_chunk, src, path, amp_cols, k_ray)
    w = torch.as_tensor(list(weights), dtype=dtype, device=device)
    return (e_re * e_re + e_im * e_im) @ w


def encircled_energy(psf, grid, center, radii):
    """The fraction of the PSF's energy within each radius of ``center``
    (a uniform grid: equal quadrature weights).  Returns (len(radii),)."""
    psf = torch.as_tensor(psf)
    grid = torch.as_tensor(grid, device=psf.device)
    center = torch.as_tensor(center, dtype=grid.dtype, device=grid.device)
    dist = torch.linalg.vector_norm(grid - center[None, :], dim=1)
    total = torch.clamp(torch.sum(psf), min=_tiny(psf.dtype))
    radii = torch.as_tensor(radii, dtype=grid.dtype, device=grid.device)
    inside = dist[None, :] <= radii[:, None]
    return torch.sum(torch.where(inside, psf[None, :], 0.0), dim=1) / total


# ======================================================================
# Zernike wavefront decomposition
# ======================================================================

def _noll_indices(j):
    """Noll index j (1-based) -> (n, m): even j the cosine (m > 0) term,
    odd j the sine (m < 0) term (Noll, JOSA 66, 207 (1976))."""
    if j < 1:
        raise ValueError(f"bad Noll index {j}")
    n = 0
    j1 = j - 1
    while j1 > n:
        n += 1
        j1 -= n
    m = (-1) ** j * ((n % 2) + 2 * ((j1 + ((n + 1) % 2)) // 2))
    return n, m


def zernike_basis(rho, theta, n_terms=15):
    """Noll-ordered Zernike polynomials Z_1..Z_n at polar pupil coordinates
    ``rho`` in [0, 1] and ``theta``: (N, n_terms), orthonormal over the unit
    disk with Noll's normalisation (the RMS wavefront is the norm of the
    coefficients)."""
    rho = torch.as_tensor(rho)
    theta = torch.as_tensor(theta, device=rho.device)
    cols = []
    for j in range(1, n_terms + 1):
        n, m = _noll_indices(j)
        am = abs(m)
        r = torch.zeros_like(rho)
        for k in range((n - am) // 2 + 1):
            c = ((-1) ** k * math.factorial(n - k)
                 / (math.factorial(k)
                    * math.factorial((n + am) // 2 - k)
                    * math.factorial((n - am) // 2 - k)))
            r = r + c * rho ** (n - 2 * k)
        if m == 0:
            z = math.sqrt(n + 1.0) * r
        elif m > 0:
            z = math.sqrt(2.0 * (n + 1)) * r * torch.cos(am * theta)
        else:
            z = math.sqrt(2.0 * (n + 1)) * r * torch.sin(am * theta)
        cols.append(z)
    return torch.stack(cols, dim=1)


def zernike_fit(pupil_points, opd, n_terms=15, pupil_radius=None,
                center=None):
    """Least-squares Zernike decomposition of a wavefront: ``pupil_points``
    (N, 2) ray pupil coordinates, ``opd`` (N,) optical path differences
    there.  Coordinates are normalised by ``pupil_radius`` (default: the
    largest radius present) about ``center`` (default: the centroid).
    Returns ``(coeffs, residual_rms)``, the Noll-ordered coefficients in
    the OPD's units (the least-squares solution of least norm) and the
    RMS left unexplained.  Differentiable: the
    squared radius is clamped and atan2 given a safe x at the pupil's
    exact centre."""
    pts = torch.as_tensor(pupil_points)
    opd = torch.as_tensor(opd, dtype=pts.dtype, device=pts.device)
    c = (torch.mean(pts, dim=0) if center is None
         else torch.as_tensor(center, dtype=pts.dtype, device=pts.device))
    rel = pts - c
    r2 = torch.sum(rel * rel, dim=1)
    radius = torch.sqrt(torch.clamp(r2, min=_tiny(pts.dtype)))
    if pupil_radius is None:
        pupil_radius = torch.max(radius)
    rho = radius / pupil_radius
    at_center = r2 == 0
    safe_x = torch.where(at_center, torch.ones_like(rel[:, 0]), rel[:, 0])
    theta = torch.atan2(torch.where(at_center, torch.zeros_like(rel[:, 1]),
                                    rel[:, 1]), safe_x)
    basis = zernike_basis(rho, theta, n_terms)
    # the minimum-norm solution, as jnp.linalg.lstsq gives it (singular
    # values below eps max(N, n_terms) of the largest cut): a pupil that
    # leaves terms undetermined, such as a 2D scene's line of rays, still
    # has one answer, on the CPU and on CUDA (whose lstsq assumes full rank)
    coeffs = torch.linalg.pinv(basis) @ opd
    residual = opd - basis @ coeffs
    return coeffs, torch.sqrt(torch.mean(residual * residual))


# ======================================================================
# MTF (modulation transfer function)
# ======================================================================

def _per_axis_spacing(spacing, ndim):
    try:
        spacings = tuple(spacing)
    except TypeError:
        spacings = (spacing,) * ndim
    if len(spacings) != ndim:
        raise ValueError(
            f"spacing has {len(spacings)} entries for a {ndim}-D PSF")
    return spacings


def _frequencies(n, d, dtype, device, real=False):
    f = (np.fft.rfftfreq if real else np.fft.fftfreq)(n, d=d)
    return torch.as_tensor(f, dtype=dtype, device=device)


def mtf_from_psf(psf, spacing):
    """The MTF of a PSF sampled on a regular grid: the modulus of its
    Fourier transform normalised to 1 at DC.  ``psf`` has any rank,
    ``spacing`` is the grid pitch (a scalar or one per axis).  Returns
    ``(mtf, freqs)``: the fftshift'd MTF (DC at the centre) and the
    ascending per-axis frequencies (cycles per length unit).  The window
    must hold the whole pattern and the pitch Nyquist-sample the cutoff
    ``2 NA / lambda``; differentiable."""
    psf = torch.as_tensor(psf)
    spacings = _per_axis_spacing(spacing, psf.ndim)
    otf = torch.abs(torch.fft.fftn(psf))
    dc = torch.clamp(otf[(0,) * psf.ndim], min=_tiny(otf.dtype))
    mtf = torch.fft.fftshift(otf / dc)
    freqs = tuple(
        torch.fft.fftshift(_frequencies(n, d, psf.dtype, psf.device))
        for n, d in zip(psf.shape, spacings))
    return mtf, freqs


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` for ascending ``xp``: linear inside,
    the end values outside."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def mtf_at(psf, spacing, freqs, axis=-1):
    """The MTF at chosen spatial frequencies along one axis: the through-DC
    cut (the transform of the PSF projected onto ``axis``), linearly
    interpolated at ``|freqs|`` (cycles per length unit; the MTF of a real
    PSF is even).  A differentiable "MTF >= 0.4 at 50 lp/mm" term.

    A frequency above the grid's Nyquist (``rfftfreq``'s last entry,
    1 / (2 spacing) for an even count) raises ``ValueError``.  The JAX
    package's ``mtf_at`` (``analysis.py:657-681``) instead clamps such a
    frequency to the edge value through ``jnp.interp``: a number the grid
    cannot resolve, returned as if it were the MTF there.  The port
    declines to copy that; inside the band the two agree.  The check reads
    the frequencies on the host."""
    psf = torch.as_tensor(psf)
    spacings = _per_axis_spacing(spacing, psf.ndim)
    axis = axis % psf.ndim
    proj = psf
    for ax in reversed(range(psf.ndim)):
        if ax != axis:
            proj = torch.sum(proj, dim=ax)
    otf = torch.abs(torch.fft.rfft(proj))
    mtf = otf / torch.clamp(otf[0], min=_tiny(otf.dtype))
    fr = _frequencies(proj.shape[0], spacings[axis], psf.dtype, psf.device,
                      real=True)
    f = torch.abs(torch.as_tensor(freqs, dtype=psf.dtype, device=psf.device))
    nyquist = float(fr[-1])
    if f.numel() and float(torch.max(f)) > nyquist:
        raise ValueError(
            f"mtf_at: frequency {float(torch.max(f))!r} is above the grid's "
            f"Nyquist {nyquist!r} (spacing {spacings[axis]!r}, "
            f"{proj.shape[0]} samples); sample the PSF finer")
    return _interp(f, fr, mtf)
