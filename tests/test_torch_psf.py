"""The physical-optics analysis (``analysis.py``'s PSF, Zernike and MTF
half, and ``parallel/sharding.parallel_psf``) against the JAX package, on
the CPU in float64, on seeded numpy inputs.

* ``huygens_psf`` dense and in ray blocks (the port's host loop under
  ``torch.utils.checkpoint``), with and without the phase reduction:
  values within rtol 1e-9 of JAX's, and the gradients with respect to the
  sources, paths and amplitudes within 1e-9 of their largest magnitude.
* ``psf_from_result`` and ``polychromatic_psf`` (dense and blocked) from
  the same rays, with an intensity field and unfinished rays: rtol 1e-9.
* ``zernike_basis`` and ``zernike_fit`` (a chief ray at the exact pupil
  centre included; its gradient finite): rtol 1e-10.
* ``encircled_energy`` and ``mtf_from_psf``: rtol 1e-12; ``mtf_at`` inside
  the band (both axes, negative frequencies, the Nyquist itself): 1e-12.
* ``mtf_at`` above the grid's Nyquist raises ``ValueError`` in the port;
  the JAX package clamps to the edge value (a reference fault its
  docstring names).
* ``parallel_psf`` on two gloo ranks (two processes, each with half the
  rays) against the dense PSF: rtol 1e-9.
"""

import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import analysis as j_an
from tensorflowraytrace_tpu.config import FINISHED as J_FINISHED
from tensorflowraytrace_tpu.models.rays import RaySet as JRaySet
from tensorflowraytrace_tpu_torch import analysis as t_an
from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.utils.convert import rayset_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
RTOL = 1e-9
ROOT = Path(__file__).resolve().parents[1]
N, G = 96, 25
LAM = 0.55e-3


# the JAX references compiled whole: op by op, JAX compiles every
# primitive on first use, which costs this file more than the comparisons
j_psf = jax.jit(j_an.huygens_psf, static_argnames=("ray_chunk",
                                                   "phase_reduction"))


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def wavefront(seed=3):
    """Wavelet sources on a curved last surface near x = 0, paths of a
    slightly aberrated focus at x = 3 (a spread of a few waves), mixed
    amplitudes with two dead rays, and a 5 x 5 grid around the focus."""
    rng = np.random.default_rng(seed)
    y = np.linspace(-0.6, 0.6, N)
    src = np.stack([0.1 * y ** 2 + rng.normal(0, 1e-4, N), y], axis=1)
    focus = np.array([3.0, 0.0])
    opl = 10.0 - 1.5 * np.linalg.norm(src - focus, axis=1) + 3e-4 * y ** 4
    amp = rng.uniform(0.5, 1.0, N)
    amp[[4, 50]] = 0.0
    gy, gx = np.meshgrid(np.linspace(-4e-3, 4e-3, 5),
                         np.linspace(-4e-3, 4e-3, 5), indexing="ij")
    grid = focus + np.stack([gx.ravel(), gy.ravel()], axis=1)
    return src, opl, amp, grid


def close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def grads_close(t_g, j_g, tol=RTOL):
    for t, j in zip(t_g, j_g):
        j = np.asarray(j)
        scale = float(np.abs(j).max())
        assert np.isfinite(j).all() and scale > 0
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=tol * scale)


@functools.lru_cache(maxsize=None)
def jax_psf_and_grad(reduction):
    """JAX's dense PSF of ``wavefront()`` and the gradient of a weighted
    sum of it with respect to the sources, paths and amplitudes."""
    src, opl, amp, grid = wavefront()
    weights = np.linspace(1.0, 2.0, G)

    def f(s, o, a):
        return j_psf(s, o, LAM, jnp.asarray(grid), amplitudes=a,
                     medium_n=1.5, phase_reduction=reduction)

    j_in = [jnp.asarray(a) for a in (src, opl, amp)]
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * weights),
                             argnums=(0, 1, 2)))(*j_in)
    return f(*j_in), grads, weights


@pytest.mark.parametrize("chunk,reduction", [(None, True), (40, True),
                                             (None, False)])
def test_huygens_psf_and_gradient_match_jax(chunk, reduction):
    """The port's blocked sum (its own host loop) is held to JAX's dense
    values and gradients, and its values to JAX's blocked ``lax.scan``."""
    src, opl, amp, grid = wavefront()
    t_in = [torch.tensor(a, requires_grad=True) for a in (src, opl, amp)]
    t_psf = t_an.huygens_psf(*t_in[:2], LAM, torch.as_tensor(grid),
                             amplitudes=t_in[2], medium_n=1.5,
                             ray_chunk=chunk, phase_reduction=reduction)
    j_dense, j_g, weights = jax_psf_and_grad(reduction)
    close(t_psf, j_dense)
    if chunk is not None:
        close(t_psf, j_psf(src, opl, LAM, grid, amp, 1.5, ray_chunk=chunk,
                           phase_reduction=reduction))
    t_g = torch.autograd.grad(torch.sum(t_psf * torch.as_tensor(weights)),
                              t_in)
    grads_close(t_g, j_g)


def rays_pair(with_intensity, wavelengths=None):
    """The same rays in both packages: wavefront sources as p0, paths,
    cur_n 1.5, a few rays unfinished."""
    src, opl, amp, _ = wavefront()
    state = np.full(N, J_FINISHED, np.int32)
    state[[1, 7, 60]] = 0
    fields = {"opl": opl, "cur_n": np.full(N, 1.5)}
    if with_intensity:
        fields["intensity"] = amp ** 2
    wl = wavelengths if wavelengths is not None else np.full(N, 550.0)
    p1 = src + np.array([1.0, 0.0])
    j_rays = JRaySet.make(src, p1, wl, state,
                          {k: jnp.asarray(v) for k, v in fields.items()},
                          dtype=jnp.float64)
    t_rays = rayset_from_numpy(src, p1, wl, state, fields, dtype=F64,
                               device="cpu")
    return (types.SimpleNamespace(rays=j_rays),
            types.SimpleNamespace(rays=t_rays))


@pytest.mark.parametrize("chunk", [None, 32])
def test_psf_from_result_and_polychromatic_match_jax(chunk):
    _, _, _, grid = wavefront()
    j_res, t_res = rays_pair(True)
    j_mono = jax.jit(lambda rays: j_an.psf_from_result(
        types.SimpleNamespace(rays=rays), jnp.asarray(grid), LAM,
        ray_chunk=chunk))
    close(t_an.psf_from_result(t_res, torch.as_tensor(grid), LAM,
                               ray_chunk=chunk), j_mono(j_res.rays))
    lines = [450.0, 550.0, 650.0]
    wl = np.array(lines + [700.0])[np.arange(N) % 4]  # 700 nm: no line
    j_res, t_res = rays_pair(True, wl)
    kw = dict(weights=[0.5, 1.0, 0.7], ray_chunk=chunk)
    j_poly = jax.jit(lambda rays: j_an.polychromatic_psf(
        types.SimpleNamespace(rays=rays), jnp.asarray(grid), lines, 1e-6,
        **kw))
    close(t_an.polychromatic_psf(t_res, torch.as_tensor(grid), lines, 1e-6,
                                 **kw), j_poly(j_res.rays))
    with pytest.raises(ValueError, match="optical_path_reaction"):
        del t_res.rays.fields["opl"]
        t_an.psf_from_result(t_res, torch.as_tensor(grid), LAM)


def test_zernike_basis_and_fit_match_jax(rng):
    rho, theta = rng.uniform(0, 1, 50), rng.uniform(-np.pi, np.pi, 50)
    close(t_an.zernike_basis(torch.as_tensor(rho), torch.as_tensor(theta), 21),
          jax.jit(j_an.zernike_basis, static_argnums=2)(
              jnp.asarray(rho), jnp.asarray(theta), 21), 1e-10, 1e-14)
    assert [t_an._noll_indices(j) for j in range(1, 22)] == [
        j_an._noll_indices(j) for j in range(1, 22)]
    pts = rng.uniform(-1, 1, (80, 2))
    pts -= pts.mean(axis=0)
    pts[0] = 0.0  # the chief ray at the exact centre
    opd = 0.3 * pts[:, 0] ** 2 - 0.1 * pts[:, 1] + 0.05 * pts[:, 0] ** 3
    j_fit = jax.jit(j_an.zernike_fit, static_argnums=(2, 3, 4))
    for center in (None, (0.0, 0.0)):
        j_c, j_r = j_fit(jnp.asarray(pts), jnp.asarray(opd), 15, None, center)
        t_pts = torch.tensor(pts, requires_grad=True)
        t_c, t_r = t_an.zernike_fit(t_pts, torch.as_tensor(opd), 15,
                                    center=center)
        close(t_c, j_c, 1e-10, 1e-13)
        close(t_r, j_r, 1e-9, 1e-14)
    g, = torch.autograd.grad(t_c[3] + t_r, t_pts)
    assert torch.isfinite(g).all()


def test_zernike_fit_of_a_pupil_line_is_the_least_norm_one(rng):
    """A 2D scene's pupil is a line of points (x = 0): 11 Zernike terms are
    not all determined there, and the fit is the least-norm solution that
    ``jnp.linalg.lstsq`` returns (examples/wavefront_lens.py's fit)."""
    ys = np.linspace(-1.0, 1.0, 48)
    pts = np.stack([np.zeros_like(ys), ys], axis=1)
    opd = 0.02 * ys ** 2 - 0.005 * ys ** 4 + 1e-3 * rng.normal(size=48)
    j_c, j_r = jax.jit(j_an.zernike_fit, static_argnums=(2, 3, 4))(
        jnp.asarray(pts), jnp.asarray(opd), 11, 1.0, (0.0, 0.0))
    t_c, t_r = t_an.zernike_fit(torch.as_tensor(pts), torch.as_tensor(opd),
                                11, pupil_radius=1.0, center=(0.0, 0.0))
    close(t_c, j_c, 1e-9, 1e-13)
    close(t_r, j_r, 1e-9, 1e-14)


def test_encircled_energy_and_mtf_from_psf_match_jax():
    src, opl, amp, _ = wavefront()
    gy, gx = np.meshgrid(np.linspace(-8e-3, 8e-3, 16),
                         np.linspace(-8e-3, 8e-3, 16), indexing="ij")
    grid = np.array([3.0, 0.0]) + np.stack([gx.ravel(), gy.ravel()], axis=1)
    psf = np.asarray(j_psf(src, opl, LAM, grid, amp, 1.5))
    radii = [1e-3, 3e-3, 6e-3]
    psf = psf.copy()
    close(t_an.encircled_energy(torch.as_tensor(psf), torch.as_tensor(grid),
                                (3.0, 0.0), radii),
          j_an.encircled_energy(psf, grid, (3.0, 0.0), radii), 1e-12)
    img = psf.reshape(16, 16)
    for data, spacing in ((img, (1e-3, 2e-3)), (img[0], 1e-3)):
        t_mtf, t_fr = t_an.mtf_from_psf(torch.as_tensor(data), spacing)
        j_mtf, j_fr = j_an.mtf_from_psf(jnp.asarray(data), spacing)
        close(t_mtf, j_mtf, 1e-12, 1e-15)
        for t, j in zip(t_fr, j_fr):
            close(t, j, 1e-12)


def psf_image():
    src, opl, amp, _ = wavefront()
    gy, gx = np.meshgrid(np.linspace(-8e-3, 8e-3, 15),
                         np.linspace(-8e-3, 8e-3, 16), indexing="ij")
    grid = np.array([3.0, 0.0]) + np.stack([gx.ravel(), gy.ravel()], axis=1)
    return np.array(j_psf(src, opl, LAM, grid, amp, 1.5)).reshape(15, 16)


@pytest.mark.parametrize("axis", [0, -1])
def test_mtf_at_in_band_matches_jax(axis):
    img = psf_image()
    spacing = (1.1e-3, 1.0e-3)
    n = img.shape[axis]
    nyquist = float(np.fft.rfftfreq(n, d=spacing[axis])[-1])
    freqs = np.array([0.0, 17.0, -42.5, 0.5 * nyquist, -nyquist, nyquist])
    close(t_an.mtf_at(torch.as_tensor(img), spacing, torch.as_tensor(freqs),
                      axis),
          j_an.mtf_at(jnp.asarray(img), spacing, jnp.asarray(freqs), axis),
          1e-12, 1e-15)


def test_mtf_at_raises_above_nyquist_where_the_reference_clamps():
    img = psf_image()
    spacing = 1.0e-3
    nyquist = float(np.fft.rfftfreq(16, d=spacing)[-1])   # 500 cycles/unit
    above = [100.0, 1.5 * nyquist]
    # the JAX package returns the edge value for the unresolvable one
    j_mtf_at = jax.jit(j_an.mtf_at, static_argnums=1)
    j_val = np.asarray(j_mtf_at(jnp.asarray(img), spacing, jnp.asarray(above)))
    j_edge = np.asarray(j_mtf_at(jnp.asarray(img), spacing,
                                 jnp.asarray([nyquist])))
    assert j_val[1] == j_edge[0]
    with pytest.raises(ValueError, match="Nyquist"):
        t_an.mtf_at(torch.as_tensor(img), spacing, torch.as_tensor(above))
    assert "analysis.py:657-681" in t_an.mtf_at.__doc__
    assert "clamps" in t_an.mtf_at.__doc__


PARALLEL_RANK = r"""
import json, sys
import numpy as np, torch
from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.parallel import sharding as par
config.set_default_device("cpu")
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
par.init_multihost("gloo", init_method=f"tcp://localhost:{port}",
                   world_size=2, rank=rank)
data = np.load(path)
half = data["src"].shape[0] // 2
part = slice(rank * half, (rank + 1) * half)
psf = par.parallel_psf(par.ray_mesh(), float(data["lam"]), medium_n=1.5)(
    torch.as_tensor(data["src"][part]), torch.as_tensor(data["opl"][part]),
    torch.as_tensor(data["amp"][part]), torch.as_tensor(data["grid"]))
print(json.dumps(psf.tolist()))
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def parallel_ranks(tmp_path_factory):
    """The two gloo ranks' processes, started with the module's first test
    so that they start while the other tests run."""
    from tensorflowraytrace_tpu_torch import streamed

    src, opl, amp, grid = wavefront()
    path = str(tmp_path_factory.mktemp("psf") / "wavefront.npz")
    np.savez(path, src=src, opl=opl, amp=amp, grid=grid, lam=LAM)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    port = str(streamed.free_port())
    procs = [subprocess.Popen([sys.executable, "-c", PARALLEL_RANK, str(r),
                               port, path], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    yield procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(autouse=True, scope="module")
def start_ranks_first(parallel_ranks):
    yield


def test_parallel_psf_on_two_gloo_ranks_matches_dense(parallel_ranks):
    outs = [p.communicate(timeout=120)[0] for p in parallel_ranks]
    assert all(p.returncode == 0 for p in parallel_ranks), outs
    psfs = [np.array(json.loads(o.strip().splitlines()[-1])) for o in outs]
    np.testing.assert_array_equal(psfs[0], psfs[1])
    src, opl, amp, grid = wavefront()
    dense = np.asarray(j_psf(src, opl, LAM, grid, amp, 1.5))
    np.testing.assert_allclose(psfs[0], dense, rtol=RTOL)
