"""The classical lens-design examples, on the analytic sequential tracer.

Counterparts of the JAX package's examples, without their drawing, each at
the example's defaults and in its dtype (float32, since the JAX examples
run float64 only under x64), on CUDA unless given ``device=``:

* ``cooke_triplet`` (examples/cooke_triplet.py): the six curvatures of a
  crown-flint-crown triplet designed by Adam under a cosine schedule,
  ``scenes2d.cosine_decay`` (optax's ``cosine_decay_schedule(lr, steps,
  alpha=3e-2)``), against the centroid-relative RMS spot of 3 Fraunhofer
  lines x 3 fields x 48 hex-pupil rays traced as one flat batch onto a
  fixed image plane.  Its check: ``rms1 < 0.5 rms0`` from 200 steps on.
* ``paraxial_analysis`` (examples/paraxial_analysis.py): the first-order
  report of the triplet's start, the back focal point against a real
  marginal ray, S4 against the Petzval sum, and a 6-step Newton solve of
  the last curvature for EFL 10 through ``torch.autograd.grad``.
* ``lens_report`` (examples/lens_report.py): its items 1-6 as data (the
  first-order numbers and pupils, the Seidel table, the field curves,
  axial and lateral colour, the RMS spots and the on-axis Huygens PSF on a
  ``grid_pts``^2 patch with its MTF up to 0.9 of the Nyquist).  Its check:
  ``|mtf[0] - 1| < 1e-9``.
* ``best_form_singlet``: the lens design of tests/test_lsq.py's
  ``TestLensDesign`` (an f/10 singlet's two curvatures, EFL 50 pinned by a
  weighted row, a 15-ray fan) through ``lsq.lm_solve`` in float64.  The
  solve stalls in the merit valley, in the JAX package and here alike (its
  fixed x10 / x0.2 damping): the result is returned, the thin-lens shape
  factor is not asserted.
* ``sequential_vs_mesh`` (examples/sequential_vs_mesh_bench.py): one
  asphere singlet (front cap c = 0.5, k = -0.3; plane back at z = 0.3;
  image at z = 2; glass 1.5) traced analytically by ``trace_sequential``
  and through the mesh engine on the same surfaces tessellated by
  ``ParametricAsphereBoundary`` at edge 0.02 (35,826 triangles with the
  2-triangle target, Morton-sorted), 3 bounces; on the card the example's
  configuration, ``cull="grid"`` with the re-sort (the two-level search
  K4).  ``check=True`` first runs the example's 512-ray agreement test.

    out = cooke_triplet(device="cpu")
"""

from __future__ import annotations

import functools
import statistics
import time

import numpy as np
import torch

from tensorflowraytrace_tpu_torch import analysis, lsq, scenes2d
from tensorflowraytrace_tpu_torch.config import FINISHED, resolve_device
from tensorflowraytrace_tpu_torch.drawing import figure, host_array
from tensorflowraytrace_tpu_torch.engine import TraceConfig, trace
from tensorflowraytrace_tpu_torch.models.acceleration import (
    morton_sort_triangles,
)
from tensorflowraytrace_tpu_torch.models.boundaries import (
    ParametricAsphereBoundary,
)
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import (
    Scene3D, TriangleSet, concat_triangles,
)
from tensorflowraytrace_tpu_torch.ops import materials as mats
from tensorflowraytrace_tpu_torch.paraxial import (
    axial_color, field_curves, lateral_color, paraxial_system,
    paraxial_trace, petzval_sum, seidel_sums, solve_stop,
)
from tensorflowraytrace_tpu_torch.sequential import (
    AsphereStack, collimated_bundle, trace_sequential,
)

MATERIALS = (mats.vacuum, mats.crown_glass, mats.flint_glass)

# the Cooke triplet: crown | air | flint | air | crown | air; the axial
# layout is fixed and the curvatures are the prescription
COOKE_VERTEX_Z = (0.0, 0.55, 1.45, 1.85, 2.75, 3.15)
COOKE_MAT_AFTER = (1, 0, 2, 0, 1, 0)
COOKE_IMAGE_Z = 11.5
COOKE_HALF_AP = 0.62                # entrance bundle half-aperture
COOKE_APERTURES = (1.0, 1.0, 0.75, 0.75, 1.0, 1.0)  # the flint is the stop
F_LINE, D_LINE, C_LINE = 486.1, 587.6, 656.3        # Fraunhofer lines, nm
WAVELENGTHS = (F_LINE, D_LINE, C_LINE)
FIELDS = (0.0, 0.03, 0.05)          # radians off axis
# a symmetric start: positive crowns bracketing a negative flint
P_INIT = (0.32, -0.04, -0.30, 0.30, 0.04, -0.32)
COOKE_ALPHA = 3e-2                  # the cosine schedule's final fraction

# examples/paraxial_analysis.py
TARGET_EFL = 10.0
EFL_NEWTON_STEPS = 6
SEIDEL_FIELD = 0.05

# examples/lens_report.py
STOP_INDEX = 2                      # the flint's front face is the stop
STOP_SEMI_AP = 0.45
MAX_FIELD = 0.05                    # radians
REPORT_Z_START = -1.0

# the best-form singlet of tests/test_lsq.py
SINGLET_WL = 587.6
SINGLET_EFL = 50.0
SINGLET_C0 = (0.02, -0.02)

# examples/sequential_vs_mesh_bench.py
SVM_C, SVM_K = 0.5, -0.3
SVM_Z_BACK = 0.3
SVM_Z_IMG = 2.0
SVM_EDGE = 0.02
SVM_BOUNCES = 3
SVM_WAVELENGTH = 550.0
SVM_HALF_AP = 0.6
SVM_CHECK_RAYS = 512
SVM_FINISHED_MIN = 0.9
SVM_MAX_DEV = 0.02
SVM_REPS = 5                        # timed traces after the warm-up
SVM_MATERIALS = (mats.vacuum, mats.build_constant_material(1.5))


def _host(t):
    return t.detach().cpu().numpy()


# ----------------------------------------------------------------------
# the Cooke triplet
# ----------------------------------------------------------------------

def cooke_stack(curvatures, dtype=torch.float32, device=None,
                apertures=COOKE_APERTURES):
    """The triplet at ``curvatures`` (six); ``apertures=None`` leaves the
    surfaces unvignetted (the report's and the first-order analysis's
    stack)."""
    return AsphereStack.make(vertex_z=COOKE_VERTEX_Z, c=curvatures,
                             aperture=apertures, mat_after=COOKE_MAT_AFTER,
                             dtype=dtype, device=device)


def cooke_bundles(n_rays, dtype=torch.float32, device=None):
    """Every line x field x pupil ray as one flat batch: ``(p, d,
    wavelength, n_bundles, n_rays)``, the bundles in line-major order."""
    device = resolve_device(device)
    ps, ds, wls = [], [], []
    for wl in WAVELENGTHS:
        for th in FIELDS:
            p, d = collimated_bundle(n_rays, COOKE_HALF_AP, z_start=-1.0,
                                     field_angle=th, grid="hex", dtype=dtype,
                                     device=device)
            ps.append(p)
            ds.append(d)
            wls.append(torch.full((n_rays,), wl, dtype=dtype, device=device))
    return (torch.cat(ps), torch.cat(ds), torch.cat(wls),
            len(WAVELENGTHS) * len(FIELDS), n_rays)


def cooke_loss(curvatures, bundles):
    """The mean centroid-relative squared landing radius per bundle (focus
    and distortion free, blur not), plus a vignetting penalty: ``(loss,
    (spot, alive))``."""
    p, d, wl, n_bundles, n_rays = bundles
    stack = cooke_stack(curvatures, p.dtype, p.device)
    res = trace_sequential(p, d, wl, stack, MATERIALS, image_z=COOKE_IMAGE_Z)
    land = res.landing.reshape(n_bundles, n_rays, 2)
    alive = res.alive.reshape(n_bundles, n_rays)
    w = alive.to(p.dtype)
    cnt = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)
    centroid = torch.sum(land * w[:, :, None], dim=1, keepdim=True) \
        / cnt[:, :, None]
    r2 = torch.sum((land - centroid) ** 2, dim=2)
    spot = torch.sum(torch.where(alive, r2, 0.0)) / torch.sum(cnt)
    lost = torch.mean(1.0 - w)
    return spot + 10.0 * lost * lost, (spot, alive)


def cooke_rms(curvatures, bundles):
    """Per-(line, field) centroid-relative RMS spot radii, keyed
    ``(wavelength, field)`` (read on the host)."""
    p, d, wl, n_bundles, n_rays = bundles
    with torch.no_grad():
        stack = cooke_stack(curvatures, p.dtype, p.device)
        res = trace_sequential(p, d, wl, stack, MATERIALS,
                               image_z=COOKE_IMAGE_Z)
    land = _host(res.landing).reshape(n_bundles, n_rays, 2)
    alive = _host(res.alive).reshape(n_bundles, n_rays)
    out, i = {}, 0
    for wlv in WAVELENGTHS:
        for th in FIELDS:
            pts = land[i][alive[i]]
            out[(wlv, th)] = float(np.sqrt(((pts - pts.mean(0)) ** 2)
                                           .sum(1).mean()))
            i += 1
    return out


def cooke_design(steps=2000, n_rays=48, lr=2e-3, dtype=torch.float32,
                 device=None):
    """The design's parts: ``(params, step, bundles)``, the trainable
    curvatures (at ``P_INIT``), one Adam step under the cosine schedule
    over ``steps`` (it returns the loss before the step, on the device) and
    the rays."""
    device = resolve_device(device)
    bundles = cooke_bundles(n_rays, dtype, device)
    params = torch.tensor(P_INIT, dtype=dtype, device=device,
                          requires_grad=True)
    adam, schedule = scenes2d.cosine_decay(lr, max(steps, 1),
                                           COOKE_ALPHA)([params])

    def step():
        adam.zero_grad(set_to_none=True)
        loss = cooke_loss(params, bundles)[0]
        loss.backward()
        adam.step()
        schedule.step()
        return loss.detach()

    return params, step, bundles


def cooke_triplet(steps=2000, n_rays=48, lr=2e-3, dtype=torch.float32,
                  device=None):
    """Design the triplet: ``steps`` Adam steps from ``P_INIT``.  Returns
    ``{"params", "rms0", "rms1", "start", "final", "losses", "seconds"}``
    (the mean RMS spot before and after, the per-(line, field) radii, the
    loss every ``steps // 8`` steps).  Raises when ``steps >= 200`` and the
    mean RMS spot did not halve (the example's check)."""
    params, step, bundles = cooke_design(steps, n_rays, lr, dtype, device)
    start = cooke_rms(params, bundles)
    rms0 = float(np.mean(list(start.values())))
    losses = {}
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step()
        if i % max(1, steps // 8) == 0:
            losses[i] = loss
    losses = {i: float(v) for i, v in losses.items()}
    seconds = time.perf_counter() - t0
    final = cooke_rms(params, bundles)
    rms1 = float(np.mean(list(final.values())))
    if steps >= 200 and not rms1 < 0.5 * rms0:
        raise RuntimeError(f"cooke triplet: the mean RMS spot went {rms0} -> "
                           f"{rms1}, not below half")
    return {"params": params.detach(), "rms0": rms0, "rms1": rms1,
            "start": start, "final": final, "losses": losses,
            "seconds": seconds}


# ----------------------------------------------------------------------
# the first-order analysis and the lens report
# ----------------------------------------------------------------------

def _tolerance(dtype):
    return 1e-9 if dtype == torch.float64 else 1e-4


def paraxial_analysis(dtype=torch.float32, device=None):
    """The first-order report of the triplet's start and the example's
    three checks (each raises when it fails): the back focal point within
    ``100 tol (1 + |bfp|)`` of where a real near-axis ray crosses the axis;
    S4 within ``tol (1e-3 + |H^2 P|)`` of the Lagrange invariant squared
    times the Petzval sum; the Newton EFL solve within ``tol * 10`` of 10
    (``tol`` 1e-9 in float64, 1e-4 in float32).  Returns a dict of the
    numbers as host arrays, ``seidel`` a dict of the Seidel sums and the
    per-surface table."""
    device = resolve_device(device)
    tol = _tolerance(dtype)
    stack = cooke_stack(P_INIT, dtype, device, apertures=None)
    ps = paraxial_system(stack, MATERIALS, D_LINE)
    out = {"efl": ps.efl, "bfp": ps.back_focal_point,
           "ffp": ps.front_focal_point,
           "front_principal": ps.front_principal_plane,
           "back_principal": ps.back_principal_plane,
           "petzval": petzval_sum(stack, MATERIALS, D_LINE),
           "axial_color": axial_color(stack, MATERIALS, WAVELENGTHS)}

    # the real-ray check: a near-axis ray crosses the axis at F'
    y0 = 1e-7 if dtype == torch.float64 else 1e-3
    p = torch.tensor([[0.0, y0, -1.0]], dtype=dtype, device=device)
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=dtype, device=device)
    res = trace_sequential(p, d, D_LINE, stack, MATERIALS)
    t = -res.p[0, 1] / res.d[0, 1]
    out["z_cross"] = res.p[0, 2] + t * res.d[0, 2]

    # the Seidel table: the marginal ray through the aperture edge, the
    # chief ray at the full field through the front vertex (the stop here)
    z_start, z_pupil = -1.0, COOKE_VERTEX_Z[0]
    seidel = seidel_sums(stack, MATERIALS, D_LINE,
                         marginal=(COOKE_HALF_AP, 0.0),
                         chief=(SEIDEL_FIELD * (z_start - z_pupil),
                                SEIDEL_FIELD),
                         z_start=z_start, chromatic=(F_LINE, C_LINE))
    out["seidel"] = {f: _host(getattr(seidel, f)) for f in (
        "S1", "S2", "S3", "S4", "S5", "C1", "C2", "H", "per_surface")}

    # the EFL solve on the last curvature: Newton on the system power
    base = torch.tensor(P_INIT, dtype=dtype, device=device)

    def power_err(c_last):
        c = torch.cat([base[:-1], c_last.reshape(1)])
        return (paraxial_system(cooke_stack(c, dtype, device, None),
                                MATERIALS, D_LINE).power - 1.0 / TARGET_EFL)

    c_last = base[-1]
    for _ in range(EFL_NEWTON_STEPS):
        c_var = c_last.detach().requires_grad_(True)
        f = power_err(c_var)
        (g,) = torch.autograd.grad(f, c_var)
        c_last = c_var.detach() - f.detach() / g
    out["c_last"] = c_last
    out["efl_solved"] = paraxial_system(
        cooke_stack(torch.cat([base[:-1], c_last.reshape(1)]), dtype, device,
                    None), MATERIALS, D_LINE).efl

    out = {k: (v if k == "seidel" else _host(v)) for k, v in out.items()}
    bfp, pz = float(out["bfp"]), float(out["petzval"])
    z_cross = float(out["z_cross"])
    if not abs(z_cross - bfp) < 100 * tol * (1 + abs(bfp)):
        raise RuntimeError(f"paraxial analysis: the real marginal ray crosses "
                           f"at {z_cross}, the back focal point is {bfp}")
    s4 = float(out["seidel"]["S4"])
    s4_ref = float(out["seidel"]["H"]) ** 2 * pz
    if not abs(s4 - s4_ref) < tol * (1e-3 + abs(s4_ref)):
        raise RuntimeError(f"paraxial analysis: S4 {s4} is not H^2 x the "
                           f"Petzval sum {s4_ref}")
    efl_solved = float(out["efl_solved"])
    if not abs(efl_solved - TARGET_EFL) < tol * TARGET_EFL:
        raise RuntimeError(f"paraxial analysis: the EFL solve reached "
                           f"{efl_solved}, not {TARGET_EFL}")
    return out


def _spot(stack, z_image, n_rays, dtype, device, field, wl=D_LINE):
    """The RMS spot radius of a hex bundle at ``field`` on the plane
    ``z_image``, and its landed points (host)."""
    p, d = collimated_bundle(n_rays, STOP_SEMI_AP, z_start=REPORT_Z_START,
                             field_angle=field, grid="hex", dtype=dtype,
                             device=device)
    res = trace_sequential(p, d, wl, stack, MATERIALS, image_z=z_image)
    pts = _host(res.landing)[_host(res.alive)]
    return float(np.sqrt(((pts - pts.mean(0)) ** 2).sum(1).mean())), pts


def onaxis_psf_mtf(stack, z_image, psf_rays, grid_pts, f_no, dtype,
                   device):
    """The on-axis Huygens PSF on a square patch of the image plane (the
    geometric spot plus a few diffraction lobes) and its MTF out to just
    past the diffraction cutoff ``1 / (lambda f_no)``, at most 0.9 of the
    Nyquist: ``(psf2d, axis, freqs, mtf)``, the last three on the host."""
    p, d = collimated_bundle(psf_rays, STOP_SEMI_AP, z_start=REPORT_Z_START,
                             grid="hex", dtype=dtype, device=device)
    res = trace_sequential(p, d, D_LINE, stack, MATERIALS)  # at the last surface
    lam = D_LINE * 1e-6                     # mm
    rms, _ = _spot(stack, z_image, min(psf_rays, 512), dtype, device, 0.0)
    half = float(max(4.0 * rms, 30.0 * lam))
    ax = np.linspace(-half, half, grid_pts)
    gx, gy = np.meshgrid(ax, ax)
    grid = torch.as_tensor(
        np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z_image)], 1),
        dtype=dtype, device=device)
    amp = torch.where(res.alive, 1.0, 0.0).to(dtype)
    psf = analysis.huygens_psf(res.p, res.opl, lam, grid, amplitudes=amp,
                               ray_chunk=1024)
    psf2d = psf.reshape(grid_pts, grid_pts)
    dx = float(ax[1] - ax[0])
    nyq = 1.0 / (2.0 * dx)
    f_max = min(0.9 * nyq, 1.15 / (lam * f_no))
    freqs = np.linspace(0.0, f_max, 32)
    mtf = analysis.mtf_at(psf2d, dx, torch.as_tensor(freqs, dtype=dtype,
                                                     device=device))
    return psf2d, ax, freqs, _host(mtf)


def lens_report(n_rays=2000, psf_rays=2048, grid_pts=101, n_fields=5,
                dtype=torch.float32, device=None, png=None):
    """The report of the triplet's start, items 1-6 of the example as a
    dict: ``efl``, ``bfp``, ``f_no``, ``entrance_pupil``, ``exit_pupil``,
    ``seidel`` (a ``SeidelSums``), ``field_curves`` (a ``FieldCurves``),
    ``axial_color``, ``lateral_color`` (F, d, C), ``spots`` (RMS radius by
    field), ``mtf`` (frequencies, values) and ``psf``.  Raises when
    ``|mtf[0] - 1| >= 1e-9`` (the example's check).  ``png``: a path to
    write the example's figure to (field curves, distortion, spot diagrams,
    the MTF)."""
    device = resolve_device(device)
    stack = cooke_stack(P_INIT, dtype, device, apertures=None)

    # 1. first order
    sys_d = paraxial_system(stack, MATERIALS, D_LINE)
    sol = solve_stop(stack, MATERIALS, D_LINE, stop_index=STOP_INDEX,
                     aperture=STOP_SEMI_AP, field_angle=MAX_FIELD,
                     z_start=REPORT_Z_START)
    efl = float(sys_d.efl)
    bfp = float(sys_d.back_focal_point)
    # the working f/# at the infinite conjugate: 1 / (2 n' u'_marginal)
    _, us_m = paraxial_trace(sol.marginal[0], sol.marginal[1], stack,
                             MATERIALS, D_LINE, z_start=REPORT_Z_START)
    f_no = abs(1.0 / (2.0 * float(us_m[-1])))

    # 2. the Seidel table
    seidel = seidel_sums(stack, MATERIALS, D_LINE, sol.marginal, sol.chief,
                         z_start=REPORT_Z_START, chromatic=(F_LINE, C_LINE))

    # 3. the field curves
    fields = torch.as_tensor(np.linspace(0.0, MAX_FIELD, n_fields),
                             dtype=dtype, device=device)
    fc = field_curves(stack, MATERIALS, D_LINE, stop_index=STOP_INDEX,
                      aperture=STOP_SEMI_AP, field_angles=fields,
                      z_start=REPORT_Z_START, rho=0.1)

    # 4. colour
    ax_col = _host(axial_color(stack, MATERIALS, WAVELENGTHS))
    lat_col = _host(lateral_color(stack, MATERIALS, WAVELENGTHS, sol.chief,
                                  REPORT_Z_START, bfp))

    # 5. the real-ray spots
    spot_points = {float(th): _spot(stack, bfp, n_rays, dtype, device,
                                    float(th)) for th in _host(fields)}
    spots = {th: rms for th, (rms, _) in spot_points.items()}

    # 6. the PSF and the MTF
    psf2d, psf_ax, freqs, mtf = onaxis_psf_mtf(stack, bfp, psf_rays,
                                               grid_pts, f_no, dtype, device)
    if not abs(float(mtf[0]) - 1.0) < 1e-9:
        raise RuntimeError(f"lens report: the MTF at 0 is {mtf[0]}, not 1")
    if png is not None:
        _report_figure(png, fc, _host(fields), bfp, spot_points, freqs, mtf)
    return {"efl": efl, "bfp": bfp, "f_no": f_no,
            "entrance_pupil": float(sol.entrance_pupil),
            "exit_pupil": float(sol.exit_pupil), "seidel": seidel,
            "field_curves": fc, "axial_color": ax_col,
            "lateral_color": lat_col, "spots": spots, "mtf": (freqs, mtf),
            "psf": (psf2d, psf_ax)}


def _report_figure(path, fc, fields, bfp, spot_points, freqs, mtf):
    """The lens report's figure, as the example draws it, into ``path``."""
    fig = figure(figsize=(10, 8))
    axes = fig.subplots(2, 2)
    a = axes[0, 0]
    a.plot(1e3 * (host_array(fc.tangential) - bfp), fields, "-o",
           label="tangential")
    a.plot(1e3 * (host_array(fc.sagittal) - bfp), fields, "-s",
           label="sagittal")
    a.set_xlabel("focus shift (um)")
    a.set_ylabel("field (rad)")
    a.set_title("astigmatic field curves")
    a.legend()
    a = axes[0, 1]
    a.plot(100 * host_array(fc.distortion), fields, "-o")
    a.set_xlabel("distortion (%)")
    a.set_title("distortion")
    a = axes[1, 0]
    for th, (_, pts) in spot_points.items():
        c = pts.mean(0)
        a.plot(1e3 * (pts[:, 0] - c[0]), 1e3 * (pts[:, 1] - c[1]), ".", ms=1,
               label=f"{th:.3f} rad")
    a.set_xlabel("um")
    a.set_aspect("equal")
    a.set_title("spot diagrams (centroid-relative)")
    a.legend(markerscale=8, fontsize=7)
    a = axes[1, 1]
    a.plot(host_array(freqs), host_array(mtf), "-")
    a.set_xlabel("spatial frequency (cycles/mm)")
    a.set_ylabel("MTF")
    a.set_ylim(0, 1.02)
    a.set_title("on-axis MTF (d line)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)


# ----------------------------------------------------------------------
# the best-form singlet (damped least squares)
# ----------------------------------------------------------------------

def singlet_stack(c):
    """tests/test_lsq.py's f/10 singlet: curvatures ``c`` (two), 3 mm of
    crown glass, semi-apertures 8, in ``c``'s dtype and on its device."""
    return AsphereStack.make(vertex_z=(0.0, 3.0), c=c, aperture=(8.0, 8.0),
                             mat_after=(1, 0), dtype=c.dtype,
                             device=c.device)


def singlet_residual(c):
    """The merit vector: the transverse errors of a 15-ray fan at the
    paraxial focus (mm) and the EFL error weighted 100."""
    materials = (mats.vacuum, mats.crown_glass)
    stack = singlet_stack(c)
    ps = paraxial_system(stack, materials, SINGLET_WL)
    p, d = collimated_bundle(15, 2.5, z_start=-5.0, dtype=c.dtype,
                             device=c.device)
    r = trace_sequential(p, d, SINGLET_WL, stack, materials,
                         image_z=ps.back_focal_point)
    return torch.cat([r.p[:, 1] * r.alive.to(c.dtype),
                      torch.atleast_1d(100.0 * (ps.efl - SINGLET_EFL))])


def best_form_singlet(steps=25, dtype=torch.float64, device=None):
    """``lsq.lm_solve`` of the singlet from the equiconvex start.  Returns
    ``{"result" (an LMResult), "cost0", "efl", "q"}``: ``q = (c1 + c2) /
    (c1 - c2)``, the shape factor (the thin-lens third-order optimum is
    ``2 (n^2 - 1) / (n + 2)``, which the stalled solve does not reach)."""
    device = resolve_device(device)
    c0 = torch.tensor(SINGLET_C0, dtype=dtype, device=device)
    r0 = singlet_residual(c0)
    res = lsq.lm_solve(singlet_residual, c0, steps=steps)
    c1, c2 = (float(v) for v in res.params)
    efl = float(paraxial_system(singlet_stack(res.params),
                                (mats.vacuum, mats.crown_glass),
                                SINGLET_WL).efl)
    return {"result": res, "cost0": float(0.5 * torch.dot(r0, r0)),
            "efl": efl, "q": (c1 + c2) / (c1 - c2)}


# ----------------------------------------------------------------------
# sequential against mesh
# ----------------------------------------------------------------------

def svm_stack(dtype=torch.float32, device=None):
    """The singlet as a 2-surface stack."""
    return AsphereStack.make(vertex_z=(0.0, SVM_Z_BACK), c=(SVM_C, 0.0),
                             k=(SVM_K, 0.0), mat_after=(1, 0), dtype=dtype,
                             device=device)


def svm_bundle(n, dtype=torch.float32, device=None):
    """``n`` collimated hex-pupil rays of half-aperture 0.6 from z = -1."""
    return collimated_bundle(n, SVM_HALF_AP, z_start=-1.0, grid="hex",
                             dtype=dtype, device=device)


def svm_mesh_scene(edge=SVM_EDGE, dtype=torch.float32, device=None):
    """The same singlet tessellated: both surfaces as
    ``ParametricAsphereBoundary`` meshes at ``edge``, merged and
    Morton-sorted, before a 10 x 10 target at the image plane."""
    device = resolve_device(device)
    front = ParametricAsphereBoundary(
        (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), aperture_radius=1.0,
        target_edge_size=edge, mat_in=0, mat_out=1, dtype=dtype,
        device=device)
    back = ParametricAsphereBoundary(
        (0.0, 0.0, SVM_Z_BACK), (0.0, 0.0, 1.0), aperture_radius=1.0,
        target_edge_size=edge, mat_in=1, mat_out=0, dtype=dtype,
        device=device)
    with torch.no_grad():
        s_front = front.build(torch.tensor([SVM_C, SVM_K], dtype=dtype,
                                           device=device))
        s_back = back.build(torch.zeros(2, dtype=dtype, device=device))
        merged, _ = morton_sort_triangles(concat_triangles([s_front,
                                                            s_back]))
    half = 5.0
    target = TriangleSet.make(
        [[-half, -half, SVM_Z_IMG], [half, half, SVM_Z_IMG]],
        [[half, -half, SVM_Z_IMG], [-half, half, SVM_Z_IMG]],
        [[half, half, SVM_Z_IMG], [-half, -half, SVM_Z_IMG]], dtype=dtype,
        device=device)
    return Scene3D.build(optical=[merged], targets=[target])


def svm_config(device):
    """The example's mesh trace configuration: on the card the CUDA
    searches with ``cull="grid"`` and the re-sort (K4), elsewhere the
    plain brute search; 3 bounces."""
    on_card = torch.device(device).type == "cuda"
    return TraceConfig(max_bounces=SVM_BOUNCES, use_kernel=on_card,
                       cull="grid" if on_card else False,
                       resort_rays=on_card)


def svm_rays(p, d, dtype):
    return RaySet.make(p, p + d, SVM_WAVELENGTH, dtype=dtype,
                       device=p.device)


def svm_check(scene=None, cfg=None, dtype=torch.float32, device=None):
    """The example's agreement test: 512 rays traced analytically and
    through the mesh scene (``svm_mesh_scene()`` and ``svm_config`` unless
    given); more than 90% must finish and every finished ray must land
    within 0.02 (the tessellation floor) of its analytic landing, or it
    raises.  Returns ``{"finished", "max_dev"}``."""
    device = resolve_device(device)
    scene = svm_mesh_scene(dtype=dtype, device=device) if scene is None \
        else scene
    cfg = svm_config(device) if cfg is None else cfg
    p, d = svm_bundle(SVM_CHECK_RAYS, dtype, device)
    with torch.no_grad():
        exact = trace_sequential(p, d, SVM_WAVELENGTH, svm_stack(dtype, device),
                                 SVM_MATERIALS, image_z=SVM_Z_IMG).p[:, :2]
        mres = trace(svm_rays(p, d, dtype), scene, SVM_MATERIALS, cfg)
    fin = mres.rays.state == FINISHED
    finished = float(fin.to(torch.float64).mean())
    if not finished > SVM_FINISHED_MIN:
        raise RuntimeError(f"sequential vs mesh: {finished} of the rays "
                           f"finished, not more than {SVM_FINISHED_MIN}")
    dev = torch.abs(mres.rays.p1[:, :2] - exact)[fin]
    max_dev = float(dev.max())
    if not max_dev < SVM_MAX_DEV:
        raise RuntimeError(f"sequential vs mesh: a landing is {max_dev} from "
                           f"the analytic one, not below {SVM_MAX_DEV}")
    return {"finished": finished, "max_dev": max_dev}


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_seconds(fn, device):
    """The median wall time of ``SVM_REPS`` synchronised calls of ``fn``
    after one more."""
    fn()
    times = []
    for _ in range(SVM_REPS):
        _synchronize(device)
        t0 = time.perf_counter()
        fn()
        _synchronize(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def svm_traces(n_rays, scene, configs, dtype=torch.float32, device=None):
    """The traces that :func:`sequential_vs_mesh` times, as callables:
    ``"analytic"``, ``trace_sequential`` of ``n_rays`` hex-pupil rays on
    the 2-surface stack, and for each ``label: TraceConfig`` of ``configs``
    the same rays through ``scene`` under that configuration."""
    device = resolve_device(device)
    p, d = svm_bundle(n_rays, dtype, device)
    stack = svm_stack(dtype, device)
    rays = svm_rays(p, d, dtype)
    runs = {"analytic": lambda: trace_sequential(
        p, d, SVM_WAVELENGTH, stack, SVM_MATERIALS, image_z=SVM_Z_IMG)}
    for label, cfg in configs.items():
        runs[label] = functools.partial(trace, rays, scene, SVM_MATERIALS,
                                        cfg)
    return runs


def sequential_vs_mesh(n_rays=1 << 20, edge=SVM_EDGE, check=False,
                       configs=None, dtype=torch.float32, device=None):
    """Trace ``n_rays`` through the singlet analytically (2 surfaces and
    the image transfer) and through its mesh under each ``label:
    TraceConfig`` of ``configs`` (``{"mesh": svm_config(device)}`` unless
    given), each timed as the median of ``SVM_REPS`` synchronised traces
    after a warm-up.  ``check=True`` first runs :func:`svm_check` under each
    configuration.  Returns ``{"seconds": {label: s}, "n_triangles",
    "check": {label: svm_check's dict} or None}``, ``"analytic"`` among
    the labels of ``seconds``."""
    device = resolve_device(device)
    scene = svm_mesh_scene(edge, dtype, device)
    configs = {"mesh": svm_config(device)} if configs is None else configs
    out = {"check": {label: svm_check(scene, cfg, dtype=dtype, device=device)
                     for label, cfg in configs.items()} if check else None,
           "n_triangles": scene.triangles.n_surfaces}
    with torch.no_grad():
        out["seconds"] = {
            label: _median_seconds(fn, device) for label, fn in
            svm_traces(n_rays, scene, configs, dtype, device).items()}
    return out
