"""The 2D reaction examples: ``examples/fresnel_intensity.py``,
``spectrometer.py``, ``fresnel_rhomb.py``, ``ar_coating.py``,
``wavefront_lens.py``, ``achromat.py`` and ``hybrid_achromat.py``.

Each function is the example's ``main`` at its defaults: it raises where
one of the example's checks fails (naming every failed check) and returns
the numbers the example prints.  On the card every trace runs the CUDA
searches (K5 for segments, K6 for arcs) and every backward the CUDA
segment sum (K2), children starting ``engine.start_epsilon`` of the start
scene past their surface; elsewhere the plain searches.  Both devices
run either dtype: K5, K6 and K2 have float32 and float64 instances.
``optax.adam`` becomes ``torch.optim.Adam`` through
``Optimizer(optax_tx=...)`` (:func:`adam_design`).  Every check keeps the example's own limit, in
float32 too: the card met each of them (PERF.md, PR 18).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from tensorflowraytrace_tpu_torch.analysis import histogram2d, zernike_fit
from tensorflowraytrace_tpu_torch.config import FINISHED, resolve_device
from tensorflowraytrace_tpu_torch.engine import TraceConfig, start_epsilon, trace
from tensorflowraytrace_tpu_torch.models import distributions as dist
from tensorflowraytrace_tpu_torch.models import sources as src
from tensorflowraytrace_tpu_torch.models.rays import RaySet
from tensorflowraytrace_tpu_torch.models.surfaces import ArcSet, Scene2D, SegmentSet
from tensorflowraytrace_tpu_torch.operations import (
    fresnel_intensity_reaction, grating_reaction, jones_polarization_reaction,
    metasurface_reaction, optical_path_reaction, seed_optical_path,
    seed_polarization, stokes_parameters, thin_film_intensity_reaction,
)
from tensorflowraytrace_tpu_torch.ops import materials as mats
from tensorflowraytrace_tpu_torch.ops import thinfilm
from tensorflowraytrace_tpu_torch.optim import Optimizer
from tensorflowraytrace_tpu_torch.scenes2d import (
    _on_card, masked, strehl_hyperbola_x,
)

PI = math.pi

def _checks(label, checks):
    """Raise naming every failed one of ``checks`` ((description, ok)
    pairs)."""
    failed = [what for what, ok in checks if not ok]
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))


def _config(scene, bounces, device):
    """The examples' ``TraceConfig(max_bounces=bounces)`` where the port
    runs: the kernels exactly on the card, children starting
    ``start_epsilon(scene)`` past their surface."""
    return TraceConfig(max_bounces=bounces, use_kernel=_on_card(device),
                       ray_start_epsilon=start_epsilon(scene))


def _scalar(v, dtype, device):
    return torch.as_tensor(v, dtype=dtype, device=device)


def _host(t):
    return t.detach().cpu().numpy()


def _collimated(ys, x, wavelength, dtype, device):
    """Rays from (x, y) for each of ``ys`` (a tensor) heading +x."""
    p0 = torch.stack([torch.full_like(ys, x), ys], dim=1)
    return RaySet.make(p0, p0 + torch.tensor([1.0, 0.0], dtype=dtype,
                                             device=device),
                       wavelength, dtype=dtype, device=device)


def adam_design(loss, q0, lr, mask=None):
    """``optax.adam(lr)`` on one parameter vector ``q0`` of ``loss(q)``,
    through ``Optimizer(optax_tx=...)`` (no clip, as in the examples); the
    entries ``mask`` (0 or 1) leaves out get no gradient.  The pairing was
    held against optax within rtol 1e-9 (tests/test_torch_designs.py).
    ``opt.run_phase(n)`` returns the losses, ``opt.parameters[0]`` is
    ``q``."""
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=q0.dtype, device=q0.device)
    return Optimizer(
        lambda params: loss(params[0] if mask is None
                            else masked(params[0], mask)),
        [q0], learning_rate=1.0, grad_clip=math.inf, pass_key=False,
        optax_tx=lambda ps: torch.optim.Adam(ps, lr=lr))


# ----------------------------------------------------------------------
# examples/fresnel_intensity.py
# ----------------------------------------------------------------------

FRESNEL_GLASS = 1.52
FRESNEL_RADIUS = 8.0


def fresnel_scene(radius, dtype, device):
    """A flat entry face and a convex exit arc of ``radius`` (plano-convex,
    n = 1.52) and a screen at x = 14."""
    entry = SegmentSet.make([[0.0, -3.0]], [[0.0, 3.0]], mat_in=1, mat_out=0,
                            dtype=dtype, device=device)
    exit_arc = ArcSet.make(
        torch.stack([torch.stack([1.0 - radius, torch.zeros_like(radius)])]),
        -PI / 3, PI / 3, radius, mat_in=0, mat_out=1, dtype=dtype,
        device=device)
    screen = SegmentSet.make([[14.0, -30.0]], [[14.0, 30.0]], dtype=dtype,
                             device=device)
    return Scene2D.build(optical_segments=[entry], optical_arcs=[exit_arc],
                         target_segments=[screen])


def fresnel_intensity(rays=2000, dtype=torch.float32, device=None,
                      verbose=True):
    """``examples/fresnel_intensity.py``: a fan of ``rays`` from (-2, 0)
    over +-0.5 rad through the plano-convex lens with
    ``fresnel_intensity_reaction`` (3 bounces); the power delivered, the
    screen's count and power profiles (48 bins), the gradient of the
    delivered power in the exit radius, and the example's checks: the
    power under the two-interface normal-incidence bound and above half
    the landed share, the edge bins' power/count ratios at most the
    centre's, the gradient finite.  Returns a dict of these."""
    device = resolve_device(device)
    materials = (mats.vacuum, mats.build_constant_material(FRESNEL_GLASS))
    reaction = fresnel_intensity_reaction()
    angles = np.linspace(-0.5, 0.5, rays)
    p0 = np.full((rays, 2), [-2.0, 0.0])
    p1 = p0 + np.stack([np.cos(angles), np.sin(angles)], axis=1)
    ray_set = RaySet.make(p0, p1, 550.0, fields={
        "intensity": torch.ones(rays, dtype=dtype, device=device)},
        dtype=dtype, device=device)
    radius0 = _scalar(FRESNEL_RADIUS, dtype, device)
    cfg = _config(fresnel_scene(radius0, dtype, device), 3, device)

    with torch.no_grad():
        res = trace(ray_set, fresnel_scene(radius0, dtype, device), materials,
                    cfg, reaction=reaction)
    fin = _host(res.rays.state == FINISHED)
    inten = _host(res.rays.fields["intensity"])
    power = float(inten[fin].sum()) / rays
    landed = fin.sum() / rays
    t0 = 1.0 - ((1.0 - FRESNEL_GLASS) / (1.0 + FRESNEL_GLASS)) ** 2
    rng = ((13.9, 14.1), (-12.0, 12.0))
    fin_t = (res.rays.state == FINISHED).to(dtype)
    x, y = res.rays.p1[:, 0], res.rays.p1[:, 1]
    counts = _host(histogram2d(x, y, rng, 1, 48, dtype=dtype,
                               weights=fin_t))[:, 0]
    powers = _host(histogram2d(x, y, rng, 1, 48, dtype=dtype,
                               weights=fin_t * res.rays.fields["intensity"]))[:, 0]
    occupied = counts > 0
    ratio = powers[occupied] / counts[occupied]
    mid = len(ratio) // 2

    def delivered(radius):
        r = trace(ray_set, fresnel_scene(radius, dtype, device), materials,
                  cfg, reaction=reaction)
        ok = r.rays.state == FINISHED
        return torch.sum(torch.where(ok, r.rays.fields["intensity"], 0.0))

    radius = radius0.clone().requires_grad_(True)
    g = float(torch.autograd.grad(delivered(radius), radius)[0])
    out = {"power": power, "finished": int(fin.sum()), "counts": counts,
           "powers": powers, "ratio": ratio, "grad": g}
    if verbose:
        print(f"{out['finished']}/{rays} rays reach the screen carrying "
              f"{power:.4f} of the emitted power; power/count centre "
              f"{ratio[mid]:.4f}, edges {ratio[0]:.4f} / {ratio[-1]:.4f}; "
              f"d(delivered)/d(radius) = {g:.6f}")
    _checks("fresnel_intensity", [
        (f"power {power} above the normal-incidence bound "
         f"{t0 * t0 * landed}", power <= t0 * t0 * landed + 1e-9),
        (f"power {power} not above half the landed share {landed}",
         power > 0.5 * landed),
        (f"edge ratio {ratio[0]} above the centre's {ratio[mid]}",
         ratio[0] <= ratio[mid] + 1e-9),
        (f"edge ratio {ratio[-1]} above the centre's {ratio[mid]}",
         ratio[-1] <= ratio[mid] + 1e-9),
        (f"gradient {g} not finite", np.isfinite(g))])
    return out


# ----------------------------------------------------------------------
# examples/spectrometer.py
# ----------------------------------------------------------------------

SPECTRO_LAMBDAS = (450.0, 650.0)
SPECTRO_ANCHORS = (-0.9, -2.1)   # the prescribed detector heights
SPECTRO_START = (1.5, 2.5)       # groove spacing in um, detector distance
SPECTRO_BLAZE = 550.0


def spectrometer_problem(dtype=torch.float32, device=None):
    """``examples/spectrometer.py``'s layout: a transmission grating at
    x = 1 and a detector ``dist`` beyond it, traced in vacuum (2 bounces)
    by rays from the origin heading +x.  Returns ``landings(params, lams,
    efficiency=None)`` -> (detector heights, states, rays), ``params`` =
    (spacing in nm, dist); with ``efficiency`` the grating's order-1
    efficiency curve rides on ``fresnel_intensity_reaction``."""
    device = resolve_device(device)
    grating = SegmentSet.make([[1.0, -50.0]], [[1.0, 50.0]], mat_in=0,
                              mat_out=0, dtype=dtype, device=device)
    ids = {"segments": torch.tensor([0, -1], device=device)}
    one = torch.ones((), dtype=dtype, device=device)

    def scene(dist_):
        x = 1.0 + dist_
        det = SegmentSet.make(torch.stack([torch.stack([x, -80.0 * one])]),
                              torch.stack([torch.stack([x, 80.0 * one])]),
                              dtype=dtype, device=device)
        return Scene2D.build(optical_segments=[grating],
                             target_segments=[det])

    cfg = _config(scene(_scalar(SPECTRO_START[1], dtype, device)), 2, device)

    def landings(params, lams, efficiency=None):
        spacing, dist_ = params[0], params[1]
        rx = grating_reaction(
            [(spacing, 1, "transmission")], ids,
            efficiencies=None if efficiency is None else [efficiency])
        n = lams.shape[0]
        p1 = torch.zeros((n, 2), dtype=dtype, device=device)
        p1[:, 0] = 1.0
        rays = RaySet.make(torch.zeros((n, 2), dtype=dtype, device=device),
                           p1, lams, dtype=dtype, device=device)
        if efficiency is not None:
            rx = fresnel_intensity_reaction(base_reaction=rx)
            rays = rays.with_field("intensity",
                                   torch.ones(n, dtype=dtype, device=device))
        res = trace(rays, scene(dist_), (mats.vacuum,), cfg, reaction=rx)
        return res.rays.p1[:, 1], res.rays.state, res.rays

    landings.cfg = cfg
    return landings


def spectrometer_denorm(q):
    """The example's normalised coordinates: spacing in um, distance as
    is."""
    return torch.stack([1000.0 * q[0], q[1]])


def spectrometer_design(landings, dtype, device):
    """The anchor loss of the normalised coordinates and its Adam (lr
    0.1) from the example's start: ``(loss, optimizer)``."""
    anchors = torch.tensor(SPECTRO_LAMBDAS, dtype=dtype, device=device)
    targets = torch.tensor(SPECTRO_ANCHORS, dtype=dtype, device=device)

    def loss(q):
        y, _, _ = landings(spectrometer_denorm(q), anchors)
        return torch.sum((y - targets) ** 2)

    return loss, adam_design(loss, torch.tensor(SPECTRO_START, dtype=dtype,
                                                device=device), 0.1)


def spectrometer(steps=400, dtype=torch.float32, device=None, verbose=True):
    """``examples/spectrometer.py``: the groove spacing and the detector
    distance designed by Adam so that 450 and 650 nm land at -0.9 and
    -2.1, then the band of 21 wavelengths against the grating equation and
    the blaze curve's throughput, with the example's checks: the anchor
    loss below 1e-8, every band ray landing, the landings and the
    throughput within rtol 1e-6 of the analytic ones.  Returns a dict."""
    device = resolve_device(device)
    landings = spectrometer_problem(dtype, device)
    loss, opt = spectrometer_design(landings, dtype, device)
    losses = opt.run_phase(steps)
    q = opt.parameters[0]
    params = spectrometer_denorm(q)
    with torch.no_grad():
        v = float(loss(q))
        lams = dist._linspace(SPECTRO_LAMBDAS[0], SPECTRO_LAMBDAS[1], 21,
                              dtype, device)
        y, state, _ = landings(params, lams)

        def eta(order, wavelength, cos_i):
            return 0.82 * torch.exp(
                -((wavelength - SPECTRO_BLAZE * order) / 180.0) ** 2)

        _, _, thru_rays = landings(params, lams, efficiency=eta)
    y, lams_h = _host(y), _host(lams)
    spacing, dist_ = (float(p) for p in params)
    s = lams_h / spacing
    y_exact = -dist_ * s / np.sqrt(1 - s * s)
    band_err = float(np.max(np.abs(y - y_exact) / np.abs(y_exact)))
    thru = _host(thru_rays.fields["intensity"])
    expect = 0.82 * np.exp(-((lams_h - SPECTRO_BLAZE) / 180.0) ** 2)
    thru_err = float(np.max(np.abs(thru - expect) / np.abs(expect)))
    nonlin = float(np.max(np.abs(y - np.linspace(y[0], y[-1], 21))))
    out = {"losses": losses, "spacing": spacing, "dist": dist_,
           "anchor_loss": v, "band": y, "band_rel_err": band_err,
           "nonlinearity": nonlin, "throughput": thru,
           "throughput_rel_err": thru_err}
    if verbose:
        print(f"designed: spacing {spacing:.2f} nm, detector at {dist_:.4f} "
              f"(anchor loss {v:.2e}); band: max relative error "
              f"{band_err:.3e}, deviation from linear {nonlin:.4f}; "
              f"throughput {thru.min():.3f} .. {thru.max():.3f} (relative "
              f"error {thru_err:.3e})")
    _checks("spectrometer", [
        (f"anchor loss {v} not below 1e-8", v < 1e-8),
        ("a band ray did not land",
         bool(np.all(_host(state) == FINISHED))),
        (f"band landings off the grating equation by {band_err} (rtol "
         f"1e-6)", band_err <= 1e-6),
        (f"throughput off the blaze curve by {thru_err} (rtol 1e-6)",
         thru_err <= 1e-6)])
    return out


# ----------------------------------------------------------------------
# examples/fresnel_rhomb.py
# ----------------------------------------------------------------------

RHOMB_GLASS = 1.5


def tir_phase(theta):
    """The analytic relative TIR phase delta_s - delta_p at internal
    incidence ``theta`` (n = 1.5 against vacuum)."""
    b = np.sqrt(RHOMB_GLASS ** 2 * np.sin(theta) ** 2 - 1.0)
    ds = -2.0 * np.arctan2(b, RHOMB_GLASS * np.cos(theta))
    dp = -2.0 * np.arctan2(RHOMB_GLASS * b, np.cos(theta))
    return ds - dp


def rhomb_problem(dtype=torch.float32, device=None, theta0=0.80):
    """``examples/fresnel_rhomb.py``'s channel: glass between y = -1 and
    y = +1, one short wall patch a bounce at the two TIR points of a ray
    from the origin climbing at pi/2 - theta, traced with
    ``jones_polarization_reaction`` from 45-degree linear light (2
    bounces).  Returns ``stokes(theta)``, the emerging Stokes parameters;
    the geometry is a function of ``theta``, so gradients flow through the
    launch direction and the walls."""
    device = resolve_device(device)
    materials = (mats.vacuum, mats.build_constant_material(RHOMB_GLASS))
    reaction = jones_polarization_reaction()
    one = torch.ones((), dtype=dtype, device=device)

    def scene(theta):
        t = torch.tan(PI / 2 - theta)
        x1 = 1.0 / t
        x2 = x1 + 2.0 / t

        def seg(xc, y, mat_in, mat_out):
            return SegmentSet.make(
                torch.stack([torch.stack([xc - 0.5, y * one])]),
                torch.stack([torch.stack([xc + 0.5, y * one])]),
                mat_in=mat_in, mat_out=mat_out, dtype=dtype, device=device)

        # both wall normals point +y: the top wall's glass side is mat_in,
        # the bottom wall's mat_out
        return Scene2D.build(optical_segments=[
            seg(x1, 1.0, mat_in=1, mat_out=0),
            seg(x2, -1.0, mat_in=0, mat_out=1)])

    cfg = _config(scene(_scalar(theta0, dtype, device)), 2, device)

    def stokes(theta):
        climb = PI / 2 - theta
        d = torch.stack([torch.cos(climb), torch.sin(climb)])[None, :]
        rays = RaySet.make(torch.zeros((1, 2), dtype=dtype, device=device), d,
                           550.0, dtype=dtype, device=device)
        rays = seed_polarization(rays, jones=(1 / math.sqrt(2),
                                              1 / math.sqrt(2)))
        res = trace(rays, scene(theta), materials, cfg, reaction=reaction)
        return stokes_parameters(res.rays)

    stokes.cfg = cfg
    return stokes


def rhomb_loss(stokes, theta):
    """Circular light has no linear part: (S2 / S0)^2 (S1 is 0 by
    construction)."""
    s = stokes(theta)
    return (s["S2"][0] / s["S0"][0]) ** 2


def fresnel_rhomb(steps=150, lr=0.03, theta0=0.80, dtype=torch.float32,
                  device=None, verbose=True):
    """``examples/fresnel_rhomb.py``: ``steps`` of plain gradient descent
    (lr 0.03) on the internal angle, then the example's checks: the
    per-bounce TIR phase within 2e-3 rad of 45 degrees, |S2| < 5e-3 and
    |S3| / S0 within 1e-4 of 1.  Returns a dict of the angle, the Stokes
    parameters, the phase and the per-step losses."""
    device = resolve_device(device)
    stokes = rhomb_problem(dtype, device, theta0)
    theta = _scalar(theta0, dtype, device)
    losses = []
    for _ in range(steps):
        t = theta.detach().requires_grad_(True)
        loss = rhomb_loss(stokes, t)
        g, = torch.autograd.grad(loss, t)
        losses.append(loss.detach())
        theta = (t - lr * g).detach()
    with torch.no_grad():
        s = {k: float(v[0]) for k, v in stokes(theta).items()}
    theta_f = float(theta)
    delta = float(tir_phase(theta_f))
    out = {"theta": theta_f, "stokes": s, "delta": delta,
           "losses": _host(torch.stack(losses)) if losses else np.zeros(0)}
    if verbose:
        print(f"converged theta = {math.degrees(theta_f):.4f} deg; per-bounce "
              f"TIR phase = {math.degrees(delta):.4f} deg; Stokes out: "
              f"S0={s['S0']:.6f} S1={s['S1']:.2e} S2={s['S2']:.2e} "
              f"S3={s['S3']:.6f}")
    _checks("fresnel_rhomb", [
        (f"TIR phase {delta} not within 2e-3 of pi/4",
         abs(abs(delta) - PI / 4) < 2e-3),
        (f"|S2| {abs(s['S2'])} not below 5e-3", abs(s["S2"]) < 5e-3),
        (f"|S3|/S0 {abs(s['S3']) / s['S0']} not within 1e-4 of 1",
         abs(abs(s["S3"]) / s["S0"] - 1.0) < 1e-4)])
    return out


# ----------------------------------------------------------------------
# examples/ar_coating.py
# ----------------------------------------------------------------------

N_BK7 = 1.5168      # BK7 at 550 nm
N_MGF2 = 1.38       # low-index layer
N_AL2O3 = 1.63      # mid-index layer
COATING_START = (60.0, 40.0)    # deliberately off-design, nm


def band_mean_reflectance(thicknesses, n_layers, lams, cosines):
    """The mean unpolarized R of a stack on BK7 over a wavelength x
    incidence-cosine grid (the broadband AR objective)."""
    lam_g, cos_g = torch.meshgrid(lams, cosines, indexing="xy")
    lam_f, cos_f = lam_g.reshape(-1), cos_g.reshape(-1)
    one = torch.ones_like(lam_f)
    if len(n_layers):
        ln = torch.stack([n * one for n in n_layers])
        ld = torch.stack([t * one for t in thicknesses])
    else:
        ln = ld = torch.zeros((0,) + one.shape, dtype=one.dtype,
                              device=one.device)
    return torch.mean(thinfilm.stack_R_unpolarized(
        one, N_BK7 * one, cos_f, lam_f, ln, ld))


def design_coating(steps, dtype=torch.float32, device=None):
    """The example's 2-layer AR design (MgF2 over Al2O3): ``steps`` of
    clipped gradient descent (step 3e4, thicknesses kept in [5, 400] nm)
    on the reflectance averaged over 450-650 nm (11) and 0-30 degrees (5).
    Returns ``(d, r_start, r_designed, r_quarter_wave, r_bare)``."""
    device = resolve_device(device)
    lams = dist._linspace(450.0, 650.0, 11, dtype, device)
    cosines = torch.cos(dist._linspace(0.0, math.radians(30.0), 5, dtype,
                                       device))
    n_layers = (N_MGF2, N_AL2O3)   # outer (air side) first

    def loss(d):
        return band_mean_reflectance(d, n_layers, lams, cosines)

    d = torch.tensor(COATING_START, dtype=dtype, device=device)
    with torch.no_grad():
        r0 = loss(d)
    for _ in range(steps):
        leaf = d.detach().requires_grad_(True)
        g, = torch.autograd.grad(loss(leaf), leaf)
        d = torch.clamp(d - 3e4 * g, 5.0, 400.0)
    with torch.no_grad():
        r1 = loss(d)
        d_qw = thinfilm.quarter_wave_thickness(N_MGF2, 550.0)
        r_qw = band_mean_reflectance(
            torch.tensor([d_qw], dtype=dtype, device=device), (N_MGF2,),
            lams, cosines)
        r_bare = band_mean_reflectance(
            torch.zeros((0,), dtype=dtype, device=device), (), lams, cosines)
    return d, float(r0), float(r1), float(r_qw), float(r_bare)


def coated_lens(dtype=torch.float32, device=None):
    """The symmetric biconvex BK7 lens (two arcs of radius 6, half-height
    1.5) and a screen at x = 8; returns ``(scene, materials)``."""
    r, half = 6.0, 1.5
    sag = r - math.sqrt(r * r - half * half)
    th = math.asin(half / r)
    entry = ArcSet.make([[sag - r + 1.0, 0.0]], [-th], [th], [r],
                        mat_in=1, mat_out=0, dtype=dtype, device=device)
    exit_ = ArcSet.make([[r - sag + 1.4, 0.0]], [PI - th], [PI + th], [r],
                        mat_in=1, mat_out=0, dtype=dtype, device=device)
    tgt = SegmentSet.make([[8.0, -6.0]], [[8.0, 6.0]], dtype=dtype,
                          device=device)
    scene = Scene2D.build(optical_arcs=[entry, exit_], target_segments=[tgt])
    return scene, (mats.vacuum, mats.build_constant_material(N_BK7))


def white_fan(n, dtype=torch.float32, device=None):
    """``n`` rays from the origin over +-0.12 rad, 450-650 nm across the
    fan, each of unit intensity."""
    ang = np.linspace(-0.12, 0.12, n)
    lam = np.linspace(450.0, 650.0, n)
    p1 = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    return RaySet.make(np.zeros((n, 2)), p1, lam, fields={
        "intensity": torch.ones(n, dtype=dtype, device=device)},
        dtype=dtype, device=device)


def ar_coating(steps=300, rays=512, dtype=torch.float32, device=None,
               verbose=True):
    """``examples/ar_coating.py``: the coating designed (``design_coating``,
    thin films only, no trace), then a white fan of ``rays`` traced through
    the lens bare and with both faces coated
    (``thin_film_intensity_reaction``, 3 bounces), and the example's
    checks: the design below the quarter-wave MgF2 benchmark, itself below
    bare glass, and the coated lens delivering more power.  Returns a
    dict."""
    device = resolve_device(device)
    d, r0, r1, r_qw, r_bare = design_coating(steps, dtype, device)
    stack = [(N_MGF2, d[0]), (N_AL2O3, d[1])]
    scene, materials = coated_lens(dtype, device)
    cfg = _config(scene, 3, device)
    fan = white_fan(rays, dtype, device)
    coat_ids = {"arcs": torch.tensor([0, 0], device=device)}

    def delivered(res):
        hit = res.rays.state == FINISHED
        return float(torch.sum(torch.where(hit, res.rays.fields["intensity"],
                                           0.0)))

    with torch.no_grad():
        bare = trace(fan, scene, materials, cfg,
                     reaction=thin_film_intensity_reaction([], {}))
        coated = trace(fan, scene, materials, cfg,
                       reaction=thin_film_intensity_reaction([stack],
                                                             coat_ids))
    p_bare, p_coat = delivered(bare), delivered(coated)
    out = {"thickness": _host(d), "r_start": r0, "r_designed": r1,
           "r_quarter_wave": r_qw, "r_bare": r_bare, "power_bare": p_bare,
           "power_coated": p_coat,
           "landed": int((coated.rays.state == FINISHED).sum())}
    if verbose:
        print(f"band+angle mean R: bare {r_bare:.4f} -> start {r0:.4f} -> "
              f"designed {r1:.4f} (QW MgF2 {r_qw:.4f}), d = "
              f"{np.round(out['thickness'], 1)} nm; {out['landed']} rays "
              f"land; delivered power bare {p_bare:.2f}, coated {p_coat:.2f} "
              f"(+{100 * (p_coat / p_bare - 1):.2f}%)")
    _checks("ar_coating", [
        (f"designed R {r1} not below the quarter-wave {r_qw}", r1 < r_qw),
        (f"quarter-wave R {r_qw} not below bare {r_bare}", r_qw < r_bare),
        (f"coated power {p_coat} not above bare {p_bare}", p_coat > p_bare)])
    return out


# ----------------------------------------------------------------------
# examples/wavefront_lens.py
# ----------------------------------------------------------------------

WAVE_GLASS = 1.5
WAVE_FOCUS = 3.0
WAVE_HALF_AP = 1.0
WAVE_LAUNCH_X = -2.0


def wavefront_problem(n_segments=64, n_rays=192, dtype=torch.float32,
                      device=None):
    """``examples/wavefront_lens.py``'s lens: a polyline entrance surface of
    ``n_segments`` segments over |y| <= 1.15 (its vertices' x the
    parameters; glass of n = 1.5 behind it), ``n_rays`` collimated rays
    from x = -2 over |y| <= 1 carrying their optical path, a target at the
    focus x = 3 (2 bounces).  Returns ``(wavefront, ys_v, ray_ys)``:
    ``wavefront(xs)`` -> (per-ray OPD about the design path 2 + 1.5 * 3,
    the trace), and the vertices' and rays' heights."""
    device = resolve_device(device)
    materials = (mats.vacuum, mats.build_constant_material(WAVE_GLASS))
    reaction = optical_path_reaction()
    ys_v = dist._linspace(-1.15 * WAVE_HALF_AP, 1.15 * WAVE_HALF_AP,
                          n_segments + 1, dtype, device)
    ray_ys = dist._linspace(-WAVE_HALF_AP, WAVE_HALF_AP, n_rays, dtype,
                            device)
    rays = seed_optical_path(_collimated(ray_ys, WAVE_LAUNCH_X, 550.0, dtype,
                                         device))
    target = SegmentSet.make([[WAVE_FOCUS, -3.0]], [[WAVE_FOCUS, 3.0]],
                             dtype=dtype, device=device)
    focus = torch.tensor([WAVE_FOCUS, 0.0], dtype=dtype, device=device)
    design_opl = -WAVE_LAUNCH_X + WAVE_GLASS * WAVE_FOCUS

    def scene(xs):
        verts = torch.stack([xs, ys_v], dim=1)
        surf = SegmentSet.make(verts[:-1], verts[1:], mat_in=1, mat_out=0,
                               dtype=dtype, device=device)
        return Scene2D.build(optical_segments=[surf], target_segments=[target])

    cfg = _config(scene(torch.zeros_like(ys_v)), 2, device)

    def wavefront(xs):
        res = trace(rays, scene(xs), materials, cfg, reaction=reaction)
        # the path to the focus from each ray's last refraction point
        to_focus = torch.linalg.vector_norm(res.rays.p0 - focus, dim=1)
        opl = res.rays.fields["opl"] + res.rays.fields["cur_n"] * to_focus
        return opl - design_opl, res

    wavefront.cfg = cfg
    return wavefront, ys_v, ray_ys


def wavefront_loss(wavefront):
    """The mean squared OPD."""
    return lambda xs: torch.mean(wavefront(xs)[0] ** 2)


def wavefront_lens(steps=800, n_segments=64, n_rays=192, lr=1e-2,
                   dtype=torch.float32, device=None, verbose=True):
    """``examples/wavefront_lens.py``: Adam (lr 1e-2) on the mean squared
    OPD from a flat start, then the example's checks: the RMS wavefront
    error down 50x, the focal spot's RMS down 10x, the surface within
    5e-3 of the analytic hyperbola inside the aperture, and of the 11-term
    Zernike fit of the OPD over the pupil, defocus (Z4) down 50x and
    spherical (Z11) down 10x.  Returns a dict."""
    device = resolve_device(device)
    wavefront, ys_v, ray_ys = wavefront_problem(n_segments, n_rays, dtype,
                                                device)
    loss = wavefront_loss(wavefront)
    xs0 = torch.zeros_like(ys_v)
    pupil = torch.stack([ray_ys, torch.zeros_like(ray_ys)], dim=1)

    def measure(xs):
        opd, res = wavefront(xs)
        c, _ = zernike_fit(pupil, opd, n_terms=11, pupil_radius=WAVE_HALF_AP,
                           center=(0.0, 0.0))
        return (math.sqrt(float(torch.mean(opd ** 2))),
                math.sqrt(float(torch.mean(res.rays.p1[:, 1] ** 2))), _host(c))

    with torch.no_grad():
        rms0_wf, rms0_spot, c0 = measure(xs0)
    opt = adam_design(loss, xs0, lr)
    t0 = time.perf_counter()
    losses = opt.run_phase(steps)
    seconds = time.perf_counter() - t0
    xs = opt.parameters[0]
    with torch.no_grad():
        rms_wf, rms_spot, c1 = measure(xs)
    ys_h = _host(ys_v)
    in_ap = np.abs(ys_h) <= WAVE_HALF_AP
    dev = float(np.abs(_host(xs) - strehl_hyperbola_x(
        ys_h, WAVE_FOCUS, WAVE_GLASS))[in_ap].max())
    out = {"losses": losses, "xs": xs, "rms_wf0": rms0_wf, "rms_wf": rms_wf,
           "rms_spot0": rms0_spot, "rms_spot": rms_spot,
           "hyperbola_dev": dev, "zernike0": c0, "zernike": c1,
           "seconds": seconds}
    if verbose:
        print(f"RMS wavefront error {rms0_wf:.5f} -> {rms_wf:.3e}, focal "
              f"spot RMS {rms0_spot:.5f} -> {rms_spot:.2e}; max |surface - "
              f"hyperbola| = {dev:.2e}; Z4 {c0[3]:+.4f} -> {c1[3]:+.4f}, Z11 "
              f"{c0[10]:+.4f} -> {c1[10]:+.4f}")
    _checks("wavefront_lens", [
        (f"RMS wavefront {rms_wf} not below {rms0_wf} / 50",
         rms_wf < rms0_wf / 50),
        (f"spot RMS {rms_spot} not below {rms0_spot} / 10",
         rms_spot < rms0_spot / 10),
        (f"surface off the hyperbola by {dev} (limit 5e-3)", dev < 5e-3),
        (f"defocus Z4 {c1[3]} not below {c0[3]} / 50",
         abs(c1[3]) < abs(c0[3]) / 50),
        (f"spherical Z11 {c1[10]} not below {c0[10]} / 10",
         abs(c1[10]) < abs(c0[10]) / 10)])
    return out


# ----------------------------------------------------------------------
# examples/achromat.py
# ----------------------------------------------------------------------

F_LINE, D_LINE, C_LINE = 486.1, 587.6, 656.3
LINES = (F_LINE, D_LINE, C_LINE)
ACHROMAT_SCREEN_X = 15.0
ACHROMAT_APERTURE = 1.0
ACHROMAT_X = (0.0, 0.5, 0.8)     # front, cemented interface, back
C_MIN, C_MAX = 1.0 / 500.0, 1.0 / 3.0
ACHROMAT_GLASSES = (mats.vacuum, mats.crown_glass, mats.flint_glass)
SINGLET_START = (1.0 / 16.0, 1.0 / 16.0)
DOUBLET_START = (1.0 / 8.0, 1.0 / 8.0, 1.0 / 60.0)


def _axial_arc(center_x, radius, bulge, mat_in, mat_out, dtype, device):
    """An arc crossing the axis at ``center_x``, its centre a signed
    radius away: ``bulge`` -1 bulges toward -x (window around pi), +1
    toward +x (window around 0)."""
    cx = center_x - bulge * radius
    center = torch.stack([torch.stack([cx, torch.zeros_like(cx)])])
    a0, a1 = (3 * PI / 4, 5 * PI / 4) if bulge < 0 else (-PI / 4, PI / 4)
    return ArcSet.make(center, a0, a1, radius, mat_in=mat_in,
                       mat_out=mat_out, dtype=dtype, device=device)


def _achromat_screen(dtype, device):
    return SegmentSet.make([[ACHROMAT_SCREEN_X, -6.0]],
                           [[ACHROMAT_SCREEN_X, 6.0]], dtype=dtype,
                           device=device)


def build_doublet(c, dtype=torch.float32, device=None):
    """The cemented doublet vacuum | crown | flint | vacuum from the
    curvatures ``c`` (clipped to [1/500, 1/3])."""
    c = torch.clamp(c, C_MIN, C_MAX)
    r = 1.0 / c
    x = [_scalar(v, dtype, c.device) for v in ACHROMAT_X]
    arcs = [_axial_arc(x[0], r[0], -1, 1, 0, dtype, c.device),
            _axial_arc(x[1], r[1], +1, 1, 2, dtype, c.device),
            _axial_arc(x[2], r[2], +1, 2, 0, dtype, c.device)]
    return Scene2D.build(optical_arcs=arcs,
                         target_segments=[_achromat_screen(dtype, c.device)])


def build_singlet(c, dtype=torch.float32, device=None):
    """The biconvex crown singlet (the chromatic control)."""
    c = torch.clamp(c, C_MIN, C_MAX)
    r = 1.0 / c
    x = [_scalar(v, dtype, c.device) for v in ACHROMAT_X]
    arcs = [_axial_arc(x[0], r[0], -1, 1, 0, dtype, c.device),
            _axial_arc(x[1], r[1], +1, 1, 0, dtype, c.device)]
    return Scene2D.build(optical_arcs=arcs,
                         target_segments=[_achromat_screen(dtype, c.device)])


def achromat_rays(n_heights=21, dtype=torch.float32, device=None):
    """The F, d and C lines, collimated over |y| <= 1 from x = -1
    (``AngularSource`` of a static beam)."""
    beam = dist.StaticUniformBeam(-ACHROMAT_APERTURE, ACHROMAT_APERTURE,
                                  n_heights)
    angles = dist.StaticUniformAngularDistribution(0.0, 0.0, 1)
    source = src.AngularSource(2, (-1.0, 0.0), 0.0, angles, beam, list(LINES))
    return source.sample(dtype=dtype, device=device)


def focal_metrics(res):
    """Each line's best-focus x and RMS spot there, from the exiting ray
    segments (the least-squares common crossing of y = a + b x)."""
    fin = _host(res.rays.state == FINISHED)
    p0, p1 = _host(res.rays.p0), _host(res.rays.p1)
    wl = _host(res.rays.wavelength)
    v = p1 - p0
    b = v[:, 1] / v[:, 0]
    a = p0[:, 1] - p0[:, 0] * b
    out = {}
    for line in LINES:
        m = fin & (np.abs(wl - line) < 1e-3) & (np.abs(b) > 1e-9)
        x = -np.sum(a[m] * b[m]) / max(np.sum(b[m] ** 2), 1e-12)
        out[line] = (x, math.sqrt(np.mean((a[m] + b[m] * x) ** 2)))
    return out


def achromat_loss(build, rays, bounces, cfg, chroma_weight=0.0):
    """The polychromatic spot (the mean squared landing height, a miss
    counted at 0), plus ``chroma_weight`` times the spread of the lines'
    defocus slopes (least-squares slope of landing height on pupil
    height)."""
    n = rays.n_rays
    h = rays.p0[:, 1]
    line_masks = [torch.abs(rays.wavelength - line) < 1e-3 for line in LINES]
    dtype = rays.p0.dtype

    def loss(params):
        res = trace(rays, build(params[0], dtype), ACHROMAT_GLASSES, cfg)
        finished = res.rays.state == FINISHED
        y = torch.where(finished, res.rays.p1[:, 1], 0.0)
        spot = torch.sum(y ** 2) / n
        if not chroma_weight:
            return spot
        slopes = []
        for m in line_masks:
            hm = torch.where(m & finished, h, 0.0)
            slopes.append(torch.sum(hm * y)
                          / torch.clamp(torch.sum(hm * hm), min=1e-12))
        d = torch.stack(slopes)
        return spot + chroma_weight * torch.sum((d - torch.mean(d)) ** 2)

    return loss


def achromat_design(build, c0, rays, bounces, lr, chroma_weight=0.0):
    """The example's optimizer on one lens: momentum 0.9 steps of the
    ``Optimizer`` (learning rate ``lr``, clip 0.01)."""
    dtype, device = rays.p0.dtype, rays.p0.device
    c0 = torch.tensor(c0, dtype=dtype, device=device)
    cfg = _config(build(c0, dtype), bounces, device)
    loss = achromat_loss(build, rays, bounces, cfg, chroma_weight)
    return Optimizer(loss, [c0], learning_rate=lr, grad_clip=0.01,
                     pass_key=False), cfg


def achromat_optimize(build, c0, rays, bounces, steps, lr, chroma_weight=0.0):
    """``steps`` momentum steps, then the final trace: every ray must land
    (the example's check).  Returns ``(params, last error, focal metrics,
    per-step errors)``."""
    opt, cfg = achromat_design(build, c0, rays, bounces, lr, chroma_weight)
    errors = [opt.single_step(None, momentum=0.9, sync=False)
              for _ in range(steps)]
    params = torch.clamp(opt.parameters[0], C_MIN, C_MAX)
    with torch.no_grad():
        res = trace(rays, build(params, rays.p0.dtype), ACHROMAT_GLASSES, cfg)
    _checks("achromat", [("rays escaped the lens",
                          bool(torch.all(res.rays.state == FINISHED)))])
    errors = _host(torch.stack(errors)) if errors else np.zeros(0)
    return params, float(errors[-1]) if steps else None, focal_metrics(res), \
        errors


def achromat(steps=400, n_heights=21, dtype=torch.float32, device=None,
             png=None, verbose=True):
    """``examples/achromat.py``: the crown singlet (3 bounces) and the
    crown/flint doublet (4 bounces, chromatic weight 10) designed by the
    same optimizer (lr 2e-3) at the F, d and C lines, each lens's
    per-line foci and the chromatic focal shift C - F; the check: every
    ray lands after each design.  The example runs float64, which either
    device runs (K5, K6 and K2 have float64 instances); ``dtype`` defaults
    to float32.  The doublet's rays are drawn into ``png`` when one is
    given.  Returns a dict."""
    device = resolve_device(device)
    rays = achromat_rays(n_heights, dtype, device)
    out = {}
    for tag, build, c0, bounces, weight in (
            ("singlet", build_singlet, SINGLET_START, 3, 0.0),
            ("doublet", build_doublet, DOUBLET_START, 4, 10.0)):
        params, err, metrics, errors = achromat_optimize(
            build, c0, rays, bounces, steps, 2e-3, weight)
        out[f"{tag}_params"] = _host(params)
        out[f"{tag}_error"] = err
        out[f"{tag}_errors"] = errors
        out[f"{tag}_metrics"] = metrics
        out[f"{tag}_shift"] = float(metrics[C_LINE][0] - metrics[F_LINE][0])
    out["improvement"] = (abs(out["singlet_shift"])
                          / max(abs(out["doublet_shift"]), 1e-12))
    if verbose:
        r = 1.0 / out["doublet_params"]
        print(f"chromatic focal shift C - F: singlet "
              f"{out['singlet_shift']:+.4f}, doublet "
              f"{out['doublet_shift']:+.4f} ({out['improvement']:.1f}x); "
              f"doublet radii {np.round(r, 2)}")
    if png is not None:
        _draw_achromat(png, out["doublet_params"], rays, dtype, device)
    return out


def _draw_achromat(png, c, rays, dtype, device):
    from tensorflowraytrace_tpu_torch import drawing

    scene = build_doublet(torch.as_tensor(c, dtype=dtype, device=device),
                          dtype)
    with torch.no_grad():
        res = trace(rays, scene, ACHROMAT_GLASSES,
                    TraceConfig(max_bounces=4, keep_history=True,
                                use_kernel=_on_card(device)))
    fig = drawing.figure(figsize=(11, 5))
    ax = fig.subplots()
    ax.set_aspect("equal")
    ax.set_xlim(-1.5, ACHROMAT_SCREEN_X + 1)
    ax.set_ylim(-3, 3)
    drawing.ArcDrawer(ax, scene.arcs, color="cyan",
                      draw_norm_arrows=False).draw()
    drawing.RayDrawer2D(ax, drawing.history_rays(res)).draw()
    fig.savefig(png, dpi=100)


# ----------------------------------------------------------------------
# examples/hybrid_achromat.py
# ----------------------------------------------------------------------

HYBRID_SCREEN_X = 15.0
HYBRID_FLAT_X = 0.5
HYBRID_START = (1.0 / 14.0, 0.0, 0.0)
HYBRID_META_SCALE = 1e-4


def hybrid_problem(n_heights=13, dtype=torch.float32, device=None):
    """``examples/hybrid_achromat.py``'s lens: a crown entry arc of
    curvature c1 (softplus-kept positive), a flat exit face at x = 0.5
    that may carry the metasurface phase c_m2 y^2 + c_m4 y^4, and a
    screen at x = 15; the F, d and C lines collimated over |y| <= 1 from
    x = -1 (the axial ray dropped), 3 bounces.  Returns
    ``(landings, rays)``: ``landings(params, use_meta)`` -> (landing
    heights, states) for ``params`` = (c1, c_m2, c_m4)."""
    device = resolve_device(device)
    ys = np.linspace(-ACHROMAT_APERTURE, ACHROMAT_APERTURE, n_heights)
    ys = ys[np.abs(ys) > 1e-9]  # the axial ray carries no signal
    n = len(ys) * len(LINES)
    p0 = np.stack([np.full(n, -1.0), np.tile(ys, len(LINES))], axis=1)
    rays = RaySet.make(p0, p0 + [1.0, 0.0], np.repeat(LINES, len(ys)),
                       dtype=dtype, device=device)
    flat = SegmentSet.make([[HYBRID_FLAT_X, -3.0]], [[HYBRID_FLAT_X, 3.0]],
                           mat_in=0, mat_out=1, dtype=dtype, device=device)
    screen = SegmentSet.make([[HYBRID_SCREEN_X, -6.0]],
                             [[HYBRID_SCREEN_X, 6.0]], dtype=dtype,
                             device=device)
    ids = {"segments": torch.tensor([0, -1], device=device)}
    materials = (mats.vacuum, mats.crown_glass)

    def scene(c1):
        # softplus keeps the curvature positive with the gradient flowing
        # (jax.nn.softplus: logaddexp(x, 0))
        c1 = torch.logaddexp(c1 * 20.0, torch.zeros_like(c1)) / 20.0 \
            + 1.0 / 500.0
        r1 = 1.0 / torch.clamp(c1, max=1.0 / 3.0)
        center = torch.stack([torch.stack([r1, torch.zeros_like(r1)])])
        s1 = ArcSet.make(center, 3 * PI / 4, 5 * PI / 4, r1, mat_in=1,
                         mat_out=0, dtype=dtype, device=device)
        return Scene2D.build(optical_arcs=[s1], optical_segments=[flat],
                             target_segments=[screen])

    cfg = _config(scene(_scalar(HYBRID_START[0], dtype, device)), 3, device)

    def landings(params, use_meta=True):
        c1, cm2, cm4 = params

        def phase(p, w):
            return cm2 * p[1] ** 2 + cm4 * p[1] ** 4

        rx = metasurface_reaction(
            [(phase, "transmission")] if use_meta else [], ids)
        res = trace(rays, scene(c1), materials, cfg, reaction=rx)
        return res.rays.p1[:, 1], res.rays.state

    landings.cfg = cfg
    return landings, rays


def hybrid_params(q):
    """The design vector's scaling: (c1, 1e-4 q1, 1e-4 q2)."""
    return q[0], q[1] * HYBRID_META_SCALE, q[2] * HYBRID_META_SCALE


def hybrid_design(landings, use_meta, q0=None, dtype=torch.float32,
                  device=None):
    """Adam (lr 5e-3) on the mean squared landing height, the metasurface
    coefficients frozen (no gradient) unless ``use_meta``."""
    device = resolve_device(device)

    def loss(q):
        y, _ = landings(hybrid_params(q), use_meta=use_meta)
        return torch.mean(y * y)

    q0 = (torch.tensor(HYBRID_START, dtype=dtype, device=device)
          if q0 is None else q0)
    return adam_design(loss, q0, 5e-3, (1.0, float(use_meta),
                                        float(use_meta)))


def hybrid_report(landings, rays, q, use_meta):
    """Each line's RMS spot and the polychromatic RMS of the landed
    rays."""
    with torch.no_grad():
        y, state = landings(hybrid_params(q), use_meta=use_meta)
    y, ok, wl = _host(y), _host(state) == FINISHED, _host(rays.wavelength)
    spots = [float(np.sqrt(np.mean(y[ok & (wl == line)] ** 2)))
             for line in LINES]
    return float(np.sqrt(np.mean(y[ok] ** 2))), spots


def hybrid_achromat(steps=600, n_heights=13, dtype=torch.float32,
                    device=None, verbose=True):
    """``examples/hybrid_achromat.py``: the curvature-only control, then
    the hybrid (curvature and metasurface coefficients) warm-started from
    it, ``steps`` Adam steps each, and the example's check: the hybrid's
    polychromatic RMS spot more than 2x smaller.  Returns a dict."""
    device = resolve_device(device)
    landings, rays = hybrid_problem(n_heights, dtype, device)
    out = {}
    q = None
    for tag, use_meta in (("refractive", False), ("hybrid", True)):
        opt = hybrid_design(landings, use_meta, q, dtype, device)
        t0 = time.perf_counter()
        out[f"{tag}_losses"] = opt.run_phase(steps)
        out[f"{tag}_seconds"] = time.perf_counter() - t0
        q = opt.parameters[0]
        out[f"{tag}_q"] = _host(q)
        out[f"{tag}_rms"], out[f"{tag}_spots"] = hybrid_report(
            landings, rays, q, use_meta)
    gain = out["refractive_rms"] / out["hybrid_rms"]
    out["gain"] = gain
    if verbose:
        print(f"polychromatic RMS spot: {out['refractive_rms']:.4f} -> "
              f"{out['hybrid_rms']:.4f} ({gain:.1f}x smaller with the "
              f"metasurface corrector); per line (F/d/C) refractive "
              f"{np.round(out['refractive_spots'], 4)}, hybrid "
              f"{np.round(out['hybrid_spots'], 4)}")
    _checks("hybrid_achromat", [(f"gain {gain} not above 2", gain > 2.0)])
    return out
