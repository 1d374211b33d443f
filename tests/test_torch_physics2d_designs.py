"""The 2D reaction designs of ``physics2d.py`` (``wavefront_lens``,
``achromat``) against the JAX examples on the CPU in
float64; the other four examples are in tests/test_torch_physics2d.py and
the hybrid achromat in tests/test_torch_physics2d_hybrid.py.

For each example the JAX example's own helpers (loaded from examples/, as
tests/test_examples.py loads them) and the port's counterparts take the
same inputs: one trace's landings and fields and one gradient, or the
first steps' losses and parameters of the design (optax against
``torch.optim.Adam``; the JAX ``Optimizer`` against the port's), within
rtol 1e-9.  Then each port function runs end to end at its size in
tests/test_examples.py's CASES with the example's checks, its numbers held
to those the example prints there.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import trace as j_trace
from tensorflowraytrace_tpu.operations import (
    optical_path_reaction as j_optical_path_reaction,
)
from tensorflowraytrace_tpu.operations import seed_optical_path as j_seed_opl
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import config, physics2d
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
J64 = jnp.float64
RTOL = 1e-9
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.fixture(autouse=True)
def on_cpu(tmp_path, monkeypatch):
    """The CPU, and a scratch working directory for the JAX examples'
    files."""
    monkeypatch.chdir(tmp_path)
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def close(t, j, rtol=RTOL, atol=1e-14):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


# ----------------------------------------------------------------------
# wavefront_lens
# ----------------------------------------------------------------------

def jax_wavefront(n_segments, n_rays):
    """The example's ``wavefront_sq`` in float64 (its body is inline in
    ``main``)."""
    ex = load("wavefront_lens")
    materials = (j_mats.vacuum, j_mats.build_constant_material(ex.N_GLASS))
    ys_v = jnp.linspace(-1.15 * ex.HALF_AP, 1.15 * ex.HALF_AP,
                        n_segments + 1, dtype=J64)
    ray_ys = jnp.linspace(-ex.HALF_AP, ex.HALF_AP, n_rays, dtype=J64)
    p0 = jnp.stack([jnp.full((n_rays,), ex.X_LAUNCH, J64), ray_ys], axis=1)
    rays = j_seed_opl(JRaySet.make(p0, p0 + jnp.asarray([1.0, 0.0], J64),
                                   550.0, dtype=J64))
    target = JSegmentSet.make([[ex.FOCUS, -3.0]], [[ex.FOCUS, 3.0]],
                              dtype=J64)
    focus = jnp.asarray([ex.FOCUS, 0.0], J64)
    C = -ex.X_LAUNCH + ex.N_GLASS * ex.FOCUS

    def wavefront_sq(xs):
        verts = jnp.stack([xs, ys_v], axis=1)
        surf = JSegmentSet.make(verts[:-1], verts[1:], mat_in=1, mat_out=0,
                                dtype=J64)
        scene = JScene2D.build(optical_segments=[surf],
                               target_segments=[target])
        res = j_trace(rays, scene, materials, JTraceConfig(max_bounces=2),
                      reaction=j_optical_path_reaction())
        to_focus = jnp.linalg.norm(res.rays.p0 - focus, axis=1)
        opl = res.rays.fields["opl"] + res.rays.fields["cur_n"] * to_focus
        return jnp.mean((opl - C) ** 2)

    return wavefront_sq


def test_wavefront_lens_steps_match_jax():
    vag = jax.jit(jax.value_and_grad(jax_wavefront(16, 24)))
    tx = optax.adam(1e-2)
    xs = jnp.zeros((17,), J64)
    state = tx.init(xs)
    j_losses = []
    for _ in range(4):
        v, g = vag(xs)
        upd, state = tx.update(g, state)
        xs = optax.apply_updates(xs, upd)
        j_losses.append(float(v))
    wavefront, ys_v, _ = physics2d.wavefront_problem(16, 24, F64, "cpu")
    opt = physics2d.adam_design(physics2d.wavefront_loss(wavefront),
                                torch.zeros_like(ys_v), 1e-2)
    close(opt.run_phase(4), j_losses)
    close(opt.parameters[0], xs)


def test_wavefront_lens_runs():
    out = physics2d.wavefront_lens(250, dtype=F64, device="cpu",
                                   verbose=False)
    # the example's own run prints these (the start's Zernike fit is the
    # least-norm one of a pupil line, as jnp.linalg.lstsq gives it)
    assert (f"{out['rms_wf']:.3e}", f"{out['rms_spot']:.2e}") == (
        "3.890e-05", "1.25e-02")
    assert (round(out["zernike0"][3], 4), round(out["zernike0"][10], 4)) \
        == (0.0231, -0.0005)


# ----------------------------------------------------------------------
# achromat
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lens", ["singlet", "doublet"])
def test_achromat_design_matches_jax(lens):
    ex = load("achromat")
    glasses = (j_mats.vacuum, j_mats.crown_glass, j_mats.flint_glass)
    j_rays = ex.make_source(9, J64)
    rays = physics2d.achromat_rays(9, F64, "cpu")
    close(rays.p0, j_rays.p0)
    close(rays.wavelength, j_rays.wavelength)
    if lens == "singlet":
        args = (ex.build_singlet, physics2d.build_singlet,
                physics2d.SINGLET_START, 3, 0.0)
    else:
        args = (ex.build_doublet, physics2d.build_doublet,
                physics2d.DOUBLET_START, 4, 10.0)
    j_build, t_build, c0, bounces, weight = args
    j_params, j_e, j_metrics = ex.optimize(
        j_build, list(c0), j_rays, glasses, bounces, 5, lr=2e-3, dtype=J64,
        verbose=False, chroma_weight=weight)
    params, e, metrics, _ = physics2d.achromat_optimize(
        t_build, c0, rays, bounces, 5, 2e-3, weight)
    close(params, j_params)
    close(e, j_e)
    for line in physics2d.LINES:
        close(metrics[line], j_metrics[line])


def test_achromat_runs(tmp_path):
    out = physics2d.achromat(5, 9, dtype=F64, device="cpu",
                             png=tmp_path / "achromat.png", verbose=False)
    # the example's own run prints +0.2356 and +0.1012
    assert (round(out["singlet_shift"], 4), round(out["doublet_shift"], 4)) \
        == (0.2356, 0.1012)
    assert (tmp_path / "achromat.png").stat().st_size > 0
