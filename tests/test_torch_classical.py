"""The port's classical lens-design examples (``classical.py``) against the
JAX package's examples on the CPU in float64, at tests/test_examples.py's
CI sizes.

* ``cooke_triplet``: the loss and its gradient at ``P_INIT`` (24 rays a
  bundle) against examples/cooke_triplet.py's ``spot_loss`` under
  ``jax.value_and_grad``, within rtol 1e-10; then 10 Adam steps under the
  cosine schedule against ``optax``: the loss before each step and the
  curvatures after it within rtol 1e-9.
* ``paraxial_analysis`` as it stands: its three checks hold in float64
  and float32; its EFL, back focal point and solved EFL equal
  examples/paraxial_analysis.py's within rtol 1e-10.
* ``sequential_vs_mesh``: the example's 512-ray check on the port's plain
  search against the port's own ``trace_sequential`` (more than 90% of
  the rays finish, every landing within 0.02), on the 35,826-triangle
  scene; ``sequential_vs_mesh`` itself at 256 rays on a coarse mesh.

``lens_report`` is in tests/test_torch_lens_report.py.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowraytrace_tpu_torch import classical, config
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
J64 = jnp.float64


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def load_example(name):
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cooke_triplet_loss_gradient_and_adam_steps():
    ex = load_example("cooke_triplet")
    n_rays, steps, lr = 24, 10, 2e-3
    bundles_j = ex.make_bundles(n_rays, J64)
    vag = jax.jit(jax.value_and_grad(
        lambda c: ex.spot_loss(c, bundles_j, J64)[0]))

    params, step, bundles = classical.cooke_design(steps, n_rays, lr, F64,
                                                   "cpu")
    for a, b in zip(bundles[:3], bundles_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-15)
    v0, g0 = vag(jnp.asarray(classical.P_INIT))
    loss, _ = classical.cooke_loss(params, bundles)
    (g,) = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(v0), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(g0), rtol=1e-10,
                               atol=1e-14)

    # the example's optimizer: optax.adam under cosine_decay_schedule
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=3e-2))
    pj = jnp.asarray(classical.P_INIT)
    state = tx.init(pj)
    for i in range(steps):
        v, gj = vag(pj)
        upd, state = tx.update(gj, state)
        pj = optax.apply_updates(pj, upd)
        got = step()
        np.testing.assert_allclose(float(got), float(v), rtol=1e-9,
                                   err_msg=f"loss at step {i}")
        np.testing.assert_allclose(params.detach().numpy(), np.asarray(pj),
                                   rtol=1e-9, err_msg=f"step {i}")
    assert float(got) < float(v0)


def test_cooke_triplet_check_and_report():
    """The example's entry point at a few steps: the spots fall, and the
    per-(line, field) report has every bundle."""
    out = classical.cooke_triplet(steps=4, n_rays=12, dtype=F64,
                                  device="cpu")
    assert set(out["final"]) == {(wl, th) for wl in classical.WAVELENGTHS
                                 for th in classical.FIELDS}
    assert out["rms1"] < out["rms0"] and np.isfinite(out["rms1"])
    assert sorted(out["losses"]) == [0, 1, 2, 3]


def test_paraxial_analysis_as_it_stands():
    ex = load_example("paraxial_analysis")
    efl, bfp, efl_solved = ex.main(verbose=False)
    out = classical.paraxial_analysis(dtype=F64, device="cpu")
    np.testing.assert_allclose(
        [float(out["efl"]), float(out["bfp"]), float(out["efl_solved"])],
        [efl, bfp, efl_solved], rtol=1e-10)
    # the example's three checks in the examples' float32 too
    out32 = classical.paraxial_analysis(dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(float(out32["efl"]), efl, rtol=1e-5)


def test_sequential_vs_mesh_check_on_the_plain_search():
    scene = classical.svm_mesh_scene(dtype=torch.float32, device="cpu")
    assert scene.triangles.n_surfaces == 35826
    cfg = classical.svm_config("cpu")
    assert not cfg.use_kernel and not cfg.cull
    out = classical.svm_check(scene, cfg, device="cpu")
    assert out["finished"] > 0.9 and out["max_dev"] < 0.02
    # the example's timing entry point, at a coarse mesh and few rays
    timed = classical.sequential_vs_mesh(n_rays=256, edge=0.1, device="cpu")
    assert timed["check"] is None and timed["n_triangles"] < 2000
    assert sorted(timed["seconds"]) == ["analytic", "mesh"]
    assert all(s > 0 for s in timed["seconds"].values())
