"""The facade's problems (``facade.py``) at small sizes on the CPU: what
``chip_smoke.py`` phase 20 checks on the card.

* The facade-tax scene and the 2D guide through ``OpticalSystem2D``: the
  facade's ``ray_trace`` equals ``engine.trace`` of the same rays and scene
  under the facade's configuration bit for bit, the four ray views
  partition the slots, and ``update()`` re-samples the source.
* The flagship lens through ``OpticalSystem3D``: ``SGD_Optimizer`` and the
  functional ``optim.Optimizer`` from the same generator seed take the
  same steps (bit for bit on the CPU), and ``SGD_Optimizer`` writes its
  parameters back into the lens.
* ``precompile_pipeline``: the matching is a permutation of the goal
  points, the cache round-trips, each per-step sample is drawn from it on
  the device asked for, and the matching's mean distance equals the JAX
  example's on the same points.
"""

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import goals as j_goals
from tensorflowraytrace_tpu_torch import config, facade, trace
from tensorflowraytrace_tpu_torch.optim import Optimizer
from tensorflowraytrace_tpu_torch.system import SGD_Optimizer
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def assert_same_trace(got, want):
    for a, b in ((got.state, want.state), (got.p0, want.p0),
                 (got.p1, want.p1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("build, bounces", [
    (lambda: facade.tax_bench_system(2048), facade.TAX_BOUNCES),
    (lambda: facade.guide_system(1024, 64, 16), 6)],
    ids=["tax_bench", "guide"])
def test_facade_trace_equals_the_functional_trace(build, bounces):
    system, engine = build()
    cfg = engine.trace_config(bounces)
    want = trace(system.sources, system.scene, system.material_callables(),
                 cfg).rays
    got = engine.ray_trace(bounces).rays
    assert_same_trace(got, want)
    n = got.n_rays
    assert (engine.finished_rays.n_rays + engine.stopped_rays.n_rays
            + engine.dead_rays.n_rays + engine.active_rays.n_rays) == n
    assert engine.finished_rays.n_rays > 0
    before = system.sources.p1.clone()
    system.update()
    assert not torch.equal(before, system.sources.p1)


def test_flagship_through_the_facade_equals_the_functional_design():
    """SGD_Optimizer on the facade and optim.Optimizer on the functional
    loss, from one seed, over a few steps of the design's first phase."""
    problem = facade.flagship_system(bp_count=6, mesh_steps=2,
                                     dtype=torch.float64)
    kw = dict(learning_rate=1.0, grad_clip=1e-3)
    sgd = SGD_Optimizer(problem["engine"], trace_depth=3,
                        error_function=problem["error_function"],
                        generator=torch.Generator().manual_seed(5), **kw)
    ref = Optimizer(problem["loss"], problem["init_params"],
                    generator=torch.Generator().manual_seed(5), **kw)
    phase = dict(lr_scale=2e-4, momentum=0.8,
                 smoothers=[problem["smoother"]] * 2)
    accumulators = [problem["accumulator"]] * 2
    got = sgd.run_phase(4, accumulators, **phase)
    want = ref.run_phase(4, accumulators, **phase)
    assert got.tolist() == want.tolist()
    for a, b in zip(sgd.parameters, ref.parameters):
        assert torch.equal(a, b)
    # written back into the lens the system builds
    lens = problem["system"].optical[0]._obj
    for a, b in zip(lens.param_list(), ref.parameters):
        assert torch.equal(a.detach(), b)


def test_precompile_pipeline(tmp_path):
    out = facade.precompile_pipeline(str(tmp_path), n=40, sample_count=16,
                                     device="cpu")
    goal, source, matched = (out["goal_points"], out["source_points"],
                             out["matched"])
    assert goal.shape == source.shape == matched.shape == (40, 2)
    # the matching permutes the goals, optimally as the JAX package's
    np.testing.assert_array_equal(np.sort(matched, axis=0),
                                  np.sort(goal, axis=0))
    np.testing.assert_array_equal(matched,
                                  j_goals.transform_map(source, goal))
    assert out["mean_distance"] == float(
        np.linalg.norm(source - matched, axis=1).mean())
    rows = {tuple(r) for r in matched.tolist()}
    for points, ranks in out["samples"]:
        assert points.shape == ranks.shape == (16, 2)
        assert points.device.type == "cpu"
        assert {tuple(r) for r in ranks.tolist()} <= rows
    again = facade.precompile_pipeline(str(tmp_path), n=40, sample_count=16,
                                       device="cpu")
    assert again["mean_distance"] == out["mean_distance"]
