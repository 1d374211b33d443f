"""``utils/profiling.py`` on the CPU: ``profile_trace`` writes a trace
that names the operations run inside it, and writes nothing when disabled;
``StepTimer`` gives the JAX package's ``mean``, ``total`` and ``report`` on
the same recorded times."""

import json

import pytest
import torch

from tensorflowraytrace_tpu.utils import profiling as j_profiling
from tensorflowraytrace_tpu_torch import config, scenes2d
from tensorflowraytrace_tpu_torch.engine import TraceConfig, trace
from tensorflowraytrace_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def test_profile_trace_writes_a_trace(tmp_path):
    rays, scene, materials = scenes2d.light_guide(256, 64, 16, device="cpu")
    cfg = TraceConfig(max_bounces=2, use_kernel=True)
    with profiling.profile_trace(str(tmp_path / "prof")) as prof:
        trace(rays, scene, materials, cfg)
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "tfrt_torch::segment_search" in names
    assert "tfrt_torch::arc_search" in names
    assert any(e.key == "tfrt_torch::segment_search"
               for e in prof.key_averages())


def test_profile_trace_disabled_writes_nothing(tmp_path):
    with profiling.profile_trace(str(tmp_path / "prof"),
                                 enabled=False) as prof:
        torch.ones(3).sum()
    assert prof is None
    assert not (tmp_path / "prof").exists()


def test_step_timer_matches_jax():
    times = [0.0125, 0.25, 0.003, 1.5]
    port, ref = profiling.StepTimer(), j_profiling.StepTimer()
    assert port.mean == ref.mean == 0 and port.report() == ref.report()
    port.times, ref.times = list(times), list(times)
    assert port.mean == ref.mean and port.total == ref.total
    assert port.report("bounce") == ref.report("bounce")
    with port as timer:
        torch.ones(3).sum()
    assert timer is port and len(port.times) == 5 and port.times[-1] >= 0
