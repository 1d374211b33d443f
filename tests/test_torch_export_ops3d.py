"""Exported traces through the ``tfrt_torch`` operators on the CPU.

``export.export_trace`` of a 2-bounce trace with ``use_kernel=True`` under
brute force, ``cull=True`` and ``cull="grid"``, in 3D (K1, K3, K4;
tests/test_torch_export_ops.py has 2D): every operator's fake
implementation is traced, the exported graph calls the operators, and the
loaded program's result equals the live trace's bit for bit.  On the card,
chip_smoke.py phase 21b does the same at full width and counts the
kernels' launches from the loaded programs.
"""

import pytest

from tensorflowraytrace_tpu_torch import config
from torch_export_common import check_exported_kernel_trace, scene_3d
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


@pytest.mark.parametrize("cull", [False, True, "grid"],
                         ids=["brute", "cull", "grid"])
def test_exported_kernel_trace(cull):
    check_exported_kernel_trace("3d", cull, *scene_3d())
