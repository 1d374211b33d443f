"""``facade.interactive_optimize`` against examples/interactive_optimize.py
at tests/test_examples.py's CI keys (two steps, a burst of ten, a save, a
step, the end), headless, in float32 (the example's dtype): the same 13
losses and final radius, the checkpoint written, and the last figure
written as a PNG at its size."""

import importlib.util
import os
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.image as mpimg  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tensorflowraytrace_tpu_torch import config, facade  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (a fixture)

# the interactive loop against the JAX example, which runs in float32: the
# two frameworks round float32 differently over the 13 steps.  The radius
# agrees to rtol 1e-4; the loss, a sum of squared landing heights, is held
# to 1e-3 of its first value (near the minimum a step's loss is a small
# remainder: one of 13 differs by 2.5e-4 of the first loss)
RTOL_F32 = 1e-4
LOSS_ATOL_SHARE = 1e-3
EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "interactive_optimize.py")


@pytest.fixture(autouse=True)
def on_cpu(tmp_path, monkeypatch):
    """The CPU, and a scratch working directory for the JAX example."""
    monkeypatch.chdir(tmp_path)
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)
    plt.close("all")


def load_example():
    spec = importlib.util.spec_from_file_location("example_interactive",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_interactive_optimize(tmp_path):
    keys = [" ", " ", "b", "s", " ", "q"]
    ref = load_example().main(simulate=keys, verbose=False)
    loop = facade.interactive_optimize(keys, dtype=torch.float32,
                                       checkpoint_dir=str(tmp_path),
                                       png=str(tmp_path / "i.png"))
    assert len(loop.losses) == len(ref.losses) == 13
    np.testing.assert_allclose(loop.losses, ref.losses, rtol=0,
                               atol=LOSS_ATOL_SHARE * ref.losses[0])
    assert loop.opt.iterations == ref.opt.iterations
    np.testing.assert_allclose(float(loop.opt.parameters[0][0]),
                               float(ref.opt.parameters[0][0]), rtol=RTOL_F32)
    assert loop.closed and len(loop.saved) == 1
    assert os.path.exists(loop.saved[0])
    assert mpimg.imread(tmp_path / "i.png").shape[:2] == (450, 1000)
