"""The examples that draw, on the CPU at tests/test_examples.py's CI sizes.

* ``scenes3d.mesh_graph_tools`` and ``scenes2d.engine_internals`` against
  ``examples/mesh_graph_tools.py`` and ``engine_internals.py``: the values
  the JAX examples print equal the port's, and each port function writes
  its PNG when given a path, at the figure's size
  (``facade.interactive_optimize``: tests/test_torch_interactive.py).
* The PNGs of ``scenes3d.caustic_render``, ``scenes2d.ghost_analysis`` and
  ``classical.lens_report``: written at the CI sizes and decoded at the
  figure's size (inches x dpi).
"""

import importlib.util
import os
import re
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.image as mpimg  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tensorflowraytrace_tpu_torch import (  # noqa: E402
    classical, config, scenes2d, scenes3d,
)
from torch_threads import one_torch_thread  # noqa: E402,F401 (a fixture)

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
    plt.close("all")


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*", text)]


def png_shape(path):
    return mpimg.imread(path).shape[:2]


def test_mesh_graph_tools(capsys, tmp_path):
    load("mesh_graph_tools").main()
    printed = capsys.readouterr().out
    out = scenes3d.mesh_graph_tools(png=str(tmp_path / "m.png"))
    assert numbers(printed.split("relationships:")[1].splitlines()[0]) == [
        out["children"], out["top"]]
    assert numbers(printed.split("generations:")[1].splitlines()[0]) == [
        out["generations"], out["reached"], out["n_points"]]
    assert numbers(printed.split("accumulator:")[1].splitlines()[0]) == [
        out["reach_top"], out["n_points"], out["reach_rim"]]
    spikes = numbers(printed.split("smoother:")[1].splitlines()[0])
    assert spikes == [1.0, round(out["spike_1"], 3), 1,
                      round(out["spike_3"], 3), 3]
    assert png_shape(tmp_path / "m.png") == (1400, 1400)


def test_engine_internals(capsys, tmp_path):
    load("engine_internals").main()
    printed = capsys.readouterr().out
    out = scenes2d.engine_internals(dtype=torch.float64,
                                    png=str(tmp_path / "e.png"))
    assert numbers(printed.split("single_pass:")[1].splitlines()[0]) == [
        out["rays"], out["refracted"]]
    assert numbers(printed.split("projection:")[1].splitlines()[0])[:2] == [
        out["beam"], out["missed"]]
    assert png_shape(tmp_path / "e.png") == (600, 1600)


@pytest.mark.parametrize("run, shape", [
    (lambda png: scenes3d.caustic_render(2048, 512, 32, 8, device="cpu",
                                         verbose=False, png=png), (980, 980)),
    (lambda png: scenes2d.ghost_analysis(101, 4, device="cpu", verbose=False,
                                         png=png), (440, 770)),
    (lambda png: classical.lens_report(400, 512, 41, 3, device="cpu",
                                       png=png), (880, 1100)),
], ids=["caustic_render", "ghost_analysis", "lens_report"])
def test_example_png(run, shape, tmp_path):
    path = str(tmp_path / "figure.png")
    run(path)
    assert png_shape(path) == shape
