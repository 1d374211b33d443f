"""The port's ``classical.lens_report`` against examples/lens_report.py on
the CPU in float64, at tests/test_examples.py's CI sizes (400 rays, 512
PSF rays, a 41^2 grid, 3 fields): the first-order numbers, the Seidel
table, the field curves, the colour curves and the RMS spots within rtol
1e-10, the MTF's frequencies within rtol 1e-12 and its values within
rtol 1e-8 (atol 1e-10), and the example's check ``|mtf[0] - 1| < 1e-9``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu_torch import classical, config
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64


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


def test_lens_report_matches_the_example():
    ex = load_example("lens_report")
    kw = dict(n_rays=400, psf_rays=512, grid_pts=41, n_fields=3)
    want = ex.main(**kw, make_plot=False, verbose=False)
    got = classical.lens_report(**kw, dtype=F64, device="cpu")
    for f in ("efl", "bfp", "f_no"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-10, err_msg=f)
    for f in ("S1", "S2", "S3", "S4", "S5", "C1", "C2", "H", "per_surface"):
        np.testing.assert_allclose(getattr(got["seidel"], f).numpy(),
                                   np.asarray(getattr(want["seidel"], f)),
                                   rtol=1e-10, atol=1e-15, err_msg=f)
    for f in ("field_angles", "z_image", "tangential", "sagittal",
              "chief_height", "paraxial_height", "distortion"):
        np.testing.assert_allclose(
            getattr(got["field_curves"], f).numpy(),
            np.asarray(getattr(want["field_curves"], f)), rtol=1e-10,
            atol=1e-14, err_msg=f)
    for f in ("axial_color", "lateral_color"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-10, err_msg=f)
    assert sorted(got["spots"]) == pytest.approx(sorted(want["spots"]))
    np.testing.assert_allclose([got["spots"][k] for k in sorted(got["spots"])],
                               [want["spots"][k] for k in sorted(want["spots"])],
                               rtol=1e-10)
    np.testing.assert_allclose(got["mtf"][0], want["mtf"][0], rtol=1e-12)
    np.testing.assert_allclose(got["mtf"][1], want["mtf"][1], rtol=1e-8,
                               atol=1e-10)
    assert abs(float(got["mtf"][1][0]) - 1.0) < 1e-9
