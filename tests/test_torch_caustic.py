"""``scenes3d.caustic_render`` (the port of examples/caustic_render.py)
against the JAX package on the CPU in float64, at the example's CI size in
tests/test_examples.py (2048 rays in blocks of 512, a 32 x 32 image,
``mesh_steps=8``): the same numpy rays through the same Morton-sorted water
surface, streamed by each package's ``trace_streamed`` with
``fresnel_intensity_reaction`` and the intensity-weighted landing
histogram.  State counts equal, the total landed weight within rtol 1e-12,
every bin within rtol 1e-12 except bins beside a landing within 1e-9 of a
bin edge (or clamped in from outside the image).  Also the block
generator's reproducibility, the float64 image's order independence, and
the conversion helpers of the reactions' parameters.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu import operations as jop
from tensorflowraytrace_tpu.models import acceleration as j_acc
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import FINISHED, scenes3d
from tensorflowraytrace_tpu_torch.engine import trace
from tensorflowraytrace_tpu_torch.utils import convert
from torch_reactions_common import on_cpu  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("on_cpu")
F64 = torch.float64
N_RAYS, BLOCK, RES, STEPS = 2048, 512, 32, 8


def load_example(name):
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sun_rays_np(n, seed=5):
    """The example's sun block drawn by numpy: ``(p0, p1)``."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-scenes3d.SUN_HALF, scenes3d.SUN_HALF, (n, 2))
    p0 = np.concatenate([xy, np.ones((n, 1))], 1)
    return p0, p0 + [0.0, 0.0, -1.0]


def test_caustic_matches_jax_stream():
    ex = load_example("caustic_render")
    p0, p1 = sun_rays_np(N_RAYS)

    # the JAX example's scene, Morton-sorted as the port sorts it
    surf, _ = j_acc.morton_sort_triangles(ex.water_surface(STEPS, 0.08,
                                                           jnp.float64))
    scene = JScene3D.build(optical=[surf], targets=[ex.pool_floor(
        scenes3d.POOL_HALF + 1.0, 3.0, jnp.float64)])
    jrays = JRaySet.make(p0, p1, 550.0, dtype=jnp.float64).with_field(
        "intensity", jnp.ones(N_RAYS))
    extent = ((-scenes3d.SUN_HALF, scenes3d.SUN_HALF),) * 2
    init, fn = j_engine.landing_histogram_fold(
        extent, RES, dtype=jnp.float64, weight_field="intensity")
    jres = j_engine.trace_streamed(
        jrays, scene, (j_mats.vacuum, j_mats.build_constant_material(
            ex.N_WATER)), JTraceConfig(max_bounces=2),
        reaction=jop.fresnel_intensity_reaction(), fold_fn=fn,
        fold_init=init, fold_fields=True, block_size=BLOCK,
        remat_blocks=False)
    j_img = np.asarray(jres.fold)

    rays = convert.rayset_from_numpy(p0, p1, 550.0, fields={
        "intensity": np.ones(N_RAYS)}, dtype=F64, device="cpu")
    out = scenes3d.caustic_render(N_RAYS, BLOCK, RES, STEPS, dtype=F64,
                                  device="cpu", rays=rays, verbose=False)
    img = out["image"].numpy()
    assert out["state_counts"] == [int(c) for c in np.asarray(
        jres.state_counts)]
    assert out["state_counts"][FINISHED] == N_RAYS
    np.testing.assert_allclose(img.sum(), j_img.sum(), rtol=1e-12)
    assert abs(out["mean_transmission"] - scenes3d.T_NORMAL) < 0.02

    # bins beside a landing within 1e-9 of an edge may differ
    render = scenes3d.CausticRender(BLOCK, RES, STEPS, dtype=F64,
                                    device="cpu")
    with torch.no_grad():
        res = trace(rays, render.scene, scenes3d.CAUSTIC_MATERIALS,
                    render.cfg, reaction=render.reaction)
    xy = res.rays.p1[:, :2].numpy()
    edges = np.linspace(-scenes3d.SUN_HALF, scenes3d.SUN_HALF, RES + 1)
    near = np.abs(xy[..., None] - edges).min(-1) < 1e-9
    near |= np.abs(xy) > scenes3d.SUN_HALF
    exempt = np.zeros((RES, RES), bool)
    for x, y in xy[near.any(1)]:
        ix = np.clip(np.searchsorted(edges, x) - 1, 0, RES - 1)
        iy = np.clip(np.searchsorted(edges, y) - 1, 0, RES - 1)
        exempt[max(iy - 1, 0):iy + 2, max(ix - 1, 0):ix + 2] = True
    assert not exempt.all()
    np.testing.assert_allclose(img[~exempt], j_img[~exempt], rtol=1e-12,
                               atol=1e-12)


def test_caustic_blocks_and_exact_image():
    """Block ``i`` is a pure function of the seed and ``i``; the float64
    image of a 2-block stream equals one trace's of the same rays bit for
    bit (exact sums of float32 weights), as chip_smoke phase 17a checks on
    the card."""
    render = scenes3d.CausticRender(256, RES, 4, device="cpu",
                                    image_dtype=F64)
    a, b = render.block(1), render.block(1)
    assert torch.equal(a.p0, b.p0) and not torch.equal(a.p0,
                                                       render.block(0).p0)
    assert float(a.p0[:, :2].abs().max()) <= scenes3d.SUN_HALF
    assert torch.equal(a.p1[:, 2], torch.zeros(256))
    stream = render(2)
    both = convert.rayset_from_numpy(
        torch.cat([render.block(0).p0, render.block(1).p0]).numpy(),
        torch.cat([render.block(0).p1, render.block(1).p1]).numpy(), 550.0,
        fields={"intensity": np.ones(512)}, dtype=torch.float32,
        device="cpu")
    init, fn = render.fold
    with torch.no_grad():
        one = trace(both, render.scene, scenes3d.CAUSTIC_MATERIALS,
                    render.cfg, reaction=render.reaction, fold_fn=fn,
                    fold_init=init, fold_fields=True)
    assert torch.equal(stream.fold, one.fold)
    counts = [int((one.rays.state == c).sum()) for c in range(4)]
    assert stream.state_counts.tolist() == counts


def test_reaction_parameters_from_numpy():
    key = np.asarray(jax.random.PRNGKey(3))
    assert convert.seed_from_jax_key(key) == (int(key[0]) << 32) | int(
        key[1])
    with pytest.raises(ValueError):
        convert.seed_from_jax_key(np.zeros(3, np.uint32))
    tables = convert.surface_tables_from_numpy(
        {"segments": np.array([0, -1]), "arcs": (np.ones(2), np.zeros(2))},
        dtype=F64, device="cpu")
    assert tables["segments"].dtype == F64 and len(tables["arcs"]) == 2
    stacks = convert.stacks_from_numpy(
        [[(np.float64(1.38), np.array(99.6)), (np.ones(3), 2.0)]],
        dtype=F64, device="cpu")
    assert stacks[0][0] == (1.38, 99.6)
    assert stacks[0][1][0].dtype == F64 and stacks[0][1][1] == 2.0
    specs = convert.gratings_from_numpy(
        [(np.float64(900.0), np.int64(2), "reflection", [0.0, 1.0, 0.0])],
        dtype=F64, device="cpu")
    assert specs[0][:3] == (900.0, 2, "reflection")
    assert specs[0][3].dtype == F64
