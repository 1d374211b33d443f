"""The port's streaming (``engine.trace_streamed``,
``engine.streamed_value_and_grad``) against the JAX package's, on the CPU
in float64, and ``streamed.trace_guide`` / ``streamed.train_guide`` at the
toy sizes of tests/test_examples.py.

Both packages trace the same numpy-made rays through two scenes: the 2D
wedge guide of tests/test_streamed.py and an 8 x 6-ring cylindrical 3D
guide (98 triangles with the target).  Folds and values within rtol 1e-12,
gradients within rtol 1e-10, state counts exactly.  A block generator that
draws from one generator shared across blocks shows that the backward of
``remat_blocks`` traces the rays the forward traced.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu.models import acceleration as j_acc
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import (
    RaySet, Scene2D, SegmentSet, TraceConfig, config, streamed,
)
from tensorflowraytrace_tpu_torch import engine as t_engine
from tensorflowraytrace_tpu_torch.ops import materials as t_mats

PI = math.pi
F64 = torch.float64
J_MATS = (j_mats.vacuum, j_mats.acrylic)
T_MATS = (t_mats.vacuum, t_mats.acrylic)
BOUNCES = 12


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU, on
    one thread: their traces issue thousands of small operations, which
    torch's thread pool slows by orders of magnitude when the test workers
    hold more threads than the machine has cores."""
    previous = config.set_default_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_default_device(previous)


def wedge_rays_np(n, seed):
    """tests/test_streamed.py's Lambertian-ish beam down the wedge guide,
    drawn by numpy: ``(p0, p1)``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.08, 0.08, n)
    a = -PI / 2 + rng.uniform(-0.35, 0.35, n) * PI
    p0 = np.stack([x, np.full(n, 3.9)], 1)
    return p0, p0 + np.stack([np.cos(a), np.sin(a)], 1)


def scene_2d(pkg):
    SegSet, Scene = (JSegmentSet, JScene2D) if pkg == "jax" else (SegmentSet,
                                                                  Scene2D)
    dtype = jnp.float64 if pkg == "jax" else F64
    guide = SegSet.make([[-0.1, -4.0], [0.0, 4.0]], [[0.0, 4.0], [0.1, -4.0]],
                        mat_in=1, mat_out=0, dtype=dtype)
    tgt = SegSet.make([[-0.5, -4.2]], [[0.5, -4.2]], dtype=dtype)
    return Scene.build(optical_segments=[guide], target_segments=[tgt])


def scene_3d(pkg):
    if pkg == "torch":
        return streamed.long_guide_scene(8, 6, F64, "cpu")
    guide = j_bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 40.0), minimum_radius=0.3, theta_res=8,
        z_res=6, rotationally_symmetric=True, initial_taper=(0.7, 0.0),
        mat_in=1, mat_out=0, dtype=jnp.float64)
    surf, _ = j_acc.morton_sort_triangles(guide.build(guide.init_params()))
    half, z = 0.35, 40.05
    target = JTriangleSet.make(
        [[-half, -half, z], [half, half, z]],
        [[half, -half, z], [-half, half, z]],
        [[half, half, z], [-half, -half, z]], dtype=jnp.float64)
    return JScene3D.build(optical=[surf], targets=[target])


SCENES = {"2d": (scene_2d, wedge_rays_np), "3d": (scene_3d,
                                                  streamed.entrance_rays_np)}


def rays_both(kind, n, seed=0):
    p0, p1 = SCENES[kind][1](n, seed)
    return (JRaySet.make(jnp.asarray(p0), jnp.asarray(p1), 575.0,
                         dtype=jnp.float64),
            RaySet.make(p0, p1, 575.0, dtype=F64))


def landing(p1):
    return p1[:, 0] ** 2


def counts_of(state):
    state = np.asarray(state)
    return [int((state == c).sum()) for c in range(4)]


N_RAGGED, BLOCK = 400, 128


@functools.lru_cache(maxsize=None)
def jax_stream(kind):
    """JAX's stream of the 400 rays of ``kind`` in blocks of 128 (4 blocks,
    the last padded with 112 DEAD slots), folding the landing sum and the
    per-ray path length; one merge sums the first over the blocks and
    concatenates the second, so one program serves both tests."""
    j_rays, _ = rays_both(kind, N_RAGGED)
    init_l, fn_l = j_engine.landing_sum_fold(landing, jnp.float64)
    init_p, fn_p = j_engine.path_length_fold(BLOCK, jnp.float64)

    def fold(acc, record):
        return (fn_l(acc[0], record), fn_p(acc[1], record))

    def merge(stacked):
        return (jnp.sum(stacked[0], axis=0),
                stacked[1].reshape(-1)[:N_RAGGED])

    res = j_engine.trace_streamed(
        j_rays, SCENES[kind][0]("jax"), J_MATS,
        JTraceConfig(max_bounces=BOUNCES), fold_fn=fold,
        fold_init=(init_l, init_p), block_size=BLOCK, merge=merge)
    return (float(res.fold[0]), np.asarray(res.fold[1]),
            np.asarray(res.state_counts).tolist())


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_sum_fold_ragged_tail_matches_jax(kind):
    """400 rays in blocks of 128: 4 blocks, the last padded with 112 DEAD
    slots that neither the fold nor the counts see."""
    ref_fold, _, ref_counts = jax_stream(kind)
    _, t_rays = rays_both(kind, N_RAGGED)
    t_init, t_fn = t_engine.landing_sum_fold(landing, F64)
    res = t_engine.trace_streamed(
        t_rays, SCENES[kind][0]("torch"), T_MATS, TraceConfig(max_bounces=BOUNCES),
        fold_fn=t_fn, fold_init=t_init, block_size=BLOCK)
    assert (res.n_blocks, res.block_size, res.n_rays) == (4, BLOCK, N_RAGGED)
    np.testing.assert_allclose(float(res.fold), ref_fold, rtol=1e-12)
    assert res.state_counts.tolist() == ref_counts
    assert sum(res.state_counts.tolist()) == N_RAGGED
    assert int(res.counts_by_name["finished"]) == ref_counts[1]
    # and the port's own unstreamed trace
    full = t_engine.trace(t_rays, SCENES[kind][0]("torch"), T_MATS,
                          TraceConfig(max_bounces=BOUNCES), fold_fn=t_fn,
                          fold_init=t_init)
    assert res.state_counts.tolist() == counts_of(full.rays.state)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_concat_per_ray_fold_matches_jax(kind):
    _, ref_path, _ = jax_stream(kind)
    _, t_rays = rays_both(kind, N_RAGGED)
    t_init, t_fn = t_engine.path_length_fold(BLOCK, F64)
    res = t_engine.trace_streamed(
        t_rays, SCENES[kind][0]("torch"), T_MATS, TraceConfig(max_bounces=BOUNCES),
        fold_fn=t_fn, fold_init=t_init, block_size=BLOCK, merge="concat")
    assert res.fold.shape == (N_RAGGED,)
    np.testing.assert_allclose(res.fold.numpy(), ref_path, rtol=1e-12)
    # a callable merge gets the folds stacked by block
    stacked = t_engine.trace_streamed(
        t_rays, SCENES[kind][0]("torch"), T_MATS, TraceConfig(max_bounces=BOUNCES),
        fold_fn=t_fn, fold_init=t_init, block_size=BLOCK, merge=lambda f: f)
    assert stacked.fold.shape == (4, BLOCK)
    np.testing.assert_array_equal(stacked.fold.reshape(-1)[:N_RAGGED].numpy(),
                                  res.fold.numpy())


def test_block_generator_matches_jax():
    """rays as a callable: block i of numpy-made rays seeded i, in both
    packages, against the JAX stream and the port's one trace of the
    concatenated blocks."""
    block, n_blocks = 96, 3
    blocks = [wedge_rays_np(block, 10 + i) for i in range(n_blocks)]
    j_init, j_fn = j_engine.landing_sum_fold(landing, jnp.float64)
    t_init, t_fn = t_engine.landing_sum_fold(landing, F64)
    j_stack = [np.stack([b[k] for b in blocks]) for k in range(2)]

    def j_gen(i):
        return JRaySet.make(jnp.asarray(j_stack[0])[i],
                            jnp.asarray(j_stack[1])[i], 575.0,
                            dtype=jnp.float64)

    def t_gen(i):
        return RaySet.make(blocks[i][0], blocks[i][1], 575.0, dtype=F64)

    ref = j_engine.trace_streamed(
        j_gen, scene_2d("jax"), J_MATS, JTraceConfig(max_bounces=BOUNCES),
        fold_fn=j_fn, fold_init=j_init, block_size=block, n_blocks=n_blocks)
    res = t_engine.trace_streamed(
        t_gen, scene_2d("torch"), T_MATS, TraceConfig(max_bounces=BOUNCES),
        fold_fn=t_fn, fold_init=t_init, block_size=block, n_blocks=n_blocks)
    assert res.n_rays == block * n_blocks
    np.testing.assert_allclose(float(res.fold), float(ref.fold), rtol=1e-12)
    assert res.state_counts.tolist() == np.asarray(ref.state_counts).tolist()
    cat = RaySet.make(np.concatenate([b[0] for b in blocks]),
                      np.concatenate([b[1] for b in blocks]), 575.0, dtype=F64)
    full = t_engine.trace(cat, scene_2d("torch"), T_MATS,
                          TraceConfig(max_bounces=BOUNCES), fold_fn=t_fn,
                          fold_init=t_init)
    np.testing.assert_allclose(float(res.fold), float(full.fold), rtol=1e-12)


def shifted(rays, dx, ns):
    """``rays`` moved by ``dx`` along x (``ns``: jnp or torch)."""
    if ns is jnp:
        s = jnp.stack([dx, jnp.zeros_like(dx)])
    else:
        s = torch.stack([dx, torch.zeros_like(dx)])
    return dataclasses.replace(rays, p0=rays.p0 + s, p1=rays.p1 + s)


@functools.lru_cache(maxsize=None)
def jax_stream_gradient():
    """JAX's d(landing loss)/d(shift) through its stream (remat_blocks) of
    the 400 rays of :func:`test_gradient_through_stream_matches_jax`."""
    j_rays, _ = rays_both("2d", 400, seed=1)
    j_init, j_fn = j_engine.landing_sum_fold(landing, jnp.float64)

    def j_loss(dx):
        return j_engine.trace_streamed(
            shifted(j_rays, dx, jnp), scene_2d("jax"), J_MATS,
            JTraceConfig(max_bounces=BOUNCES), fold_fn=j_fn,
            fold_init=j_init, block_size=128).fold

    return float(jax.grad(j_loss)(jnp.asarray(0.01)))


@pytest.mark.parametrize("remat", [False, True])
def test_gradient_through_stream_matches_jax(remat):
    """d(landing loss)/d(shift) through the stream with remat_blocks (and
    the bounces' own remat), against JAX's and the port's unstreamed
    trace."""
    _, t_rays = rays_both("2d", 400, seed=1)
    t_init, t_fn = t_engine.landing_sum_fold(landing, F64)
    t_cfg = TraceConfig(max_bounces=BOUNCES, remat=remat)
    t_scene = scene_2d("torch")
    g_ref = jax_stream_gradient()
    dx = torch.tensor(0.01, dtype=F64, requires_grad=True)
    loss = t_engine.trace_streamed(
        shifted(t_rays, dx, torch), t_scene, T_MATS, t_cfg, fold_fn=t_fn,
        fold_init=t_init, block_size=128, remat_blocks=True).fold
    g = float(torch.autograd.grad(loss, dx)[0])
    full = t_engine.trace(shifted(t_rays, dx, torch), t_scene, T_MATS, t_cfg,
                          fold_fn=t_fn, fold_init=t_init).fold
    g_full = float(torch.autograd.grad(full, dx)[0])
    assert g != 0.0 and math.isfinite(g)
    np.testing.assert_allclose(g, g_ref, rtol=1e-10)
    np.testing.assert_allclose(g, g_full, rtol=1e-10)


def test_gradient_of_generated_stream_under_checkpoint():
    """The hazard of a generator under ``torch.utils.checkpoint``: the
    block generator draws from ONE generator shared across blocks (a second
    draw gives other rays), and its rays depend on the parameter.  The
    stream draws each block outside the checkpoint, so its gradient equals
    that of one trace of the blocks the forward drew, in order."""
    block, n_blocks = 128, 3
    scene = scene_2d("torch")
    cfg = TraceConfig(max_bounces=BOUNCES)
    init, fn = t_engine.landing_sum_fold(landing, F64)
    dx = torch.tensor(0.01, dtype=F64, requires_grad=True)

    def draws(gen):
        x = (torch.rand(block, generator=gen, dtype=F64) - 0.5) * 0.16
        a = -PI / 2 + (torch.rand(block, generator=gen, dtype=F64) - 0.5) * 0.7 * PI
        p0 = torch.stack([x, torch.full_like(x, 3.9)], 1)
        return p0, p0 + torch.stack([torch.cos(a), torch.sin(a)], 1)

    gen = torch.Generator().manual_seed(5)
    first, second = draws(gen), draws(gen)
    assert not torch.equal(first[0], second[0])  # the generator moves on

    def make_gen():
        g = torch.Generator().manual_seed(5)

        def block_rays(i):
            p0, p1 = draws(g)
            return shifted(RaySet.make(p0, p1, 575.0, dtype=F64), dx, torch)

        return block_rays

    calls = []
    real = t_engine.checkpoint

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    t_engine.checkpoint = counted
    try:
        loss = t_engine.trace_streamed(
            make_gen(), scene, T_MATS, cfg, fold_fn=fn, fold_init=init,
            block_size=block, n_blocks=n_blocks, remat_blocks=True).fold
        g = float(torch.autograd.grad(loss, dx)[0])
    finally:
        t_engine.checkpoint = real
    assert len(calls) == n_blocks
    gen = make_gen()
    blocks = [gen(i) for i in range(n_blocks)]
    cat = RaySet(p0=torch.cat([b.p0 for b in blocks]),
                 p1=torch.cat([b.p1 for b in blocks]),
                 wavelength=torch.cat([b.wavelength for b in blocks]),
                 state=torch.cat([b.state for b in blocks]))
    ref = t_engine.trace(cat, scene, T_MATS, cfg, fold_fn=fn, fold_init=init)
    g_ref = float(torch.autograd.grad(ref.fold, dx)[0])
    assert g != 0.0
    np.testing.assert_allclose(float(loss.detach()), float(ref.fold.detach()),
                               rtol=1e-12)
    np.testing.assert_allclose(g, g_ref, rtol=1e-10)


def test_no_grad_stream_adds_no_checkpoint(monkeypatch):
    """Under ``torch.no_grad()`` ``remat_blocks`` adds nothing."""
    calls = []
    real = t_engine.checkpoint
    monkeypatch.setattr(t_engine, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, t_rays = rays_both("2d", 200)
    init, fn = t_engine.landing_sum_fold(landing, F64)
    with torch.no_grad():
        t_engine.trace_streamed(t_rays, scene_2d("torch"), T_MATS,
                                TraceConfig(max_bounces=BOUNCES), fold_fn=fn,
                                fold_init=init, block_size=64,
                                remat_blocks=True)
    assert calls == []


@pytest.mark.parametrize("remat_blocks", [True, False])
def test_streamed_value_and_grad_matches_jax_and_fused(remat_blocks):
    """The port (which has no ``remat_blocks``: each block's backward
    follows its forward) against JAX's with and without its checkpoint,
    and against torch autograd of the fused sum."""
    block, n_blocks = 128, 4
    p0, p1 = wedge_rays_np(block * n_blocks, 2)
    j_p0 = jnp.asarray(p0.reshape(n_blocks, block, 2))
    j_p1 = jnp.asarray(p1.reshape(n_blocks, block, 2))
    j_scene, t_scene = scene_2d("jax"), scene_2d("torch")
    j_cfg = JTraceConfig(max_bounces=BOUNCES)
    t_cfg = TraceConfig(max_bounces=BOUNCES)

    def j_block_loss(tx, i):
        blk = JRaySet.make(j_p0[i], j_p1[i], 575.0, dtype=jnp.float64)
        init, fn = j_engine.landing_sum_fold(lambda q: (q[:, 0] - tx) ** 2,
                                             jnp.float64)
        return j_engine.trace(blk, j_scene, J_MATS, j_cfg, fold_fn=fn,
                              fold_init=init).fold

    def t_block_loss(params, i, shift):
        blk = RaySet.make(p0[i * block:(i + 1) * block],
                          p1[i * block:(i + 1) * block], 575.0, dtype=F64)
        init, fn = t_engine.landing_sum_fold(
            lambda q: (q[:, 0] - params[0] + shift) ** 2, F64)
        return t_engine.trace(blk, t_scene, T_MATS, t_cfg, fold_fn=fn,
                              fold_init=init).fold

    v_ref, g_ref = j_engine.streamed_value_and_grad(
        j_block_loss, n_blocks, remat_blocks=remat_blocks)(jnp.asarray(0.02))
    run = t_engine.streamed_value_and_grad(t_block_loss, n_blocks)
    params = [torch.tensor(0.02, dtype=F64)]
    v, g = run(params, 0.0)
    # against JAX within the engines' float64 parity (tests/
    # test_torch_deeptrace.py): one of these rays refracts near the critical
    # angle at its second bounce, which turns the two engines' last-bit
    # differences into 1.1e-10 of its landing point
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-9)
    np.testing.assert_allclose(float(g[0]), float(g_ref), rtol=1e-9)
    # torch autograd of the fused sum, with the pass-through argument
    leaf = params[0].clone().requires_grad_(True)
    fused = sum(t_block_loss([leaf], i, 0.003) for i in range(n_blocks))
    g_fused = torch.autograd.grad(fused, leaf)[0]
    v2, g2 = run(params, 0.003)
    np.testing.assert_allclose(float(v2), float(fused.detach()), rtol=1e-12)
    np.testing.assert_allclose(float(g2[0]), float(g_fused), rtol=1e-10)


@pytest.mark.parametrize("case", ["no_fold", "callable_without_n_blocks",
                                  "zero_blocks", "bad_merge"])
def test_value_errors(case):
    _, t_rays = rays_both("2d", 8)
    scene = scene_2d("torch")
    init, fn = t_engine.landing_sum_fold(landing, F64)
    if case == "no_fold":
        with pytest.raises(ValueError, match="fold"):
            t_engine.trace_streamed(t_rays, scene, T_MATS)
    elif case == "callable_without_n_blocks":
        with pytest.raises(ValueError, match="n_blocks"):
            t_engine.trace_streamed(lambda i: t_rays, scene, T_MATS,
                                    fold_fn=fn, fold_init=init)
    elif case == "zero_blocks":
        with pytest.raises(ValueError, match="n_blocks must be positive"):
            t_engine.streamed_value_and_grad(lambda p, i: p, 0)
    else:
        with pytest.raises(ValueError, match="merge"):
            t_engine.trace_streamed(t_rays, scene, T_MATS, fold_fn=fn,
                                    fold_init=init, merge="mean")


def test_keep_history_message_points_to_trace_streamed():
    """An absurd keep_history request fails at once, pointing at folds and
    trace_streamed (the JAX package's tests/test_streamed.py holds its
    own)."""
    _, t_rays = rays_both("2d", 8)
    n = 200_000_000
    big = RaySet(p0=t_rays.p0[:1].expand(n, 2), p1=t_rays.p1[:1].expand(n, 2),
                 wavelength=t_rays.wavelength[:1].expand(n),
                 state=t_rays.state[:1].expand(n))
    with pytest.raises(ValueError, match="trace_streamed"):
        t_engine.trace(big, scene_2d("torch"), T_MATS,
                       TraceConfig(max_bounces=50, keep_history=True))


def test_trace_guide_toy():
    """``streamed.trace_guide`` at the toy size of tests/test_examples.py
    (its plain searches on the CPU): two stream sizes, each checked; and
    the stream equals one trace of its blocks."""
    rows = streamed.trace_guide(n_rays=2048, block=512, bounces=6,
                                theta_res=8, z_res=12, scaling_points=2,
                                verbose=False)
    assert [r["n_rays"] for r in rows] == [1024, 2048]
    for r in rows:
        assert sum(r["state_counts"]) == r["n_rays"]
        assert r["state_counts"][1] > 0 and math.isfinite(r["fold"])
    stream = streamed.GuideTrace(512, 6, 8, 12, device="cpu")
    assert not stream.cfg.use_kernel and stream.cfg.max_bounces == 6
    res = stream(2)
    blocks = [stream.block(i) for i in range(2)]
    cat = RaySet(p0=torch.cat([b.p0 for b in blocks]),
                 p1=torch.cat([b.p1 for b in blocks]),
                 wavelength=torch.cat([b.wavelength for b in blocks]),
                 state=torch.cat([b.state for b in blocks]))
    init, fn = stream.fold
    full = t_engine.trace(cat, stream.scene, streamed.MATERIALS, stream.cfg,
                          fold_fn=fn, fold_init=init)
    np.testing.assert_allclose(float(res.fold), float(full.fold), rtol=1e-5)
    assert res.state_counts.tolist() == counts_of(full.rays.state)
    assert res.state_counts.tolist() == rows[0]["state_counts"]


def test_train_guide_toy():
    """``streamed.train_guide`` at the toy size of tests/test_examples.py:
    its loss falls, and its first step's loss is the sum of its four block
    losses at the initial guide."""
    losses, params, seconds = streamed.train_guide(
        rays_per_step=2048, block=512, steps=3, bounces=6, theta_res=6,
        z_res=6, dtype=F64, verbose=False)
    assert len(losses) == len(seconds) == 3 and losses[-1] < losses[0]
    assert bool(torch.isfinite(params).all())
    guide, block_loss = streamed.guide_block_loss(512, 6, 6, 6, F64, "cpu")
    with torch.no_grad():
        fused = sum(block_loss([guide.init_params()], i,
                               streamed.fold_in(7, 0)) for i in range(4))
    np.testing.assert_allclose(float(fused) / 2048, losses[0], rtol=1e-12)
