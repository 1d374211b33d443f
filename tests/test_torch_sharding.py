"""The port's data parallelism (``parallel/sharding.py``,
``Optimizer(mesh=...)``) against the JAX package's, on the CPU in float64.

``streamed.dryrun`` runs two gloo ranks in subprocesses (one subprocess
call, the file's only one) on its "tiny" workload: ``parallel_trace`` of
256 numpy-made rays through an 8 x 6-ring guide (128 bounces under
``early_exit``; the landing sum reduced by "sum", "max", "min" and "none",
and the per-ray path length), ``parallel_trace_streamed`` of the same rays
in blocks of 48 (ragged on each rank), ``parallel_streamed_value_and_grad``
over 3 blocks of 64 rays of the 6 x 6-ring guide (ragged over 2 ranks), and
one ``Optimizer(mesh=...)`` step; and a one-process control, which it
checks them against.  Here the printed numbers are held to the JAX
package's ``parallel_trace``, ``parallel_trace_streamed`` and
``parallel_streamed_value_and_grad`` on conftest's 8-device mesh over the
same rays (folds within rtol 1e-12, counts and states exactly), and the
optimizer step to the summed single-process step.  A one-rank gloo group in
this process runs ``streamed.train_guide`` and ``streamed.sharded_guide``
with a mesh against their single-process runs.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu.models import acceleration as j_acc
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu.parallel import sharding as j_par
from tensorflowraytrace_tpu_torch import FINISHED, config, streamed
from tensorflowraytrace_tpu_torch.optim import Optimizer, _apply_param_update
from tensorflowraytrace_tpu_torch.parallel import sharding as t_par

ROOT = Path(__file__).resolve().parents[1]
F64 = jnp.float64
J_MATS = (j_mats.vacuum, j_mats.acrylic)
TINY = streamed.DRYRUN_SIZES["tiny"]
WORLD = 2


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


@pytest.fixture(scope="module")
def dryrun_proc():
    """The dryrun's subprocess, started first so that it runs while this
    process compiles the JAX references."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorflowraytrace_tpu_torch.streamed",
         "dryrun", "--world", str(WORLD), "--backend", "gloo", "--device",
         "cpu", "--size", "tiny"], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def dryrun_out(dryrun_proc, jax_trace, jax_vag):
    """The dryrun's JSON line, read after the JAX references are made."""
    text = dryrun_proc.communicate(timeout=120)[0]
    assert dryrun_proc.returncode == 0, text
    return json.loads(text.strip().splitlines()[-1])


def j_long_guide():
    theta, z_res = TINY["trace_guide"]
    guide = j_bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 40.0), minimum_radius=0.3,
        theta_res=theta, z_res=z_res, rotationally_symmetric=True,
        initial_taper=(0.7, 0.0), mat_in=1, mat_out=0, dtype=F64)
    surf, _ = j_acc.morton_sort_triangles(guide.build(guide.init_params()))
    return JScene3D.build(optical=[surf], targets=[j_quad(40.05)])


def j_quad(z):
    half = 0.35
    return JTriangleSet.make(
        [[-half, -half, z], [half, half, z]],
        [[half, -half, z], [-half, half, z]],
        [[half, half, z], [-half, -half, z]], dtype=F64)


def j_rays(p0, p1):
    return JRaySet.make(jnp.asarray(p0), jnp.asarray(p1), 575.0, dtype=F64)


def radius2(p1):
    return p1[:, 0] ** 2 + p1[:, 1] ** 2


@pytest.fixture(scope="module")
def jax_trace(dryrun_proc):
    """JAX's parallel_trace and parallel_trace_streamed of the dryrun's rays
    on the 8-device mesh, and its trace of each rank's half alone."""
    mesh = j_par.ray_mesh(8)
    scene = j_long_guide()
    rays = j_rays(*streamed.entrance_rays_np(TINY["trace_rays"],
                                             streamed.DRYRUN_SEED))
    cfg = JTraceConfig(max_bounces=TINY["trace_bounces"], early_exit=True)
    n_local = TINY["trace_rays"] // 8
    init_l, fn_l = j_engine.landing_sum_fold(radius2, F64)
    init_p, fn_p = j_engine.path_length_fold(n_local, F64)

    def fold(acc, record):
        return (fn_l(acc[0], record), fn_p(acc[1], record))

    res = j_par.parallel_trace(j_par.shard_rays(rays, mesh), scene, J_MATS,
                               cfg, mesh, fold_fn=fold,
                               fold_init=(init_l, init_p))
    streamed_res = j_par.parallel_trace_streamed(
        j_par.shard_rays(rays, mesh), scene, J_MATS,
        JTraceConfig(max_bounces=TINY["trace_bounces"]), mesh=mesh,
        fold_fn=fn_l, fold_init=init_l, block_size=TINY["stream_block"])
    k = TINY["trace_rays"] // WORLD
    halves = [j_engine.trace(
        jax.tree.map(lambda a: a[r * k:(r + 1) * k], rays), scene, J_MATS,
        cfg, fold_fn=fn_l, fold_init=init_l) for r in range(WORLD)]
    return {"state": np.asarray(res.rays.state),
            "fold": float(res.fold[0]), "path": np.asarray(res.fold[1]),
            "n_bounces": int(res.n_bounces),
            "streamed_fold": float(streamed_res.fold),
            "streamed_counts": np.asarray(streamed_res.state_counts).tolist(),
            "partials": [float(h.fold) for h in halves],
            "half_depths": [int(h.n_bounces) for h in halves]}


@pytest.fixture(scope="module")
def jax_vag(dryrun_proc):
    """JAX's parallel_streamed_value_and_grad of the dryrun's block loss on
    the 8-device mesh (3 blocks: the block grid is padded)."""
    theta, z_res = TINY["vag_guide"]
    guide = j_bd.ParametricCylindricalGuide(
        (0.0, 0.0, 0.0), (0.0, 0.0, 6.0), minimum_radius=0.3,
        theta_res=theta, z_res=z_res, rotationally_symmetric=True,
        initial_taper=(0.7, 0.0), mat_in=1, mat_out=0, dtype=F64)
    target = j_quad(6.05)
    n_blocks, block = TINY["vag_blocks"], TINY["vag_block"]
    blocks = [streamed.entrance_rays_np(
        block, streamed.fold_in(streamed.DRYRUN_SEED, i))
        for i in range(n_blocks)]
    p0 = jnp.asarray(np.stack([b[0] for b in blocks]))
    p1 = jnp.asarray(np.stack([b[1] for b in blocks]))
    cfg = JTraceConfig(max_bounces=TINY["vag_bounces"], remat=True)
    exit_center = jnp.asarray([0.0, 0.0, 6.05], F64)

    def block_loss(params, i, shift):
        scene = JScene3D.build(optical=[guide.build(params)],
                               targets=[target])
        res = j_engine.trace(j_rays(p0[i], p1[i]), scene, J_MATS, cfg)
        d2 = jnp.sum((res.rays.p1 - (exit_center + shift)) ** 2, axis=1)
        return jnp.sum(jnp.where(res.rays.state != FINISHED, d2, 0.0))

    run = j_par.parallel_streamed_value_and_grad(
        block_loss, n_blocks, mesh=j_par.ray_mesh(8))
    value, grad = run(guide.init_params(), jnp.asarray(streamed.VAG_SHIFT))
    return float(value), np.asarray(grad)


def rank_concat(out, key):
    return np.concatenate([r["trace"][key] for r in out["ranks"]])


def test_parallel_trace_matches_jax(dryrun_out, jax_trace):
    """The ranks' shards, gathered, are JAX's sharded trace: states exactly,
    per-ray path lengths within rtol 1e-12; the summed landing fold within
    rtol 1e-12; the counts exactly."""
    np.testing.assert_array_equal(rank_concat(dryrun_out, "state"),
                                  jax_trace["state"])
    np.testing.assert_allclose(rank_concat(dryrun_out, "path"),
                               jax_trace["path"], rtol=1e-12)
    for r in dryrun_out["ranks"]:
        np.testing.assert_allclose(r["trace"]["fold"][0], jax_trace["fold"],
                                   rtol=1e-12)
    counts = np.sum([r["trace"]["counts"] for r in dryrun_out["ranks"]], 0)
    expect = [int((jax_trace["state"] == c).sum()) for c in range(4)]
    assert counts.tolist() == expect == dryrun_out["control"]["trace"]["counts"]


def test_fold_reduce_max_min_none(dryrun_out, jax_trace):
    """"max", "min" and "none" reduce the ranks' partial landing sums: the
    JAX trace of each rank's half alone gives the partials."""
    partials = jax_trace["partials"]
    assert partials[0] != partials[1]
    for r in dryrun_out["ranks"]:
        got = r["trace"]["fold"]
        np.testing.assert_allclose(got[1], max(partials), rtol=1e-12)
        np.testing.assert_allclose(got[2], min(partials), rtol=1e-12)
        np.testing.assert_allclose(got[3], partials[0], rtol=1e-12)


def test_early_exit_reports_the_global_depth(dryrun_out, jax_trace):
    """Under early_exit each rank stops at its own depth, and n_bounces is
    the largest: JAX's over the 8 devices, and below the bounce budget."""
    depths = jax_trace["half_depths"]
    assert depths[0] != depths[1]
    for r in dryrun_out["ranks"]:
        assert r["trace"]["n_bounces"] == jax_trace["n_bounces"] == max(depths)
    assert jax_trace["n_bounces"] < TINY["trace_bounces"]


def test_parallel_trace_streamed_matches_jax(dryrun_out, jax_trace):
    """Each rank streams its 128 rays in blocks of 48 (the last one ragged);
    the fold sums and the counts are summed over the ranks."""
    for r in dryrun_out["ranks"]:
        st = r["streamed"]
        np.testing.assert_allclose(st["fold"], jax_trace["streamed_fold"],
                                   rtol=1e-12)
        assert st["counts"] == jax_trace["streamed_counts"]
        assert st["n_rays"] == TINY["trace_rays"]


def test_parallel_streamed_value_and_grad_matches_jax(dryrun_out, jax_vag):
    """3 blocks over 2 ranks (rank 0 takes blocks 0 and 2, rank 1 block 1)
    against JAX's 8-device grid: the value within rtol 1e-12, the gradient
    within rtol 1e-10."""
    value, grad = jax_vag
    for r in dryrun_out["ranks"]:
        np.testing.assert_allclose(r["vag"]["value"], value, rtol=1e-12)
        np.testing.assert_allclose(r["vag"]["grad"], grad, rtol=1e-10,
                                   atol=1e-10 * np.abs(grad).max())


def test_ranks_agree_with_the_one_process_control(dryrun_out):
    """``dryrun`` checked the ranks against its control (it raises
    otherwise); the relative errors it measured are float64 rounding, and
    each rank's slots hash as the control's trace of its shard and as its
    slice of the control's trace of all the rays."""
    assert set(dryrun_out["errors"]) == {
        "trace_sum", "streamed", "vag_value", "vag_grad", "step_error",
        "step_velocity", "step_params"}
    assert all(e <= 1e-12 for e in dryrun_out["errors"].values())
    control = dryrun_out["control"]["trace"]
    for r, shard, cut in zip(dryrun_out["ranks"], control["shards"],
                             control["whole_slices"]):
        assert all(r["trace"][k] == shard[k] == cut[k]
                   for k in ("state_sha", "p1_sha", "path_sha"))


def test_mesh_optimizer_step_matches_summed_single_process(dryrun_out):
    """One ``Optimizer(mesh=...)`` step equals the single-process update
    pipeline applied to the loss and gradient summed over the ranks'
    generators (``split_keys``: seeds ``rank_seed(0, r)``), replayed
    here."""
    prob = streamed.DryrunProblem("tiny", "cpu")
    p = prob.guide.init_params()
    error, grad = 0.0, torch.zeros_like(p)
    for r in range(WORLD):
        gen = torch.Generator().manual_seed(t_par.rank_seed(0, r))
        leaf = p.detach().requires_grad_(True)
        loss = prob.step_loss([leaf], gen)
        error += float(loss.detach())
        grad = grad + torch.autograd.grad(loss, [leaf])[0]
    opt = prob.optimizer()
    with torch.no_grad():
        p_ref, v_ref = _apply_param_update(
            p, grad, torch.zeros_like(p), 1.0, opt.momentum, 1.0,
            opt.learning_rate, opt.clip_mode, opt.clip_scale, opt.grad_clip,
            None, None)
    assert bool((v_ref != 0).any())
    for r in dryrun_out["ranks"]:
        np.testing.assert_allclose(r["step"]["error"], error, rtol=1e-12)
        np.testing.assert_allclose(r["step"]["params"], p_ref.numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(r["step"]["velocity"], v_ref.numpy(),
                                   rtol=1e-12, atol=1e-15)


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process."""
    t_par.init_multihost("gloo", init_method="tcp://localhost:"
                         f"{streamed.free_port()}", world_size=1, rank=0)
    try:
        yield t_par.ray_mesh()
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_equals_single_process(one_rank_group):
    """On one rank the mesh paths are the single-process ones: the streamed
    training and the sharded training give the same losses, the shards and
    replicas are the inputs."""
    mesh = one_rank_group
    assert (mesh.rank, mesh.world_size, mesh.device.type) == (0, 1, "cpu")
    kw = dict(rays_per_step=1024, block=256, steps=2, bounces=4, theta_res=6,
              z_res=6, dtype=torch.float64, verbose=False)
    losses_mesh, params_mesh, _ = streamed.train_guide(mesh=mesh, **kw)
    losses, params, _ = streamed.train_guide(**kw)
    np.testing.assert_allclose(losses_mesh, losses, rtol=1e-12)
    np.testing.assert_allclose(params_mesh.numpy(), params.numpy(),
                               rtol=1e-12)
    kw = dict(rays=512, steps=3, bounces=4, dtype=torch.float64,
              verbose=False)
    errors_mesh, _, _ = streamed.sharded_guide(mesh=mesh, **kw)
    errors, _, _ = streamed.sharded_guide(**kw)
    np.testing.assert_array_equal(errors_mesh, errors)
    assert errors[-1] < errors[0]

    prob = streamed.DryrunProblem("tiny", "cpu")
    shard = t_par.shard_rays(prob.rays, mesh)
    assert torch.equal(shard.p0, prob.rays.p0)
    assert torch.equal(t_par.shard_rays_from_local(prob.rays, mesh).p1,
                       prob.rays.p1)
    scene = t_par.replicate(prob.trace_scene, mesh)
    assert torch.equal(scene.triangles.vp, prob.trace_scene.triangles.vp)
    host = t_par.replicate_from_host({"a": np.arange(3.0), "b": [True]}, mesh)
    assert host["a"].tolist() == [0.0, 1.0, 2.0] and host["b"][0].item()
    gen = t_par.split_keys(0, mesh)
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=torch.Generator()
                                  .manual_seed(0)))


def test_shard_rays_needs_an_even_split(one_rank_group, monkeypatch):
    prob = streamed.DryrunProblem("tiny", "cpu")
    mesh = t_par.RayMesh(group=None, rank=0, world_size=3,
                         device=torch.device("cpu"))
    with pytest.raises(ValueError, match="split evenly"):
        t_par.shard_rays(prob.rays, mesh)


def test_no_fallback_and_pass_key_rules(monkeypatch):
    """NCCL without CUDA raises, and never turns into gloo; ``mesh=``
    needs ``pass_key=True``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA"):
        t_par.init_multihost(backend="nccl", init_method="tcp://localhost:1",
                             world_size=1, rank=0)
    assert not dist.is_initialized()
    mesh = t_par.RayMesh(group=None, rank=0, world_size=1,
                         device=torch.device("cpu"))
    with pytest.raises(ValueError, match="pass_key"):
        Optimizer(lambda p: p[0].sum(), [np.zeros(3)], mesh=mesh,
                  pass_key=False)
    with pytest.raises(ValueError, match="n_blocks must be positive"):
        t_par.parallel_streamed_value_and_grad(lambda p, i: p, 0, mesh=mesh)
