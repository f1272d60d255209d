"""Multi-device sharding tests on the 8-virtual-CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_limx_control_tpu.core.config import (ControllerConfig, GaitParams,
                                              SRBDConfig)
from mpc_limx_control_tpu.control import rollout as ro
from mpc_limx_control_tpu.parallel import mesh as pmesh


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(
        ControllerConfig(), mode="walk",
        gait=dataclasses.replace(GaitParams(), swing_time=0.3,
                                 stance_time=0.3),
        srbd=SRBDConfig.walking(), desired_velocity=(0.5, 0.0, 0.0))


def test_mesh_has_8_devices():
    mesh = pmesh.make_mesh()
    assert mesh.devices.size == 8


def test_initialize_multihost_noop():
    # without a coordinator this is a no-op returning the device count
    assert pmesh.initialize_multihost() == len(jax.devices())


def test_sharded_step_matches_single_device(cfg):
    B = 16
    mesh = pmesh.make_mesh()
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    # perturb scenarios so they differ
    key = jax.random.PRNGKey(0)
    s0 = s0.replace(xi=s0.xi.at[:, 9].add(
        0.05 * jax.random.normal(key, (B,), jnp.float32)))

    step = pmesh.sharded_batch_step(cfg, mesh)
    s_sharded = pmesh.shard_leading(s0, mesh)
    out_sharded, stats = step(s_sharded, jnp.asarray(0.0))

    out_local, metrics = jax.vmap(
        lambda s: ro.plant_step(cfg, s, jnp.asarray(0.0)))(s0)
    np.testing.assert_allclose(np.asarray(out_sharded.xi),
                               np.asarray(out_local.xi), atol=1e-4)
    np.testing.assert_allclose(float(stats["mean_height"]),
                               float(jnp.mean(metrics["height"])),
                               rtol=1e-6)


def test_shard_map_step_collectives(cfg):
    B = 8
    mesh = pmesh.make_mesh()
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    step = pmesh.shard_map_step(cfg, mesh)
    s_sharded = pmesh.shard_leading(s0, mesh)
    out, stats = step(s_sharded, jnp.asarray(0.0))
    assert np.isfinite(float(stats["mean_height"]))
    assert out.xi.shape == (B, 13)


def test_sharding_preserved_across_steps(cfg):
    B = 8
    mesh = pmesh.make_mesh()
    s0 = pmesh.shard_leading(ro.initial_plant_state(cfg, batch=(B,)), mesh)
    step = pmesh.sharded_batch_step(cfg, mesh)
    s1, _ = step(s0, jnp.asarray(0.0))
    s2, _ = step(s1, jnp.asarray(1.0))
    spec = s2.xi.sharding.spec
    assert spec == jax.sharding.PartitionSpec("data")


def test_sharded_rollout_matches_single_device(cfg):
    """Multi-STEP rollout under sharding: a lax.scan of the full tick
    inside one sharded jit must reproduce the unsharded rollout bit-class
    identically (per-shard checksum equality)."""
    B = 16
    steps = 20
    mesh = pmesh.make_mesh()
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    key = jax.random.PRNGKey(2)
    s0 = s0.replace(xi=s0.xi.at[:, 9].add(
        0.05 * jax.random.normal(key, (B,), jnp.float32)))

    run = pmesh.sharded_rollout(cfg, mesh, steps)
    final_sh, stats = run(pmesh.shard_leading(s0, mesh), jnp.asarray(0.0))

    final_1, metrics = jax.jit(
        lambda s: ro.batched_rollout(cfg, s, steps))(s0)

    np.testing.assert_allclose(np.asarray(final_sh.xi),
                               np.asarray(final_1.xi), atol=1e-4)
    # per-step replicated stats match the single-device means
    np.testing.assert_allclose(
        np.asarray(stats["mean_height"]),
        np.asarray(jnp.mean(metrics["height"], axis=0)), atol=1e-5)
    assert stats["mean_height"].shape == (steps,)


def test_shard_map_rollout_matches(cfg):
    B = 8
    steps = 10
    mesh = pmesh.make_mesh()
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    run = pmesh.shard_map_rollout(cfg, mesh, steps)
    final, stats = run(pmesh.shard_leading(s0, mesh), jnp.asarray(0.0))
    final_1, metrics = jax.jit(
        lambda s: ro.batched_rollout(cfg, s, steps))(s0)
    np.testing.assert_allclose(np.asarray(final.xi),
                               np.asarray(final_1.xi), atol=1e-4)
    np.testing.assert_allclose(
        float(stats["mean_height"][-1]),
        float(jnp.mean(metrics["height"][:, -1])), rtol=1e-5)


def test_walking_kernel_under_sharding(monkeypatch):
    """The Triton walking-QP kernel (Pallas interpreter here) composes
    with both sharding styles: its partitioning rule splits the scenario
    axis across the mesh, and a 5-tick rollout on 4 devices equals the
    one-device rollout.  Horizon 8 keeps the interpreted kernel small."""
    import functools

    from mpc_limx_control_tpu.ops import mpc_fused_pallas as fused

    monkeypatch.setattr(fused, "use_kernel", lambda nu: nu == 3)
    monkeypatch.setattr(fused, "fused_walking_qp", functools.partial(
        fused.fused_walking_qp, interpret=True))
    wcfg = ControllerConfig.walking()
    wcfg = dataclasses.replace(
        wcfg, srbd=dataclasses.replace(wcfg.srbd, horizon=8))
    B, steps = 8, 5
    mesh = pmesh.make_mesh(jax.devices()[:4])
    s0 = ro.initial_plant_state(wcfg, batch=(B,))
    s0 = s0.replace(xi=s0.xi.at[:, 9].add(
        0.05 * jax.random.normal(jax.random.PRNGKey(3), (B,), jnp.float32)))
    ref, _ = jax.jit(lambda s: ro.batched_rollout(wcfg, s, steps))(s0)
    for make in (pmesh.sharded_rollout, pmesh.shard_map_rollout):
        final, stats = make(wcfg, mesh, steps)(
            pmesh.shard_leading(s0, mesh), jnp.asarray(0.0))
        np.testing.assert_allclose(np.asarray(final.xi),
                                   np.asarray(ref.xi), atol=1e-5)
        assert final.xi.sharding.spec == jax.sharding.PartitionSpec("data")
