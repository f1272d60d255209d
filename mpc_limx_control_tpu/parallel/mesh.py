"""Device-mesh scaling: scenario-sharded batched MPC.

The reference's only "distribution" is ROS pub/sub plus a UDP link to one
robot (SURVEY.md §5).  This engine scales along the scenario batch axis
instead: thousands of simultaneous MPC problems laid out over a
`jax.sharding.Mesh` with a single ('data',) axis — per-scenario work is
tiny and independent, so plain data parallelism over the cards (joined
all to all by NVLink) is the natural mapping: cross-scenario
communication is only the reduction statistics.

Two styles are provided:

* :func:`sharded_batch_step` — GSPMD: jit with NamedSharding'd inputs;
  XLA inserts the collectives for cross-scenario reductions.
* :func:`shard_map_step` — explicit `shard_map` with `psum`'d stats, for
  when collective placement must be pinned by hand.

Multi-host: the same code runs under `jax.distributed.initialize()` with a
process-spanning mesh — jax.make_mesh handles the device order.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpc_limx_control_tpu.core.config import ControllerConfig
from mpc_limx_control_tpu.control import rollout as ro


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Bring up jax.distributed for a multi-host run and return the global
    device count.

    On single-host (or when no coordinator is configured) this is a no-op
    returning the local device count.  After initialization,
    :func:`make_mesh` over `jax.devices()` spans all hosts and the same
    sharded step functions run unchanged — per-host shards stay local,
    cross-host traffic is only the psum'd statistics.
    """
    if coordinator_address is None:
        import os
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    return len(jax.devices())


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              axis_name: str = "data") -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    # Auto axis type = classic GSPMD: the compiler propagates shardings and
    # inserts collectives (jax 0.9 defaults to Explicit, which would make
    # every constant/creation op inside the step demand explicit specs).
    return jax.make_mesh(
        (len(devices),), (axis_name,),
        axis_types=(jax.sharding.AxisType.Auto,), devices=devices)


def shard_leading(tree, mesh: Mesh, axis_name: str = "data"):
    """device_put every leaf with its leading axis split over the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.device_put(tree, sharding)


def replicate(tree, mesh: Mesh):
    return jax.device_put(tree, NamedSharding(mesh, P()))


def scenario_stats(metrics: dict) -> dict:
    """Cross-scenario reductions (global means/extremes + argmin-cost
    scenario).  Under a sharded jit these lower to cross-device
    collectives."""
    height = metrics["height"]
    residual = metrics["qp_residual"]
    cost = jnp.abs(height - jnp.mean(height))
    return {
        "mean_height": jnp.mean(height),
        "max_qp_residual": jnp.max(residual),
        "best_scenario": jnp.argmin(cost),
        "grf_mean_fz": jnp.mean(metrics["grf"][..., 2]
                                + metrics["grf"][..., 5]),
    }


def sharded_batch_step(cfg: ControllerConfig, mesh: Mesh,
                       axis_name: str = "data") -> Callable:
    """Jitted batched plant step with scenario sharding (GSPMD style).

    Returns step(state: PlantState[B,...], iteration) ->
    (PlantState, stats dict of replicated scalars).
    """
    data = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())

    @partial(jax.jit,
             in_shardings=(data, repl),
             out_shardings=(data, repl))
    def step(state, iteration):
        new_state, metrics = jax.vmap(
            lambda s: ro.plant_step(cfg, s, iteration))(state)
        return new_state, scenario_stats(metrics)

    return step


def sharded_rollout(cfg: ControllerConfig, mesh: Mesh, steps: int,
                    axis_name: str = "data") -> Callable:
    """Multi-step closed-loop rollout under scenario sharding: a lax.scan
    of the FULL controller tick inside one sharded jit — the deployment
    shape for long scaling runs (zero host round-trips per tick; the
    cross-scenario statistics are reduced across devices every step).

    Returns run(state[B,...], start_iteration) -> (final_state,
    stats-over-time dict of replicated [steps] arrays).
    """
    data = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())

    @partial(jax.jit,
             in_shardings=(data, repl),
             out_shardings=(data, repl))
    def run(state, start_iteration):
        def body(s, it):
            s2, metrics = jax.vmap(
                lambda ss: ro.plant_step(cfg, ss, it))(s)
            return s2, scenario_stats(metrics)

        its = (jnp.arange(steps, dtype=state.xi.dtype)
               + jnp.asarray(start_iteration, state.xi.dtype))
        final, stats = jax.lax.scan(body, state, its)
        return final, stats

    return run


def shard_map_rollout(cfg: ControllerConfig, mesh: Mesh, steps: int,
                      axis_name: str = "data") -> Callable:
    """Explicit-collective multi-step rollout: lax.scan inside shard_map,
    per-step psum'd statistics.  Functionally identical to
    :func:`sharded_rollout`; collective placement pinned by hand."""
    data_spec = P(axis_name)

    def _local(state, start_iteration):
        def body(s, it):
            s2, metrics = jax.vmap(
                lambda ss: ro.plant_step(cfg, ss, it))(s)
            n = jax.lax.psum(metrics["height"].shape[0], axis_name)
            stats = {
                "mean_height": jax.lax.psum(
                    jnp.sum(metrics["height"]), axis_name) / n,
                "max_qp_residual": jax.lax.pmax(
                    jnp.max(metrics["qp_residual"]), axis_name),
            }
            return s2, stats

        its = (jnp.arange(steps, dtype=state.xi.dtype)
               + jnp.asarray(start_iteration, state.xi.dtype))
        return jax.lax.scan(body, state, its)

    mapped = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(data_spec, P()),
        out_specs=(data_spec, P()),
        check_vma=False)
    return jax.jit(mapped)


def shard_map_step(cfg: ControllerConfig, mesh: Mesh,
                   axis_name: str = "data") -> Callable:
    """Explicit-collective variant: per-shard vmap + psum/pmax reductions."""
    data_spec = P(axis_name)

    def _local(state, iteration):
        new_state, metrics = jax.vmap(
            lambda s: ro.plant_step(cfg, s, iteration))(state)
        n = jax.lax.psum(metrics["height"].shape[0], axis_name)
        stats = {
            "mean_height": jax.lax.psum(
                jnp.sum(metrics["height"]), axis_name) / n,
            "max_qp_residual": jax.lax.pmax(
                jnp.max(metrics["qp_residual"]), axis_name),
        }
        return new_state, stats

    # check_vma=False: constants created inside the body (identity
    # matrices, weight diagonals) are unvarying while scenario data varies
    # over 'data'; the VMA checker would reject the mixed lax.scan carries.
    mapped = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(data_spec, P()),
        out_specs=(data_spec, P()),
        check_vma=False)
    return jax.jit(mapped)
