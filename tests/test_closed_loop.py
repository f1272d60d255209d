"""Closed-loop circle-tracking tests vs the float64 oracle trajectory.

These are the batched equivalents of the reference's two runnable oracles
(src/qpSolver_test.cpp, src/linear_mpc_example.cpp) with the printed-output
eyeball check replaced by numerical assertions (SURVEY.md §4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_limx_control_tpu.control import linear_mpc
from mpc_limx_control_tpu.core.config import MPCConfig, SolverConfig
from mpc_limx_control_tpu.oracle import pipeline as oracle

STEPS = 120  # enough to cover transient + steady tracking; full run is 500


@pytest.fixture(scope="module")
def oracle_run():
    return oracle.run_closed_loop(steps=STEPS)


def test_closed_loop_f64_matches_oracle(oracle_run):
    cfg = MPCConfig(solver=SolverConfig(iters=30))
    params = linear_mpc.setup(cfg, dtype=jnp.float64)
    run = jax.jit(
        lambda x0: linear_mpc.closed_loop(cfg, params, x0, STEPS)
    )(jnp.asarray([2.0, 0.0, 0.0, 0.0], jnp.float64))
    u_err = np.max(np.abs(np.asarray(run["controls"])
                          - oracle_run["controls"]))
    x_err = np.max(np.abs(np.asarray(run["states"]) - oracle_run["states"]))
    assert u_err < 1e-8, u_err
    assert x_err < 1e-8, x_err


def test_closed_loop_f32_within_budget(oracle_run):
    """BASELINE.md: control-sequence max error <= 1e-3 vs the reference
    pipeline on identical horizons — here in f32."""
    cfg = MPCConfig(solver=SolverConfig(iters=25))
    params = linear_mpc.setup(cfg, dtype=jnp.float32)
    run = jax.jit(
        lambda x0: linear_mpc.closed_loop(cfg, params, x0, STEPS)
    )(jnp.asarray([2.0, 0.0, 0.0, 0.0], jnp.float32))
    u_err = np.max(np.abs(np.asarray(run["controls"])
                          - oracle_run["controls"]))
    assert u_err < 1e-3, u_err
    # Tracking error profile must match the oracle's to the same budget.
    e_err = np.max(np.abs(np.asarray(run["errors"]) - oracle_run["errors"]))
    assert e_err < 1e-3, e_err


def test_closed_loop_batched_vmap(oracle_run):
    """Batched scenarios: scenario 0 reproduces the single run; perturbed
    scenarios stay bounded and track."""
    cfg = MPCConfig(solver=SolverConfig(iters=25))
    params = linear_mpc.setup(cfg, dtype=jnp.float32)
    x0s = jnp.asarray([
        [2.0, 0.0, 0.0, 0.0],
        [1.5, 0.2, 0.5, -0.1],
        [2.5, -0.3, -0.5, 0.2],
        [0.0, 0.0, 0.0, 0.0],
    ], jnp.float32)
    runs = jax.jit(
        lambda xs: linear_mpc.batched_closed_loop(cfg, params, xs, STEPS)
    )(x0s)
    u0_err = np.max(np.abs(np.asarray(runs["controls"][0])
                           - oracle_run["controls"]))
    assert u0_err < 1e-3
    # all scenarios converge toward the circle (transients from far starts
    # take longer than 120 steps to fully settle — physical, not numerical)
    errors = np.asarray(runs["errors"])
    final_err = errors[:, -20:].mean(axis=1)
    early_err = errors[:, 5:25].mean(axis=1)
    assert (final_err < 0.2).all(), final_err
    assert (final_err <= early_err + 1e-3).all(), (early_err, final_err)
    # inputs respect bounds
    assert np.abs(np.asarray(runs["controls"])).max() <= 8.0 + 1e-4
