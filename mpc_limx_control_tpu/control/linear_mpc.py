"""Jitted closed-loop linear MPC — the minimum end-to-end slice.

Batched equivalent of the reference's working numerical core: the
500-step circle-tracking loop of src/qpSolver_test.cpp:38-75 /
src/linear_mpc_example.cpp:133-195, re-expressed as

    setup   (once):  ZOH discretize + cache condensation    [device]
    tick    (scan):  reference -> (f,h) -> batched QP -> plant step

The whole rollout is one `lax.scan` under jit; scenario batching is a
`vmap` over initial states.  The plant step x <- Ad x + Bd u mirrors
`QPSolver::updateState` (src/QPSolver.cpp:108-111).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mpc_limx_control_tpu.core.config import MPCConfig
from mpc_limx_control_tpu.models import double_integrator as di
from mpc_limx_control_tpu.ops import condense as cnd
from mpc_limx_control_tpu.ops import discretize as dsc
from mpc_limx_control_tpu.ops import qp as qps


class LinearMPCParams(NamedTuple):
    Ad: jnp.ndarray
    Bd: jnp.ndarray
    cache: cnd.CondensationCache
    x_min: jnp.ndarray
    x_max: jnp.ndarray


def setup(cfg: MPCConfig, dtype=jnp.float32) -> LinearMPCParams:
    """Discretize and cache the condensation for the configured system."""
    Ac, Bc = di.continuous_matrices(dtype)
    Ad, Bd = dsc.zoh(Ac, Bc, cfg.ts)
    Q = jnp.diag(jnp.asarray(cfg.q_diag, dtype))
    R = jnp.diag(jnp.asarray(cfg.r_diag, dtype))
    P = cfg.p_scale * Q
    cache = cnd.condense_cache(
        Ad, Bd, Q, R, P, cfg.horizon,
        with_state_rows=cfg.use_state_constraints)
    return LinearMPCParams(
        Ad=Ad, Bd=Bd, cache=cache,
        x_min=jnp.asarray(cfg.x_min, dtype),
        x_max=jnp.asarray(cfg.x_max, dtype))


def solve_tick(cfg: MPCConfig, params: LinearMPCParams, x: jnp.ndarray,
               k: jnp.ndarray):
    """One MPC solve at closed-loop step k: returns (u [nu], sol)."""
    dtype = x.dtype
    x_ref = di.circle_reference(k, cfg.ts, cfg.horizon, dtype=dtype)
    if cfg.use_state_constraints:
        f, h = cnd.linear_terms(params.cache, x, x_ref, cfg.u_min, cfg.u_max,
                                params.x_min, params.x_max)
    else:
        f, h = cnd.linear_terms(params.cache, x, x_ref, cfg.u_min, cfg.u_max)
    solver = qps.make_pdip(iters=cfg.solver.iters)
    sol = solver(params.cache.H, f, params.cache.G, h)
    return sol.u[: cfg.nu], sol


def closed_loop(cfg: MPCConfig, params: LinearMPCParams, x0: jnp.ndarray,
                steps: int):
    """Full closed-loop rollout from x0 (single scenario; vmap to batch).

    Returns dict: states [steps+1, nx], controls [steps, nu],
    errors [steps] (position tracking error as printed by the reference,
    src/qpSolver_test.cpp:84-89), residuals [steps].
    """

    def tick(x, k):
        u, sol = solve_tick(cfg, params, x, k)
        x_next = params.Ad @ x + params.Bd @ u
        ref_now = di.circle_reference(k, cfg.ts, 0, dtype=x.dtype)[0]
        err = jnp.linalg.norm(
            jnp.stack([x_next[0] - ref_now[0], x_next[2] - ref_now[2]]))
        return x_next, (x_next, u, err, sol.residual)

    ks = jnp.arange(steps, dtype=x0.dtype)
    x_last, (xs, us, errs, res) = lax.scan(tick, x0, ks)
    states = jnp.concatenate([x0[None], xs], axis=0)
    return {"states": states, "controls": us, "errors": errs,
            "residuals": res}


def batched_closed_loop(cfg: MPCConfig, params: LinearMPCParams,
                        x0s: jnp.ndarray, steps: int):
    """vmap of closed_loop over a batch of initial states [B, nx]."""
    return jax.vmap(lambda x0: closed_loop(cfg, params, x0, steps))(x0s)
