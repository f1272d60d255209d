"""Riccati-form ADMM (ops/riccati.py) vs the condensed warm ADMM.

The two solve the SAME optimization with the same splitting: iterates
must agree to f32 accumulation error.  Also validates the plain LQR
solve against the condensed unconstrained minimizer.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mpc_limx_control_tpu.ops import riccati as ric
from test_mpc_fused import _walking_inputs, _xla_reference


def test_riccati_lqr_matches_condensed_unconstrained():
    """One Riccati solve with r_lin = 0 equals the unconstrained
    condensed minimizer argmin 1/2 z'Kz + f'z (with rho G'G in K)."""
    B = 8
    cfg, Ad, Bd_t, x_ref, xi0 = _walking_inputs(B, jax.random.PRNGKey(0))
    c = cfg.srbd
    N = c.horizon
    q = tuple(float(v) for v in c.q_diag)
    r = tuple(float(v) for v in c.r_diag)
    p = tuple(float(c.p_scale) * float(v) for v in c.q_diag)
    mu = float(c.friction_mu)
    Gu = ((1.0, 0.0, -mu), (-1.0, 0.0, -mu), (0.0, 1.0, -mu),
          (0.0, -1.0, -mu), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
    rho = float(c.solver.admm_rho)

    factors = ric.riccati_factor(Ad, Bd_t, q, r, p, Gu, rho)
    r_lin = jnp.zeros((B, N, 3), jnp.float32)
    u = ric.riccati_solve(Ad, Bd_t, factors, xi0, x_ref, q, p, r_lin)

    # condensed reference: K z = -f with K = H + rho G'G
    from mpc_limx_control_tpu.models import srbd
    from mpc_limx_control_tpu.ops import condense as cnd
    Q = jnp.diag(jnp.asarray(c.q_diag, jnp.float32))
    R = jnp.diag(jnp.asarray(c.r_diag, jnp.float32))
    P = c.p_scale * Q
    G, _ = srbd.friction_cone_rows(c, N, jnp.float32)
    qp = jax.vmap(lambda a, b, xr, x0: cnd.condense(
        a, b, Q, R, P, N, x0, xr, None, None, extra_G=G,
        extra_h=jnp.zeros(G.shape[0])))(Ad, Bd_t, x_ref, xi0)
    K = qp.H + rho * (G.T @ G)[None]
    z_ref = jnp.linalg.solve(K, -qp.f[..., None])[..., 0]

    scale = float(jnp.max(jnp.abs(z_ref))) + 1.0
    np.testing.assert_allclose(np.asarray(u.reshape(B, -1)),
                               np.asarray(z_ref),
                               atol=3e-3 * scale, rtol=0)


def test_riccati_admm_matches_condensed_admm():
    """Full warm-started ADMM: Riccati-factorized x-updates produce the
    same iterates as the condensed _batched_admm."""
    B = 16
    cfg, Ad, Bd_t, x_ref, xi0 = _walking_inputs(B, jax.random.PRNGKey(4))
    c = cfg.srbd
    N = c.horizon
    kz, ky = jax.random.split(jax.random.PRNGKey(9))
    z_w = 5.0 * jax.random.normal(kz, (B, 3 * N), jnp.float32)
    y_w = jnp.abs(jax.random.normal(ky, (B, 6 * N), jnp.float32))

    sol_ref, (z_ref, y_ref) = _xla_reference(
        cfg, Ad, Bd_t, x_ref, xi0, z_w, y_w, c.solver.admm_warm_iters)

    solver = ric.make_admm_riccati(c)
    sol_r, (z_r, y_r) = solver(Ad, Bd_t, x_ref, xi0, z_w, y_w)

    scale = float(jnp.max(jnp.abs(z_ref))) + 1.0
    np.testing.assert_allclose(np.asarray(z_r), np.asarray(z_ref),
                               atol=3e-3 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(y_r), np.asarray(y_ref),
                               atol=3e-3 * scale, rtol=0)


def test_riccati_method_in_controller_rollout():
    """SolverConfig.method='riccati' drives the full walking tick."""
    import dataclasses
    from mpc_limx_control_tpu.core.config import ControllerConfig
    from mpc_limx_control_tpu.control import rollout as ro

    cfg = ControllerConfig.walking()
    cfg = dataclasses.replace(
        cfg, srbd=dataclasses.replace(
            cfg.srbd, solver=dataclasses.replace(cfg.srbd.solver,
                                                 method="riccati")))
    B = 4
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    final, m = jax.jit(lambda s: ro.batched_rollout(cfg, s, 400))(s0)
    h = np.asarray(m["height"])
    assert h.min() > 0.55, h.min()
    assert not np.isnan(np.asarray(final.xi)).any()
