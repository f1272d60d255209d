"""Structure-exploiting fast paths vs the dense reference pipeline.

* ops/condense.py:condense_lti_diag — band-form H/f (LTI Ad + diagonal
  weights) must equal the dense condensation (reference layout,
  src/QPSolver.cpp:50-60) to fp tolerance.
* ops/qp.py:make_admm_warm_kron — block-diagonal-cone ADMM must produce
  the same iterates as the generic ADMM on the expanded G = kron(I, Gu).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_limx_control_tpu.ops import condense as cnd
from mpc_limx_control_tpu.ops import qp as qps


def _random_problem(key, N=20, nx=13, nu=3, dtype=jnp.float64):
    k = jax.random.split(key, 6)
    # stable-ish LTI Ad close to identity (the SRBD discretization shape)
    Ad = jnp.eye(nx, dtype=dtype) + 0.05 * jax.random.normal(
        k[0], (nx, nx), dtype)
    Bd_t = 0.3 * jax.random.normal(k[1], (N, nx, nu), dtype)
    q = jnp.abs(jax.random.normal(k[2], (nx,), dtype)) + 0.1
    r = jnp.abs(jax.random.normal(k[3], (nu,), dtype)) + 0.1
    p = 20.0 * q
    x0 = jax.random.normal(k[4], (nx,), dtype)
    x_ref = jax.random.normal(k[5], (N + 1, nx), dtype)
    return Ad, Bd_t, q, r, p, x0, x_ref


@pytest.mark.parametrize("seed", [0, 1])
def test_band_condensation_matches_dense(seed):
    N, nx, nu = 20, 13, 3
    Ad, Bd_t, q, r, p, x0, x_ref = _random_problem(jax.random.PRNGKey(seed))

    qp = cnd.condense(Ad, Bd_t, jnp.diag(q), jnp.diag(r), jnp.diag(p),
                      N, x0, x_ref, None, None,
                      extra_G=jnp.zeros((1, N * nu), x0.dtype),
                      extra_h=jnp.zeros((1,), x0.dtype))
    H_fast, f_fast = cnd.condense_lti_diag(Ad, Bd_t, q, r, p, N, x0, x_ref)

    np.testing.assert_allclose(np.asarray(H_fast), np.asarray(qp.H),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(f_fast), np.asarray(qp.f),
                               rtol=1e-10, atol=1e-10)


def test_band_condensation_vmapped():
    """Batched (vmap) band condensation equals per-scenario dense."""
    B, N, nx, nu = 4, 8, 5, 2
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    probs = [_random_problem(k, N=N, nx=nx, nu=nu) for k in keys]
    Ad = jnp.stack([pb[0] for pb in probs])
    Bd = jnp.stack([pb[1] for pb in probs])
    q, r, p = probs[0][2], probs[0][3], probs[0][4]
    x0 = jnp.stack([pb[5] for pb in probs])
    xr = jnp.stack([pb[6] for pb in probs])

    H_b, f_b = jax.vmap(
        lambda a, b, x, xrf: cnd.condense_lti_diag(a, b, q, r, p, N, x, xrf)
    )(Ad, Bd, x0, xr)
    for i in range(B):
        qp = cnd.condense(Ad[i], Bd[i], jnp.diag(q), jnp.diag(r),
                          jnp.diag(p), N, x0[i], xr[i], None, None,
                          extra_G=jnp.zeros((1, N * nu), x0.dtype),
                          extra_h=jnp.zeros((1,), x0.dtype))
        np.testing.assert_allclose(np.asarray(H_b[i]), np.asarray(qp.H),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(f_b[i]), np.asarray(qp.f),
                                   rtol=1e-9, atol=1e-9)


def test_admm_kron_matches_dense_admm():
    """Kron-structured ADMM == generic ADMM on the expanded G, iterate for
    iterate (same algorithm, same rho/alpha/warm start)."""
    B, N, nu, mu = 6, 10, 3, 6
    n, m = N * nu, N * mu
    dtype = jnp.float64
    key = jax.random.split(jax.random.PRNGKey(3), 5)
    M = jax.random.normal(key[0], (B, n, n), dtype)
    H = jnp.matmul(M, jnp.swapaxes(M, -1, -2)) + 0.5 * jnp.eye(n, dtype=dtype)
    f = jax.random.normal(key[1], (B, n), dtype)
    Gu = jax.random.normal(key[2], (mu, nu), dtype)
    G = jnp.kron(jnp.eye(N, dtype=dtype), Gu)
    h = jnp.abs(jax.random.normal(key[3], (B, m), dtype)) + 0.5
    z0 = jax.random.normal(key[4], (B, n), dtype) * 0.1
    y0 = jnp.zeros((B, m), dtype)

    dense = qps.make_admm_warm(iters=25, rho=0.7, alpha=1.5)
    kron = qps.make_admm_warm_kron(Gu, iters=25, rho=0.7, alpha=1.5)
    sol_d, (zd, yd) = jax.vmap(
        lambda Hb, fb, hb, zb, yb: dense(Hb, fb, G, hb, zb, yb)
    )(H, f, h, z0, y0)
    sol_k, (zk, yk) = jax.vmap(kron)(H, f, h, z0, y0)

    np.testing.assert_allclose(np.asarray(sol_k.u), np.asarray(sol_d.u),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(zk), np.asarray(zd),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(yk), np.asarray(yd),
                               rtol=1e-8, atol=1e-10)
