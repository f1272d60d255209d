"""Riccati-form ADMM for the stance GRF MPC (HPIPM-style alternative).

The condensed path (ops/condense.py + ops/qp.py / ops/mpc_fused_pallas.py)
eliminates the states and factors a dense nz x nz matrix; the reference's
own solve works the same way through qpOASES (src/QPSolver.cpp:31-106).
This module keeps the SPARSE (state-and-control) form instead and solves
each ADMM x-update as an equality-constrained LQR via the backward Riccati
recursion — O(N (nx^3 + nx^2 nu)) sequential steps, no nz x nz matrix, the
classic HPIPM/factorization trade (Frison & Diehl, "HPIPM: a
high-performance quadratic programming framework for model predictive
control").

Mathematically IDENTICAL iterates to the condensed warm ADMM: the
x-update minimizes

    1/2 z' (H + rho G'G) z + (f - rho G'(v - y))' z,   H = 2(B'Qbar B + Rbar)

whose KKT system over (x_{1..N}, u_{0..N-1}) with the dynamics as equality
constraints is exactly the LQR with stage weights (2Q, 2R + rho Gu'Gu),
tracking terms -2Q x_ref, and per-step input linear terms
-rho Gu'(v_t - y_t).  The Riccati gains (P_t, K_t, (R~ + B'PB)^{-1}) are
iteration-INVARIANT (they depend only on the QP matrices), so the
factorization runs once per tick and every ADMM iteration is one backward
linear sweep + one forward rollout of [B, nx] vectors.

Where it wins or loses is an empirical question this module exists to
answer; its sequential 2N-step sweeps trade the condensed path's
dense-matrix work for scan latency.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from mpc_limx_control_tpu.core.types import QPSolution


def _inv3(M):
    """Batched closed-form inverse of [..., 3, 3] (adjugate/det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
        jnp.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
        jnp.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def riccati_factor(Ad, Bd_t, q_diag, r_diag, p_diag, Gu, rho):
    """Backward Riccati factorization, batched.

    Ad [B,nx,nx]; Bd_t [B,N,nx,nu].  Weights follow the condensed-QP
    scaling (H = 2(B'Qbar B + Rbar) + rho G'G): Q~ = 2 diag(q), terminal
    2 diag(p), R~ = 2 diag(r) + rho Gu'Gu.

    Returns per-step tensors (leading axis N): gains K_t [N,B,nu,nx],
    Hinv_t [N,B,nu,nu], BtP_t = Bd_t' P_{t+1} [N,B,nu,nx], and
    Acl_t = Ad - Bd_t K_t [N,B,nx,nx].
    """
    dtype = Ad.dtype
    nx = Ad.shape[-1]
    Q2 = 2.0 * jnp.diag(jnp.asarray(q_diag, dtype))
    P2 = 2.0 * jnp.diag(jnp.asarray(p_diag, dtype))
    Gu_ = jnp.asarray(Gu, dtype)
    R2 = (2.0 * jnp.diag(jnp.asarray(r_diag, dtype))
          + rho * (Gu_.T @ Gu_))

    Bd_scan = jnp.moveaxis(Bd_t, 1, 0)                  # [N,B,nx,nu]

    def step(P_next, Bd):
        # all small batched matmuls; f32-pinned (same reasoning as the
        # ADMM K^-1 pin, NOTES.md)
        with jax.default_matmul_precision("float32"):
            BtP = jnp.einsum("bxu,bxy->buy", Bd, P_next)     # B' P [B,nu,nx]
            Hs = R2 + jnp.einsum("buy,byv->buv", BtP, Bd)    # [B,nu,nu]
            Hinv = _inv3(Hs) if Hs.shape[-1] == 3 else jnp.linalg.inv(Hs)
            BtPA = jnp.einsum("buy,byz->buz", BtP, Ad)       # [B,nu,nx]
            K = jnp.einsum("buv,bvz->buz", Hinv, BtPA)       # gain
            Acl = Ad - jnp.einsum("bxu,buz->bxz", Bd, K)
            P = Q2 + jnp.einsum("byx,byz,bzw->bxw", Ad, P_next, Acl)
            P = 0.5 * (P + jnp.swapaxes(P, -1, -2))
        return P, (K, Hinv, BtP, Acl)

    P_term = jnp.broadcast_to(P2, Ad.shape)
    _, (K, Hinv, BtP, Acl) = lax.scan(step, P_term, Bd_scan[::-1])
    # scan ran t = N-1 .. 0; flip back to forward order
    return (K[::-1], Hinv[::-1], BtP[::-1], Acl[::-1])


def riccati_solve(Ad, Bd_t, factors, x0, x_ref, q_diag, p_diag, r_lin):
    """One LQR solve with the precomputed factorization.

    r_lin [B,N,nu]: per-step input linear terms (the ADMM
    -rho Gu'(v_t - y_t)).  Returns u [B,N,nu].

    Affine recursions (standard LQR with linear terms; the cross terms
    cancel through K' = A'P B Hinv):
        k_t = Hinv_t (B_t' s_{t+1} + r_t)
        s_t = q_t + Acl_t' s_{t+1} - K_t' r_t
        u_t = -K_t x_t - k_t,  x_{t+1} = A x_t + B_t u_t
    with q_t = -2Q x_ref_t (t >= 1; q_0 = 0 — x_0 is fixed) and
    s_N = -2P x_ref_N.
    """
    dtype = Ad.dtype
    K, Hinv, BtP, Acl = factors
    del BtP
    Q2 = 2.0 * jnp.diag(jnp.asarray(q_diag, dtype))
    P2 = 2.0 * jnp.diag(jnp.asarray(p_diag, dtype))
    N = Bd_t.shape[1]

    qlin = -jnp.einsum("xy,bty->btx", Q2, x_ref[:, 1:N])   # t = 1..N-1
    qN = -jnp.einsum("xy,by->bx", P2, x_ref[:, N])         # s_N

    Bd_scan = jnp.moveaxis(Bd_t, 1, 0)                     # [N,B,nx,nu]
    r_scan = jnp.moveaxis(r_lin, 1, 0)                     # [N,B,nu]
    q_stage = jnp.concatenate(
        [jnp.zeros_like(qN)[None], jnp.moveaxis(qlin, 1, 0)],
        axis=0)                                            # t = 0..N-1

    with jax.default_matmul_precision("float32"):
        def bwd(s_next, inp):
            Bd, r_t, q_t, Hinv_t, Acl_t, K_t = inp
            k = jnp.einsum("buv,bv->bu",
                           Hinv_t,
                           jnp.einsum("bxu,bx->bu", Bd, s_next) + r_t)
            s = (q_t
                 + jnp.einsum("bxz,bx->bz", Acl_t, s_next)
                 - jnp.einsum("buz,bu->bz", K_t, r_t))
            return s, k

        inputs = (Bd_scan[::-1], r_scan[::-1], q_stage[::-1],
                  Hinv[::-1], Acl[::-1], K[::-1])
        _, ks_rev = lax.scan(bwd, qN, inputs)
        ks = ks_rev[::-1]                                  # [N,B,nu]

        def fwd(x, inp):
            Bd, K_t, k_t = inp
            u = -jnp.einsum("buz,bz->bu", K_t, x) - k_t
            x_next = (jnp.einsum("bxz,bz->bx", Ad, x)
                      + jnp.einsum("bxu,bu->bx", Bd, u))
            return x_next, u

        _, us = lax.scan(fwd, x0, (Bd_scan, K, ks))

    return jnp.moveaxis(us, 0, 1)                          # [B,N,nu]


def make_admm_riccati(cfg_srbd):
    """Warm-started ADMM with Riccati-factorized x-updates: same
    interface and (mathematically) same iterates as
    ops/mpc_fused_pallas.make_admm_fused — fn(Ad, Bd_t, x_ref, x0,
    z_warm, y_warm) -> (QPSolution, (z, y)) on BATCHED inputs.
    """
    c = cfg_srbd
    N = c.horizon
    mu = float(c.friction_mu)
    Gu = ((1.0, 0.0, -mu), (-1.0, 0.0, -mu),
          (0.0, 1.0, -mu), (0.0, -1.0, -mu),
          (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
    hu = (0.0, 0.0, 0.0, 0.0, float(c.fz_max), -float(c.fz_min))
    q_diag = tuple(float(v) for v in c.q_diag)
    r_diag = tuple(float(v) for v in c.r_diag)
    p_diag = tuple(float(c.p_scale) * float(v) for v in c.q_diag)
    iters = int(c.solver.admm_warm_iters)
    rho = float(c.solver.admm_rho)
    alpha = float(c.solver.admm_alpha)

    def _solve(Ad, Bd_t, x_ref, x0, z_warm, y_warm):
        dtype = x0.dtype
        B = x0.shape[0]
        nu = Bd_t.shape[-1]
        mu_rows = len(Gu)
        Gu_ = jnp.asarray(Gu, dtype)
        h_t = jnp.asarray(hu, dtype)                       # per-step [mu]

        factors = riccati_factor(Ad, Bd_t, q_diag, r_diag, p_diag,
                                 Gu, rho)

        def lqr(v, y):
            # r_t = -rho Gu'(v_t - y_t), per step
            w = (v - y).reshape(B, N, mu_rows)
            r_lin = -rho * jnp.einsum("mv,btm->btv", Gu_, w)
            u = riccati_solve(Ad, Bd_t, factors, x0, x_ref,
                              q_diag, p_diag, r_lin)
            return u.reshape(B, N * nu)

        def g_mv(z):
            zb = z.reshape(B, N, nu)
            return jnp.einsum("mv,btv->btm", Gu_, zb).reshape(B, -1)

        h_full = jnp.tile(h_t, N)[None]
        v = jnp.minimum(g_mv(z_warm), h_full)
        y = y_warm

        def step(carry, _):
            v, y = carry
            z = lqr(v, y)
            gz = g_mv(z)
            gzr = alpha * gz + (1.0 - alpha) * v
            v_new = jnp.minimum(gzr + y, h_full)
            y = y + gzr - v_new
            return (v_new, y), None

        (v, y), _ = lax.scan(step, (v, y), None, length=iters)
        z = lqr(v, y)

        r_prim = jnp.max(jnp.abs(g_mv(z) - v), axis=-1)
        sol = QPSolution(u=z, iterations=iters, residual=r_prim)
        return sol, (z, y)

    def solve(*args):
        # f32 pin for the cone matvecs too — the bf16 MXU default on the
        # O(100 N) forces is the NOTES.md silent-degradation class
        with jax.default_matmul_precision("float32"):
            return _solve(*args)

    return solve


def make_admm_riccati_single(cfg_srbd):
    """Single-scenario interface with a vmap rule dispatching to the
    batched :func:`make_admm_riccati` — the same custom_vmap pattern as
    make_admm_fused, for use inside the vmapped controller tick."""
    batched = make_admm_riccati(cfg_srbd)

    @jax.custom_batching.custom_vmap
    def solve(Ad, Bd_t, x_ref, x0, z_warm, y_warm):
        sol, zy = batched(Ad[None], Bd_t[None], x_ref[None], x0[None],
                          z_warm[None], y_warm[None])
        return (QPSolution(u=sol.u[0], iterations=sol.iterations,
                           residual=sol.residual[0]),
                (zy[0][0], zy[1][0]))

    @solve.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = [a if b else jnp.broadcast_to(a, (axis_size, *a.shape))
                for a, b in zip(args, in_batched)]
        out = batched(*args)
        spec = (QPSolution(u=True, iterations=False, residual=True),
                (True, True))
        return out, spec

    return solve
