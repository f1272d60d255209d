"""Batched, branch-free QP solvers.

The reference solves each condensed MPC QP with qpOASES' dense active-set
method, nWSR = 50000 (src/QPSolver.cpp:83-106) — an inherently sequential,
branchy algorithm that cannot be batched on SIMD hardware.  This engine
replaces it with two fixed-iteration, fully vectorized solvers over

    min_z 1/2 z' H z + f' z   s.t.   G z <= h

* :func:`pdip_qp` — primal-dual interior point with Mehrotra
  predictor-corrector, a fixed number of Newton steps under `lax.scan`.
  ~1e-6 relative accuracy in <=20 iterations in f32; f64 reaches 1e-10.
  One batched Cholesky of (H + G'DG) per step — the hot kernel.
* :func:`admm_qp` — over-relaxed ADMM with a single cached Cholesky factor
  of (H + rho G'G); cheapest per iteration and warm-startable across MPC
  ticks (the previous tick's solution shifts by one stage).

Both are pure functions of arrays: vmap for scenario batching, jit end to
end.  Accuracy is asserted against the float64 CPU oracle
(oracle/qp_oracle.py) in tests/test_qp.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from mpc_limx_control_tpu.core.types import QPSolution


def _posdef_chol(M: jnp.ndarray, reg: float) -> jnp.ndarray:
    n = M.shape[-1]
    return jnp.linalg.cholesky(M + reg * jnp.eye(n, dtype=M.dtype))


def _chol_solve(L: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


def _max_step(v: jnp.ndarray, dv: jnp.ndarray) -> jnp.ndarray:
    """Largest alpha in (0,1] with v + alpha*dv >= 0, branch-free."""
    ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
    return jnp.minimum(1.0, jnp.min(ratio))


def ruiz_equilibrate(H: jnp.ndarray, f: jnp.ndarray, G: jnp.ndarray,
                     h: jnp.ndarray, iters: int = 6):
    """OSQP-style Ruiz equilibration of the QP.

    Returns (H', f', G', h', D) where the scaled problem in z' = D^{-1} z has
    H' = D H D, f' = D f, G' = E G D, h' = E h; after solving, u = D * z'.
    Drastically improves f32 conditioning of ill-scaled condensations.
    """
    n = f.shape[-1]
    m = h.shape[-1]
    D = jnp.ones((n,), H.dtype)
    E = jnp.ones((m,), H.dtype)
    floor = jnp.asarray(1e-8, H.dtype)

    def body(carry, _):
        D, E = carry
        Hs = jnp.abs(H) * D[:, None] * D[None, :]
        Gs = jnp.abs(G) * E[:, None] * D[None, :]
        col = jnp.maximum(jnp.max(Hs, axis=0), jnp.max(Gs, axis=0))
        D = D / jnp.sqrt(jnp.maximum(col, floor))
        Gs = jnp.abs(G) * E[:, None] * D[None, :]
        row = jnp.max(Gs, axis=1)
        E = E / jnp.sqrt(jnp.maximum(row, floor))
        return (D, E), None

    (D, E), _ = lax.scan(body, (D, E), None, length=iters)
    Hp = H * D[:, None] * D[None, :]
    fp = f * D
    Gp = G * E[:, None] * D[None, :]
    hp = h * E
    return Hp, fp, Gp, hp, D


@partial(jax.jit, static_argnames=("iters", "scale"))
def pdip_qp(H: jnp.ndarray, f: jnp.ndarray, G: jnp.ndarray, h: jnp.ndarray,
            iters: int = 20, scale: bool = False) -> QPSolution:
    """Fixed-iteration Mehrotra predictor-corrector IPM (single scenario).

    Batched use: `jax.vmap(lambda H,f,G,h: pdip_qp(H,f,G,h,iters))`.
    All control flow is a `lax.scan` of `iters` identical Newton steps;
    no data-dependent branching, so the whole solve fuses under jit.
    With `scale=True` the problem is Ruiz-equilibrated first (recommended
    in f32).
    """
    if scale:
        H, f, G, h, D_scale = ruiz_equilibrate(H, f, G, h)
    dtype = H.dtype
    n = f.shape[-1]
    m = h.shape[-1]
    eps = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-8, dtype)
    d_cap = jnp.asarray(1e14 if dtype == jnp.float64 else 1e7, dtype)
    reg = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-6, dtype)

    L_h = _posdef_chol(H, reg)
    z0 = -_chol_solve(L_h, f)
    s0_raw = h - G @ z0
    shift = jnp.maximum(0.0, -jnp.min(s0_raw)) + 1.0
    s0 = s0_raw + shift
    lam0 = jnp.ones((m,), dtype)
    f_scale = 1.0 + jnp.max(jnp.abs(f))
    mu0 = jnp.dot(s0, lam0) / m

    def merit_of(z, s, lam):
        r_dual = H @ z + f + G.T @ lam
        r_prim = jnp.maximum(G @ z - h, 0.0)
        mu = jnp.dot(s, lam) / m
        return (jnp.max(jnp.abs(r_dual)) / f_scale
                + jnp.max(r_prim)
                + mu / mu0)

    def newton_step(carry, _):
        z, s, lam, z_best, merit_best = carry
        r_dual = H @ z + f + G.T @ lam
        r_prim = G @ z + s - h
        mu = jnp.dot(s, lam) / m

        d = jnp.minimum(lam / jnp.maximum(s, eps), d_cap)
        M = H + (G.T * d) @ G
        L = _posdef_chol(M, reg)

        def direction(r_comp):
            rhs = -r_dual + G.T @ ((r_comp - lam * r_prim)
                                   / jnp.maximum(s, eps))
            dz = _chol_solve(L, rhs)
            ds = -r_prim - G @ dz
            dlam = -(r_comp + lam * ds) / jnp.maximum(s, eps)
            return dz, ds, dlam

        dz_a, ds_a, dlam_a = direction(s * lam)
        a_aff = jnp.minimum(_max_step(s, ds_a), _max_step(lam, dlam_a))
        mu_aff = jnp.dot(s + a_aff * ds_a, lam + a_aff * dlam_a) / m
        sigma = (mu_aff / jnp.maximum(mu, eps)) ** 3

        dz, ds, dlam = direction(s * lam - sigma * mu + ds_a * dlam_a)
        alpha = 0.99 * jnp.minimum(_max_step(s, ds), _max_step(lam, dlam))

        z = z + alpha * dz
        s = jnp.maximum(s + alpha * ds, eps)
        lam = jnp.maximum(lam + alpha * dlam, eps)

        merit = merit_of(z, s, lam)
        better = merit < merit_best
        z_best = jnp.where(better, z, z_best)
        merit_best = jnp.where(better, merit, merit_best)
        return (z, s, lam, z_best, merit_best), None

    init = (z0, s0, lam0, z0, merit_of(z0, s0, lam0))
    (z, s, lam, z_best, merit_best), _ = lax.scan(
        newton_step, init, None, length=iters)

    u = z_best * D_scale if scale else z_best
    return QPSolution(u=u, iterations=iters, residual=merit_best)


def _batched_pdip(H, f, G, h, iters: int, z_warm=None, lam_warm=None):
    """Batch-first PDIP: H [B,n,n], f [B,n], G [B,m,n], h [B,m].

    Same math as :func:`pdip_qp`, with one batched Cholesky per Newton
    step shared by the affine and corrector solves.

    (z_warm, lam_warm): warm start from a previous (similar) solve —
    slacks are re-derived from z_warm and pushed strictly interior;
    multipliers floored away from zero.  Cuts the iteration count roughly
    in half for receding-horizon resolves.
    """
    dtype = H.dtype
    B, n = f.shape
    m = h.shape[-1]
    eps = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-8, dtype)
    d_cap = jnp.asarray(1e14 if dtype == jnp.float64 else 1e7, dtype)
    reg = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-6, dtype)
    eye = jnp.eye(n, dtype=dtype)

    def make_solver(M):
        L = jnp.linalg.cholesky(M + reg * eye)

        def solve(r):
            y = jax.scipy.linalg.solve_triangular(
                L, r[..., None], lower=True)
            return jax.scipy.linalg.solve_triangular(
                jnp.swapaxes(L, -1, -2), y, lower=False)[..., 0]

        return solve

    Gt = jnp.swapaxes(G, -1, -2)

    if z_warm is not None:
        # primal-only warm start: previous solution as z0 with the same
        # interior shift scheme as the cold start; multipliers restart at
        # a centered value.  (Warm multipliers from a *changed* problem —
        # e.g. across a gait phase switch — routinely poison the first
        # Newton step, measured as closed-loop instability.)
        z0 = z_warm
        s0_raw = h - jnp.einsum("bmn,bn->bm", G, z0)
        shift = jnp.maximum(
            0.0, -jnp.min(s0_raw, axis=-1, keepdims=True)) + 0.1
        s0 = s0_raw + shift
        lam0 = jnp.ones_like(h)
        del lam_warm
    else:
        # cold start: z = -H^{-1} f, slacks shifted interior
        z0 = -make_solver(H)(f)
        s0_raw = h - jnp.einsum("bmn,bn->bm", G, z0)
        shift = jnp.maximum(
            0.0, -jnp.min(s0_raw, axis=-1, keepdims=True)) + 1.0
        s0 = s0_raw + shift
        lam0 = jnp.ones_like(h)
    f_scale = 1.0 + jnp.max(jnp.abs(f), axis=-1)
    mu0 = jnp.sum(s0 * lam0, axis=-1) / m

    def merit_of(z, s, lam):
        r_dual = (jnp.einsum("bij,bj->bi", H, z) + f
                  + jnp.einsum("bmn,bm->bn", G, lam))
        r_prim = jnp.maximum(jnp.einsum("bmn,bn->bm", G, z) - h, 0.0)
        mu = jnp.sum(s * lam, axis=-1) / m
        return (jnp.max(jnp.abs(r_dual), axis=-1) / f_scale
                + jnp.max(r_prim, axis=-1) + mu / mu0)

    def max_step(v, dv):
        ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, jnp.min(ratio, axis=-1))

    def newton_step(carry, _):
        z, s, lam, z_best, merit_best = carry
        r_dual = (jnp.einsum("bij,bj->bi", H, z) + f
                  + jnp.einsum("bmn,bm->bn", G, lam))
        gz = jnp.einsum("bmn,bn->bm", G, z)
        r_prim = gz + s - h
        mu = jnp.sum(s * lam, axis=-1) / m

        d = jnp.minimum(lam / jnp.maximum(s, eps), d_cap)
        M = H + jnp.matmul(Gt, G * d[..., None])

        s_safe = jnp.maximum(s, eps)

        def rhs_of(r_comp):
            return -r_dual + jnp.einsum(
                "bmn,bm->bn", G, (r_comp - lam * r_prim) / s_safe)

        rc_aff = s * lam
        solver = make_solver(M)        # one factorization per Newton step
        dz_a = solver(rhs_of(rc_aff))
        ds_a = -r_prim - jnp.einsum("bmn,bn->bm", G, dz_a)
        dlam_a = -(rc_aff + lam * ds_a) / s_safe
        a_aff = jnp.minimum(max_step(s, ds_a), max_step(lam, dlam_a))
        mu_aff = jnp.sum((s + a_aff[..., None] * ds_a)
                         * (lam + a_aff[..., None] * dlam_a), axis=-1) / m
        sigma = (mu_aff / jnp.maximum(mu, eps)) ** 3

        rc = s * lam - (sigma * mu)[..., None] + ds_a * dlam_a
        dz = solver(rhs_of(rc))
        ds = -r_prim - jnp.einsum("bmn,bn->bm", G, dz)
        dlam = -(rc + lam * ds) / s_safe
        alpha = (0.99 * jnp.minimum(max_step(s, ds),
                                    max_step(lam, dlam)))[..., None]

        z = z + alpha * dz
        s = jnp.maximum(s + alpha * ds, eps)
        lam = jnp.maximum(lam + alpha * dlam, eps)
        merit = merit_of(z, s, lam)
        better = merit < merit_best
        z_best = jnp.where(better[..., None], z, z_best)
        merit_best = jnp.where(better, merit, merit_best)
        return (z, s, lam, z_best, merit_best), None

    init = (z0, s0, lam0, z0, merit_of(z0, s0, lam0))
    (z_f, s_f, lam_f, z_best, merit_best), _ = lax.scan(
        newton_step, init, None, length=iters)
    sol = QPSolution(u=z_best, iterations=iters, residual=merit_best)
    return sol, (z_best, lam_f)


def make_pdip(iters: int = 20):
    """A pdip solver whose vmap rule dispatches to the batch-native
    implementation.

    Usage: `solver = make_pdip(iters); jax.vmap(solver)(H, f, G, h)` or
    call it unbatched.
    """

    @jax.custom_batching.custom_vmap
    def solve(H, f, G, h):
        return pdip_qp(H, f, G, h, iters=iters)

    @solve.def_vmap
    def _rule(axis_size, in_batched, H, f, G, h):
        def bc(x, batched):
            return x if batched else jnp.broadcast_to(
                x, (axis_size, *x.shape))

        out, _ = _batched_pdip(bc(H, in_batched[0]), bc(f, in_batched[1]),
                               bc(G, in_batched[2]), bc(h, in_batched[3]),
                               iters)
        return out, QPSolution(u=True, iterations=False, residual=True)

    return solve


def make_pdip_warm(iters: int = 6):
    """Warm-started variant: fn(H, f, G, h, z_warm, lam_warm) ->
    (QPSolution, (z_final, lam_final)) for threading through receding-
    horizon resolves.  Vmap dispatches to the batched path."""

    @jax.custom_batching.custom_vmap
    def solve(H, f, G, h, z_warm, lam_warm):
        sol, zl = _batched_pdip(
            H[None], f[None], G[None], h[None], iters,
            z_warm[None], lam_warm[None])
        return (QPSolution(u=sol.u[0], iterations=sol.iterations,
                           residual=sol.residual[0]),
                (zl[0][0], zl[1][0]))

    @solve.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = [a if b else jnp.broadcast_to(a, (axis_size, *a.shape))
                for a, b in zip(args, in_batched)]
        out = _batched_pdip(*args[:4], iters,
                            z_warm=args[4], lam_warm=args[5])
        spec = (QPSolution(u=True, iterations=False, residual=True),
                (True, True))
        return out, spec

    return solve


def _batched_admm(H, f, G, h, z_warm, y_warm, iters: int, rho: float,
                  alpha: float):
    """Batch-first over-relaxed ADMM for  min 1/2 z'Hz + f'z  s.t. Gz <= h.

    ONE factorization of (H + rho G'G) per solve (vs one per Newton step in
    PDIP) and matvec-only iterations — the cheapest warm-started batched
    path.  Returns (QPSolution, (z, y)) with y the scaled dual, threaded
    tick-to-tick exactly like the PDIP warm state.
    """
    dtype = H.dtype
    n = f.shape[-1]
    reg = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-6, dtype)
    eye = jnp.eye(n, dtype=dtype)
    Gt = jnp.swapaxes(G, -1, -2)

    # One explicit K^{-1} per solve (Cholesky + one triangular solve with
    # n RHS + a GEMM), then every ADMM iteration is matmul-only.  ADMM
    # tolerates the f32 inverse's ~1e-2 |K Kinv - I| residual (an
    # inexact-ADMM perturbation, self-corrected by the iteration) but not
    # reduced-precision matmuls (TF32 on the GPU): forming K, Kinv and M1
    # and the iteration matvecs are pinned to full f32.
    with jax.default_matmul_precision("float32"):
        K = H + rho * jnp.matmul(Gt, G) + reg * eye
        L = jnp.linalg.cholesky(K)
        Linv = jax.scipy.linalg.solve_triangular(
            L, jnp.broadcast_to(eye, L.shape), lower=True)
        Kinv = jnp.matmul(jnp.swapaxes(Linv, -1, -2), Linv)
        M1 = rho * jnp.matmul(Kinv, Gt)                  # [B, n, m]
        z_base = -jnp.einsum("bij,bj->bi", Kinv, f)

        v0 = jnp.minimum(jnp.einsum("bmn,bn->bm", G, z_warm), h)

        def step(carry, _):
            v, y = carry
            z = z_base + jnp.einsum("bnm,bm->bn", M1, v - y)
            gz = jnp.einsum("bmn,bn->bm", G, z)
            gz_relaxed = alpha * gz + (1.0 - alpha) * v
            v_new = jnp.minimum(gz_relaxed + y, h)
            y = y + gz_relaxed - v_new
            return (v_new, y), None

        (v, y), _ = lax.scan(step, (v0, y_warm), None, length=iters)
        z = z_base + jnp.einsum("bnm,bm->bn", M1, v - y)

        # splitting-consistency residual |Gz - v|_inf: the ADMM
        # convergence measure (OSQP primal residual); strictly positive
        # for any finite iteration count, so downstream schedule logic can
        # use residual > 0 as the "a QP was solved this tick" marker
        r_prim = jnp.max(jnp.abs(jnp.einsum("bmn,bn->bm", G, z) - v),
                         axis=-1)
    residual = r_prim / (1.0 + jnp.max(jnp.abs(f), axis=-1))
    sol = QPSolution(u=z, iterations=iters, residual=residual)
    return sol, (z, y)


def _batched_admm_kron(H, f, Gu, h, z_warm, y_warm, iters: int, rho: float,
                       alpha: float):
    """Batch-first ADMM with block-diagonal constraints G = kron(I_N, Gu).

    The per-step friction cone gives every horizon step the same [mu,nu]
    constraint block (models/srbd.py:friction_cone_rows), so G is never
    materialized: G'G = kron(I, Gu'Gu) is a compile-time constant added to
    H, the M1 = rho K^-1 G' formation shrinks from an [n,n]x[n,m] GEMM to a
    per-block [n,N,nu]x[mu,nu] contraction (~20x fewer MACs at N=20), and
    the per-iteration G matvecs contract over nu instead of n.  Identical
    iterates to :func:`_batched_admm` on the expanded G.

    H [B,n,n]; f [B,n]; Gu [mu,nu] (shared across batch and horizon);
    h [B,m] with m = N*mu, n = N*nu.
    """
    dtype = H.dtype
    B, n = f.shape
    mu_, nu_ = Gu.shape
    N = n // nu_
    m = N * mu_
    reg = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-6, dtype)
    eye = jnp.eye(n, dtype=dtype)
    GtG = jnp.kron(jnp.eye(N, dtype=dtype), Gu.T @ Gu)   # constant-folded
    K = H + (rho * GtG + reg * eye)
    L = jnp.linalg.cholesky(K)

    def g_mv(z):                                         # G z, [B,m]
        zb = z.reshape(-1, N, nu_)
        return jnp.einsum("mv,bkv->bkm", Gu, zb).reshape(-1, m)

    # f32 pin: see _batched_admm — the K^-1 formation is numerically
    # sensitive to reduced-precision matmuls.
    with jax.default_matmul_precision("float32"):
        Linv = jax.scipy.linalg.solve_triangular(
            L, jnp.broadcast_to(eye, L.shape), lower=True)
        Kinv = jnp.matmul(jnp.swapaxes(Linv, -1, -2), Linv)
        M1 = rho * jnp.einsum(
            "bxkv,mv->bxkm", Kinv.reshape(B, n, N, nu_), Gu).reshape(B, n, m)
        z_base = -jnp.einsum("bij,bj->bi", Kinv, f)

        v0 = jnp.minimum(g_mv(z_warm), h)

        def step(carry, _):
            v, y = carry
            z = z_base + jnp.einsum("bnm,bm->bn", M1, v - y)
            gz = g_mv(z)
            gz_relaxed = alpha * gz + (1.0 - alpha) * v
            v_new = jnp.minimum(gz_relaxed + y, h)
            y = y + gz_relaxed - v_new
            return (v_new, y), None

        (v, y), _ = lax.scan(step, (v0, y_warm), None, length=iters)
        z = z_base + jnp.einsum("bnm,bm->bn", M1, v - y)

    r_prim = jnp.max(jnp.abs(g_mv(z) - v), axis=-1)
    residual = r_prim / (1.0 + jnp.max(jnp.abs(f), axis=-1))
    sol = QPSolution(u=z, iterations=iters, residual=residual)
    return sol, (z, y)


def make_admm_warm_kron(Gu: jnp.ndarray, iters: int = 10, rho: float = 1.0,
                        alpha: float = 1.6):
    """Warm-started ADMM specialized to G = kron(I_N, Gu): fn(H, f, h,
    z_warm, y_warm) -> (QPSolution, (z, y)).  Gu [mu,nu] is closed over
    (a compile-time constant — the friction-cone block); the expanded G is
    never formed."""

    @jax.custom_batching.custom_vmap
    def solve(H, f, h, z_warm, y_warm):
        sol, zy = _batched_admm_kron(H[None], f[None], Gu, h[None],
                                     z_warm[None], y_warm[None],
                                     iters, rho, alpha)
        return (QPSolution(u=sol.u[0], iterations=sol.iterations,
                           residual=sol.residual[0]),
                (zy[0][0], zy[1][0]))

    @solve.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = [a if b else jnp.broadcast_to(a, (axis_size, *a.shape))
                for a, b in zip(args, in_batched)]
        sol, zy = _batched_admm_kron(args[0], args[1], Gu, args[2],
                                     args[3], args[4], iters, rho, alpha)
        spec = (QPSolution(u=True, iterations=False, residual=True),
                (True, True))
        return (sol, zy), spec

    return solve


def make_admm_warm(iters: int = 10, rho: float = 1.0, alpha: float = 1.6):
    """Warm-started batched ADMM: fn(H, f, G, h, z_warm, y_warm) ->
    (QPSolution, (z, y)).  Vmap dispatches to the batch-native path; the
    warm state threads tick-to-tick like the PDIP variant."""

    @jax.custom_batching.custom_vmap
    def solve(H, f, G, h, z_warm, y_warm):
        sol, zy = _batched_admm(H[None], f[None], G[None], h[None],
                                z_warm[None], y_warm[None],
                                iters, rho, alpha)
        return (QPSolution(u=sol.u[0], iterations=sol.iterations,
                           residual=sol.residual[0]),
                (zy[0][0], zy[1][0]))

    @solve.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = [a if b else jnp.broadcast_to(a, (axis_size, *a.shape))
                for a, b in zip(args, in_batched)]
        out = _batched_admm(*args, iters, rho, alpha)
        spec = (QPSolution(u=True, iterations=False, residual=True),
                (True, True))
        return out, spec

    return solve


@partial(jax.jit, static_argnames=("iters",))
def admm_qp(H: jnp.ndarray, f: jnp.ndarray, G: jnp.ndarray, l: jnp.ndarray,
            u: jnp.ndarray, iters: int = 50, rho: float = 1.0,
            alpha: float = 1.6,
            z_warm: Optional[jnp.ndarray] = None,
            y_warm: Optional[jnp.ndarray] = None) -> QPSolution:
    """Over-relaxed ADMM for  min 1/2 z'Hz + f'z  s.t.  l <= Gz <= u.

    One Cholesky of (H + rho G'G) per solve; each iteration is two matvecs
    and a clip — the cheapest per-iteration batched solver, and warm-
    startable via (z_warm, y_warm) from the previous MPC tick.
    """
    dtype = H.dtype
    m = l.shape[-1]
    n = f.shape[-1]
    reg = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-6, dtype)

    K = H + rho * (G.T @ G)
    L = _posdef_chol(K, reg)

    z = jnp.zeros((n,), dtype) if z_warm is None else z_warm
    v = G @ z
    y = jnp.zeros((m,), dtype) if y_warm is None else y_warm

    def step(carry, _):
        z, v, y = carry
        rhs = -f + rho * (G.T @ (v - y))
        z_new = _chol_solve(L, rhs)
        gz = G @ z_new
        gz_relaxed = alpha * gz + (1.0 - alpha) * v
        v_new = jnp.clip(gz_relaxed + y, l, u)
        y_new = y + gz_relaxed - v_new
        return (z_new, v_new, y_new), None

    (z, v, y), _ = lax.scan(step, (z, v, y), None, length=iters)

    r_prim = jnp.max(jnp.abs(G @ z - v))
    residual = r_prim / (1.0 + jnp.max(jnp.abs(f)))
    return QPSolution(u=z, iterations=iters, residual=residual)
