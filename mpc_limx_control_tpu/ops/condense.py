"""Condensation: prediction matrices and dense QP formation.

Batched re-design of `QPSolver::buildQPParams` (reference
src/QPSolver.cpp:31-81).  The reference builds A_aug / B_aug with nested
Python-style loops and `Ad.pow`; here both are produced by a single
`lax.scan` over the horizon (O(N) sequential steps of batched matmuls), which
XLA unrolls/fuses, and the whole pipeline generalizes to
time-varying (Ad_t, Bd_t) — required for contact-scheduled SRBD MPC, where B
switches with the gait (capability the reference's single-support `mpcQP`
only gestures at).

Shapes (single scenario; batch via vmap):
    Ad [nx,nx] or [N,nx,nx]      Bd [nx,nu] or [N,nx,nu]
    A_blocks [N+1,nx,nx]         A_blocks[i] = Ad_{i-1}...Ad_0
    B_blocks [N+1,N,nx,nu]       B_blocks[i,j] = Ad_{i-1}..Ad_{j+1} Bd_j, j<i
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


class CondensedQP(NamedTuple):
    """Dense condensed QP: min 1/2 z'Hz + f'z  s.t.  Gz <= h.

    H [nz,nz]; f [nz]; G [m,nz]; h [m]  (nz = N*nu).
    `A_blocks`/`B_blocks` are kept for state reconstruction and diagnostics.
    """

    H: jnp.ndarray
    f: jnp.ndarray
    G: jnp.ndarray
    h: jnp.ndarray
    A_blocks: jnp.ndarray
    B_blocks: jnp.ndarray


def prediction_matrices(Ad: jnp.ndarray, Bd: jnp.ndarray, N: int):
    """Build (A_blocks [N+1,nx,nx], B_blocks [N+1,N,nx,nu]) by scan.

    Accepts LTI ([nx,nx]) or LTV ([N,nx,nx]) inputs.  Equivalent to the
    reference's power form (src/QPSolver.cpp:36-47) when LTI.
    """
    nx = Ad.shape[-1]
    nu = Bd.shape[-1]
    dtype = Ad.dtype
    if Ad.ndim == 2:
        Ad = jnp.broadcast_to(Ad, (N, nx, nx))
    if Bd.ndim == 2:
        Bd = jnp.broadcast_to(Bd, (N, nx, nu))

    eye = jnp.eye(nx, dtype=dtype)

    def step_a(phi, a_t):
        phi_next = a_t @ phi
        return phi_next, phi_next

    # full unroll: N is small (15-20) and the per-step matmuls are tiny;
    # unrolling lets XLA fuse the whole chain instead of paying scan
    # latency per step
    _, phis = lax.scan(step_a, eye, Ad, unroll=True)
    A_blocks = jnp.concatenate([eye[None], phis], axis=0)

    # Row recursion: G_i = Ad_{i-1} @ G_{i-1} + e_{i-1} (x) Bd_{i-1}.
    # G_{i-1}[i-1] is zero before its own injection, so the one-hot add is
    # exact (no dynamic-index update needed).
    onehot = jnp.eye(N, dtype=dtype)

    def step_b(g_prev, inp):
        a_t, b_t, e_t = inp
        g = jnp.einsum("xy,nyu->nxu", a_t, g_prev)
        g = g + e_t[:, None, None] * b_t[None]
        return g, g

    g0 = jnp.zeros((N, nx, nu), dtype)
    _, rows = lax.scan(step_b, g0, (Ad, Bd, onehot), unroll=True)
    B_blocks = jnp.concatenate([g0[None], rows], axis=0)
    return A_blocks, B_blocks


def _flatten_b(B_blocks: jnp.ndarray) -> jnp.ndarray:
    """[N+1,N,nx,nu] -> [(N+1)*nx, N*nu] dense prediction matrix."""
    n1, N, nx, nu = B_blocks.shape
    return B_blocks.transpose(0, 2, 1, 3).reshape(n1 * nx, N * nu)


def condense(
    Ad: jnp.ndarray,
    Bd: jnp.ndarray,
    Q: jnp.ndarray,
    R: jnp.ndarray,
    P: jnp.ndarray,
    N: int,
    x0: jnp.ndarray,
    x_ref: jnp.ndarray,
    u_min: float,
    u_max: float,
    x_min: Optional[jnp.ndarray] = None,
    x_max: Optional[jnp.ndarray] = None,
    extra_G: Optional[jnp.ndarray] = None,
    extra_h: Optional[jnp.ndarray] = None,
) -> CondensedQP:
    """Form the condensed QP for one scenario.

    x_ref is [N+1, nx] (row i = reference state at step i; the reference
    stores the transpose and flattens column-major, src/QPSolver.cpp:59 —
    identical vector).  Cost H = 2(B'Q̄B + R̄),
    f = 2 B'Q̄(A_aug x0 - x_ref_vec) (src/QPSolver.cpp:58-60).

    Constraints assembled as G z <= h:
      * input box (src/QPSolver.cpp:67-68)
      * state box through prediction rows 1..N (src/QPSolver.cpp:71-80)
      * optional extra rows (friction cones...): extra_G [me, N*nu].

    The reference's over-determined "equality constraints"
    (src/QPSolver.cpp:63-64) are intentionally dropped — see
    oracle/qp_oracle.py for why they cannot be honored.
    """
    # Full f32 contractions: a TF32 H/f (the GPU default for f32 dots)
    # moves the walking solve by ~5e-4 of the force scale, half the f32
    # budget of 1e-3; pinned, it stays at ~3e-6 (chip_smoke phase 6).
    with jax.default_matmul_precision("float32"):
        nx = Ad.shape[-1]
        nu = Bd.shape[-1]
        dtype = x0.dtype
        A_blocks, B_blocks = prediction_matrices(Ad, Bd, N)
        B_mat = _flatten_b(B_blocks)                       # [(N+1)nx, Nnu]
        nz = N * nu

        # Block-diagonal cost application without materializing Q_bar.
        Qs = jnp.concatenate(
            [jnp.broadcast_to(Q, (N, nx, nx)), P[None]], axis=0)  # [N+1,nx,nx]
        B_rows = B_mat.reshape(N + 1, nx, nz)
        QB = jnp.einsum("ixy,iyz->ixz", Qs, B_rows).reshape((N + 1) * nx, nz)
        R_bar = jnp.kron(jnp.eye(N, dtype=dtype), R)
        H = 2.0 * (B_mat.T @ QB + R_bar)
        H = 0.5 * (H + H.T)

        x_pred_free = (A_blocks @ x0).reshape(-1)      # A_aug x0 [(N+1)nx]
        err = x_pred_free - x_ref.reshape(-1)
        f = 2.0 * (QB.T @ err)

        G_parts = []
        h_parts = []
        if u_min is not None:
            eye_z = jnp.eye(nz, dtype=dtype)
            G_parts += [eye_z, -eye_z]
            h_parts += [jnp.full((nz,), u_max, dtype),
                        jnp.full((nz,), -u_min, dtype)]

        if x_min is not None:
            B_pred = B_mat[nx:]                            # states 1..N
            xf = x_pred_free[nx:]
            x_max_t = jnp.tile(jnp.asarray(x_max, dtype), N)
            x_min_t = jnp.tile(jnp.asarray(x_min, dtype), N)
            G_parts += [B_pred, -B_pred]
            h_parts += [x_max_t - xf, -(x_min_t - xf)]

        if extra_G is not None:
            G_parts.append(extra_G)
            h_parts.append(extra_h)

        G = jnp.concatenate(G_parts, axis=0)
        h = jnp.concatenate(h_parts, axis=0)
        return CondensedQP(H=H, f=f, G=G, h=h,
                           A_blocks=A_blocks, B_blocks=B_blocks)


def condense_lti_diag(Ad: jnp.ndarray, Bd_t: jnp.ndarray,
                      q_diag, r_diag, p_diag, N: int,
                      x0: jnp.ndarray, x_ref: jnp.ndarray):
    """Band-form condensation for LTI Ad + LTV Bd + DIAGONAL weights.

    Produces exactly the (H, f) of :func:`condense` (reference cost layout,
    src/QPSolver.cpp:50-60) but without materializing the prediction matrix
    B_mat [(N+1)nx, Nnu] or QB — the dominant HBM traffic and GEMM of the
    walking tick.  Uses the block-Toeplitz structure of B'Q̄B when Ad is
    step-invariant (true for the shared-yaw SRBD linearization,
    models/srbd.py):

        H[j,k]/2 = Bd_j' (Ad')^{k-j} W_k Bd_k + delta_jk R      (j <= k)
        W_k      = Q + Ad' W_{k+1} Ad,   W_{N-1} = P            (backward)
        f[j]/2   = Bd_j' s_j,   s_j = Q_{j+1} err_{j+1} + Ad' s_{j+1}

    so the cost is O(N nx^2 (nx + N nu)) small matmuls instead of the
    O((N nu)^2 N nx) dense GEMM — ~4x fewer MACs at N=20/nx=13/nu=3 and
    ~500x less intermediate memory per scenario.

    Args: Ad [nx,nx]; Bd_t [N,nx,nu]; q_diag/r_diag/p_diag length nx/nu/nx;
    x0 [nx]; x_ref [N+1,nx].  Returns (H [nz,nz], f [nz]).  Batch via vmap.
    """
    nx = Ad.shape[-1]
    nu = Bd_t.shape[-1]
    dtype = x0.dtype
    nz = N * nu
    q = jnp.asarray(q_diag, dtype)
    r = jnp.asarray(r_diag, dtype)
    p = jnp.asarray(p_diag, dtype)
    AdT = Ad.T

    # ---- W_k backward recursion (cost-to-go Gramians) ------------------
    def w_step(W, _):
        W_prev = jnp.diag(q) + AdT @ W @ Ad
        return W_prev, W_prev

    W_last = jnp.diag(p)
    _, Ws_rev = lax.scan(w_step, W_last, None, length=N - 1, unroll=True)
    Ws = jnp.concatenate([Ws_rev[::-1], W_last[None]], axis=0)  # [N,nx,nx]

    V = jnp.einsum("kxy,kyu->kxu", Ws, Bd_t)            # W_k Bd_k [N,nx,nu]

    # ---- band assembly: S[j, j+d] = Bd_j' (Ad')^d V_{j+d} --------------
    S = jnp.zeros((N, N, nu, nu), dtype)
    T = V
    for d in range(N):
        if d > 0:
            T = jnp.einsum("yx,kyu->kxu", Ad, T)        # T_d[k] = Ad' T_{d-1}[k]
        band = jnp.einsum("jxu,jxv->juv", Bd_t[:N - d], T[d:])
        j_idx = jnp.arange(N - d)
        S = S.at[j_idx, j_idx + d].set(band)

    U = S.transpose(0, 2, 1, 3).reshape(nz, nz)         # upper incl. diagonal
    diag_idx = jnp.arange(N)
    D = jnp.zeros((N, N, nu, nu), dtype).at[diag_idx, diag_idx].set(
        S[diag_idx, diag_idx])
    Dmat = D.transpose(0, 2, 1, 3).reshape(nz, nz)
    R_bar = jnp.diag(jnp.tile(r, N))
    H = 2.0 * (U + U.T - Dmat + R_bar)

    # ---- f: adjoint (backward) sweep instead of QB' err ----------------
    def fwd(x, _):
        xn = Ad @ x
        return xn, xn

    _, xs = lax.scan(fwd, x0, None, length=N, unroll=True)
    err = jnp.concatenate([x0[None], xs], axis=0) - x_ref       # [N+1,nx]
    qw = jnp.concatenate(
        [jnp.broadcast_to(q, (N - 1, nx)), p[None]], axis=0)    # Q_1..Q_N
    qerr = qw * err[1:]                                          # [N,nx]

    def bwd(s, qe):
        s_new = qe + AdT @ s
        return s_new, s_new

    _, ss = lax.scan(bwd, jnp.zeros((nx,), dtype), qerr[::-1], unroll=True)
    s = ss[::-1]                                                 # s_j [N,nx]
    f = 2.0 * jnp.einsum("jxu,jx->ju", Bd_t, s).reshape(nz)
    return H, f


class CondensationCache(NamedTuple):
    """Per-(Ad,Bd) precomputation for LTI MPC: everything that does not
    depend on (x0, x_ref).  The reference rebuilds all of this every control
    step (src/QPSolver.cpp:31-60); caching it leaves only two small matvecs
    per tick on the device.

    A_blocks [N+1,nx,nx]; B_mat [(N+1)nx, nz]; QB [(N+1)nx, nz];
    H [nz,nz]; G [m,nz] (constraint matrix, constant for box+state rows).
    """

    A_blocks: jnp.ndarray
    B_mat: jnp.ndarray
    QB: jnp.ndarray
    H: jnp.ndarray
    G: jnp.ndarray
    N: int
    nx: int
    nu: int


def condense_cache(Ad, Bd, Q, R, P, N, with_state_rows: bool = True,
                   extra_G: Optional[jnp.ndarray] = None) -> CondensationCache:
    """Precompute the x0-independent parts of the condensed QP."""
    nx = Ad.shape[-1]
    nu = Bd.shape[-1]
    dtype = Ad.dtype
    A_blocks, B_blocks = prediction_matrices(Ad, Bd, N)
    B_mat = _flatten_b(B_blocks)
    nz = N * nu
    Qs = jnp.concatenate(
        [jnp.broadcast_to(Q, (N, nx, nx)), P[None]], axis=0)
    B_rows = B_mat.reshape(N + 1, nx, nz)
    QB = jnp.einsum("ixy,iyz->ixz", Qs, B_rows).reshape((N + 1) * nx, nz)
    R_bar = jnp.kron(jnp.eye(N, dtype=dtype), R)
    H = 2.0 * (B_mat.T @ QB + R_bar)
    H = 0.5 * (H + H.T)

    eye_z = jnp.eye(nz, dtype=dtype)
    G_parts = [eye_z, -eye_z]
    if with_state_rows:
        G_parts += [B_mat[nx:], -B_mat[nx:]]
    if extra_G is not None:
        G_parts.append(extra_G)
    G = jnp.concatenate(G_parts, axis=0)
    return CondensationCache(A_blocks=A_blocks, B_mat=B_mat, QB=QB, H=H,
                             G=G, N=N, nx=nx, nu=nu)


def linear_terms(cache: CondensationCache, x0, x_ref, u_min, u_max,
                 x_min=None, x_max=None, extra_h=None):
    """Per-tick linear pieces (f, h) for the cached condensation.

    x_ref is [N+1, nx].  Must pass x_min/x_max iff the cache was built with
    state rows, and extra_h iff it was built with extra_G.
    """
    N, nx, nu = cache.N, cache.nx, cache.nu
    dtype = x0.dtype
    nz = N * nu
    x_pred_free = (cache.A_blocks @ x0).reshape(-1)
    err = x_pred_free - x_ref.reshape(-1)
    f = 2.0 * (cache.QB.T @ err)

    h_parts = [jnp.full((nz,), u_max, dtype), jnp.full((nz,), -u_min, dtype)]
    if x_min is not None:
        xf = x_pred_free[nx:]
        x_max_t = jnp.tile(jnp.asarray(x_max, dtype), N)
        x_min_t = jnp.tile(jnp.asarray(x_min, dtype), N)
        h_parts += [x_max_t - xf, -(x_min_t - xf)]
    if extra_h is not None:
        h_parts.append(extra_h)
    return f, jnp.concatenate(h_parts, axis=0)


def predict_states(qp: CondensedQP, x0: jnp.ndarray,
                   z: jnp.ndarray) -> jnp.ndarray:
    """Reconstruct the predicted state trajectory [N+1, nx] from controls."""
    free = qp.A_blocks @ x0                             # [N+1, nx]
    forced = jnp.einsum("ijxu,ju->ix", qp.B_blocks,
                        z.reshape(qp.B_blocks.shape[1], -1))
    return free + forced
