"""Warm-started condensed GRF MPC solves: XLA composition + a Triton kernel.

Both solvers below answer the stance-force QP of the walking/standing
controller (reference src/QPSolver.cpp:31-106: dense condensation + QP
solve) with the same warm ADMM iterates as ops/qp.py:_batched_admm:

* the XLA composition — ops/condense.py:condense + _batched_admm; it runs
  for every unbatched call, for the two-foot standing form (nu = 6) and on
  every backend without a GPU;
* :func:`fused_walking_qp` — a Pallas kernel lowered through Triton for
  the single-support walking form (nu = 3) on the GPU.  One program solves
  one scenario: forward condensation (the prediction-matrix row block
  Gamma_k and the free response Ad^k x0 carried through the horizon,
  H += Gamma_k' Q_k Gamma_k), K^-1 of K = H + rho G'G + reg I by a
  symmetric sweep, M1 = rho K^-1 G', and the ADMM iterations, all in
  registers.  Device memory sees only the (padded) QP inputs and
  (z, y, residual), where the XLA composition writes and re-reads H, K,
  L, L^-1, K^-1 and M1 per tick.  (Exact forward/backward substitution per
  iteration was tried first: 720 dependent masked steps per scenario made
  the solve 1.8-2.3x slower than the XLA composition on an H100; the
  sweep needs 60.)

No TF32: every contraction in the kernel is either an elementwise
multiply-and-reduce or a ``pl.dot`` with ``precision=HIGHEST``, which the
Triton lowering maps to IEEE f32 FMA (``input_precision=ieee``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.custom_partitioning import custom_partitioning
from jax.experimental.pallas import triton as plt
from jax.sharding import NamedSharding, PartitionSpec as P

from mpc_limx_control_tpu.core.types import QPSolution

_HI = lax.Precision.HIGHEST
# Eight warps a program: the [64,128] M1 and [128,64] G operands take 32
# registers a thread each (measured on an H100: 8 warps beat 4 and 2 at
# B=1024 and B=4096).
_NUM_WARPS = 8


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _qp_kernel(ad_ref, bc_ref, xr_ref, x0_ref, zw_ref, yw_ref,
               q_ref, p_ref, c_ref, g_ref, h_ref,
               z_ref, y_ref, res_ref, *, N, nu, iters, rho, alpha):
    """One scenario: condense -> K^-1 -> warm ADMM (padded shapes).

    ad [X,X]; bc [X,NP] (Bd_k in columns nu*k..nu*k+nu-1); xr [NR,X]
    (x_ref rows 1..N); x0 [X]; zw [NP]; yw [MP]; q/p [X]; c [NP,NP]
    (2R + rho G'G + reg I, identity on the padding); g [MP,NP]; h [MP].
    Padded rows/columns are zero, so they never reach the real entries.
    """
    n = N * nu
    ad = ad_ref[...]
    bc = bc_ref[...]
    q = q_ref[...]
    p = p_ref[...]
    X, NP = bc.shape
    blk = lax.broadcasted_iota(jnp.int32, (X, NP), 1) // nu

    # ---- condensation: Gamma_{k+1} = Ad Gamma_k + Bd_k E_k -------------
    def cond_step(k, carry):
        gam, c, H, f = carry
        gam = (pl.dot(ad, gam, precision=_HI)
               + jnp.where(blk == k, bc, 0.0))
        c = jnp.sum(ad * c[None, :], axis=1)          # Ad^{k+1} x0
        w = jnp.where(k == N - 1, p, q)
        H = H + pl.dot(gam, w[:, None] * gam, trans_a=True, precision=_HI)
        e = w * (c - xr_ref[k, :])
        f = f + jnp.sum(gam * e[:, None], axis=0)
        return gam, c, H, f

    zero_h = jnp.zeros((NP, NP), jnp.float32)
    _, _, H, f = lax.fori_loop(
        0, N, cond_step,
        (jnp.zeros((X, NP), jnp.float32), x0_ref[...], zero_h,
         jnp.zeros((NP,), jnp.float32)))
    f = 2.0 * f
    H = H + H.T                     # 2 sym(Gamma'QGamma): condense's form
    K = H + c_ref[...]

    ri = lax.broadcasted_iota(jnp.int32, (NP, NP), 0)
    ci = lax.broadcasted_iota(jnp.int32, (NP, NP), 1)
    vi = lax.broadcasted_iota(jnp.int32, (NP,), 0)
    # ---- symmetric sweep (Gauss-Jordan without pivoting, stable on the
    # SPD K) in registers: after pivots 0..n-1 the matrix holds -K^-1.
    # Each pivot is one masked column extraction and a rank-1 update; the
    # ADMM iterations are then two matvecs each, as in _batched_admm.
    def sweep(k, A):
        colk = jnp.sum(jnp.where(ci == k, A, 0.0), axis=1)
        inv = 1.0 / jnp.sum(jnp.where(vi == k, colk, 0.0))
        u = jnp.where(vi == k, 0.0, colk)
        A = A - (u[:, None] * u[None, :]) * inv
        ui = u * inv
        A = jnp.where(ci == k, ui[:, None], A)
        A = jnp.where(ri == k, ui[None, :], A)
        return jnp.where((ri == k) & (ci == k), -inv, A)

    kinv = -lax.fori_loop(0, n, sweep, K)
    m1 = rho * pl.dot(kinv, g_ref[...], trans_b=True, precision=_HI)
    z_base = -jnp.sum(kinv * f[None, :], axis=1)

    def z_of(w):                         # K^-1 (rho G'w - f)
        return z_base + jnp.sum(m1 * w[None, :], axis=1)

    def g_mv(z):
        return jnp.sum(g_ref[...] * z[None, :], axis=1)

    h = h_ref[...]

    def admm_iter(_, carry):
        v, y = carry
        z = z_of(v - y)
        gzr = alpha * g_mv(z) + (1.0 - alpha) * v
        v_new = jnp.minimum(gzr + y, h)
        return v_new, y + gzr - v_new

    v0 = jnp.minimum(g_mv(zw_ref[...]), h)
    v, y = lax.fori_loop(0, iters, admm_iter, (v0, yw_ref[...]))
    z = z_of(v - y)
    res = jnp.max(jnp.abs(g_mv(z) - v)) / (1.0 + jnp.max(jnp.abs(f)))
    z_ref[...] = z
    y_ref[...] = y
    res_ref[...] = jnp.full(res_ref.shape, res, jnp.float32)


# operands: six per-scenario blocks (leading axis b), five shared constants
_KERNEL_RULE = ("b a0 a1, b a2 a3, b a4 a5, b a6, b a7, b a8, "
                "c0, c1, c2 c3, c4 c5, c6 -> b r0, b r1, b r2")


def _scenario_partitioned(call):
    """`call` (the kernel on any batch) with a partitioning rule for
    sharded jits: the per-scenario operands and all results are split
    along the leading axis like operand 0, the constants are replicated.
    Without it XLA would gather the whole batch onto every device."""
    fn = custom_partitioning(call)

    def axis(arg_shapes):
        spec = getattr(arg_shapes[0].sharding, "spec", ())
        return spec[0] if len(spec) else None

    def infer(mesh, arg_shapes, result_shape):
        return tuple(NamedSharding(mesh, P(axis(arg_shapes)))
                     for _ in result_shape)

    def partition(mesh, arg_shapes, result_shape):
        ax = axis(arg_shapes)
        args = tuple(NamedSharding(mesh, P(ax) if i < 6 else P())
                     for i in range(len(arg_shapes)))
        return mesh, call, infer(mesh, arg_shapes, result_shape), args

    fn.def_partition(partition=partition, infer_sharding_from_operands=infer,
                     sharding_rule=_KERNEL_RULE)
    return fn


@functools.partial(
    jax.jit, static_argnames=("N", "iters", "rho", "alpha", "reg",
                              "q_diag", "r_diag", "p_diag", "Gu", "h",
                              "interpret"))
def fused_walking_qp(Ad, Bd_t, x_ref, x0, z_warm, y_warm, *,
                     N: int, iters: int, rho: float, alpha: float,
                     reg: float, q_diag, r_diag, p_diag, Gu, h,
                     interpret: bool = False):
    """Batched condensation + warm-ADMM GRF solve in one Triton kernel.

    Ad [B,nx,nx]; Bd_t [B,N,nx,nu]; x_ref [B,N+1,nx]; x0 [B,nx];
    z_warm [B,N*nu]; y_warm [B,N*mu].  Static: the diagonal weights, cone
    rows Gu [mu][nu] and bounds h [N*mu] as nested tuples.  Returns
    (z [B,n], y [B,m], residual [B]).  `interpret` runs the kernel in the
    Pallas interpreter (CPU tests only).
    """
    B, nx = x0.shape
    nu = Bd_t.shape[-1]
    mu_ = len(Gu)
    n, m = N * nu, N * mu_
    X, NP, MP, NR = _pow2(nx), _pow2(n), _pow2(m), _pow2(N)
    f32 = jnp.float32

    def pad(a, *widths):
        return jnp.pad(a.astype(f32), ((0, 0),) + tuple(
            (0, w - s) for w, s in zip(widths, a.shape[1:])))

    ad = pad(Ad, X, X)
    bc = pad(jnp.swapaxes(Bd_t, 1, 2).reshape(B, nx, n), X, NP)
    xr = pad(x_ref[:, 1:], NR, X)

    Gu_np = np.asarray(Gu, np.float64)
    G_np = np.kron(np.eye(N), Gu_np)
    c_np = np.eye(NP)                         # identity on the padding
    c_np[:n, :n] = (2.0 * np.kron(np.eye(N), np.diag(r_diag))
                    + rho * G_np.T @ G_np + reg * np.eye(n))
    g_np = np.zeros((MP, NP))
    g_np[:m, :n] = G_np
    consts = [np.pad(np.asarray(q_diag, np.float64), (0, X - nx)),
              np.pad(np.asarray(p_diag, np.float64), (0, X - nx)),
              c_np, g_np,
              np.pad(np.asarray(h, np.float64), (0, MP - m))]
    consts = [jnp.asarray(a, f32) for a in consts]

    kernel = functools.partial(_qp_kernel, N=N, nu=nu, iters=iters,
                               rho=float(rho), alpha=float(alpha))

    def call(*args):                    # any batch: grid = leading axis
        nb = args[0].shape[0]

        def per_scenario(a):
            return pl.BlockSpec((None, *a.shape[1:]),
                                lambda b, _k=a.ndim - 1: (b,) + (0,) * _k)

        def shared(a):
            return pl.BlockSpec(a.shape, lambda b, _k=a.ndim: (0,) * _k)

        return pl.pallas_call(
            kernel,
            grid=(nb,),
            in_specs=[per_scenario(a) for a in args[:6]]
                     + [shared(a) for a in args[6:]],
            out_specs=tuple(pl.BlockSpec((None, w), lambda b: (b, 0))
                            for w in (NP, MP, 16)),
            out_shape=tuple(jax.ShapeDtypeStruct((nb, w), f32)
                            for w in (NP, MP, 16)),
            backend="triton",
            compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                               num_stages=1),
            interpret=interpret,
            name="walking_qp",
        )(*args)

    z, y, res = _scenario_partitioned(call)(
        ad, bc, xr, pad(x0, X), pad(z_warm, NP), pad(y_warm, MP), *consts)
    return z[:, :n], y[:, :m], res[:, 0]


def use_kernel(nu: int) -> bool:
    """The Triton kernel serves the single-support form (nu = 3) on the
    GPU; the two-foot form (nu = 6, a 128x128 factor) and every other
    backend take the XLA composition."""
    return nu == 3 and jax.default_backend() == "gpu"


class _QPConsts:
    """Static QP data of the stance-force MPC as hashable tuples."""

    def __init__(self, c, two_feet: bool):
        mu = float(c.friction_mu)
        Gu1 = ((1.0, 0.0, -mu), (-1.0, 0.0, -mu),
               (0.0, 1.0, -mu), (0.0, -1.0, -mu),
               (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
        hu = (0.0, 0.0, 0.0, 0.0, float(c.fz_max), -float(c.fz_min))
        r1 = tuple(float(v) for v in c.r_diag)
        if two_feet:
            Gu_np = np.zeros((12, 6))
            Gu_np[:6, :3] = Gu1
            Gu_np[6:, 3:] = Gu1
            self.Gu = tuple(tuple(float(v) for v in row) for row in Gu_np)
            hu, r1 = hu * 2, r1 * 2
        else:
            self.Gu = Gu1
        self.N = int(c.horizon)
        self.h = hu * self.N
        self.r_diag = r1
        self.q_diag = tuple(float(v) for v in c.q_diag)
        self.p_diag = tuple(float(c.p_scale) * float(v) for v in c.q_diag)
        self.iters = int(c.solver.admm_warm_iters)
        self.rho = float(c.solver.admm_rho)
        self.alpha = float(c.solver.admm_alpha)
        self.reg = 1e-6

    def kernel_kw(self):
        return dict(N=self.N, iters=self.iters, rho=self.rho,
                    alpha=self.alpha, reg=self.reg, q_diag=self.q_diag,
                    r_diag=self.r_diag, p_diag=self.p_diag, Gu=self.Gu,
                    h=self.h)


def _xla_solve(k: _QPConsts, Ad, Bd_t, x_ref, x0, z_warm, y_warm):
    """Batched XLA composition (condense + _batched_admm): the reference
    semantics of the kernel."""
    from mpc_limx_control_tpu.ops import condense as _cnd
    from mpc_limx_control_tpu.ops import qp as _qps

    dtype = x0.dtype
    B = x0.shape[0]
    N = k.N
    Q = jnp.diag(jnp.asarray(k.q_diag, dtype))
    R = jnp.diag(jnp.asarray(k.r_diag, dtype))
    P = jnp.diag(jnp.asarray(k.p_diag, dtype))
    G = jnp.kron(jnp.eye(N, dtype=dtype), jnp.asarray(k.Gu, dtype))
    hv = jnp.asarray(k.h, dtype)
    qp = jax.vmap(lambda a, b, xr, xx: _cnd.condense(
        a, b, Q, R, P, N, xx, xr, None, None,
        extra_G=G, extra_h=hv))(Ad, Bd_t, x_ref, x0)
    return _qps._batched_admm(
        qp.H, qp.f, jnp.broadcast_to(G, (B, *G.shape)),
        jnp.broadcast_to(hv, (B, *hv.shape)),
        z_warm, y_warm, k.iters, k.rho, k.alpha)


def _batched_solve(k: _QPConsts, kernel, Ad, Bd_t, x_ref, x0,
                   z_warm, y_warm):
    """(QPSolution, (z, y)) over a batch, through `kernel` (a
    fused_walking_qp-like callable) or, when None, the XLA composition."""
    if kernel is None:
        return _xla_solve(k, Ad, Bd_t, x_ref, x0, z_warm, y_warm)
    z, y, res = kernel(Ad, Bd_t, x_ref, x0, z_warm, y_warm,
                       **k.kernel_kw())
    return QPSolution(u=z, iterations=k.iters, residual=res), (z, y)


def _default_kernel(nu: int):
    return fused_walking_qp if use_kernel(nu) else None


def make_walking_fused(cfg):
    """Warm walking GRF solver from the FULL controller config:
    fn(arms, x0, v_des, yaw_rate, z_warm, y_warm, anchor) ->
    (QPSolution, xi_pred, (z, y)).  anchor [3] = (x, y, yaw) is the
    reference pose origin (pass x0's xy + yaw for the fully receding
    reference).

    arms [N,3] per scenario (vmap for batches).  SRBD linearization, ZOH
    and the walking reference run in XLA; under vmap the QP goes to the
    Triton kernel on the GPU (see :func:`use_kernel`).
    """
    from mpc_limx_control_tpu.models import srbd as _srbd

    c = cfg.srbd
    k = _QPConsts(c, two_feet=False)
    kernel = _default_kernel(3)
    N = k.N
    ts = float(c.ts)
    height_des = float(cfg.ground_height) + float(cfg.base_height)

    def _batched(kern, arms, x0, v_des, yaw_rate, z_warm, y_warm, anc):
        dtype = x0.dtype
        Ac, Bc_t = jax.vmap(lambda a, p, yw: _srbd.linearize_shared(
            cfg.robot, a, p, yw, dtype))(arms, x0[:, 3:6], x0[:, 2])
        Ad, Bd_t = _srbd.discretize_srbd(Ac, Bc_t, ts)
        anc3 = jnp.concatenate(
            [anc[:, :2], jnp.zeros_like(anc[:, :1])], -1)
        x_ref = jax.vmap(lambda xx, vv, ww, aa, ya: _srbd.walking_reference(
            xx, c, N, vv, ww, height_des=height_des,
            pos_anchor=aa, yaw_anchor=ya))(x0, v_des, yaw_rate, anc3,
                                           anc[:, 2])
        sol, zy = _batched_solve(k, kern, Ad, Bd_t, x_ref, x0,
                                 z_warm, y_warm)
        u0 = sol.u[:, :3]
        xp = (jnp.einsum("bxy,by->bx", Ad, x0)
              + jnp.einsum("bxu,bu->bx", Bd_t[:, 0], u0))
        return sol, xp, zy

    @jax.custom_batching.custom_vmap
    def solve(arms, x0, v_des, yaw_rate, z_warm, y_warm, anchor):
        sol, xp, zy = _batched(
            None, arms[None], x0[None], v_des[None], yaw_rate[None],
            z_warm[None], y_warm[None], anchor[None])
        return (QPSolution(u=sol.u[0], iterations=sol.iterations,
                           residual=sol.residual[0]),
                xp[0], (zy[0][0], zy[1][0]))

    @solve.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = [a if b else jnp.broadcast_to(a, (axis_size, *a.shape))
                for a, b in zip(args, in_batched)]
        out = _batched(kernel, *args)
        spec = (QPSolution(u=True, iterations=False, residual=True),
                True, (True, True))
        return out, spec

    return solve


def make_admm_fused(cfg_srbd, two_feet: bool = False):
    """Warm-started condensation+ADMM solver for the stance GRF QP:
    fn(Ad, Bd_t, x_ref, x0, z_warm, y_warm) -> (QPSolution, (z, y)).

    two_feet=False: the single-support walking form (nu = 3, one cone).
    two_feet=True: the double-support standing form (nu = 6, block-diag
    cone for both feet, input weights duplicated) — the stance_mpc QP of
    control/controller.py with a full-stance schedule.

    All weights/cone constants come from the SRBDConfig (compile-time
    Python floats).  The unbatched path runs the XLA composition; under
    vmap the kernel choice follows :func:`use_kernel`.
    """
    k = _QPConsts(cfg_srbd, two_feet=two_feet)
    kernel = _default_kernel(6 if two_feet else 3)

    @jax.custom_batching.custom_vmap
    def solve(Ad, Bd_t, x_ref, x0, z_warm, y_warm):
        sol, zy = _xla_solve(k, Ad[None], Bd_t[None], x_ref[None],
                             x0[None], z_warm[None], y_warm[None])
        return (QPSolution(u=sol.u[0], iterations=sol.iterations,
                           residual=sol.residual[0]),
                (zy[0][0], zy[1][0]))

    @solve.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = [a if b else jnp.broadcast_to(a, (axis_size, *a.shape))
                for a, b in zip(args, in_batched)]
        out = _batched_solve(k, kernel, *args)
        spec = (QPSolution(u=True, iterations=False, residual=True),
                (True, True))
        return out, spec

    return solve
