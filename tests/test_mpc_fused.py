"""The batched GRF solves of ops/mpc_fused_pallas.py on the CPU.

The Triton walking-QP kernel runs here in the Pallas interpreter and must
reproduce the XLA reference composition (ops/condense.py:condense +
ops/qp.py:_batched_admm) and an independent float64 oracle of the same
ADMM iterates (oracle/corpus.py:condense_ltv_f64 + NumPy), across
horizons and batch sizes (padding: n 60 -> 64, m 120 -> 128, N -> 32).
Also pinned: the choice of kernel (nu = 3 on the GPU only), its
custom_vmap rule, and the unbatched path.  The same kernel compiled for
the card is checked by tests/test_gpu.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_limx_control_tpu.core.config import ControllerConfig
from mpc_limx_control_tpu.models import srbd
from mpc_limx_control_tpu.ops import mpc_fused_pallas as fused


def _small_cfg(N=8):
    cfg = ControllerConfig.walking()
    return dataclasses.replace(
        cfg, srbd=dataclasses.replace(cfg.srbd, horizon=N))


def _walking_inputs(B, key, cfg=None):
    """Realistic single-support walking QP inputs for B scenarios."""
    cfg = cfg or ControllerConfig.walking()
    c = cfg.srbd
    N = c.horizon
    k1, k2, k3, k4 = jax.random.split(key, 4)
    pos = jnp.asarray([0.0, 0.0, 0.65], jnp.float32) + \
        0.02 * jax.random.normal(k1, (B, 3), jnp.float32)
    yaw = 0.1 * jax.random.normal(k2, (B,), jnp.float32)
    arms = pos[:, None, :] + jnp.asarray([0.02, 0.1, -0.65]) + \
        0.03 * jax.random.normal(k3, (B, N, 3), jnp.float32)
    Ac, Bc_t = jax.vmap(
        lambda a, p, y: srbd.linearize_shared(cfg.robot, a, p, y,
                                              jnp.float32))(arms, pos, yaw)
    Ad, Bd_t = srbd.discretize_srbd(Ac, Bc_t, c.ts)
    xi0 = jax.vmap(srbd.initial_state)(
        jnp.concatenate([0.01 * jax.random.normal(k4, (B, 2)),
                         yaw[:, None]], -1),
        pos,
        jnp.zeros((B, 3)),
        jnp.asarray([0.4, 0.0, 0.0]) + jnp.zeros((B, 3)))
    v_des = jnp.broadcast_to(jnp.asarray([0.5, 0.0, 0.0]), (B, 3))
    x_ref = jax.vmap(lambda x, v: srbd.walking_reference(
        x, c, N, v, jnp.zeros(()), height_des=0.65))(xi0, v_des)
    return cfg, Ad.astype(jnp.float32), Bd_t.astype(jnp.float32), \
        x_ref.astype(jnp.float32), xi0.astype(jnp.float32)


def _warm(B, N):
    kz, ky = jax.random.split(jax.random.PRNGKey(9))
    z_w = 5.0 * jax.random.normal(kz, (B, 3 * N), jnp.float32)
    y_w = jnp.abs(jax.random.normal(ky, (B, 6 * N), jnp.float32))
    return z_w, y_w


def _xla_reference(cfg, Ad, Bd_t, x_ref, xi0, z_w, y_w, iters):
    """The XLA composition (condense + _batched_admm) at `iters`."""
    import copy

    k = copy.copy(fused._QPConsts(cfg.srbd, two_feet=False))
    k.iters = iters
    return fused._xla_solve(k, Ad, Bd_t, x_ref, xi0, z_w, y_w)


def _interpret_kernel(monkeypatch):
    """Route the solver factories to the kernel in the interpreter."""
    monkeypatch.setattr(fused, "use_kernel", lambda nu: nu == 3)
    monkeypatch.setattr(fused, "fused_walking_qp", functools.partial(
        fused.fused_walking_qp, interpret=True))


def _admm_f64(cfg, Ad, Bd_t, x_ref, x0, z_w, y_w):
    """Float64 oracle of the warm ADMM iterates, independent of
    ops/condense.py and ops/qp.py: oracle condensation + NumPy ADMM with
    exact solves."""
    from mpc_limx_control_tpu.oracle.corpus import condense_ltv_f64

    c = cfg.srbd
    N = c.horizon
    Q = np.diag(np.asarray(c.q_diag, np.float64))
    R = np.diag(np.asarray(c.r_diag, np.float64))
    G, h = (np.asarray(a, np.float64)
            for a in srbd.friction_cone_rows(c, N, jnp.float64))
    rho, alpha = c.solver.admm_rho, c.solver.admm_alpha
    out = []
    for b in range(Ad.shape[0]):
        H, f = condense_ltv_f64(Ad[b], Bd_t[b], Q, R, c.p_scale * Q, N,
                                x0[b], x_ref[b])
        K = H + rho * G.T @ G + 1e-6 * np.eye(H.shape[0])
        v = np.minimum(G @ np.asarray(z_w[b], np.float64), h)
        y = np.asarray(y_w[b], np.float64)
        for _ in range(c.solver.admm_warm_iters):
            z = np.linalg.solve(K, rho * G.T @ (v - y) - f)
            gzr = alpha * G @ z + (1.0 - alpha) * v
            v_new = np.minimum(gzr + y, h)
            y = y + gzr - v_new
            v = v_new
        out.append(np.linalg.solve(K, rho * G.T @ (v - y) - f))
    return np.stack(out)


@pytest.mark.parametrize("N", [8, 20])
@pytest.mark.parametrize("B", [1, 5, 130])
def test_kernel_interpret_matches_xla(N, B):
    """The kernel's iterates equal the XLA composition's (same warm
    state, same iteration count) at every horizon and batch size."""
    cfg, Ad, Bd_t, x_ref, xi0 = _walking_inputs(
        B, jax.random.PRNGKey(3), cfg=_small_cfg(N))
    k = fused._QPConsts(cfg.srbd, two_feet=False)
    z_w, y_w = _warm(B, N)
    sol_r, (z_r, y_r) = fused._xla_solve(k, Ad, Bd_t, x_ref, xi0, z_w, y_w)
    z, y, res = fused.fused_walking_qp(Ad, Bd_t, x_ref, xi0, z_w, y_w,
                                       interpret=True, **k.kernel_kw())
    assert z.shape == (B, 3 * N) and y.shape == (B, 6 * N)
    assert res.shape == (B,)
    scale = float(jnp.max(jnp.abs(z_r))) + 1.0
    np.testing.assert_allclose(np.asarray(z), np.asarray(z_r),
                               atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_r),
                               atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(res), np.asarray(sol_r.residual),
                               atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("N", [8, 20])
def test_kernel_interpret_matches_f64_oracle(N):
    """f32 kernel vs the float64 oracle of the same iterates: within the
    f32 budget of 1e-3 of the force scale (measured ~1e-5)."""
    B = 4
    cfg, Ad, Bd_t, x_ref, xi0 = _walking_inputs(
        B, jax.random.PRNGKey(11), cfg=_small_cfg(N))
    k = fused._QPConsts(cfg.srbd, two_feet=False)
    z_w, y_w = _warm(B, N)
    z, _, _ = fused.fused_walking_qp(Ad, Bd_t, x_ref, xi0, z_w, y_w,
                                     interpret=True, **k.kernel_kw())
    z64 = _admm_f64(cfg, *(np.asarray(a, np.float64)
                           for a in (Ad, Bd_t, x_ref, xi0, z_w, y_w)))
    scale = float(np.abs(z64).max()) + 1.0
    assert np.abs(np.asarray(z) - z64).max() / scale < 1e-3


def test_fused_unbatched_path():
    """The unbatched (single-scenario) path runs the XLA reference."""
    key = jax.random.PRNGKey(5)
    cfg, Ad, Bd_t, x_ref, xi0 = _walking_inputs(1, key)
    c = cfg.srbd
    N = c.horizon
    z_w = jnp.zeros((3 * N,), jnp.float32)
    y_w = jnp.zeros((6 * N,), jnp.float32)
    solver = fused.make_admm_fused(c)
    sol, (z, y) = solver(Ad[0], Bd_t[0], x_ref[0], xi0[0], z_w, y_w)
    assert z.shape == (3 * N,)
    assert y.shape == (6 * N,)
    assert np.isfinite(np.asarray(sol.u)).all()


def test_fused_matches_xla_reference_small_horizon(monkeypatch):
    """make_admm_fused's custom_vmap rule with the kernel (interpreter)
    matches the same factory on the XLA composition, and its unbatched
    call stays on the XLA composition."""
    B = 4
    cfg, Ad, Bd_t, x_ref, xi0 = _walking_inputs(
        B, jax.random.PRNGKey(3), cfg=_small_cfg())
    z_w, y_w = _warm(B, cfg.srbd.horizon)
    args = (Ad, Bd_t, x_ref, xi0, z_w, y_w)
    sol_r, (z_r, y_r) = jax.vmap(fused.make_admm_fused(cfg.srbd))(*args)
    _interpret_kernel(monkeypatch)
    solver = fused.make_admm_fused(cfg.srbd)
    sol_f, (z_f, y_f) = jax.vmap(solver)(*args)
    scale = float(jnp.max(jnp.abs(z_r))) + 1.0
    np.testing.assert_allclose(np.asarray(z_f), np.asarray(z_r),
                               atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(y_f), np.asarray(y_r),
                               atol=1e-4 * scale, rtol=0)
    sol_1, _ = solver(*(a[0] for a in args))
    np.testing.assert_allclose(np.asarray(sol_1.u), np.asarray(sol_r.u[0]),
                               atol=1e-4 * scale, rtol=0)


def test_prep_fused_matches_xla_small_horizon(monkeypatch):
    """make_walking_fused (SRBD linearization + ZOH + reference in XLA,
    the QP in the kernel) matches its XLA composition end to end."""
    B = 3
    cfg = _small_cfg()
    N = cfg.srbd.horizon
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(21), 3)
    pos = jnp.asarray([0.0, 0.0, 0.65]) + 0.02 * jax.random.normal(
        k1, (B, 3))
    arms = pos[:, None, :] + jnp.asarray([0.02, 0.1, -0.65]) + \
        0.03 * jax.random.normal(k2, (B, N, 3))
    xi0 = jax.vmap(srbd.initial_state)(
        0.01 * jax.random.normal(k3, (B, 3)), pos, jnp.zeros((B, 3)),
        jnp.asarray([0.4, 0.0, 0.0]) + jnp.zeros((B, 3)))
    v_des = jnp.broadcast_to(jnp.asarray([0.5, 0.0, 0.0]), (B, 3))
    yaw_rate = 0.05 * jax.random.normal(jax.random.PRNGKey(17), (B,))
    z_w, y_w = _warm(B, N)
    anc = jnp.concatenate([xi0[:, 3:5], xi0[:, 2:3]], -1)
    args = tuple(a.astype(jnp.float32)
                 for a in (arms, xi0, v_des, yaw_rate, z_w, y_w, anc))
    sol_r, xp_r, zy_r = jax.vmap(fused.make_walking_fused(cfg))(*args)
    _interpret_kernel(monkeypatch)
    sol_f, xp_f, zy_f = jax.vmap(fused.make_walking_fused(cfg))(*args)
    scale = float(jnp.max(jnp.abs(sol_r.u))) + 1.0
    np.testing.assert_allclose(np.asarray(sol_f.u), np.asarray(sol_r.u),
                               atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(zy_f[1]), np.asarray(zy_r[1]),
                               atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(xp_f), np.asarray(xp_r),
                               atol=1e-4 * scale, rtol=0)


def test_kernel_chosen_by_nu_on_gpu(monkeypatch):
    """The kernel serves nu = 3 on the GPU only; nu = 6 and the CPU take
    the XLA composition."""
    assert not fused.use_kernel(3) and not fused.use_kernel(6)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert fused.use_kernel(3) and not fused.use_kernel(6)


@pytest.mark.parametrize("mode", ["walk", "stand"])
def test_no_pallas_path_on_cpu(mode):
    """On the CPU the batched plant step traces to plain XLA: no
    pallas_call anywhere in the tick."""
    from mpc_limx_control_tpu.control import rollout as ro

    cfg = (ControllerConfig.walking() if mode == "walk"
           else ControllerConfig.standing())
    s0 = ro.initial_plant_state(cfg, batch=(2,))
    jaxpr = jax.make_jaxpr(jax.vmap(
        lambda s: ro.plant_step(cfg, s, jnp.asarray(0.0))))(s0)
    assert "pallas_call" not in str(jaxpr)
