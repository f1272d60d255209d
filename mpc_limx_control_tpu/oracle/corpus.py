"""Capture real walking/standing SRBD QPs from closed-loop rollouts.

The accuracy story of this repo rests on comparing the batched solvers against
float64 oracles on *the problems the controller actually solves* — not just
synthetic QPs.  This module (a) steps the closed-loop plant and records the
controller state at sampled ticks, and (b) rebuilds, in float64 NumPy, the
exact condensed GRF QP (H, f, G, h) that `stance_mpc_single_support` /
`stance_mpc` (control/controller.py) poses at that state — same gait clock,
placement, anchor logic, moment arms, SRBD linearization, exact-ZOH
discretization, reference synthesis, and friction-cone rows.

Capture fidelity is guarded by tests/test_active_set_oracle.py: the f64
oracle solution of the rebuilt QP must match the u the in-loop solver
produced at that tick (to the solver's accuracy), for cold AND
warm-started intermediate problems.

Reference lineage: the QP corresponds to the intended stance-force MPC of
include/mpcQP.h (corrected physics, models/srbd.py) condensed as in
src/QPSolver.cpp:31-81 and constrained by friction cones instead of the
placeholder +/-8 N box (include/mpcQP.h:59).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mpc_limx_control_tpu.core.config import ControllerConfig
from mpc_limx_control_tpu.control import gait as gaitmod
from mpc_limx_control_tpu.control import rollout as ro
from mpc_limx_control_tpu.models import kinematics as kin
from mpc_limx_control_tpu.models import srbd
from mpc_limx_control_tpu.utils import rotations as rot


class CapturedQP(NamedTuple):
    """One condensed GRF QP (float64 NumPy) + the in-loop solve's answer."""

    H: np.ndarray          # [nz, nz]
    f: np.ndarray          # [nz]
    G: np.ndarray          # [m, nz]
    h: np.ndarray          # [m]
    u_loop: np.ndarray     # [nu] first-step GRF the controller applied
    iteration: int
    warm: bool             # True once the warm state is threaded (tick > 0)
    nu: int                # 3 (walking single-support) or 6 (standing)
    # the uncondensed inputs of the same QP (float64), as the batched
    # solvers take them: Ad [nx,nx], Bd_t [N,nx,nu], x_ref [N+1,nx], x0
    inputs: tuple = ()


def condense_ltv_f64(Ad, Bd_t, Q, R, P, N, x0, x_ref):
    """Float64 LTV condensation: H, f for min 1/2 z'Hz + f'z.

    Ad [nx,nx] (step-invariant — the SRBD Ac does not depend on the arm),
    Bd_t [N,nx,nu] per-step input matrices, x_ref [N+1,nx] (row i =
    reference state at step i).  Same math as ops/condense.py:condense
    generalizing src/QPSolver.cpp:31-60 to time-varying B.
    """
    Ad = np.asarray(Ad, np.float64)
    Bd_t = np.asarray(Bd_t, np.float64)
    nx = Ad.shape[0]
    nu = Bd_t.shape[-1]

    powers = [np.eye(nx)]
    for _ in range(N):
        powers.append(Ad @ powers[-1])
    A_aug = np.concatenate(powers, axis=0)               # [(N+1)nx, nx]

    B_aug = np.zeros(((N + 1) * nx, N * nu))
    for i in range(1, N + 1):
        for j in range(i):
            B_aug[i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = (
                powers[i - j - 1] @ Bd_t[j])

    Q_bar = np.zeros(((N + 1) * nx, (N + 1) * nx))
    for i in range(N):
        Q_bar[i * nx:(i + 1) * nx, i * nx:(i + 1) * nx] = Q
    Q_bar[N * nx:, N * nx:] = P

    R_bar = np.kron(np.eye(N), R)
    H = 2.0 * (B_aug.T @ Q_bar @ B_aug + R_bar)
    H = 0.5 * (H + H.T)
    x_ref_vec = np.asarray(x_ref, np.float64).reshape(-1)
    f = 2.0 * B_aug.T @ Q_bar @ (A_aug @ np.asarray(x0, np.float64)
                                 - x_ref_vec)
    return H, f


def _to64(x):
    return jnp.asarray(np.asarray(x), jnp.float64)


def build_walking_qp_f64(cfg: ControllerConfig, state: ro.PlantState,
                         iteration: float) -> tuple:
    """Rebuild, in float64, the single-support walking GRF QP that
    controller.tick poses at `state` (truth odometry).

    Returns (H [60,60], f [60], G [120,60], h [120], inputs) for the
    default N = 20 horizon, inputs = (Ad, Bd_t, x_ref, x0).  Mirrors
    control/controller.py:tick -> stance_mpc_single_support step by step.
    """
    assert cfg.mode == "walk"
    c = cfg.srbd
    N = c.horizon
    dtype = jnp.float64

    xi = _to64(state.xi)
    q = _to64(state.q)
    it = jnp.asarray(float(iteration), dtype)
    pos = xi[3:6]
    ori = xi[0:3]
    v_pos = xi[9:12]
    v_des = jnp.asarray(cfg.desired_velocity, dtype)
    yaw_rate_des = jnp.asarray(cfg.desired_yaw_rate, dtype)

    gait = gaitmod.gait_clock(cfg.gait, it)
    target_w = gaitmod.foot_placement(
        cfg, gait, pos, v_des, v_actual=v_pos)

    # anchor logic (tick()): clip the persistent (x, y, yaw) anchor into
    # its bands, shift placement by the integral term, use it as the MPC
    # reference origin
    band = cfg.ref_anchor_band
    yband = cfg.yaw_anchor_band
    anchor_used = None
    yaw_anchor_used = None
    if state.ref_anchor is not None and band > 0.0:
        ra = _to64(state.ref_anchor)
        anchor_used = jnp.clip(ra[:2], pos[:2] - band, pos[:2] + band)
        yaw_anchor_used = jnp.clip(ra[2], ori[2] - yband, ori[2] + yband)
        if cfg.anchor_placement_gain > 0.0:
            target_w = target_w.at[:2].add(
                cfg.anchor_placement_gain * (pos[:2] - anchor_used))

    # world foot positions from FK + base pose
    quat = rot.rpy_to_quat(ori)
    R_wb = rot.quat_to_rot(quat)
    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype)
    p_l_w = pos + R_wb @ kin.forward_kinematics(gl, q[:3])
    p_r_w = pos + R_wb @ kin.forward_kinematics(gr, q[3:])

    schedule = gaitmod.contact_schedule(cfg.gait, it, N, c.ts)
    on_l = schedule.astype(dtype)
    arm_l = jnp.where(gait.left_swing, target_w, p_l_w)
    arm_r = jnp.where(gait.left_swing, p_r_w, target_w)
    arms = jnp.where(on_l[:, None] > 0.5, arm_l[None], arm_r[None])

    xi0 = srbd.initial_state(ori, pos, xi[6:9], v_pos)
    yaw = ori[2]
    Ac, Bc_t = srbd.linearize_shared(cfg.robot, arms, pos, yaw, dtype)
    Ad, Bd_t = srbd.discretize_srbd(Ac, Bc_t, c.ts)

    anchor_xy = pos[:2] if anchor_used is None else anchor_used
    anchor3 = jnp.concatenate([anchor_xy, jnp.zeros((1,), dtype)])
    x_ref = srbd.walking_reference(
        xi0, c, N, v_des, yaw_rate_des,
        height_des=cfg.ground_height + cfg.base_height,
        pos_anchor=anchor3, yaw_anchor=yaw_anchor_used)

    Q = np.diag(np.asarray(c.q_diag, np.float64))
    R = np.diag(np.asarray(c.r_diag, np.float64))
    P = c.p_scale * Q
    inputs = tuple(np.asarray(a) for a in (Ad, Bd_t, x_ref, xi0))
    H, f = condense_ltv_f64(*inputs[:2], Q, R, P, N, *inputs[3:], inputs[2])

    Gnp, hnp = srbd.friction_cone_rows(c, N, jnp.float64)
    return H, f, np.asarray(Gnp), np.asarray(hnp), inputs


def build_standing_qp_f64(cfg: ControllerConfig, state: ro.PlantState,
                          iteration: float) -> tuple:
    """Rebuild, in float64, the two-foot standing GRF QP of stance_mpc
    (nu = 6, both feet on over the whole horizon, position anchored over
    the support midpoint).  Returns (H, f, G, h, inputs) as
    :func:`build_walking_qp_f64`."""
    assert cfg.mode == "stand"
    c = cfg.srbd
    N = c.horizon
    dtype = jnp.float64

    xi = _to64(state.xi)
    pos = xi[3:6]
    ori = xi[0:3]
    v_des = jnp.asarray(cfg.desired_velocity, dtype)
    yaw_rate_des = jnp.asarray(cfg.desired_yaw_rate, dtype)

    p_l_w = _to64(state.foot_l)
    p_r_w = _to64(state.foot_r)
    pos_anchor = 0.5 * (p_l_w + p_r_w)
    pos_anchor = pos_anchor.at[2].set(cfg.ground_height + cfg.base_height)

    xi0 = srbd.initial_state(ori, pos, xi[6:9], xi[9:12])
    yaw = ori[2]
    arms2 = jnp.stack([p_l_w, p_r_w], axis=-2)
    Ac, Bc2 = srbd.linearize_shared(cfg.robot, arms2, pos, yaw, dtype)
    Bc = jnp.concatenate([Bc2[0], Bc2[1]], axis=-1)      # [13, 6]
    Ad, Bd = srbd.discretize_srbd(Ac, Bc, c.ts)
    Bd_t = jnp.broadcast_to(Bd, (N, 13, 6))

    x_ref = srbd.walking_reference(
        xi0, c, N, v_des, yaw_rate_des,
        height_des=cfg.ground_height + cfg.base_height,
        pos_anchor=pos_anchor)

    Q = np.diag(np.asarray(c.q_diag, np.float64))
    R = np.diag(np.asarray(tuple(c.r_diag) * 2, np.float64))
    P = c.p_scale * Q
    inputs = tuple(np.asarray(a) for a in (Ad, Bd_t, x_ref, xi0))
    H, f = condense_ltv_f64(*inputs[:2], Q, R, P, N, *inputs[3:], inputs[2])

    # two-foot cone rows with both feet on (controller._cone_rows/_bounds)
    mu = c.friction_mu
    Gu1 = np.asarray([[1.0, 0.0, -mu], [-1.0, 0.0, -mu],
                      [0.0, 1.0, -mu], [0.0, -1.0, -mu],
                      [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float64)
    Gu = np.block([[Gu1, np.zeros((6, 3))], [np.zeros((6, 3)), Gu1]])
    G = np.kron(np.eye(N), Gu)
    hu = np.asarray([0.0, 0.0, 0.0, 0.0, c.fz_max, -c.fz_min] * 2)
    h = np.tile(hu, N)
    return H, f, G, h, inputs


def capture_corpus(cfg: ControllerConfig, ticks: int, sample_every: int,
                   skip_first: int = 0,
                   kick: tuple | None = None) -> list[CapturedQP]:
    """Run the closed loop for `ticks` 1 kHz steps and capture the GRF QP
    at every `sample_every`-th tick (from `skip_first` on).

    The controller path is the production one (plant_step with the warm
    ADMM solver); u_loop records the
    force it actually applied, so the captured problems include
    warm-started intermediate solves, not just cold starts.

    kick=(tick, (dvx, dvy, dvz)): velocity impulse applied to the plant at
    `tick` — disturbance-recovery QPs drive the friction cone/fz bounds
    active, exercising the constrained solve paths the steady gait never
    touches.
    """
    state = ro.initial_plant_state(cfg)
    step = jax.jit(lambda s, it: ro.plant_step(cfg, s, it))
    build = (build_walking_qp_f64 if cfg.mode == "walk"
             else build_standing_qp_f64)
    nu = 3 if cfg.mode == "walk" else 6

    out = []
    for t in range(ticks):
        if kick is not None and t == kick[0]:
            state = state.replace(xi=state.xi.at[9:12].add(
                jnp.asarray(kick[1], state.xi.dtype)))
        pending = None
        if t >= skip_first and (t - skip_first) % sample_every == 0:
            pending = build(cfg, state, float(t))
        new_state, metrics = step(state, jnp.asarray(float(t),
                                                     state.xi.dtype))
        if pending is not None:
            H, f, G, h, inputs = pending
            grf = np.asarray(metrics["grf"], np.float64)
            if cfg.mode == "walk":
                # u0 is the STANCE foot's force (controller.tick zeroes
                # the swing foot's slot)
                g_clk = gaitmod.gait_clock(cfg.gait, float(t))
                left_stance = not bool(g_clk.left_swing)
                u_loop = grf[:3] if left_stance else grf[3:]
            else:
                u_loop = grf
            out.append(CapturedQP(H=H, f=f, G=G, h=h, u_loop=u_loop,
                                  iteration=t, warm=t > 0, nu=nu,
                                  inputs=inputs))
        state = new_state
    return out
