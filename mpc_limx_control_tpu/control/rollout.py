"""Batched closed-loop walking/standing simulation harness.

The reference closes its loop through Gazebo + the limxsdk UDP link
(SURVEY.md §3.1); the numerical analogue it actually exercises is the
linear plant rollout x <- Ad x + Bd u of src/QPSolver.cpp:108-111.  This
module is the batched equivalent: a SRBD plant driven by the
full controller tick, entirely on device —

    plant state: xi(13), joints q(6), world foot positions (L, R)
    per tick:  truth odometry -> controller.tick -> GRF + joint cmd
               -> SRBD step at the control rate -> foot/joint kinematics

Swing joints track their commands ideally (perfect position servo — the
same idealization the reference's move-to-zero phase assumes); stance feet
are pinned where they touched down, their joint angles given by IK.
"""

from __future__ import annotations

from typing import NamedTuple

import chex
import jax
import jax.numpy as jnp
from jax import lax

from mpc_limx_control_tpu.core.config import ControllerConfig
from mpc_limx_control_tpu.core.types import (ImuData, JointState, KFState,
                                             OdomState)
from mpc_limx_control_tpu.control import controller as ctrl
from mpc_limx_control_tpu.control import gait as gaitmod
from mpc_limx_control_tpu.models import kinematics as kin
from mpc_limx_control_tpu.models import srbd
from mpc_limx_control_tpu.utils import rotations as rot


@chex.dataclass(frozen=True)
class PlantState:
    xi: jnp.ndarray        # [..., 13] SRBD state
    q: jnp.ndarray         # [..., 6] joint angles
    foot_l: jnp.ndarray    # [..., 3] world
    foot_r: jnp.ndarray    # [..., 3] world
    # warm-start state of the GRF QP (cfg.qp_warm_start): stacked controls
    # z [..., nz] and multipliers lambda [..., m]; None when disabled
    qp_z: jnp.ndarray | None = None
    qp_lam: jnp.ndarray | None = None
    # estimator_mode == "kf": filter state + previous v/q for synthesizing
    # IMU acceleration and joint velocities from the plant
    kf: "KFState | None" = None
    prev_v: jnp.ndarray | None = None
    prev_q: jnp.ndarray | None = None
    # walking MPC reference anchor (cfg.ref_anchor_band > 0): [..., 3] =
    # (x, y, yaw), the persistent world pose the reference ramps
    # originate from, advanced at (v_des, yaw_rate_des) and band-clipped
    # each tick; None = receding
    ref_anchor: jnp.ndarray | None = None


def initial_plant_state(cfg: ControllerConfig, batch=(),
                        dtype=jnp.float32) -> PlantState:
    """Standing at the configured base height, feet at their static
    offsets, joints from IK."""
    pos = jnp.zeros((*batch, 3), dtype).at[..., 2].set(
        cfg.ground_height + cfg.base_height)
    xi = jnp.zeros((*batch, 13), dtype)
    xi = xi.at[..., 3:6].set(pos)
    xi = xi.at[..., 12].set(-9.81)

    off_l = jnp.asarray(cfg.robot.nominal_foot_offset_left, dtype)
    off_r = jnp.asarray(cfg.robot.nominal_foot_offset_right, dtype)
    foot_l = (pos + off_l).at[..., 2].set(cfg.ground_height)
    foot_r = (pos + off_r).at[..., 2].set(cfg.ground_height)
    if cfg.mode == "stand":
        # a point-foot biped has no COP authority: static equilibrium
        # requires the feet directly below the COM in x
        foot_l = foot_l.at[..., 0].set(pos[..., 0])
        foot_r = foot_r.at[..., 0].set(pos[..., 0])

    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype)
    zero3 = jnp.zeros((*batch, 3), dtype)
    q_l = kin.inverse_kinematics_analytic(gl, foot_l - pos, zero3)
    q_r = kin.inverse_kinematics_analytic(gr, foot_r - pos, zero3)
    q = jnp.concatenate([q_l, q_r], axis=-1)

    qp_z = qp_lam = None
    if cfg.qp_warm_start:
        N = cfg.srbd.horizon
        # walk: single-support nz = 3N / m = 6N; stand: two-foot 6N / 12N
        nu = 3 if cfg.mode == "walk" else 6
        qp_z = jnp.zeros((*batch, nu * N), dtype)
        # PDIP threads multipliers (strictly positive); ADMM threads the
        # scaled dual y, which starts at zero
        if cfg.srbd.solver.method in ("admm", "admm_fused"):
            qp_lam = jnp.zeros((*batch, 2 * nu * N), dtype)
        else:
            qp_lam = jnp.ones((*batch, 2 * nu * N), dtype)
    ref_anchor = None
    if cfg.ref_anchor_band > 0.0 and cfg.mode == "walk":
        # (x, y, yaw) — initial yaw is zero
        ref_anchor = jnp.concatenate(
            [pos[..., :2], jnp.zeros((*batch, 1), dtype)], -1)
    kf = prev_v = prev_q = None
    if cfg.estimator_mode == "kf":
        kf = KFState.initial(batch, cfg.estimator.initial_covariance,
                             dtype)
        # seed the filter at the true initial state so the transient is
        # the filter's own, not a cold start from the origin
        kf = kf.replace(x_hat=kf.x_hat
                        .at[..., 0:3].set(pos)
                        .at[..., 6:9].set(foot_l)
                        .at[..., 9:12].set(foot_r))
        prev_v = jnp.zeros((*batch, 3), dtype)
        prev_q = q
    return PlantState(xi=xi, q=q, foot_l=foot_l, foot_r=foot_r,
                      qp_z=qp_z, qp_lam=qp_lam,
                      kf=kf, prev_v=prev_v, prev_q=prev_q,
                      ref_anchor=ref_anchor)


def _odom_from_xi(xi: jnp.ndarray) -> OdomState:
    ori = xi[..., 0:3]
    return OdomState(pos=xi[..., 3:6], ori=ori,
                     quat=rot.rpy_to_quat(ori),
                     v_pos=xi[..., 9:12], v_ori=xi[..., 6:9])


def _kf_estimate(cfg: ControllerConfig, state: PlantState,
                 iteration: jnp.ndarray):
    """Synthesize sensors from the plant truth and run one KF tick
    (the intended path of src/mpc_control.cpp:158-192): returns
    (kf_new, odom, truth, joints)."""
    from mpc_limx_control_tpu.control import estimator as est
    dtype = state.xi.dtype
    truth = _odom_from_xi(state.xi)
    dt = cfg.gait.dt
    dq = (state.q - state.prev_q) / dt
    joints = JointState(q=state.q, dq=dq, tau=jnp.zeros_like(state.q))
    R_wb = rot.quat_to_rot(truth.quat)
    a_world = (truth.v_pos - state.prev_v) / dt
    g_vec = jnp.asarray([0.0, 0.0, -9.81], dtype)
    # accelerometer = specific force in the body frame
    acc_body = jnp.einsum("...ji,...j->...i", R_wb, a_world - g_vec)
    gyro_body = jnp.einsum("...ji,...j->...i", R_wb, truth.v_ori)
    imu = ImuData(quat=truth.quat, acc=acc_body, gyro=gyro_body)
    if cfg.mode == "stand":
        contact = jnp.ones((*state.q.shape[:-1], 2), bool)
    else:
        g_clk = gaitmod.gait_clock(cfg.gait, iteration)
        contact = jnp.stack([~g_clk.left_swing, g_clk.left_swing], -1)
    out = est.estimator_tick(cfg, state.kf, joints, imu, contact, dt)
    return out.kf, out.odom, truth, joints


def plant_step(cfg: ControllerConfig, state: PlantState,
               iteration: jnp.ndarray, grf_override=None, v_des=None):
    """One 1 kHz simulation tick for ONE scenario (vmap for batches).

    With `grf_override`, the MPC solve is skipped and the given force held
    (the intermediate ticks of the reference's mpcStep = 5 / dtMPC = 5 ms
    re-solve schedule, include/MPCParam.h:46-47).  `v_des` overrides the
    configured velocity command for this tick (velocity profiles)."""
    dtype = state.xi.dtype
    iteration = jnp.asarray(iteration, dtype)
    truth = _odom_from_xi(state.xi)

    if cfg.estimator_mode == "kf":
        # the controller sees the FILTER's estimate, not the truth
        kf_new, odom, truth, joints = _kf_estimate(cfg, state, iteration)
    else:
        kf_new = state.kf
        odom = truth
        joints = JointState(q=state.q, dq=jnp.zeros_like(state.q),
                            tau=jnp.zeros_like(state.q))

    qp_warm = None
    if cfg.qp_warm_start:
        qp_warm = (state.qp_z, state.qp_lam)
    cmd, diag = ctrl.tick(cfg, odom, joints, iteration,
                          grf_override=grf_override, qp_warm=qp_warm,
                          v_des=v_des, ref_anchor=state.ref_anchor)
    anchor_new = diag.ref_anchor if state.ref_anchor is not None else None

    # ---- SRBD dynamics with the commanded GRF ------------------------
    # exact-ZOH step in explicit vector form (srbd.srbd_step_vector):
    # identical math to linearize_shared + discretize_srbd + matvec, but
    # no [13,13]/[13,6] matrices: exact f32 elementwise work instead of
    # batched small matmuls.
    feet = jnp.stack([state.foot_l, state.foot_r], axis=-2)
    if cfg.mode == "stand":
        on_l = jnp.ones((), dtype)
        on_r = jnp.ones((), dtype)
        left_swing = jnp.zeros((), bool)
    else:
        g = gaitmod.gait_clock(cfg.gait, iteration)
        left_swing = g.left_swing
        on_l = 1.0 - left_swing.astype(dtype)
        on_r = left_swing.astype(dtype)
    forces = jnp.stack([diag.grf[..., 0:3] * on_l,
                        diag.grf[..., 3:6] * on_r], axis=-2)
    xi_new = srbd.srbd_step_vector(cfg.robot, state.xi, feet, forces,
                                   cfg.gait.dt)

    # ---- foot / joint kinematics -------------------------------------
    base_new = xi_new[..., 3:6]
    R_new = rot.quat_to_rot(rot.rpy_to_quat(xi_new[..., 0:3]))
    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype)

    if cfg.mode == "stand":
        q_l = kin.inverse_kinematics_analytic(
            gl, jnp.einsum("...ji,...j->...i", R_new,
                           state.foot_l - base_new), state.q[..., :3])
        q_r = kin.inverse_kinematics_analytic(
            gr, jnp.einsum("...ji,...j->...i", R_new,
                           state.foot_r - base_new), state.q[..., 3:])
        if cfg.qp_warm_start and diag.qp_state is not None:
            qp_z_new, qp_lam_new = diag.qp_state
        else:
            qp_z_new, qp_lam_new = state.qp_z, state.qp_lam
        new_state = PlantState(xi=xi_new,
                               q=jnp.concatenate([q_l, q_r], -1),
                               foot_l=state.foot_l, foot_r=state.foot_r,
                               qp_z=qp_z_new, qp_lam=qp_lam_new,
                               kf=kf_new,
                               prev_v=(truth.v_pos
                                       if state.prev_v is not None
                                       else None),
                               prev_q=(state.q
                                       if state.prev_q is not None
                                       else None),
                               ref_anchor=anchor_new)
    else:
        # swing leg executes its command; stance leg keeps its foot pinned
        q_sw = jnp.where(left_swing[..., None], cmd.q[..., :3],
                         cmd.q[..., 3:])
        p_sw_b = kin.forward_kinematics(
            jax.tree.map(lambda a, b: jnp.where(left_swing, a, b), gl, gr),
            q_sw)
        p_sw_w = base_new + jnp.einsum("...ij,...j->...i", R_new, p_sw_b)
        # rigid ground: the swing foot cannot penetrate the support
        # surface.  Without this clamp an estimator position bias makes
        # the commanded touchdown land below z = ground, the foot is
        # pinned there, and the KF (whose absolute-z reference is "feet
        # on the ground") re-anchors one bias higher — a positive
        # feedback that sinks the closed loop ~5 cm/s (round-5 finding;
        # the 1200-tick KF gate never saw it).  Gazebo's contact solver
        # provided this constraint for the reference implicitly.
        p_sw_w = p_sw_w.at[..., 2].set(
            jnp.maximum(p_sw_w[..., 2], cfg.ground_height))

        foot_l = jnp.where(left_swing[..., None], p_sw_w, state.foot_l)
        foot_r = jnp.where(left_swing[..., None], state.foot_r, p_sw_w)

        # select-then-compute: only the STANCE leg needs the pinning IK
        # (the swing leg's joints come from the command)
        g_st = jax.tree.map(lambda a, b: jnp.where(left_swing, b, a),
                            gl, gr)
        foot_st = jnp.where(left_swing[..., None], foot_r, foot_l)
        q_prev_st = jnp.where(left_swing[..., None],
                              state.q[..., 3:], state.q[..., :3])
        q_st = kin.inverse_kinematics_analytic(
            g_st, jnp.einsum("...ji,...j->...i", R_new,
                             foot_st - base_new), q_prev_st)
        q_new = jnp.where(
            left_swing[..., None],
            jnp.concatenate([q_sw, q_st], -1),
            jnp.concatenate([q_st, q_sw], -1))
        if cfg.qp_warm_start and diag.qp_state is not None:
            qp_z, qp_lam = diag.qp_state
        else:
            qp_z, qp_lam = state.qp_z, state.qp_lam
        new_state = PlantState(xi=xi_new, q=q_new,
                               foot_l=foot_l, foot_r=foot_r,
                               qp_z=qp_z, qp_lam=qp_lam,
                               kf=kf_new,
                               prev_v=(truth.v_pos
                                       if state.prev_v is not None
                                       else None),
                               prev_q=(state.q
                                       if state.prev_q is not None
                                       else None),
                               ref_anchor=anchor_new)

    metrics = {
        "est_error": jnp.linalg.norm(odom.pos - truth.pos, axis=-1),
        "height": xi_new[..., 5],
        "velocity": xi_new[..., 9:12],
        "grf": diag.grf,
        "qp_residual": diag.qp_residual,
        "foot_target": diag.foot_target,
    }
    if cfg.estimator_mode == "kf":
        # covariance-health observability — the role of the reference's
        # 200 Hz odom/pose-with-covariance stream
        # (include/stateEstimator.h:404-419): the filter covariance
        # diagonal for base position/velocity, per tick
        cov_diag = jnp.diagonal(kf_new.p_cov, axis1=-2, axis2=-1)
        metrics["kf_cov_pos"] = cov_diag[..., 0:3]
        metrics["kf_cov_vel"] = cov_diag[..., 3:6]
    return new_state, metrics


def rollout(cfg: ControllerConfig, state0: PlantState, steps: int,
            start_iteration: int = 0, mpc_every: int = 1,
            v_des_schedule: jnp.ndarray | None = None):
    """Closed-loop simulation for ONE scenario; returns (final, metrics)
    with metrics stacked over time on axis 0.

    mpc_every > 1 reproduces the reference's dtMPC schedule: the GRF MPC
    is re-solved every `mpc_every` ticks (reference mpcStep = 5,
    include/MPCParam.h:46-47) and the force held in between, while gait,
    swing tracking, and the plant run at the full control rate.
    """
    if mpc_every == 1:
        # start_iteration may be a traced per-scenario scalar (perturbed
        # gait phases across the batch): keep arange static and shift
        its = (jnp.arange(steps, dtype=state0.xi.dtype)
               + jnp.asarray(start_iteration, state0.xi.dtype))
        if v_des_schedule is None:
            return lax.scan(lambda s, it: plant_step(cfg, s, it),
                            state0, its)
        return lax.scan(lambda s, x: plant_step(cfg, s, x[0], v_des=x[1]),
                        state0, (its, v_des_schedule))

    assert steps % mpc_every == 0, (steps, mpc_every)

    def block(s, it0):
        s, m0 = plant_step(cfg, s, it0)
        grf = m0["grf"]
        ms = [m0]
        for j in range(1, mpc_every):
            s, mj = plant_step(cfg, s, it0 + j, grf_override=grf)
            ms.append(mj)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs, 0), *ms)
        return s, stacked

    it0s = (jnp.arange(0, steps, mpc_every, dtype=state0.xi.dtype)
            + jnp.asarray(start_iteration, state0.xi.dtype))
    final, metrics = lax.scan(block, state0, it0s)
    metrics = jax.tree.map(
        lambda x: x.reshape(steps, *x.shape[2:]), metrics)
    return final, metrics


def batched_rollout(cfg: ControllerConfig, state0: PlantState, steps: int,
                    start_iteration=0, mpc_every: int = 1):
    """vmap of rollout over the leading batch axis of state0.

    start_iteration may be an array [B] to stagger the gait phase across
    scenarios (BASELINE config 4: perturbed initial states/gaits)."""
    if hasattr(start_iteration, "shape") and jnp.ndim(start_iteration) == 1:
        return jax.vmap(
            lambda s, it0: rollout(cfg, s, steps, it0, mpc_every))(
            state0, start_iteration)
    return jax.vmap(
        lambda s: rollout(cfg, s, steps, start_iteration, mpc_every))(
        state0)


def soak_rollout(cfg: ControllerConfig, state0: PlantState,
                 n_windows: int, window: int, start_iteration=0,
                 mpc_every: int = 1):
    """Endurance soak: `n_windows` blocks of `window` ticks, metrics
    reduced to per-window summary statistics ON DEVICE.

    A 60k-tick (60 s at the reference's 1 kHz rate,
    include/MPCParam.h:44-47) batched rollout would materialize
    ~60k x B x 14 floats of per-tick metrics.  This wrapper scans window
    blocks and keeps only
    [n_windows]-shaped reductions, so a full minute-long soak fetches a
    few KB: limit-cycle stationarity, anchor windup, KF covariance drift,
    and f32 accumulation over minutes become assertable numbers.

    `start_iteration` may be a [B] array (staggered gait phases).
    `mpc_every` > 1 soaks the reference's dtMPC hold schedule
    (include/MPCParam.h:46-47).
    Returns (final_state, stats) where every stats leaf is [n_windows].
    """
    batched = state0.xi.ndim == 2
    dtype = state0.xi.dtype
    it0 = jnp.asarray(start_iteration, dtype)

    def wbody(carry, _):
        s, it = carry
        if batched:
            s2, m = batched_rollout(cfg, s, window, start_iteration=it,
                                    mpc_every=mpc_every)
        else:
            s2, m = rollout(cfg, s, window, start_iteration=it,
                            mpc_every=mpc_every)
        h = m["height"]
        v = m["velocity"]
        stats = {
            "height_mean": h.mean(),
            "height_min": h.min(),
            "height_max": h.max(),
            "vx_mean": v[..., 0].mean(),
            "vy_mean": v[..., 1].mean(),
            "qp_res_max": m["qp_residual"].max(),
            "est_err_max": m["est_error"].max(),
            "nonfinite_ticks": jnp.sum(
                ~jnp.isfinite(h)).astype(jnp.int32),
        }
        if "kf_cov_pos" in m:
            stats["kf_cov_pos_max"] = m["kf_cov_pos"].max()
            stats["kf_cov_pos_mean"] = m["kf_cov_pos"].mean()
            stats["kf_cov_vel_max"] = m["kf_cov_vel"].max()
        return (s2, it + window), stats

    (final, _), stats = lax.scan(wbody, (state0, it0), None,
                                 length=n_windows)
    return final, stats


def soak_stationary(stats: dict, tail_frac: float = 0.8) -> dict:
    """Host-side stationarity summary of soak_rollout stats.

    Over the last `tail_frac` of windows: windowed height/vx spread and a
    least-squares drift slope PER WINDOW (a true limit cycle has ~zero
    drift; anchor windup, KF re-anchoring sinks, or f32 accumulation all
    show up as a nonzero slope long before they cross a hard floor —
    the round-5 KF touchdown sink was exactly such a drift, invisible to
    a 1200-tick gate)."""
    import numpy as np
    out = {}
    n = len(np.asarray(stats["height_mean"]))
    i0 = int(round((1.0 - tail_frac) * n))
    w = np.arange(n - i0, dtype=np.float64)
    for key in ("height_mean", "vx_mean", "kf_cov_pos_mean"):
        if key not in stats:
            continue
        y = np.asarray(stats[key], np.float64)[i0:]
        slope = float(np.polyfit(w, y, 1)[0]) if len(y) > 1 else 0.0
        out[f"{key}_tail_mean"] = float(y.mean())
        out[f"{key}_tail_ptp"] = float(y.max() - y.min())
        out[f"{key}_drift_per_window"] = slope
    out["height_min"] = float(np.asarray(stats["height_min"]).min())
    out["nonfinite_ticks"] = int(
        np.asarray(stats["nonfinite_ticks"]).sum())
    if "kf_cov_pos_max" in stats:
        # all-time max is dominated by the (intended) initial-covariance
        # transient; boundedness in steady state is the TAIL max
        out["kf_cov_pos_max"] = float(
            np.asarray(stats["kf_cov_pos_max"]).max())
        out["kf_cov_pos_max_tail"] = float(
            np.asarray(stats["kf_cov_pos_max"])[i0:].max())
        out["kf_cov_vel_max"] = float(
            np.asarray(stats["kf_cov_vel_max"]).max())
    return out
