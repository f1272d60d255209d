"""The TRON1 walking controller tick: estimate -> gait -> placement ->
swing IK -> stance-force MPC -> joint command.

This is the batched counterpart of `MPC::run`
(include/MPCController.h:183-196) with the piece the reference left empty —
`computeSupportFootForce` (include/MPCController.h:177-180) — actually
implemented via the intended SRBD condensed-QP GRF solve (include/mpcQP.h),
corrected and generalized:

* walking uses the single-support formulation (one GRF per horizon step —
  the scheduled foot's — so nz = 3N); standing uses the two-foot nu = 6
  form with contact gating;
* contact-scheduled LTV condensation over the horizon;
* pyramidal friction-cone constraints instead of the placeholder +/-8 N box;
* warm-started batched PDIP (primal threaded tick-to-tick);
* stance joint torques tau = J^T (-R^T f) closing the loop the reference
  never wired up.

The whole tick is a pure function, jit-compiled, vmappable over a scenario
batch; no Python control flow depends on data.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_limx_control_tpu.core.config import ControllerConfig
from mpc_limx_control_tpu.core.types import (GaitState, JointState, OdomState,
                                             RobotCmd)
from mpc_limx_control_tpu.control import gait as gaitmod
from mpc_limx_control_tpu.models import kinematics as kin
from mpc_limx_control_tpu.models import srbd
from mpc_limx_control_tpu.ops import condense as cnd
from mpc_limx_control_tpu.ops import qp as qps
from mpc_limx_control_tpu.utils import rotations as rot


class TickDiagnostics(NamedTuple):
    gait: GaitState
    grf: jnp.ndarray           # [..., 6] stance forces (world), L then R
    qp_residual: jnp.ndarray   # [...]
    foot_target: jnp.ndarray   # [..., 3]
    swing_q: jnp.ndarray       # [..., 3]
    predicted_xi: jnp.ndarray  # [..., 13] one-step-ahead SRBD state
    qp_state: tuple            # (z, lambda) for warm-starting the next tick
    ref_anchor: jnp.ndarray | None = None  # [..., 2] next-tick ref anchor


def _cone_single(cfg: ControllerConfig, dtype):
    """Single-foot friction-cone rows [6, 3]."""
    mu = cfg.srbd.friction_mu
    return jnp.asarray([
        [1.0, 0.0, -mu],
        [-1.0, 0.0, -mu],
        [0.0, 1.0, -mu],
        [0.0, -1.0, -mu],
        [0.0, 0.0, 1.0],
        [0.0, 0.0, -1.0],
    ], dtype)


def _cone_rows(cfg: ControllerConfig, dtype):
    """Static friction-cone matrix for two feet over the horizon:
    G [12N, 6N].  The bound vector h is schedule-dependent (built per
    tick)."""
    c = cfg.srbd
    Gu1 = _cone_single(cfg, dtype)
    Gu = jax.scipy.linalg.block_diag(Gu1, Gu1)          # [12, 6]
    return jnp.kron(jnp.eye(c.horizon, dtype=dtype), Gu)


def _cone_bounds(cfg: ControllerConfig, on_l: jnp.ndarray,
                 on_r: jnp.ndarray, dtype):
    """h [..., 12N]: fz in [fz_min, fz_max] for stance feet, fz = 0 for
    swing feet (which with the cone rows forces the whole GRF to zero).
    on_l/on_r [..., N] in {0,1}."""
    c = cfg.srbd

    def foot_h(on):
        zeros4 = jnp.zeros((*on.shape, 4), dtype)
        top = on[..., None] * c.fz_max                  # fz <= on*fz_max
        bot = -on[..., None] * c.fz_min                 # -fz <= -on*fz_min
        return jnp.concatenate([zeros4, top, bot], axis=-1)   # [..., N, 6]

    h = jnp.concatenate([foot_h(on_l), foot_h(on_r)], axis=-1)  # [...,N,12]
    return h.reshape(*h.shape[:-2], -1)


def stance_mpc(cfg: ControllerConfig, odom: OdomState,
               arm_l: jnp.ndarray, arm_r: jnp.ndarray,
               on_l: jnp.ndarray, on_r: jnp.ndarray, v_des: jnp.ndarray,
               yaw_rate_des: jnp.ndarray,
               pos_anchor: jnp.ndarray | None = None,
               qp_warm=None):
    """Solve the two-foot SRBD GRF MPC for ONE scenario (standing / double
    support: nu = 6 with schedule gating).

    arm_l/arm_r [3]: the world position each foot exerts force from when in
    stance (current position for a currently-standing foot; the placement
    target for a foot that lands within the horizon).
    on_l/on_r [N] in {0,1}: stance schedule per foot over the horizon.

    Solver dispatch mirrors the walking path: with warm state and
    method "admm"/"admm_fused" the solve is the warm ADMM (the two-foot
    form of ops/mpc_fused_pallas.py); otherwise the cold fixed-iteration
    PDIP.

    Returns (grf [6] world forces (L,R), residual, xi_pred [13],
    qp_state).
    """
    c = cfg.srbd
    N = c.horizon
    dtype = odom.pos.dtype

    xi0 = srbd.initial_state(odom.ori, odom.pos, odom.v_ori, odom.v_pos)
    yaw = odom.ori[..., 2]

    # Per-foot linearization at the operating point (per-foot moment arm
    # constant over the horizon; the schedule gates which columns act).
    arms2 = jnp.stack([arm_l, arm_r], axis=-2)          # [2, 3]
    Ac, Bc2 = srbd.linearize_shared(cfg.robot, arms2, odom.pos, yaw, dtype)
    Bc = jnp.concatenate([Bc2[..., 0, :, :], Bc2[..., 1, :, :]], axis=-1)
    Ad, Bd = srbd.discretize_srbd(Ac, Bc, c.ts)

    # LTV input gating over the horizon: zero the swing foot's columns.
    gate = jnp.concatenate([
        jnp.repeat(on_l[:, None], 3, axis=1),
        jnp.repeat(on_r[:, None], 3, axis=1),
    ], axis=1)                                          # [N, 6]
    Bd_t = Bd[None] * gate[:, None, :]                  # [N, 13, 6]

    x_ref = srbd.walking_reference(xi0, c, N, v_des, yaw_rate_des,
                                   height_des=cfg.ground_height + cfg.base_height,
                                   pos_anchor=pos_anchor)

    if (c.solver.method in ("admm", "admm_fused")
            and qp_warm is not None):
        # NB the solver's bounds are the full-stance constants —
        # correct for the standing schedule (on_l = on_r = 1), which is
        # the only schedule this warm path is used with (tick() routes
        # walking gaits to stance_mpc_single_support).
        from mpc_limx_control_tpu.ops import mpc_fused_pallas as fqp
        solver = fqp.make_admm_fused(c, two_feet=True)
        sol, qp_state = solver(Ad, Bd_t, x_ref, xi0, qp_warm[0],
                               qp_warm[1])
        grf = sol.u[:6]
        xi_pred = Ad @ xi0 + Bd_t[0] @ grf
        return grf, sol.residual, xi_pred, qp_state

    Q = jnp.diag(jnp.asarray(c.q_diag, dtype))
    # input weight per foot (r_diag is per-GRF, duplicated for two feet)
    R = jnp.diag(jnp.asarray(tuple(c.r_diag) * 2, dtype))
    P = c.p_scale * Q
    G = _cone_rows(cfg, dtype)
    h = _cone_bounds(cfg, on_l, on_r, dtype)

    qp = cnd.condense(Ad, Bd_t, Q, R, P, N, xi0, x_ref,
                      None, None, extra_G=G, extra_h=h)
    solver = qps.make_pdip(iters=c.solver.iters)
    sol = solver(qp.H, qp.f, qp.G, qp.h)
    grf = sol.u[:6]
    xi_pred = qp.A_blocks[1] @ xi0 + qp.B_blocks[1, 0] @ grf
    return grf, sol.residual, xi_pred, None


def stance_mpc_single_support(cfg: ControllerConfig, odom: OdomState,
                              arm_l: jnp.ndarray, arm_r: jnp.ndarray,
                              left_stance: jnp.ndarray, v_des: jnp.ndarray,
                              yaw_rate_des: jnp.ndarray,
                              qp_warm=None,
                              pos_anchor: jnp.ndarray | None = None):
    """Walking-gait GRF MPC: exactly ONE stance foot per horizon step, so
    the decision variable is the 3-vector GRF of *the scheduled foot* at
    each step (nz = 3N) instead of a 6-vector with half its columns gated
    to zero (nz = 6N).  Same solution, 4-8x cheaper QP (the Cholesky and
    G'DG costs are cubic/quadratic in nz).

    left_stance [N] in {0,1}.  Returns (grf [6] (L,R) with the swing
    foot's force zero, residual, xi_pred [13]).

    pos_anchor [..., 3]: the persistent tracking anchor (x, y, yaw) —
    clipped by the caller; None = fully receding reference
    (include/mpcQP.h:83-85 position, :74-76 yaw).
    """
    c = cfg.srbd
    N = c.horizon
    dtype = odom.pos.dtype

    xi0 = srbd.initial_state(odom.ori, odom.pos, odom.v_ori, odom.v_pos)
    yaw = odom.ori[..., 2]

    on_l = left_stance.astype(dtype)
    arms = jnp.where(on_l[:, None] > 0.5, arm_l[None], arm_r[None])  # [N,3]

    # reference-anchor xy/yaw: the persistent tracking anchor (clipped by
    # the caller) or the current pose (receding, include/mpcQP.h:83-85)
    if pos_anchor is None:
        anchor_xy = odom.pos[..., :2]
        yaw_anchor = None
    else:
        anchor_xy = pos_anchor[..., :2]
        yaw_anchor = pos_anchor[..., 2]

    if c.solver.method == "admm_fused" and qp_warm is not None:
        # batched walking solve (ops/mpc_fused_pallas.py:
        # make_walking_fused): SRBD linearization, exact nilpotent ZOH and
        # walking reference in XLA; condensation, Cholesky and the warm
        # ADMM iterations in one Triton kernel on the GPU.
        from mpc_limx_control_tpu.ops import mpc_fused_pallas as fqp
        solver = fqp.make_walking_fused(cfg)
        anchor3 = jnp.concatenate(
            [anchor_xy,
             (odom.ori[..., 2:3] if yaw_anchor is None
              else yaw_anchor[..., None])], -1)
        sol, xi_pred, qp_state = solver(arms, xi0, v_des, yaw_rate_des,
                                        qp_warm[0], qp_warm[1],
                                        anchor3)
        u0 = sol.u[:3]
        left_now = on_l[0] > 0.5
        zeros3 = jnp.zeros_like(u0)
        grf = jnp.where(left_now,
                        jnp.concatenate([u0, zeros3], -1),
                        jnp.concatenate([zeros3, u0], -1))
        return grf, sol.residual, xi_pred, qp_state

    # shared-yaw linearization + exact nilpotent ZOH: Ad is step-invariant
    # (Ac does not depend on the arm), only Bd varies over the horizon
    Ac, Bc_t = srbd.linearize_shared(cfg.robot, arms, odom.pos, yaw, dtype)
    Ad, Bd_t = srbd.discretize_srbd(Ac, Bc_t, c.ts)     # [13,13],[N,13,3]

    Q = jnp.diag(jnp.asarray(c.q_diag, dtype))
    R = jnp.diag(jnp.asarray(c.r_diag, dtype))
    P = c.p_scale * Q

    anchor3 = jnp.concatenate(
        [anchor_xy, jnp.zeros_like(anchor_xy[..., :1])], -1)
    x_ref = srbd.walking_reference(xi0, c, N, v_des, yaw_rate_des,
                                   height_des=cfg.ground_height + cfg.base_height,
                                   pos_anchor=anchor3,
                                   yaw_anchor=yaw_anchor)

    Gu = _cone_single(cfg, dtype)                        # [6, 3]
    G = jnp.kron(jnp.eye(N, dtype=dtype), Gu)            # [6N, 3N]
    hu = jnp.asarray([0.0, 0.0, 0.0, 0.0, c.fz_max, -c.fz_min], dtype)
    h = jnp.tile(hu, N)

    if c.solver.method == "riccati" and qp_warm is not None:
        # riccati: the warm ADMM iterates with the x-updates factorized by
        # a backward Riccati recursion in the sparse form (ops/riccati.py)
        # — kept as the HPIPM-style alternative.  Cold solves (no warm
        # state yet) fall through to the generic ADMM path below.
        from mpc_limx_control_tpu.ops import riccati as ricmod
        solver = ricmod.make_admm_riccati_single(c)
        sol, qp_state = solver(Ad, Bd_t, x_ref, xi0,
                               qp_warm[0], qp_warm[1])
        u0 = sol.u[:3]
        left_now = on_l[0] > 0.5
        zeros3 = jnp.zeros_like(u0)
        grf = jnp.where(left_now,
                        jnp.concatenate([u0, zeros3], -1),
                        jnp.concatenate([zeros3, u0], -1))
        xi_pred = Ad @ xi0 + Bd_t[0] @ u0
        return grf, sol.residual, xi_pred, qp_state

    qp = cnd.condense(Ad, Bd_t, Q, R, P, N, xi0, x_ref,
                      None, None, extra_G=G, extra_h=h)
    if c.solver.method in ("admm", "admm_fused"):
        # single-factorization ADMM alternative (SolverConfig.method):
        # ONE Cholesky of (H + rho G'G) per solve and matvec-only
        # iterations — ~2x cheaper than the warm PDIP at matched
        # closed-loop accuracy.  Warm state (z, scaled dual y) threads
        # tick-to-tick through qp_warm exactly like the PDIP path.
        if qp_warm is None:
            z0 = jnp.zeros_like(qp.f)
            y0 = jnp.zeros_like(qp.h)
            iters = max(50, c.solver.iters)
        else:
            z0, y0 = qp_warm
            iters = c.solver.admm_warm_iters
        solver = qps.make_admm_warm(iters=iters, rho=c.solver.admm_rho,
                                    alpha=c.solver.admm_alpha)
        sol, qp_state = solver(qp.H, qp.f, qp.G, qp.h, z0, y0)
    elif qp_warm is None:
        solver = qps.make_pdip(iters=c.solver.iters)
        sol = solver(qp.H, qp.f, qp.G, qp.h)
        qp_state = (sol.u, jnp.ones_like(qp.h))
    else:
        solver = qps.make_pdip_warm(iters=c.solver.warm_iters)
        sol, qp_state = solver(qp.H, qp.f, qp.G, qp.h,
                               qp_warm[0], qp_warm[1])
    u0 = sol.u[:3]
    left_now = on_l[0] > 0.5
    zeros3 = jnp.zeros_like(u0)
    grf = jnp.where(left_now,
                    jnp.concatenate([u0, zeros3], -1),
                    jnp.concatenate([zeros3, u0], -1))
    xi_pred = qp.A_blocks[1] @ xi0 + qp.B_blocks[1, 0] @ u0
    return grf, sol.residual, xi_pred, qp_state


def tick(cfg: ControllerConfig, odom: OdomState, joints: JointState,
         iteration: jnp.ndarray, grf_override: jnp.ndarray | None = None,
         qp_warm=None, v_des: jnp.ndarray | None = None,
         yaw_rate_des: jnp.ndarray | None = None,
         ref_anchor: jnp.ndarray | None = None):
    """One 1 kHz control tick for ONE scenario (vmap for batches).

    Returns (RobotCmd, TickDiagnostics).  Mirrors MPC::run
    (include/MPCController.h:183-196): gait clock -> foot placement ->
    swing trajectory + IK -> (new) stance GRF MPC -> command packing.

    `grf_override` [6]: skip the MPC solve and use the given stance force —
    the intermediate-tick path of the reference's dtMPC schedule, which
    re-solves the MPC only every mpcStep = 5 control ticks
    (include/MPCParam.h:46-47) while the swing tracking runs at the full
    1 kHz rate.
    """
    dtype = odom.pos.dtype
    iteration = jnp.asarray(iteration, dtype)
    # commanded velocity: per-tick override (velocity profiles) or the
    # config default (the reference hardcodes (1,0,0),
    # include/MPCController.h:16)
    if v_des is None:
        v_des = jnp.asarray(cfg.desired_velocity, dtype)
    else:
        v_des = jnp.asarray(v_des, dtype)
    if yaw_rate_des is None:
        yaw_rate_des = jnp.asarray(cfg.desired_yaw_rate, dtype)
    else:
        yaw_rate_des = jnp.asarray(yaw_rate_des, dtype)

    gait = gaitmod.gait_clock(cfg.gait, iteration)
    target_w = gaitmod.foot_placement(cfg, gait, odom.pos, v_des,
                                      v_actual=odom.v_pos)

    # ---- reference anchor (pose tracking with anti-windup) ------------
    # ref_anchor [..., 3] = (x, y, yaw): clip the persistent anchor into a
    # band around the current pose, use the clipped value for this tick's
    # MPC reference, and advance it by (v_des, yaw_rate_des) dt for the
    # next tick.  band = 0 (or no anchor threaded) degenerates exactly to
    # the receding reference.  The yaw row is the round-5 heading
    # integral action (cfg.yaw_anchor_band): a receding yaw origin
    # re-zeroes the heading error every solve and tracks only ~76% of the
    # commanded rate through the spin-up.
    band = cfg.ref_anchor_band
    yband = cfg.yaw_anchor_band
    if ref_anchor is not None and band > 0.0:
        yaw_now = odom.ori[..., 2:3]
        anchor_used = jnp.concatenate([
            jnp.clip(ref_anchor[..., :2],
                     odom.pos[..., :2] - band,
                     odom.pos[..., :2] + band),
            jnp.clip(ref_anchor[..., 2:3], yaw_now - yband,
                     yaw_now + yband),
        ], -1)
        anchor_next = anchor_used + jnp.concatenate(
            [v_des[..., :2],
             yaw_rate_des[..., None] * jnp.ones_like(yaw_now)],
            -1) * cfg.gait.dt
        if cfg.anchor_placement_gain > 0.0:
            # integral action on the velocity error through the foot
            # placement: ran ahead of the anchor -> step further forward
            # -> brake (and vice versa); zero steady-state velocity error
            # inside the band
            target_w = target_w.at[..., :2].add(
                cfg.anchor_placement_gain
                * (odom.pos[..., :2] - anchor_used[..., :2]))
    else:
        anchor_used = None
        anchor_next = (jnp.concatenate(
            [odom.pos[..., :2] + v_des[..., :2] * cfg.gait.dt,
             odom.ori[..., 2:3]
             + yaw_rate_des[..., None] * cfg.gait.dt], -1)
            if ref_anchor is not None else None)

    # World-frame foot positions from FK + base pose
    R_wb = rot.quat_to_rot(odom.quat)
    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype)
    p_l_b = kin.forward_kinematics(gl, joints.q[..., :3])
    p_r_b = kin.forward_kinematics(gr, joints.q[..., 3:])
    p_l_w = odom.pos + jnp.einsum("...ij,...j->...i", R_wb, p_l_b)
    p_r_w = odom.pos + jnp.einsum("...ij,...j->...i", R_wb, p_r_b)

    # ---- swing leg: trajectory + analytic IK --------------------------
    foot_now_w = jnp.where(gait.left_swing, p_l_w, p_r_w)
    next_w = gaitmod.swing_trajectory(cfg.gait, gait, foot_now_w, target_w,
                                  ground_height=cfg.ground_height)
    # world -> base frame target
    next_b = jnp.einsum("...ji,...j->...i", R_wb, next_w - odom.pos)
    # select-then-compute: ONE IK call on the swing leg's geometry
    # (selecting results after two IK calls doubled the hot-path cost)
    g_sw = jax.tree.map(
        lambda a, b: jnp.where(gait.left_swing, a, b), gl, gr)
    q_guess = jnp.where(gait.left_swing[..., None],
                        joints.q[..., :3], joints.q[..., 3:])
    if cfg.ik_method == "analytic":
        swing_q = kin.inverse_kinematics_analytic(g_sw, next_b, q_guess)
    elif cfg.ik_method == "log6":
        # the reference's literal pinocchio loop: 6-DoF log6 error with
        # an identity target orientation (pinocchio_kinematics.h:61-149)
        swing_q = kin.inverse_kinematics_log6(
            g_sw, next_b, q_guess, iters=cfg.ik_iters,
            damp=cfg.ik_damp, dt=cfg.ik_dt)
    else:
        swing_q = kin.inverse_kinematics_damped_ls(
            g_sw, next_b, q_guess, iters=cfg.ik_iters, damp=cfg.ik_damp)

    # ---- stance leg: SRBD GRF MPC + torque map ------------------------
    dtype_sched = dtype
    if cfg.mode == "stand":
        on_l = jnp.ones((cfg.srbd.horizon,), dtype_sched)
        on_r = jnp.ones((cfg.srbd.horizon,), dtype_sched)
        arm_l, arm_r = p_l_w, p_r_w
        pos_anchor = 0.5 * (p_l_w + p_r_w)
        pos_anchor = pos_anchor.at[..., 2].set(
            cfg.ground_height + cfg.base_height)
    else:
        pos_anchor = None
        schedule = gaitmod.contact_schedule(
            cfg.gait, iteration, cfg.srbd.horizon, cfg.srbd.ts)
        on_l = schedule.astype(dtype_sched)
        on_r = 1.0 - on_l
        # moment arms: a currently-standing foot pushes from where it is; a
        # currently-swinging foot re-enters stance (within a horizon that
        # spans the phase switch) at the placement target.
        arm_l = jnp.where(gait.left_swing, target_w, p_l_w)
        arm_r = jnp.where(gait.left_swing, p_r_w, target_w)
    if cfg.mode == "stand":
        if grf_override is None:
            grf, residual, xi_pred, qp_state = stance_mpc(
                cfg, odom, arm_l, arm_r, on_l, on_r, v_des, yaw_rate_des,
                pos_anchor=pos_anchor, qp_warm=qp_warm)
            if qp_state is None:
                qp_state = qp_warm
        else:
            grf = grf_override
            residual = jnp.zeros_like(odom.pos[..., 0])
            xi_pred = srbd.initial_state(odom.ori, odom.pos, odom.v_ori,
                                         odom.v_pos)
            qp_state = qp_warm
    else:
        if grf_override is None:
            grf, residual, xi_pred, qp_state = stance_mpc_single_support(
                cfg, odom, arm_l, arm_r, on_l, v_des, yaw_rate_des,
                qp_warm=qp_warm, pos_anchor=anchor_used)
        else:
            # held-force tick of the dtMPC schedule: when the gait phase
            # switched since the solve, the held force belongs to the foot
            # now in stance
            left_stance_now = on_l[..., 0] > 0.5
            f_any = grf_override[..., :3] + grf_override[..., 3:]
            zeros3 = jnp.zeros_like(f_any)
            grf = jnp.where(left_stance_now,
                            jnp.concatenate([f_any, zeros3], -1),
                            jnp.concatenate([zeros3, f_any], -1))
            residual = jnp.zeros_like(odom.pos[..., 0])
            xi_pred = srbd.initial_state(odom.ori, odom.pos, odom.v_ori,
                                         odom.v_pos)
            qp_state = qp_warm

    # ---- pack the command --------------------------------------------
    left_swing = gait.left_swing
    if cfg.mode == "stand":
        f_l_b = jnp.einsum("...ji,...j->...i", R_wb, grf[..., :3])
        f_r_b = jnp.einsum("...ji,...j->...i", R_wb, grf[..., 3:])
        J_l = kin.contact_jacobian(gl, joints.q[..., :3])
        J_r = kin.contact_jacobian(gr, joints.q[..., 3:])
        tau_l = -jnp.einsum("...ji,...j->...i", J_l, f_l_b)
        tau_r = -jnp.einsum("...ji,...j->...i", J_r, f_r_b)
        q_cmd = joints.q
        tau_cmd = jnp.concatenate([tau_l, tau_r], -1)
        kp = jnp.zeros((*q_cmd.shape[:-1], 6), dtype)
        kd = jnp.full_like(kp, cfg.kd)
    else:
        # select-then-compute: the swing side's torque is zero, so only
        # the STANCE leg's Jacobian/torque map is evaluated
        g_st = jax.tree.map(
            lambda a, b: jnp.where(left_swing, b, a), gl, gr)
        q_st = jnp.where(left_swing[..., None],
                         joints.q[..., 3:], joints.q[..., :3])
        f_st_w = jnp.where(left_swing[..., None],
                           grf[..., 3:], grf[..., :3])
        f_st_b = jnp.einsum("...ji,...j->...i", R_wb, f_st_w)
        J_st = kin.contact_jacobian(g_st, q_st)
        tau_st = -jnp.einsum("...ji,...j->...i", J_st, f_st_b)
        zeros3t = jnp.zeros_like(tau_st)
        q_cmd = jnp.where(left_swing[..., None],
                          jnp.concatenate([swing_q, joints.q[..., 3:]], -1),
                          jnp.concatenate([joints.q[..., :3], swing_q], -1))
        tau_cmd = jnp.where(
            left_swing[..., None],
            jnp.concatenate([zeros3t, tau_st], -1),
            jnp.concatenate([tau_st, zeros3t], -1))
        swing_gain = jnp.where(left_swing[..., None],
                               jnp.asarray([1., 1., 1., 0., 0., 0.], dtype),
                               jnp.asarray([0., 0., 0., 1., 1., 1.], dtype))
        kp = cfg.kp * swing_gain
        kd = jnp.full_like(kp, cfg.kd)

    cmd = RobotCmd(
        mode=jnp.zeros((*q_cmd.shape[:-1], 6), jnp.int32),
        q=q_cmd, dq=jnp.zeros_like(q_cmd), tau=tau_cmd, kp=kp, kd=kd)
    diag = TickDiagnostics(gait=gait, grf=grf, qp_residual=residual,
                           foot_target=target_w, swing_q=swing_q,
                           predicted_xi=xi_pred, qp_state=qp_state,
                           ref_anchor=anchor_next)
    return cmd, diag
