"""TRON1 point-foot leg kinematics: analytic FK / IK / Jacobians.

The reference wraps a full Pinocchio URDF model
(include/pinocchio_kinematics.h:23-157) and runs a damped-least-squares IK
with a 10-iteration budget per swing update (:61-149) — the measured hot
kernel of the 1 kHz control loop (SURVEY.md §3.1).  The URDF itself is not
part of the reference repo; what it does ship are the exact link offsets in
`kinematicValues` (include/MPCParam.h:13-38), from which the 3-DoF chain

    base --abad_offset--> abad(roll,x) --hip_offset--> hip(pitch,y)
         --knee_offset--> knee(pitch,y) --foot_offset+contact_offset--> contact

is fully determined.  That admits a *closed-form* position IK (the
planar 2R sub-problem after decoupling the abad roll), which replaces the
iterative FK+Jacobian+LDLT loop with a handful of fused elementwise ops —
exactly vmappable over scenarios and legs.  Two iterative parity paths
are kept alongside: a position-only damped-LS Gauss-Newton
(`inverse_kinematics_damped_ls`) and the reference's full SE(3) log6
6-DoF loop (`inverse_kinematics_log6`, pinocchio_kinematics.h:61-149)
— the latter reproduces the reference's actual behavior of trading
position accuracy against the unreachable identity orientation of a
point foot (ik_method="log6"; the production configs use "analytic").

Conventions: left leg uses the offsets as given (y > 0); the right leg
mirrors every offset's y component.  Joint vector per leg: (abad, hip,
knee); full robot q = [left(3), right(3)] matching jointNames
(include/stateEstimator.h:67).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from mpc_limx_control_tpu.core.config import LegOffsets


class LegGeometry(NamedTuple):
    """Per-leg chain constants as arrays (sign already applied for side)."""

    abad: jnp.ndarray     # [3] base -> abad joint
    hip: jnp.ndarray      # [3] abad -> hip joint
    knee: jnp.ndarray     # [3] hip -> knee joint
    foot: jnp.ndarray     # [3] knee -> contact point (foot+contact merged)


def leg_geometry(offsets: LegOffsets = LegOffsets(), side: str = "left",
                 dtype=jnp.float32) -> LegGeometry:
    mirror = jnp.asarray(
        [1.0, 1.0 if side == "left" else -1.0, 1.0], dtype)
    a = jnp.asarray(offsets.abad_offset, dtype) * mirror
    h = jnp.asarray(offsets.hip_offset, dtype) * mirror
    k = jnp.asarray(offsets.knee_offset, dtype) * mirror
    f = (jnp.asarray(offsets.foot_offset, dtype)
         + jnp.asarray(offsets.contact_offset, dtype)) * mirror
    return LegGeometry(abad=a, hip=h, knee=k, foot=f)


def _rx(q):
    c, s = jnp.cos(q), jnp.sin(q)
    z, o = jnp.zeros_like(q), jnp.ones_like(q)
    return jnp.stack([
        jnp.stack([o, z, z], -1),
        jnp.stack([z, c, -s], -1),
        jnp.stack([z, s, c], -1),
    ], -2)


def _ry(q):
    c, s = jnp.cos(q), jnp.sin(q)
    z, o = jnp.zeros_like(q), jnp.ones_like(q)
    return jnp.stack([
        jnp.stack([c, z, s], -1),
        jnp.stack([z, o, z], -1),
        jnp.stack([-s, z, c], -1),
    ], -2)


def forward_kinematics(geom: LegGeometry, q: jnp.ndarray) -> jnp.ndarray:
    """Contact-point position in the base frame.  q = [abad, hip, knee].

    Batched over leading axes of q.
    """
    r0 = _rx(q[..., 0])
    r1 = _ry(q[..., 1])
    r2 = _ry(q[..., 2])
    r01 = r0 @ r1
    r012 = r01 @ r2
    return (geom.abad
            + jnp.einsum("...ij,j->...i", r0, geom.hip)
            + jnp.einsum("...ij,j->...i", r01, geom.knee)
            + jnp.einsum("...ij,j->...i", r012, geom.foot))


def contact_jacobian(geom: LegGeometry, q: jnp.ndarray) -> jnp.ndarray:
    """d(contact position)/d(q): [..., 3, 3] in the base frame.

    Exact via forward-mode autodiff (3 primals — cheap, fully fused);
    replaces pinocchio::computeFrameJacobian
    (include/pinocchio_kinematics.h:116) for the stance torque map
    tau = J^T f.
    """
    fk = lambda qq: forward_kinematics(geom, qq)
    if q.ndim == 1:
        return jax.jacfwd(fk)(q)
    flat = q.reshape(-1, 3)
    J = jax.vmap(jax.jacfwd(fk))(flat)
    return J.reshape(*q.shape[:-1], 3, 3)


def _wrap_angle(a):
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))


def inverse_kinematics_analytic(geom: LegGeometry, target: jnp.ndarray,
                                q_ref: jnp.ndarray) -> jnp.ndarray:
    """Closed-form position IK.  target [..., 3] in base frame; q_ref is the
    branch-selection hint (current joint angles).  Returns q [..., 3].

    Derivation: with v = target - abad, the y component of Rx(q0)^T v must
    equal the (constant) y-offset of the planar chain; the remainder is a
    planar 2R problem in the abad x-z plane solved by the law of cosines.
    Unreachable targets are clamped to the boundary of the workspace
    (cosine clipped), mirroring damped-LS behavior of saturating at maximum
    extension.
    """
    v = target - geom.abad
    vy = v[..., 1]
    vz = v[..., 2]
    # y-offset of the chain distal to the abad, invariant under Ry:
    y_chain = geom.hip[1] + geom.knee[1] + geom.foot[1]
    # Solve cos(q0) vy + sin(q0) vz = y_chain for q0 (nearest branch):
    # write vy = r cos(phi), vz = r sin(phi) => r cos(q0 - phi) = y_chain.
    r = jnp.sqrt(vy * vy + vz * vz)
    phi = jnp.arctan2(vz, vy)
    c = jnp.clip(y_chain / jnp.maximum(r, 1e-9), -1.0, 1.0)
    delta0 = jnp.arccos(c)
    cand0 = jnp.stack([_wrap_angle(phi - delta0 + 2 * jnp.pi * 0),
                       _wrap_angle(phi + delta0)], -1)
    # pick branch nearest q_ref[...,0]
    d0 = jnp.abs(_wrap_angle(cand0 - q_ref[..., 0:1]))
    q0 = jnp.take_along_axis(cand0, jnp.argmin(d0, -1, keepdims=True),
                             -1)[..., 0]

    # Rotate into the abad frame, subtract the hip offset, go planar (x,z).
    r0t = jnp.swapaxes(_rx(q0), -1, -2)
    u3 = jnp.einsum("...ij,...j->...i", r0t, v) - geom.hip
    ux, uz = u3[..., 0], u3[..., 2]

    ax, az = geom.knee[0], geom.knee[2]
    bx, bz = geom.foot[0], geom.foot[2]
    la2 = ax * ax + az * az
    lb2 = bx * bx + bz * bz
    rho = jnp.sqrt(la2 * lb2)
    psi = jnp.arctan2(ax * bz - az * bx, ax * bx + az * bz)
    k = (ux * ux + uz * uz - la2 - lb2) / 2.0
    c2 = jnp.clip(k / rho, -1.0, 1.0)
    delta2 = jnp.arccos(c2)
    cand2 = jnp.stack([_wrap_angle(psi - delta2),
                       _wrap_angle(psi + delta2)], -1)
    d2 = jnp.abs(_wrap_angle(cand2 - q_ref[..., 2:3]))
    q2 = jnp.take_along_axis(cand2, jnp.argmin(d2, -1, keepdims=True),
                             -1)[..., 0]

    # q1 from the residual rotation: e^{-i q1} (A + e^{-i q2} B) = U
    wx = ax + jnp.cos(q2) * bx + jnp.sin(q2) * bz
    wz = az - jnp.sin(q2) * bx + jnp.cos(q2) * bz
    q1 = _wrap_angle(jnp.arctan2(wz, wx) - jnp.arctan2(uz, ux))

    return jnp.stack([q0, q1, q2], -1)


def inverse_kinematics_damped_ls(geom: LegGeometry, target: jnp.ndarray,
                                 q_init: jnp.ndarray, iters: int = 10,
                                 damp: float = 1e-6,
                                 step: float = 1.0) -> jnp.ndarray:
    """Fixed-iteration damped least-squares IK (Gauss-Newton), the
    batched counterpart of include/pinocchio_kinematics.h:61-149
    (budget: <=10 iterations, damp 1e-6).  Position error only (point
    foot).  Branch-free: always runs `iters` iterations; converged iterates
    simply stop moving.
    """

    def body(q, _):
        err = forward_kinematics(geom, q) - target
        J = contact_jacobian(geom, q)
        JJt = J @ jnp.swapaxes(J, -1, -2)
        JJt = JJt + damp * jnp.eye(3, dtype=q.dtype)
        y = jnp.linalg.solve(JJt, err[..., None])[..., 0]
        dq = -jnp.einsum("...ji,...j->...i", J, y)
        return q + step * dq, None

    q, _ = lax.scan(body, q_init, None, length=iters)
    return q


def _skew(w):
    z = jnp.zeros_like(w[..., 0])
    return jnp.stack([
        jnp.stack([z, -w[..., 2], w[..., 1]], -1),
        jnp.stack([w[..., 2], z, -w[..., 0]], -1),
        jnp.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def log3(R: jnp.ndarray) -> jnp.ndarray:
    """SO(3) log: rotation matrix [..., 3, 3] -> axis-angle [..., 3]
    (pinocchio::log3), valid for theta in [0, pi) away from pi.

    Differentiation-safe at the identity: built from atan2(sin, cos)
    with double-where guards instead of arccos (whose derivative is NaN
    at the clipped |c| = 1 boundary under jacfwd — the IK Jacobian is
    forward-mode autodiff through this function, and the swing error
    rotation routinely passes near identity)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    w_raw = 0.5 * jnp.stack([R[..., 2, 1] - R[..., 1, 2],
                             R[..., 0, 2] - R[..., 2, 0],
                             R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = jnp.sum(w_raw * w_raw, -1)            # sin^2(theta)
    small = s2 < 1e-12
    s_safe = jnp.sqrt(jnp.where(small, 1.0, s2))
    theta = jnp.arctan2(s_safe, c)
    scale_big = theta / s_safe
    # theta -> 0: scale = theta/sin(theta) = 1 + theta^2/6 + ...,
    # and 1 - c = theta^2/2, so scale = 1 + (1-c)/3 (smooth in c)
    scale_small = 1.0 + (1.0 - c) * (1.0 / 3.0)
    scale = jnp.where(small, scale_small, scale_big)
    return w_raw * scale[..., None]


def log6(R: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """SE(3) log: (R [...,3,3], p [...,3]) -> twist [..., 6] in
    pinocchio Motion::toVector() order (linear first, angular second).
    Linear part = V(theta)^-1 p with the standard closed-form V^-1 =
    I - [w]x/2 + coef [w]x^2, coef -> 1/12 as theta -> 0.  Small-angle
    branches use the double-where guard so forward-mode autodiff (the
    IK Jacobian) stays finite at theta = 0."""
    w = log3(R)
    th2 = jnp.sum(w * w, -1)
    # wide Taylor branch: below theta ~ 1e-2 the closed form's
    # 2(1-cos) - theta sin is catastrophically cancelled in f32
    # (cos(theta) rounds to 1.0 for theta < ~3e-4 -> 0/0), while the
    # 1/12 + theta^2/720 series is accurate to ~theta^4/3e4 there
    small = th2 < 1e-4
    th_safe = jnp.sqrt(jnp.where(small, 1.0, th2))
    s, c = jnp.sin(th_safe), jnp.cos(th_safe)
    denom = jnp.where(small, 1.0, 2.0 * (1.0 - c) * th2)
    coef_big = (2.0 * (1.0 - c) - th_safe * s) / denom
    coef = jnp.where(small, 1.0 / 12.0 + th2 * (1.0 / 720.0), coef_big)
    wx = _skew(w)
    eye = jnp.eye(3, dtype=R.dtype)
    v_inv = eye - 0.5 * wx + coef[..., None, None] * (wx @ wx)
    v = jnp.einsum("...ij,...j->...i", v_inv, p)
    return jnp.concatenate([v, w], -1)


def leg_pose(geom: LegGeometry, q: jnp.ndarray):
    """Contact-frame pose in the base frame: (R [..., 3, 3], p [..., 3]).
    The URDF's fixed foot/contact joints carry identity rotations, so the
    frame rotation is the joint chain product Rx(q0)Ry(q1)Ry(q2)."""
    r0 = _rx(q[..., 0])
    r01 = r0 @ _ry(q[..., 1])
    r012 = r01 @ _ry(q[..., 2])
    p = (geom.abad
         + jnp.einsum("...ij,j->...i", r0, geom.hip)
         + jnp.einsum("...ij,j->...i", r01, geom.knee)
         + jnp.einsum("...ij,j->...i", r012, geom.foot))
    return r012, p


def inverse_kinematics_log6(geom: LegGeometry, target: jnp.ndarray,
                            q_init: jnp.ndarray, iters: int = 10,
                            damp: float = 1e-6,
                            dt: float = 0.1) -> jnp.ndarray:
    """SE(3) log6 damped-least-squares IK — full parity with the
    reference's pinocchio loop (include/pinocchio_kinematics.h:61-149):
    desired pose oMdes = (Identity, target); per iteration the 6-DoF
    error err = log6(oMf^-1 oMdes), J = d err/d q (the reference forms
    this as -Jlog6(iMd^-1) @ frameJacobian — here the SAME matrix is
    produced by forward-mode autodiff of the log6 error, which IS that
    chain rule), then v = -J' (J J' + damp I)^-1 err and q <- q + v DT
    with the reference's DT = 1e-1, damp = 1e-6, <=10 iterations.

    A 3-joint point foot cannot realize the identity orientation, so the
    6-DoF error trades position accuracy against the unreachable
    rotation — the reference's actual (documented) swing-IK behavior.
    The production configs use the exact closed-form position IK
    (ik_method="analytic"); this path is selected by ik_method="log6".

    Branch-free fixed iteration count (the reference's err.norm() < eps
    early-out almost never fires with an unreachable orientation)."""
    eye6 = jnp.eye(6, dtype=q_init.dtype)

    def err_fn(q, tgt):
        R, p = leg_pose(geom, q)
        Rt = jnp.swapaxes(R, -1, -2)
        t_i = jnp.einsum("...ij,...j->...i", Rt, tgt - p)
        return log6(Rt, t_i)

    def one(q0, tgt):
        def body(q, _):
            e = err_fn(q, tgt)
            J = jax.jacfwd(lambda qq: err_fn(qq, tgt))(q)   # [6, 3]
            JJt = J @ J.T + damp * eye6
            v = -J.T @ jnp.linalg.solve(JJt, e)
            return q + dt * v, None
        q, _ = lax.scan(body, q0, None, length=iters)
        return q

    if q_init.ndim == 1:
        return one(q_init, target)
    flat_q = q_init.reshape(-1, 3)
    flat_t = target.reshape(-1, 3)
    out = jax.vmap(one)(flat_q, flat_t)
    return out.reshape(q_init.shape)


def full_fk(offsets: LegOffsets, q6: jnp.ndarray, dtype=None):
    """Both contact points in the base frame from the 6-joint vector.

    Returns (p_left [...,3], p_right [...,3]).
    """
    dtype = dtype or q6.dtype
    gl = leg_geometry(offsets, "left", dtype)
    gr = leg_geometry(offsets, "right", dtype)
    return (forward_kinematics(gl, q6[..., :3]),
            forward_kinematics(gr, q6[..., 3:]))
