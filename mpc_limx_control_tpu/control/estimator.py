"""State estimation front ends: scripted "fake" source and KF wrapper.

The reference exposes two interchangeable truth sources behind one struct
(`RobotOdomState`):

* `StateEstimatorFake` reads Gazebo ground truth over ROS
  (include/state_estimator_fake.h:27-116).  With no simulator here, the
  equivalent here is a *scripted* deterministic source — a pure
  function of time producing exact odometry for batched scenarios — which
  serves the same role: developing/validating the controller against
  perfect state (SURVEY.md §4 "fake backend / mock boundary").

* `stateEstimator` is the 12-state contact-gated Kalman filter
  (include/stateEstimator.h); :func:`estimator_tick` wraps the batched KF
  core (ops/kf.py) with the FK/IMU packing that src/mpc_control.cpp:158-192
  does on the host: joint states -> foot positions/velocities relative to
  the base (world axes), IMU -> world-frame acceleration.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mpc_limx_control_tpu.core.config import ControllerConfig
from mpc_limx_control_tpu.core.types import ImuData, JointState, KFState, OdomState
from mpc_limx_control_tpu.models import kinematics as kin
from mpc_limx_control_tpu.ops import kf as kfops
from mpc_limx_control_tpu.utils import rotations as rot


def scripted_odometry(cfg: ControllerConfig, iteration: jnp.ndarray,
                      v_des: jnp.ndarray, base_height: float = 0.8,
                      yaw_rate: jnp.ndarray | None = None) -> OdomState:
    """Deterministic ground-truth odometry: straight/arc walk at the desired
    velocity.  iteration [...], v_des [..., 3].  Batched."""
    dtype = v_des.dtype
    t = iteration * cfg.gait.dt
    if yaw_rate is None:
        yaw_rate = jnp.zeros_like(t)
    yaw = yaw_rate * t
    # position: integrate v_des (constant-heading approximation for the
    # scripted source; exact for yaw_rate = 0)
    pos = jnp.stack([
        v_des[..., 0] * t, v_des[..., 1] * t,
        jnp.full_like(t, base_height) + 0 * t], -1)
    rpy = jnp.stack([jnp.zeros_like(yaw), jnp.zeros_like(yaw), yaw], -1)
    quat = rot.rpy_to_quat(rpy)
    v_ori = jnp.stack(
        [jnp.zeros_like(yaw_rate), jnp.zeros_like(yaw_rate), yaw_rate], -1)
    return OdomState(pos=pos, ori=rpy, quat=quat, v_pos=v_des * jnp.ones_like(t)[..., None],
                     v_ori=v_ori)


class EstimatorOutput(NamedTuple):
    kf: KFState
    odom: OdomState


def estimator_tick(cfg: ControllerConfig, kf_state: KFState,
                   joints: JointState, imu: ImuData,
                   contact: jnp.ndarray, dt: float) -> EstimatorOutput:
    """One KF estimation tick (batched).

    contact [..., 2] bool.  Packs measurements the way
    src/mpc_control.cpp:158-192 + include/stateEstimator.h:228-281 do:
    FK with base orientation only (position pinned at origin) gives
    base->foot vectors in world axes; foot velocity via the contact
    Jacobian; world accel = R a_imu + g.
    """
    dtype = joints.q.dtype
    R_wb = rot.quat_to_rot(imu.quat)                     # world from body

    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype)
    pl_b = kin.forward_kinematics(gl, joints.q[..., :3])
    pr_b = kin.forward_kinematics(gr, joints.q[..., 3:])
    Jl = kin.contact_jacobian(gl, joints.q[..., :3])
    Jr = kin.contact_jacobian(gr, joints.q[..., 3:])
    vl_b = jnp.einsum("...ij,...j->...i", Jl, joints.dq[..., :3])
    vr_b = jnp.einsum("...ij,...j->...i", Jr, joints.dq[..., 3:])

    # base->foot in world axes; relative velocity includes the omega x r
    # term (the reference's eeKinematics getVelocity with base angular
    # velocity set, include/stateEstimator.h:239-248)
    omega_w = jnp.einsum("...ij,...j->...i", R_wb, imu.gyro)
    pl_w = jnp.einsum("...ij,...j->...i", R_wb, pl_b)
    pr_w = jnp.einsum("...ij,...j->...i", R_wb, pr_b)
    vl_w = (jnp.einsum("...ij,...j->...i", R_wb, vl_b)
            + jnp.cross(omega_w, pl_w))
    vr_w = (jnp.einsum("...ij,...j->...i", R_wb, vr_b)
            + jnp.cross(omega_w, pr_w))

    g_vec = jnp.asarray([0.0, 0.0, -9.81], dtype)
    accel_w = jnp.einsum("...ij,...j->...i", R_wb, imu.acc) + g_vec

    meas = kfops.KFMeasurement(
        foot_pos_rel=jnp.stack([pl_w, pr_w], axis=-2),
        foot_vel_rel=jnp.stack([vl_w, vr_w], axis=-2),
        accel_world=accel_w,
        contact=contact,
        foot_heights=jnp.zeros((*contact.shape[:-1], 2), dtype),
    )
    kf_new = kfops.kf_update(cfg.estimator, kf_state, meas, dt)

    # Pack RobotOdomState (include/stateEstimator.h:318-332): world
    # position from the filter, IMU orientation, world linear velocity
    # (the reference rotates it into the body frame for the odom topic but
    # keeps filter-frame values in robotOdomState_.v_pos via twist; here we
    # keep world-frame velocity, which is what the controller consumes).
    odom = OdomState(
        pos=kf_new.x_hat[..., 0:3],
        ori=rot.quat_to_rpy(imu.quat),
        quat=imu.quat,
        v_pos=kf_new.x_hat[..., 3:6],
        v_ori=omega_w,
    )
    return EstimatorOutput(kf=kf_new, odom=odom)
