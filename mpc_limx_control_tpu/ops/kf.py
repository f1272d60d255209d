"""Batched 12-state Kalman filter for base-state estimation.

Pure-functional re-design of the reference `stateEstimator`
(include/stateEstimator.h:86-337): state xHat = [base p(3), base v(3),
left foot p(3), right foot p(3)], observation y(14) = [relative foot
positions(6), relative foot velocities(6), foot heights(2)].

Same math, batched shape:
  * constant A with dt position<-velocity coupling and B integrating IMU
    acceleration (0.5 dt^2, dt) (include/stateEstimator.h:221-223)
  * process/measurement noise exactly the reference's dt-scaled blocks
    (:224-226, :250-258)
  * per-foot noise inflation x100 when not in contact (:260-279)
  * world-frame accel = R(quat)^T-free: R_zyx^T a_imu + g (:280-281)
  * covariance update via Cholesky solves (the reference uses LU, :293-296
    — S is SPD so Cholesky is both faster and stabler), symmetrization and
    xy-block conditioning (:299-306).

The filter is a pure function (KFState, measurements) -> KFState, vmapped
over scenarios; no mutable members, no ROS publishing (metrics surfaced as
return values instead).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_limx_control_tpu.core.config import EstimatorConfig
from mpc_limx_control_tpu.core.types import KFState


class KFMeasurement(NamedTuple):
    """Per-tick inputs to the filter (world-frame quantities computed by the
    caller from FK + IMU, as src/mpc_control.cpp:158-192 does)."""

    foot_pos_rel: jnp.ndarray   # [..., 2, 3] base->foot in world axes
    foot_vel_rel: jnp.ndarray   # [..., 2, 3]
    accel_world: jnp.ndarray    # [..., 3] R^T a_imu + g
    contact: jnp.ndarray        # [..., 2] bool
    foot_heights: jnp.ndarray   # [..., 2] measured foot heights (usually 0)


def _build_static(dtype):
    """The constant observation matrix C [14, 12]
    (include/stateEstimator.h:195-206)."""
    C = jnp.zeros((14, 12), dtype)
    e3 = jnp.eye(3, dtype=dtype)
    # rows 0-5: base position relative to each foot: p - p_foot_i
    C = C.at[0:3, 0:3].set(e3)
    C = C.at[3:6, 0:3].set(e3)
    C = C.at[0:6, 6:12].set(-jnp.eye(6, dtype=dtype))
    # rows 6-11: base velocity observed from each stance foot
    C = C.at[6:9, 3:6].set(e3)
    C = C.at[9:12, 3:6].set(e3)
    # rows 12-13: foot heights
    C = C.at[12, 8].set(1.0)
    C = C.at[13, 11].set(1.0)
    return C


def kf_update(cfg: EstimatorConfig, state: KFState, meas: KFMeasurement,
              dt: float) -> KFState:
    """One predict+update step.  Batched over leading axes of `state`.

    The whole update runs at full float32 matmul precision: a
    reduced-precision f32 matmul (TF32 on the GPU) has enough relative
    error to make the innovation covariance S = C P C' + R lose
    positive-definiteness (Cholesky -> NaN within two control ticks).
    The filter is 12x12 so full precision is free.
    """
    with jax.default_matmul_precision("float32"):
        return _kf_update_body(cfg, state, meas, dt)


def _kf_update_body(cfg: EstimatorConfig, state: KFState,
                    meas: KFMeasurement, dt: float) -> KFState:
    dtype = state.x_hat.dtype
    e3 = jnp.eye(3, dtype=dtype)

    A = jnp.eye(12, dtype=dtype)
    A = A.at[0:3, 3:6].set(dt * e3)
    B = jnp.zeros((12, 3), dtype)
    B = B.at[0:3, :].set(0.5 * dt * dt * e3)
    B = B.at[3:6, :].set(dt * e3)
    C = _build_static(dtype)

    # Process noise (include/stateEstimator.h:224-226, 250-253)
    q_diag = jnp.concatenate([
        jnp.full((3,), (dt / 20.0) * cfg.imu_process_noise_position, dtype),
        jnp.full((3,), (dt * 9.81 / 20.0) * cfg.imu_process_noise_velocity,
                 dtype),
        jnp.full((6,), dt * cfg.foot_process_noise_position, dtype),
    ])
    # Measurement noise (:255-258)
    r_diag = jnp.concatenate([
        jnp.full((6,), cfg.foot_sensor_noise_position, dtype),
        jnp.full((6,), cfg.foot_sensor_noise_velocity, dtype),
        jnp.full((2,), cfg.foot_height_sensor_noise, dtype),
    ])

    # Contact gating x100 (:260-279)
    big = cfg.high_suspect_number
    contact = meas.contact.astype(dtype)                 # [..., 2]
    gate = jnp.where(contact > 0.5, 1.0, big)            # [..., 2]
    q_gate = jnp.concatenate([
        jnp.ones((*gate.shape[:-1], 6), dtype),
        jnp.repeat(gate, 3, axis=-1),
    ], axis=-1)                                          # [..., 12]
    r_gate = jnp.concatenate([
        jnp.repeat(gate, 3, axis=-1),
        jnp.repeat(gate, 3, axis=-1),
        gate,
    ], axis=-1)                                          # [..., 14]

    Qm = q_diag * q_gate                                 # [..., 12]
    Rm = r_diag * r_gate                                 # [..., 14]

    # Observation vector (:276-284): ps = -(p_foot - p_base) + radius z,
    # vs = -v_foot_rel, heights.
    ps = -meas.foot_pos_rel
    ps = ps.at[..., 2].add(cfg.foot_radius)
    vs = -meas.foot_vel_rel
    y = jnp.concatenate([
        ps.reshape(*ps.shape[:-2], 6),
        vs.reshape(*vs.shape[:-2], 6),
        meas.foot_heights,
    ], axis=-1)                                          # [..., 14]

    # Predict (:285-287)
    x_pred = (jnp.einsum("ij,...j->...i", A, state.x_hat)
              + jnp.einsum("ij,...j->...i", B, meas.accel_world))
    P_pred = (jnp.einsum("ij,...jk,lk->...il", A, state.p_cov, A)
              + _batched_diag(Qm))

    # Update via Cholesky (S SPD)
    y_model = jnp.einsum("ij,...j->...i", C, x_pred)
    ey = y - y_model
    PCt = jnp.einsum("...ij,kj->...ik", P_pred, C)       # [..., 12, 14]
    S = jnp.einsum("ij,...jk->...ik", C, PCt) + _batched_diag(Rm)
    L = jnp.linalg.cholesky(S)
    s_ey = jax.scipy.linalg.cho_solve((L, True), ey[..., None])[..., 0]
    x_new = x_pred + jnp.einsum("...ij,...j->...i", PCt, s_ey)

    SC = jax.scipy.linalg.cho_solve(
        (L, True), jnp.broadcast_to(
            _bc(C, L.shape[:-2]), (*L.shape[:-2], 14, 12)))
    P_new = P_pred - PCt @ SC @ P_pred

    # Symmetrize + xy conditioning (:299-306)
    P_new = 0.5 * (P_new + jnp.swapaxes(P_new, -1, -2))
    det_xy = (P_new[..., 0, 0] * P_new[..., 1, 1]
              - P_new[..., 0, 1] * P_new[..., 1, 0])
    cond = det_xy > 1e-6
    mask_off = jnp.ones((12, 12), dtype)
    mask_off = mask_off.at[0:2, 2:12].set(0.0)
    mask_off = mask_off.at[2:12, 0:2].set(0.0)
    scale_xy = jnp.ones((12, 12), dtype)
    scale_xy = scale_xy.at[0:2, 0:2].set(0.1)
    P_cond = P_new * mask_off * scale_xy
    P_new = jnp.where(cond[..., None, None], P_cond, P_new)

    return KFState(x_hat=x_new, p_cov=P_new)


def _batched_diag(d):
    """[..., n] -> [..., n, n] diagonal matrices."""
    n = d.shape[-1]
    return d[..., :, None] * jnp.eye(n, dtype=d.dtype)


def _bc(M, batch):
    return jnp.broadcast_to(M, (*batch, *M.shape))
