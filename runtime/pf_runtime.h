/* pf_runtime — native robot-session runtime for mpc_limx_control_tpu.
 *
 * Re-design of the reference's L0/L1 robot I/O layer: the limX
 * pointfoot SDK UDP session (reference include/pf_controller_base.h:88-91,
 * src/pf_controller_base.cpp:14-35) and its mutex-guarded latest-value
 * state mailbox, plus the 1 kHz rate-controlled control loop
 * (src/mpc_control_fake_state.cpp:57,122 — including fixing the
 * milliseconds_per_step units bug noted in SURVEY.md §6).
 *
 * Architecture: a C library (built with g++, bound from Python via ctypes)
 * providing
 *   - a UDP "robot link" (controller side) and "robot host" (robot / sim
 *     side) speaking a fixed little-endian wire format,
 *   - background receive threads feeding seqlock-style latest-value
 *     mailboxes (no allocation, no locking on the reader fast path),
 *   - an absolute-deadline rate loop (clock_nanosleep TIMER_ABSTIME).
 *
 * All functions return 0 on success, negative errno-style codes on error.
 */

#ifndef PF_RUNTIME_H
#define PF_RUNTIME_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define PFRT_NUM_JOINTS 6
#define PFRT_MAGIC 0x5046524Bu /* "PFRK" */
#define PFRT_VERSION 2

/* Diagnostic names (the reference's DiagnosticValue.name strings,
 * src/mpc_control_fake_state.cpp:27-34, as wire-stable ids). */
#define PFRT_DIAG_CALIBRATION 1u
#define PFRT_DIAG_ETHERCAT 2u
#define PFRT_DIAG_IMU 3u

/* Wire/datatypes — mirror limxsdk RobotState / RobotCmd / ImuData
 * (reference include/pf_controller_base.h:88-91). */
typedef struct {
  uint64_t stamp_ns;
  float q[PFRT_NUM_JOINTS];
  float dq[PFRT_NUM_JOINTS];
  float tau[PFRT_NUM_JOINTS];
} pfrt_robot_state;

typedef struct {
  uint64_t stamp_ns;
  float quat[4]; /* x, y, z, w */
  float acc[3];
  float gyro[3];
} pfrt_imu_data;

typedef struct {
  uint64_t stamp_ns;
  int32_t mode[PFRT_NUM_JOINTS]; /* 0 = torque (src/mpc_control.cpp:120) */
  float q[PFRT_NUM_JOINTS];
  float dq[PFRT_NUM_JOINTS];
  float tau[PFRT_NUM_JOINTS];
  float kp[PFRT_NUM_JOINTS];
  float kd[PFRT_NUM_JOINTS];
} pfrt_robot_cmd;

/* Ground-truth odometry (the RobotOdomState the fake estimator reads from
 * Gazebo, reference include/state_estimator_fake.h:19-25). */
typedef struct {
  uint64_t stamp_ns;
  float pos[3];
  float quat[4]; /* x, y, z, w */
  float v_pos[3];
  float v_ori[3];
} pfrt_odom;

/* Robot diagnostic value (the limxsdk DiagnosticValue role, reference
 * src/pf_controller_base.cpp:36-41): robot -> controller health channel.
 * A calibration diagnostic with nonzero code must abort session init
 * (src/mpc_control_fake_state.cpp:27-34). */
typedef struct {
  uint64_t stamp_ns;
  uint32_t name;  /* PFRT_DIAG_* id */
  int32_t level;  /* 0 = OK, 1 = WARN, 2 = ERROR */
  int32_t code;   /* 0 = OK; meaning is name-specific */
} pfrt_diag;

/* Estimator odometry + covariance health, controller -> observers (the
 * stateEstimator's 200 Hz odom/pose-with-covariance publication,
 * reference include/stateEstimator.h:404-419). cov_diag is the diagonal
 * of the KF covariance over [base pos(3), base vel(3), feet(6)]. */
typedef struct {
  uint64_t stamp_ns;
  float pos[3];
  float quat[4]; /* x, y, z, w */
  float v_pos[3];
  float v_ori[3];
  float cov_diag[12];
} pfrt_est_odom;

typedef struct pfrt_link pfrt_link;   /* controller side */
typedef struct pfrt_host pfrt_host;   /* robot / simulator side */

/* ---- controller side (the PFControllerBase role) ---- */
pfrt_link *pfrt_connect(const char *host_ip, uint16_t state_port,
                        uint16_t cmd_port);
void pfrt_link_close(pfrt_link *l);
/* Latest-wins reads; return 1 if fresh data since last call, 0 if stale
 * (the robotstate_on_ flag semantics, src/pf_controller_base.cpp:27),
 * negative on error. */
int pfrt_recv_state(pfrt_link *l, pfrt_robot_state *out);
int pfrt_recv_imu(pfrt_link *l, pfrt_imu_data *out);
int pfrt_recv_odom(pfrt_link *l, pfrt_odom *out);
int pfrt_recv_diag(pfrt_link *l, pfrt_diag *out);
int pfrt_send_cmd(pfrt_link *l, const pfrt_robot_cmd *cmd);
/* Estimator odometry out-stream (controller -> host/observers). */
int pfrt_send_est_odom(pfrt_link *l, const pfrt_est_odom *o);
/* counters for observability */
uint64_t pfrt_link_state_count(const pfrt_link *l);

/* ---- robot / simulator side ---- */
pfrt_host *pfrt_serve(uint16_t state_port, uint16_t cmd_port);
void pfrt_host_close(pfrt_host *h);
int pfrt_publish_state(pfrt_host *h, const pfrt_robot_state *s,
                       const pfrt_imu_data *imu);
int pfrt_publish_odom(pfrt_host *h, const pfrt_odom *o);
int pfrt_publish_diag(pfrt_host *h, const pfrt_diag *d);
int pfrt_poll_cmd(pfrt_host *h, pfrt_robot_cmd *out); /* 1 fresh / 0 stale */
int pfrt_poll_est_odom(pfrt_host *h, pfrt_est_odom *out);
uint64_t pfrt_host_cmd_count(const pfrt_host *h);

/* ---- rate-controlled loop ---- */
typedef struct pfrt_rate pfrt_rate;
pfrt_rate *pfrt_rate_new(double hz);
void pfrt_rate_free(pfrt_rate *r);
/* Sleep until the next absolute deadline; returns the number of whole
 * periods missed (0 = on time). */
int pfrt_rate_sleep(pfrt_rate *r);
/* Monotonic clock in ns, for latency measurement. */
uint64_t pfrt_now_ns(void);

#ifdef __cplusplus
}
#endif

#endif /* PF_RUNTIME_H */
