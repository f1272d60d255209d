"""Host-side robot control session — the application layer.

Counterpart of the reference's entry-point executables
(SURVEY.md §2, L5):

* :class:`ControlSession` = the `MPCWalking` app
  (src/mpc_control_fake_state.cpp:18-157): owns a runtime link, runs
  `init` (gain setup + calibration gate), `start` (move-to-zero with
  linear interpolation and the errorTest tolerance gate,
  src/mpc_control_fake_state.cpp:48-102), and `run` (the 1 kHz loop:
  poll state -> jitted controller tick -> publish command), with the
  reference's milliseconds_per_step units bug fixed (the loop really
  ticks at the configured rate).
* :func:`move_single_joint` / :func:`move_group_joints` = the limX SDK
  demos pf_joint_move / pf_groupJoints_move (src/pf_joint_move.cpp:36-78,
  src/pf_groupJoints_move.cpp:39-89): interpolate one/all joints to a
  target at 1 kHz.
* :func:`square_wave_torque` = the actuator smoke test of the vestigial
  MPCController.cpp (src/MPCController.cpp:8-17): +/-20 Nm square wave on
  joints 1 and 4 with a 1000-iteration period.
* :func:`error_test` = MPCParam::errorTest (include/MPCParam.h:75-82).

The compute path stays jitted JAX; this module is the thin host driver
around it (the role ROS + the SDK callbacks play in the reference).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpc_limx_control_tpu.core.config import ControllerConfig
from mpc_limx_control_tpu.core.types import ImuData, JointState, KFState, OdomState
from mpc_limx_control_tpu.control import controller as ctrl
from mpc_limx_control_tpu.control import estimator as est
from mpc_limx_control_tpu import runtime as rt


def error_test(target_pos, now_pos, tolerance: float = 0.1) -> bool:
    """All six joints within tolerance (include/MPCParam.h:75-82)."""
    t = np.asarray(target_pos, np.float64)
    n = np.asarray(now_pos, np.float64)
    return bool((np.abs(t[:6] - n[:6]) < tolerance).all())


def square_wave_torque(iteration: int, amplitude: float = 20.0,
                       period: int = 1000) -> np.ndarray:
    """+/-amplitude Nm on joints 1 and 4 (0-indexed: 0 and 3), switching
    every `period` iterations (src/MPCController.cpp:8-17)."""
    tau = np.zeros(6, np.float32)
    sign = 1.0 if (iteration // period) % 2 == 0 else -1.0
    tau[0] = sign * amplitude
    tau[3] = sign * amplitude
    return tau


def move_single_joint(link: rt.RobotLink, joint_id: int, target: float,
                      kp: float = 60.0, kd: float = 3.0,
                      duration_iters: int = 2000, hz: float = 1000.0,
                      max_iters: int = 20000) -> bool:
    """pf_joint_move: interpolate one joint to `target` at 1 kHz."""
    with rt.Rate(hz) as rate:
        init_q = None
        for it in range(max_iters):
            state = link.recv_state()
            if state is None:
                rate.sleep()
                continue
            if init_q is None:
                init_q = state["q"].copy()
            r = min(max(it / duration_iters, 0.0), 1.0)
            q_cmd = state["q"].copy()
            q_cmd[joint_id] = (1 - r) * init_q[joint_id] + r * target
            kp_v = np.zeros(6, np.float32)
            kd_v = np.zeros(6, np.float32)
            kp_v[joint_id] = kp
            kd_v[joint_id] = kd
            link.send_cmd(q=q_cmd, kp=kp_v, kd=kd_v)
            if r >= 1.0 and abs(state["q"][joint_id] - target) < 0.1:
                return True
            rate.sleep()
    return False


def move_group_joints(link: rt.RobotLink, targets, kp: float = 60.0,
                      kd: float = 3.0, duration_iters: int = 2000,
                      hz: float = 1000.0, tolerance: float = 0.1,
                      max_iters: int = 20000) -> bool:
    """pf_groupJoints_move / the session's move-to-zero phase: linear
    interpolation of all joints with the errorTest gate."""
    targets = np.asarray(targets, np.float32)
    with rt.Rate(hz) as rate:
        init_q = None
        it = 0
        for _ in range(max_iters):
            state = link.recv_state()
            if state is None:
                rate.sleep()
                continue
            if init_q is None:
                init_q = state["q"].copy()
            r = min(max(it / duration_iters, 0.0), 1.0)
            q_cmd = (1 - r) * init_q + r * targets
            link.send_cmd(q=q_cmd, kp=np.full(6, kp, np.float32),
                          kd=np.full(6, kd, np.float32))
            if error_test(targets, state["q"], tolerance):
                return True
            it += 1
            rate.sleep()
    return False


def zero_torque(link: rt.RobotLink) -> None:
    """Publish the all-zero safe-stop command: q = dq = tau = kp = kd = 0
    (PFControllerBase::zeroTorque, src/pf_controller_base.cpp:72-83)."""
    z = np.zeros(rt.NUM_JOINTS, np.float32)
    link.send_cmd(q=z, dq=z, tau=z, kp=z, kd=z)


def damping(link: rt.RobotLink, kd: float = 4.0) -> None:
    """Publish the damping safe-stop command: everything zero except
    kd (PFControllerBase::damping, src/pf_controller_base.cpp:86-97,
    which uses kd = 4)."""
    z = np.zeros(rt.NUM_JOINTS, np.float32)
    link.send_cmd(q=z, dq=z, tau=z, kp=z,
                  kd=np.full(rt.NUM_JOINTS, kd, np.float32))


class CalibrationError(RuntimeError):
    """A calibration diagnostic with nonzero code arrived — the analogue of
    the reference's abort() (src/mpc_control_fake_state.cpp:27-34)."""


class ControlSession:
    """The MPCWalking application: init -> start (move to zero) -> run."""

    def __init__(self, cfg: Optional[ControllerConfig] = None,
                 host_ip: str = "127.0.0.1", state_port: int = 17101,
                 cmd_port: int = 17102):
        self.cfg = cfg or ControllerConfig.walking()
        self.link = rt.RobotLink(host_ip, state_port, cmd_port)
        # Every tick fetches exactly ONE small packed array
        # [q dq tau kp kd] (30 f32) from the device; QP warm state and the
        # held GRF live on-device between ticks.  Per-tick host latency is
        # dispatch + one tiny transfer.
        def _packed(cmd):
            return jnp.concatenate(
                [cmd.q, cmd.dq, cmd.tau, cmd.kp, cmd.kd], -1)

        self._tick = jax.jit(
            lambda odom, joints, it: _packed(
                ctrl.tick(self.cfg, odom, joints, it)[0]))
        # walking reference anchor (cfg.ref_anchor_band): device-resident
        # xy state advanced by the jitted ticks, like the QP warm state
        self.ref_anchor = None
        if self.cfg.ref_anchor_band > 0.0 and self.cfg.mode == "walk":
            # (x, y, yaw) — reset by the first odom tick
            self.ref_anchor = jnp.asarray(
                [0.0, 0.0, 0.0], jnp.float32)
        # Production-path ticks (the benched sim path, live): the GRF QP is
        # warm-started tick-to-tick (ops/mpc_fused_pallas.py, unbatched:
        # the XLA composition) and held between re-solves per the
        # reference's dtMPC schedule (include/MPCParam.h:46-47).

        def _warm_impl(odom, joints, it, z, lam, anchor):
            cmd, diag = ctrl.tick(self.cfg, odom, joints, it,
                                  qp_warm=(z, lam), ref_anchor=anchor)
            anc = diag.ref_anchor if diag.ref_anchor is not None \
                else jnp.zeros((3,), jnp.float32)
            return (_packed(cmd), diag.qp_state[0], diag.qp_state[1],
                    diag.grf, anc)

        def _hold_impl(odom, joints, it, grf, anchor):
            cmd, diag = ctrl.tick(self.cfg, odom, joints, it,
                                  grf_override=grf, ref_anchor=anchor)
            anc = diag.ref_anchor if diag.ref_anchor is not None \
                else jnp.zeros((3,), jnp.float32)
            return _packed(cmd), anc

        self._tick_warm = jax.jit(_warm_impl)
        self._tick_hold = jax.jit(_hold_impl)
        self.qp_state = self._initial_qp_state()
        self._held_grf = None
        def _est_impl(kf, joints, imu, contact):
            out = est.estimator_tick(self.cfg, kf, joints, imu, contact,
                                     self.cfg.gait.dt)
            # packed wire odometry [pos quat v_pos v_ori cov_diag(12)]
            # so publication costs ONE device->host transfer
            pub = jnp.concatenate([
                out.odom.pos, out.odom.quat, out.odom.v_pos,
                out.odom.v_ori,
                jnp.diagonal(out.kf.p_cov, axis1=-2, axis2=-1)], -1)
            return out, pub

        self._est_tick = jax.jit(_est_impl)
        self.kf = KFState.initial(
            (), self.cfg.estimator.initial_covariance, jnp.float32)
        # calibration-diagnostic abort gate: set False the moment a
        # calibration diagnostic with nonzero code arrives on the wire
        self.calibrated = True

    def _initial_qp_state(self):
        """Cold warm-start state, matching rollout.initial_plant_state:
        z = 0 controls; ADMM threads the scaled dual y (zeros), PDIP
        threads strictly-positive multipliers (ones)."""
        if not self.cfg.qp_warm_start:
            return None
        c = self.cfg.srbd
        nu = 3 if self.cfg.mode == "walk" else 6
        z = jnp.zeros((nu * c.horizon,), jnp.float32)
        if c.solver.method in ("admm", "admm_fused", "riccati"):
            lam = jnp.zeros((2 * nu * c.horizon,), jnp.float32)
        else:
            lam = jnp.ones((2 * nu * c.horizon,), jnp.float32)
        return (z, lam)

    def close(self):
        self.link.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- safety commands (PFControllerBase, src/pf_controller_base.cpp:72-97)
    def zero_torque(self) -> None:
        zero_torque(self.link)

    def damping(self, kd: float = 4.0) -> None:
        damping(self.link, kd)

    def _poll_diagnostics(self) -> None:
        """Drain the diagnostic mailbox; trip the calibration gate on a
        nonzero calibration code (src/mpc_control_fake_state.cpp:27-34)."""
        d = self.link.recv_diag()
        if d is not None and d["name"] == rt.DIAG_CALIBRATION:
            self.calibrated = d["code"] == 0

    # -- init: gains + calibration gate (src/mpc_control_fake_state.cpp:24-43)
    def init(self, settle_s: float = 0.05) -> None:
        """Wait briefly for any pending calibration diagnostic, then gate.

        On failure the robot is left in damping mode (the safe analogue of
        the reference's bare abort()) and CalibrationError raised."""
        import time
        deadline = rt.now_ns() + int(settle_s * 1e9)
        while rt.now_ns() < deadline:
            self._poll_diagnostics()
            if not self.calibrated:
                break
            time.sleep(0.001)
        if not self.calibrated:
            self.damping()
            raise CalibrationError("calibration diagnostic failed")

    # -- start: move to zero point (src/mpc_control_fake_state.cpp:48-102)
    def start(self, timeout_iters: int = 20000) -> bool:
        return move_group_joints(
            self.link, np.zeros(6, np.float32), kp=self.cfg.kp,
            kd=self.cfg.kd, tolerance=self.cfg.gait.given_error_rate,
            max_iters=timeout_iters)

    # -- run: the 1 kHz MPC loop (src/mpc_control_fake_state.cpp:108-149)
    def run(self, iterations: int, hz: float = 1000.0,
            use_kf: bool = False, est_odom_every: int = 5,
            mpc_every: Optional[int] = None,
            async_dispatch: bool = False) -> dict:
        """Run `iterations` control ticks; returns loop statistics.

        The live loop IS the production path: with cfg.qp_warm_start (the
        default walking/standing configs) the GRF QP threads its warm
        state (z, y) tick-to-tick; `mpc_every` (default cfg.gait.mpc_step = 5,
        the reference's dtMPC schedule, include/MPCParam.h:46-47)
        re-solves the MPC every mpc_every ticks and holds the GRF in
        between while gait/swing tracking runs at the full rate.
        `mpc_every=1` re-solves every tick.

        With `use_kf`, contact flags for the filter's noise gating come
        from the gait clock (swing-foot measurements are inflated x100,
        include/stateEstimator.h:260-279) — NOT hardwired double support,
        which on a walking robot would let the swing foot corrupt the
        estimate.  The KF odometry + covariance diagonal is published back
        over the wire every `est_odom_every` ticks (the reference's 200 Hz
        odom/pose stream, include/stateEstimator.h:404-419).

        Returned stats include per-tick host latency (seconds) measured
        from state receipt to command send: `tick_latency_p50/p95/p99/max`
        overall plus `solve_latency_p50`/`hold_latency_p50` split by
        dtMPC role, and budget counters vs the 1 kHz control period and
        the 5 ms dtMPC budget.

        `async_dispatch` (round 5, VERDICT r4 next #7): the MPC solve is
        dispatched WITHOUT waiting and overlaps the hold ticks.  Every
        tick runs the (cheap) hold path with the force of the newest
        COMPLETED solve — jax async dispatch keeps the solve chain
        device-resident (warm state threads as device futures in
        dispatch order, so ordering is exact) and the host only polls
        `Array.is_ready()`.  The dtMPC schedule tolerates this by
        construction (the reference holds its force 5 ticks,
        include/MPCParam.h:46-47).  Stats gain a measured force-
        staleness histogram (`grf_staleness_p50/p95/max`, in ticks) and
        `solves_dispatched/solves_adopted` — the loop rate is decoupled
        from the SOLVE round trip (it remains bounded by the hold tick's
        dispatch+fetch)."""
        import time as _time
        from mpc_limx_control_tpu.control import gait as gaitmod
        if mpc_every is None:
            mpc_every = self.cfg.gait.mpc_step
        warm = self.cfg.qp_warm_start and self.qp_state is not None
        stats = {"sent": 0, "stale": 0, "missed_deadlines": 0,
                 "est_odom_published": 0, "mpc_solves": 0, "mpc_holds": 0,
                 "solves_dispatched": 0, "solves_adopted": 0}
        lat_solve: list = []
        lat_hold: list = []
        staleness: list = []
        pending: list = []      # async: dispatched, not-yet-adopted solves
        held_it = None          # tick the adopted force was solved at
        if async_dispatch and not warm:
            raise ValueError("async_dispatch requires the warm "
                             "(qp_warm_start) production path")
        it = 0
        with rt.Rate(hz) as rate:
            while it < iterations:
                t_tick0 = _time.perf_counter()
                self._poll_diagnostics()
                if not self.calibrated:
                    self.damping()
                    raise CalibrationError(
                        "calibration diagnostic failed mid-run")
                state = self.link.recv_state()
                if state is None:
                    stats["stale"] += 1
                    rate.sleep()
                    continue
                imu_raw = self.link.recv_imu()
                if use_kf and imu_raw is None:
                    # the IMU datagram trails the state packet on the wire
                    # (pf_runtime.cpp publishes them back-to-back); wait
                    # briefly for it so the filter never skips a predict
                    # step — a skipped predict leaves KF time behind plant
                    # time and the position estimate lags systematically
                    import time as _time
                    deadline = rt.now_ns() + 2_000_000        # 2 ms
                    while imu_raw is None and rt.now_ns() < deadline:
                        _time.sleep(0.00005)
                        imu_raw = self.link.recv_imu()
                    if imu_raw is None:
                        stats["stale"] += 1
                        rate.sleep()
                        continue
                joints = JointState(
                    q=jnp.asarray(state["q"]),
                    dq=jnp.asarray(state["dq"]),
                    tau=jnp.asarray(state["tau"]))
                odom_raw = self.link.recv_odom()
                if use_kf and imu_raw is not None:
                    imu = ImuData(quat=jnp.asarray(imu_raw["quat"]),
                                  acc=jnp.asarray(imu_raw["acc"]),
                                  gyro=jnp.asarray(imu_raw["gyro"]))
                    if self.cfg.mode == "stand":
                        contact = jnp.asarray([True, True])
                    else:
                        g_clk = gaitmod.gait_clock(
                            self.cfg.gait,
                            jnp.asarray(float(it), jnp.float32))
                        ls = bool(g_clk.left_swing)
                        contact = jnp.asarray([not ls, ls])
                    out, est_pub = self._est_tick(self.kf, joints, imu,
                                                  contact)
                    self.kf = out.kf
                    odom = out.odom
                    if est_odom_every and it % est_odom_every == 0:
                        e = np.asarray(est_pub)
                        self.link.send_est_odom(
                            pos=e[0:3], quat=e[3:7], v_pos=e[7:10],
                            v_ori=e[10:13], cov_diag=e[13:25],
                            stamp_ns=rt.now_ns())
                        stats["est_odom_published"] += 1
                elif odom_raw is not None:
                    # fake-estimator path: ground-truth odometry over the
                    # wire (the Gazebo-truth feed of the reference,
                    # include/state_estimator_fake.h:44-85)
                    from mpc_limx_control_tpu.utils import rotations as rotu
                    quat = jnp.asarray(odom_raw["quat"])
                    self._last_odom = OdomState(
                        pos=jnp.asarray(odom_raw["pos"]),
                        ori=rotu.quat_to_rpy(quat),
                        quat=quat,
                        v_pos=jnp.asarray(odom_raw["v_pos"]),
                        v_ori=jnp.asarray(odom_raw["v_ori"]))
                    odom = self._last_odom
                elif getattr(self, "_last_odom", None) is not None:
                    odom = self._last_odom
                else:
                    # no truth source yet — nominal standing pose
                    # (dtype-pinned: a weak f64 here poisons the f32 warm
                    # ADMM carry when x64 is enabled)
                    odom = OdomState.zeros(()).replace(
                        pos=jnp.asarray([0.0, 0.0, self.cfg.base_height],
                                        jnp.float32))
                it_arr = jnp.asarray(float(it), jnp.float32)
                solve_now = (not warm) or (it % mpc_every == 0) \
                    or (self._held_grf is None)
                if self.ref_anchor is not None and it == 0:
                    # seed the anchor at the first known base pose
                    self.ref_anchor = jnp.concatenate(
                        [odom.pos[..., :2], odom.ori[..., 2:3]], -1)
                anc = (self.ref_anchor if self.ref_anchor is not None
                       else jnp.zeros((3,), jnp.float32))
                if async_dispatch:
                    # harvest the newest COMPLETED solve (host-side poll
                    # only; execution order is already device-side exact)
                    ready = None
                    for i in range(len(pending) - 1, -1, -1):
                        if pending[i][1].is_ready():
                            ready = i
                            break
                    if ready is not None:
                        held_it, grf_r, *_ = pending[ready]
                        self._held_grf = grf_r
                        del pending[:ready + 1]
                        stats["solves_adopted"] += 1
                    if it % mpc_every == 0 or self._held_grf is None:
                        _, z, lam, grf, _ = self._tick_warm(
                            odom, joints, it_arr,
                            self.qp_state[0], self.qp_state[1], anc)
                        self.qp_state = (z, lam)   # device-future chain
                        pending.append((it, grf))
                        stats["solves_dispatched"] += 1
                        if self._held_grf is None:
                            # cold start: block once for the first force
                            held_it = it
                            self._held_grf = jax.block_until_ready(grf)
                            pending.clear()
                            stats["solves_adopted"] += 1
                    solve_now = False
                    packed, anc_n = self._tick_hold(
                        odom, joints, it_arr, self._held_grf, anc)
                    staleness.append(it - held_it)
                elif warm and solve_now:
                    packed, z, lam, grf, anc_n = self._tick_warm(
                        odom, joints, it_arr,
                        self.qp_state[0], self.qp_state[1], anc)
                    self.qp_state = (z, lam)
                    self._held_grf = grf
                elif warm:
                    packed, anc_n = self._tick_hold(
                        odom, joints, it_arr, self._held_grf, anc)
                else:
                    packed = self._tick(odom, joints, it_arr)
                    anc_n = None
                if self.ref_anchor is not None and anc_n is not None:
                    self.ref_anchor = anc_n
                p = np.asarray(packed)      # ONE device->host transfer
                self.link.send_cmd(
                    q=p[0:6], dq=p[6:12], tau=p[12:18], kp=p[18:24],
                    kd=p[24:30])
                (lat_solve if solve_now else lat_hold).append(
                    _time.perf_counter() - t_tick0)
                stats["mpc_solves" if solve_now else "mpc_holds"] += 1
                stats["sent"] += 1
                it += 1
                stats["missed_deadlines"] += rate.sleep()
        lat_all = sorted(lat_solve + lat_hold)
        if lat_all:
            def pct(xs, p):
                return float(xs[min(len(xs) - 1, int(p * len(xs)))])
            stats["tick_latency_p50"] = pct(lat_all, 0.50)
            stats["tick_latency_p95"] = pct(lat_all, 0.95)
            stats["tick_latency_p99"] = pct(lat_all, 0.99)
            stats["tick_latency_max"] = float(lat_all[-1])
            stats["ticks_over_1ms"] = int(
                sum(1 for x in lat_all if x > 1.0 / hz))
            if lat_solve:
                ls = sorted(lat_solve)
                stats["solve_latency_p50"] = pct(ls, 0.50)
                stats["solves_over_5ms"] = int(
                    sum(1 for x in ls if x > 0.005))
            if lat_hold:
                stats["hold_latency_p50"] = pct(sorted(lat_hold), 0.50)
        if staleness:
            ss = sorted(staleness)
            stats["grf_staleness_p50"] = float(ss[len(ss) // 2])
            stats["grf_staleness_p95"] = float(
                ss[min(len(ss) - 1, int(0.95 * len(ss)))])
            stats["grf_staleness_max"] = float(ss[-1])
        return stats
