"""Native runtime tests: build, UDP loopback, rate loop.

Exercises the C++ pf_runtime library (runtime/pf_runtime.cpp) through its
ctypes binding — the equivalent of the limxsdk UDP session +
mutex-guarded state mailbox (reference src/pf_controller_base.cpp:14-35).
"""

import time

import numpy as np
import pytest

from mpc_limx_control_tpu import runtime as rt


@pytest.fixture(scope="module")
def lib():
    return rt.build_library()


def test_library_builds(lib):
    assert lib.exists()


def test_loopback_roundtrip(lib):
    with rt.RobotHost(state_port=17201, cmd_port=17202) as host, \
            rt.RobotLink("127.0.0.1", state_port=17201,
                         cmd_port=17202) as link:
        q = np.arange(6, dtype=np.float32) * 0.1
        # host -> link (state)
        deadline = time.time() + 2.0
        got = None
        while got is None and time.time() < deadline:
            host.publish_state(q, dq=q * 2, stamp_ns=123)
            time.sleep(0.002)
            got = link.recv_state()
        assert got is not None, "no state received"
        np.testing.assert_allclose(got["q"], q, atol=1e-7)
        np.testing.assert_allclose(got["dq"], q * 2, atol=1e-7)

        imu = link.recv_imu()
        assert imu is not None
        np.testing.assert_allclose(imu["quat"], [0, 0, 0, 1], atol=1e-7)

        # link -> host (command)
        got_cmd = None
        deadline = time.time() + 2.0
        while got_cmd is None and time.time() < deadline:
            link.send_cmd(q=q + 1.0, kp=np.full(6, 60.0),
                          kd=np.full(6, 3.0), stamp_ns=77)
            time.sleep(0.002)
            got_cmd = host.poll_cmd()
        assert got_cmd is not None, "no cmd received"
        np.testing.assert_allclose(got_cmd["q"], q + 1.0, atol=1e-7)
        np.testing.assert_allclose(got_cmd["kp"], 60.0, atol=1e-7)


def test_latest_wins_semantics(lib):
    """Reader sees only the newest sample and stale reads return None —
    the robotstate_on_ flag behavior (src/pf_controller_base.cpp:27,
    src/mpc_control_fake_state.cpp:139)."""
    with rt.RobotHost(state_port=17203, cmd_port=17204) as host, \
            rt.RobotLink("127.0.0.1", state_port=17203,
                         cmd_port=17204) as link:
        for k in range(20):
            host.publish_state(np.full(6, float(k), np.float32))
        deadline = time.time() + 2.0
        got = None
        while time.time() < deadline:
            s = link.recv_state()
            if s is not None:
                got = s
            elif got is not None:
                break
            time.sleep(0.005)
        assert got is not None
        # newest published value wins
        assert got["q"][0] == 19.0
        # and a second read with no new data is stale
        assert link.recv_state() is None


def test_rate_loop_timing(lib):
    with rt.Rate(1000.0) as rate:
        t0 = rt.now_ns()
        missed = 0
        for _ in range(50):
            missed += rate.sleep()
        elapsed_ms = (rt.now_ns() - t0) / 1e6
    # 50 periods at 1 kHz = 50 ms (generous CI bounds)
    assert 40.0 < elapsed_ms < 250.0, elapsed_ms


def test_closed_loop_rate(lib):
    """Mini closed loop: host publishes at 1 kHz, link echoes commands;
    verify sustained round-trip throughput."""
    with rt.RobotHost(state_port=17205, cmd_port=17206) as host, \
            rt.RobotLink("127.0.0.1", state_port=17205,
                         cmd_port=17206) as link, \
            rt.Rate(1000.0) as rate:
        n = 300
        for k in range(n):
            host.publish_state(np.full(6, float(k), np.float32))
            s = link.recv_state()
            if s is not None:
                link.send_cmd(q=s["q"])
            rate.sleep()
        time.sleep(0.05)
        # most messages should arrive (UDP loopback, generous 50% bound)
        assert link.state_count > n * 0.5
        assert host.cmd_count > n * 0.3


def test_diagnostic_channel(lib):
    """Diagnostic packets (robot -> controller): the
    subscribeDiagnosticValue channel (src/pf_controller_base.cpp:36-41)."""
    with rt.RobotHost(state_port=17207, cmd_port=17208) as host, \
            rt.RobotLink("127.0.0.1", state_port=17207,
                         cmd_port=17208) as link:
        deadline = time.time() + 2.0
        got = None
        while got is None and time.time() < deadline:
            host.publish_diag(rt.DIAG_CALIBRATION, code=3, level=2,
                              stamp_ns=9)
            time.sleep(0.002)
            got = link.recv_diag()
        assert got is not None, "no diagnostic received"
        assert got["name"] == rt.DIAG_CALIBRATION
        assert got["code"] == 3
        assert got["level"] == 2
        # stale second read
        assert link.recv_diag() is None


def test_est_odom_stream(lib):
    """Estimator odometry + covariance (controller -> host): the
    stateEstimator 200 Hz odom/pose-with-covariance publication
    (include/stateEstimator.h:404-419)."""
    with rt.RobotHost(state_port=17209, cmd_port=17210) as host, \
            rt.RobotLink("127.0.0.1", state_port=17209,
                         cmd_port=17210) as link:
        cov = np.arange(12, dtype=np.float32) * 0.01
        deadline = time.time() + 2.0
        got = None
        while got is None and time.time() < deadline:
            link.send_est_odom(pos=(1.0, 2.0, 0.65), v_pos=(0.4, 0, 0),
                               cov_diag=cov, stamp_ns=11)
            time.sleep(0.002)
            got = host.poll_est_odom()
        assert got is not None, "no est odom received"
        np.testing.assert_allclose(got["pos"], [1.0, 2.0, 0.65], atol=1e-7)
        np.testing.assert_allclose(got["cov_diag"], cov, atol=1e-7)
