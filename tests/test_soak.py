"""Endurance-soak harness tests (control/rollout.py::soak_rollout).

The long on-card soak is examples/run_soak.py; here we verify the
windowed-reduction harness itself on CPU:

  * soak_rollout is exactly batched_rollout run window-by-window — same
    final state, and its per-window stats match reductions of the
    per-tick metrics;
  * (RUN_SLOW) a 10k-tick CPU soak is stationary by the stationarity
    gates (drift slope, tail spread, covariance bound).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_limx_control_tpu.core.config import ControllerConfig
from mpc_limx_control_tpu.control import rollout as ro

RUN_SLOW = os.environ.get("RUN_SLOW", "") == "1"


def _stagger(B, cycle=600):
    return jnp.asarray((np.arange(B) * cycle) // B, jnp.float32)


def test_soak_matches_batched_rollout():
    cfg = ControllerConfig.walking()
    B, W, NW = 4, 150, 2
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    it0 = _stagger(B)

    f_soak, soak_stats = jax.jit(
        lambda s: ro.soak_rollout(cfg, s, NW, W, start_iteration=it0))(s0)
    f_ref, m = jax.jit(
        lambda s: ro.batched_rollout(cfg, s, NW * W,
                                     start_iteration=it0))(s0)

    # identical trajectory: same final plant state
    for a, b in zip(jax.tree.leaves(f_soak), jax.tree.leaves(f_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-5)

    # per-window stats == reductions of the per-tick metrics
    h = np.asarray(m["height"])          # [B, T]
    vx = np.asarray(m["velocity"])[..., 0]
    for w in range(NW):
        sl = slice(w * W, (w + 1) * W)
        np.testing.assert_allclose(soak_stats["height_mean"][w],
                                   h[:, sl].mean(), atol=1e-5)
        np.testing.assert_allclose(soak_stats["height_min"][w],
                                   h[:, sl].min(), atol=1e-5)
        np.testing.assert_allclose(soak_stats["vx_mean"][w],
                                   vx[:, sl].mean(), atol=1e-5)
    assert int(np.asarray(soak_stats["nonfinite_ticks"]).sum()) == 0


def test_soak_stationary_summary_fields():
    stats = {
        "height_mean": np.full(10, 0.65),
        "height_min": np.full(10, 0.64),
        "height_max": np.full(10, 0.66),
        "vx_mean": np.full(10, 0.5),
        "vy_mean": np.zeros(10),
        "qp_res_max": np.zeros(10),
        "est_err_max": np.zeros(10),
        "nonfinite_ticks": np.zeros(10, np.int32),
    }
    s = ro.soak_stationary(stats)
    assert s["height_mean_drift_per_window"] == pytest.approx(0.0)
    assert s["height_mean_tail_mean"] == pytest.approx(0.65)
    assert s["nonfinite_ticks"] == 0
    # an injected linear drift is detected at the right magnitude
    stats["height_mean"] = 0.65 + 1e-3 * np.arange(10)
    s2 = ro.soak_stationary(stats)
    assert s2["height_mean_drift_per_window"] == pytest.approx(1e-3,
                                                               rel=1e-6)


@pytest.mark.skipif(not RUN_SLOW, reason="slow; set RUN_SLOW=1")
@pytest.mark.parametrize("mode", ["truth", "kf"])
def test_soak_stationary_10k_cpu(mode):
    """10k-tick CPU soak under the stationarity gates (scaled)."""
    import dataclasses
    cfg = ControllerConfig.walking()
    if mode == "kf":
        cfg = dataclasses.replace(cfg, estimator_mode="kf")
    B, W, NW = 8, 500, 20
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    key = jax.random.PRNGKey(7)
    s0 = s0.replace(xi=s0.xi.at[:, 9].add(
        0.05 * jax.random.normal(key, (B,), jnp.float32)))
    _, stats = jax.jit(
        lambda s: ro.soak_rollout(cfg, s, NW, W,
                                  start_iteration=_stagger(B)))(s0)
    stats = {k: np.asarray(v) for k, v in stats.items()}
    s = ro.soak_stationary(stats)
    assert s["nonfinite_ticks"] == 0
    assert s["height_min"] > 0.6
    assert abs(s["height_mean_tail_mean"] - 0.65) < 0.02
    assert abs(s["height_mean_drift_per_window"]) < 2e-4
    assert abs(s["vx_mean_tail_mean"] - 0.5) < 0.05
    if mode == "kf":
        assert np.isfinite(s["kf_cov_pos_max"])
        # 10k ticks is short enough that the tail still carries some of
        # the initial-covariance decay (measured 2.8e-6/window here vs
        # 2.2e-7 over the 60k chip soak's tail) — the band is for
        # divergence, not the settling transient
        assert abs(s["kf_cov_pos_mean_drift_per_window"]) < 1e-5


def test_soak_dtmpc_schedule_matches_batched_rollout():
    """soak_rollout(mpc_every=5) is batched_rollout on the dtMPC hold
    schedule, window by window."""
    cfg = ControllerConfig.walking()
    B, W, NW = 2, 100, 2
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    it0 = _stagger(B)
    f_soak, stats = jax.jit(lambda s: ro.soak_rollout(
        cfg, s, NW, W, start_iteration=it0, mpc_every=5))(s0)
    f_ref, m = jax.jit(lambda s: ro.batched_rollout(
        cfg, s, NW * W, start_iteration=it0, mpc_every=5))(s0)
    for a, b in zip(jax.tree.leaves(f_soak), jax.tree.leaves(f_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-5)
    h = np.asarray(m["height"])
    np.testing.assert_allclose(stats["height_mean"][0],
                               h[:, :W].mean(), atol=1e-5)
