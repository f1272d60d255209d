#!/usr/bin/env python3
"""Smoke test of the TRON1 MPC engine on one NVIDIA GPU.

Drives the main path through the entry points users call, at the shipped
presets' full width (batch 4096; walking nx=13, N=20, nu=3 -> n=60, m=120;
standing nu=6 -> n=120, m=240), and checks every result:

  1 device           the platform is `gpu`; card name and power limit
  2 walking truth    batched_rollout, 3000 ticks, quality-gate bands
  3 walking KF       the same with the contact-gated Kalman filter
  4 standing         the two-foot form (nu = 6)
  5 dtMPC            the reference's re-solve-every-5-ticks schedule
  6 solve precision  the f32 GRF solves (XLA at default and "highest"
                     matmul precision, the walking kernel) against the
                     same iterates in f64 on captured QPs; the kernel's
                     and the XLA composition's tick times
  7 one robot        ControlSession over loopback UDP, tick p50/p99
  8 quality gate     bench.quality_gate() must be ok
  9 card tests       the tests marked `gpu`, in this process

One line per phase; any failure raises and exits nonzero.  The last line
is one JSON object: {"ok": true, "device": {...}}.

Usage:
    python chip_smoke.py           # one card, phases 1-9
    python chip_smoke.py --four    # four cards: sharded_rollout and
                                   # shard_map_rollout vs one card only
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

REPO = Path(__file__).resolve().parent
B_FULL = 4096


def require_gpu(count: int = 1):
    """The first `count` JAX devices, which must be GPUs; no fallback."""
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise RuntimeError(
            f"chip_smoke needs {count} NVIDIA GPU(s); JAX found "
            f"{len(devs)} x {devs[0].platform}")
    return devs[:count]


def card_line() -> str:
    """`name, power.limit` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase(num: int, name: str, msg: str) -> None:
    print(f"phase {num} {name}: {msg}", flush=True)


def _perturbed(cfg, B, seed=0):
    from mpc_limx_control_tpu.control import rollout as ro
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    noise = 0.05 * jax.random.normal(jax.random.PRNGKey(seed), (B,),
                                     jnp.float32)
    idx = 10 if cfg.mode == "stand" else 9       # vy kick / vx spread
    return s0.replace(xi=s0.xi.at[:, idx].add(noise))


def closed_loop(cfg, B, T, window, mpc_every=1):
    """batched_rollout of T ticks, reduced on the device to the gate's
    statistics over the last `window` ticks; returns (stats, compile s,
    run s)."""
    from mpc_limx_control_tpu.control import rollout as ro

    def run(s):
        _, m = ro.batched_rollout(cfg, s, T, mpc_every=mpc_every)
        h, v = m["height"], m["velocity"]
        return {"h_mean": h[:, -window:].mean(),
                "h_min": h.min(),
                "vx_mean": v[:, -window:, 0].mean(),
                "finite": jnp.isfinite(h).all() & jnp.isfinite(v).all()}

    s0 = _perturbed(cfg, B)
    t0 = time.perf_counter()
    compiled = jax.jit(run).lower(s0).compile()
    t1 = time.perf_counter()
    out = jax.device_get(compiled(s0))
    t2 = time.perf_counter()
    return {k: float(v) for k, v in out.items()}, t1 - t0, t2 - t1


def _fmt(st, tc, tr, T):
    return (f"height_mean {st['h_mean']:.4f} height_min {st['h_min']:.4f} "
            f"vx_mean {st['vx_mean']:.4f} finite {bool(st['finite'])} "
            f"(compile {tc:.1f} s, {T} ticks {tr:.2f} s)")


def phase_rollouts(cfg_walk):
    import dataclasses

    from mpc_limx_control_tpu.core.config import ControllerConfig

    st, tc, tr = closed_loop(cfg_walk, B_FULL, 3000, 600)
    phase(2, "walking truth", f"B={B_FULL} " + _fmt(st, tc, tr, 3000))
    assert st["finite"] and abs(st["h_mean"] - 0.65) < 0.02, st
    assert abs(st["vx_mean"] - 0.5) < 0.05, st

    kcfg = dataclasses.replace(cfg_walk, estimator_mode="kf")
    st, tc, tr = closed_loop(kcfg, B_FULL, 3000, 600)
    phase(3, "walking KF", f"B={B_FULL} " + _fmt(st, tc, tr, 3000))
    assert st["finite"] and st["h_min"] > 0.6, st
    assert abs(st["vx_mean"] - 0.5) < 0.05, st

    st, tc, tr = closed_loop(ControllerConfig.standing(), B_FULL, 2000, 500)
    phase(4, "standing", f"B={B_FULL} nu=6 " + _fmt(st, tc, tr, 2000))
    assert st["finite"] and abs(st["h_mean"] - 0.65) < 0.01, st

    st, tc, tr = closed_loop(cfg_walk, B_FULL, 3000, 600, mpc_every=5)
    phase(5, "dtMPC", f"B={B_FULL} mpc_every=5 " + _fmt(st, tc, tr, 3000))
    assert st["finite"] and abs(st["h_mean"] - 0.65) < 0.02, st
    assert abs(st["vx_mean"] - 0.5) < 0.05, st


def time_walking_ticks(cfg, B, ticks=200, turns=5):
    """Median per-tick seconds of walking truth-mode batched_rollout with
    the Triton kernel and with the XLA composition, in alternating turns
    inside this process.  Returns (kernel_s, xla_s)."""
    from unittest import mock

    from mpc_limx_control_tpu.control import rollout as ro
    from mpc_limx_control_tpu.ops import mpc_fused_pallas as fused

    s0 = _perturbed(cfg, B)

    def compiled():             # a fresh function: nothing cached
        return jax.jit(lambda s: ro.batched_rollout(cfg, s, ticks)[0].xi
                       ).lower(s0).compile()

    kern = compiled()
    with mock.patch.object(fused, "use_kernel", lambda nu: False):
        xla = compiled()
    times = {"kernel": [], "xla": []}
    for fn in (kern, xla):
        fn(s0).block_until_ready()
    for _ in range(turns):
        for name, fn in (("kernel", kern), ("xla", xla)):
            t0 = time.perf_counter()
            fn(s0).block_until_ready()
            times[name].append((time.perf_counter() - t0) / ticks)
    return (float(np.median(times["kernel"])),
            float(np.median(times["xla"])))


def _tiled(qs, B):
    """The corpus QPs' uncondensed inputs (f64), tiled to a batch of B."""
    reps = -(-B // len(qs))
    out = []
    for i in range(4):
        a = np.stack([q.inputs[i] for q in qs])
        out.append(np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:B])
    return out


def phase_solves(cfg, card):
    """The batched GRF solves in f32 on the card (XLA composition at the
    default and at "highest" matmul precision, and the walking kernel)
    against the same ADMM iterates in f64, on captured walking and
    standing QPs tiled to B=4096; then the kernel's tick-time trial."""
    import copy

    from mpc_limx_control_tpu.core.config import ControllerConfig
    from mpc_limx_control_tpu.oracle import corpus
    from mpc_limx_control_tpu.ops import mpc_fused_pallas as fused

    with jax.enable_x64(True):          # the corpus QPs are built in f64
        walk = (corpus.capture_corpus(cfg, ticks=60, sample_every=29)
                + corpus.capture_corpus(cfg, ticks=80, sample_every=15,
                                        skip_first=35,
                                        kick=(30, (0.0, 0.4, 0.0))))
        stand = corpus.capture_corpus(ControllerConfig.standing(),
                                      ticks=300, sample_every=100,
                                      skip_first=60)
    # 50 cold ADMM iterations: ten times the production warm budget, so
    # rounding has room to accumulate; f32 budget 1e-3 of the GRF scale
    iters, tol = 50, 1e-3
    for name, qs, nu in (("walking", walk, 3), ("standing", stand, 6)):
        k = copy.copy(fused._QPConsts(cfg.srbd, two_feet=nu == 6))
        k.iters = iters
        n = k.N * nu
        ins = _tiled(qs, B_FULL)

        def xla(dtype, precision=None):
            with jax.enable_x64(dtype == jnp.float64), \
                    jax.default_matmul_precision(precision):
                args = [jnp.asarray(a, dtype) for a in ins]
                args += [jnp.zeros((B_FULL, n), dtype),
                         jnp.zeros((B_FULL, 2 * n), dtype)]
                return np.asarray(jax.jit(
                    lambda *a: fused._xla_solve(k, *a)[0].u)(*args),
                    np.float64)

        z64 = xla(jnp.float64)
        scale = 1.0 + np.abs(z64).max(axis=1)
        errs = {"XLA default": xla(jnp.float32),
                "XLA highest": xla(jnp.float32, "highest")}
        if fused.use_kernel(nu):
            args = [jnp.asarray(a, jnp.float32) for a in ins]
            errs["kernel"] = np.asarray(fused.fused_walking_qp(
                *args, jnp.zeros((B_FULL, n)), jnp.zeros((B_FULL, 2 * n)),
                **k.kernel_kw())[0], np.float64)
        errs = {key: float(np.max(np.abs(z - z64).max(axis=1) / scale))
                for key, z in errs.items()}
        phase(6, "solve precision",
              f"{name} nu={nu} B={B_FULL} N=20, {len(qs)} captured QPs, "
              f"{iters} ADMM iterations in f32 vs f64: "
              + ", ".join(f"{key} {v:.2e}" for key, v in errs.items())
              + f" (tolerance {tol})")
        assert max(errs.values()) < tol, errs
    if fused.use_kernel(3):
        for B in (1024, B_FULL):
            tk, tx = time_walking_ticks(cfg, B)
            phase(6, "walking kernel",
                  f"B={B} walking truth tick, median of 5 alternating "
                  f"turns: kernel {tk * 1e3:.4f} ms, XLA {tx * 1e3:.4f} ms "
                  f"({card})")


def phase_session():
    """One robot over loopback UDP against a simulated wire plant."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_session_walking import WirePlant

    from mpc_limx_control_tpu.control import session as ses
    from mpc_limx_control_tpu.core.config import ControllerConfig

    cfg = ControllerConfig.walking()
    sp, cp = 17650, 17651
    plant = WirePlant(cfg, sp, cp, publish_truth_odom=True)
    try:
        with ses.ControlSession(cfg, host_ip="127.0.0.1", state_port=sp,
                                cmd_port=cp) as session:
            session.run(iterations=50, hz=1000.0)        # compile + settle
            stats = session.run(iterations=500, hz=1000.0)
        xi = np.asarray(plant.xi)
    finally:
        plant.close()
    phase(7, "one robot",
          f"ControlSession 500 ticks over UDP: tick p50 "
          f"{stats['tick_latency_p50'] * 1e3:.3f} ms, p99 "
          f"{stats['tick_latency_p99'] * 1e3:.3f} ms, height {xi[5]:.4f}, "
          f"x {xi[3]:.3f}")
    assert stats["sent"] == 500 and 0.6 < xi[5] < 0.7, (stats, xi)


def phase_quality():
    sys.path.insert(0, str(REPO))
    import bench

    q = bench.quality_gate()
    phase(8, "quality gate", json.dumps(q))
    assert q["ok"], q


def phase_card_tests():
    import pytest

    os.environ["MPC_TESTS_ON_CARD"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests" / "test_gpu.py")])
    phase(9, "card tests", f"pytest -m gpu exit code {int(rc)}")
    assert rc == 0, rc


def run_four():
    """sharded_rollout and shard_map_rollout on a 4-card ('data',) mesh
    against the one-card batched_rollout at B = 4 x 4096, 200 ticks."""
    from mpc_limx_control_tpu.control import rollout as ro
    from mpc_limx_control_tpu.core.config import ControllerConfig
    from mpc_limx_control_tpu.parallel import mesh as pmesh

    devs = require_gpu(4)
    print(card_line(), flush=True)
    print(f"jax {jax.__version__}", flush=True)
    cfg = ControllerConfig.walking()
    B, T, atol = 4 * B_FULL, 200, 1e-3
    s0 = jax.device_put(_perturbed(cfg, B), devs[0])
    t0 = time.perf_counter()
    ref, m = jax.jit(lambda s: ro.batched_rollout(cfg, s, T))(s0)
    ref_xi = np.asarray(ref.xi)
    ref_h = np.asarray(m["height"]).mean(axis=0)
    t_one = time.perf_counter() - t0
    mesh = pmesh.make_mesh(devs)
    start = jnp.asarray(0.0, jnp.float32)
    for name, make in (("sharded_rollout", pmesh.sharded_rollout),
                       ("shard_map_rollout", pmesh.shard_map_rollout)):
        t0 = time.perf_counter()
        final, stats = make(cfg, mesh, T)(pmesh.shard_leading(s0, mesh),
                                          start)
        xi = np.asarray(final.xi)
        d = float(np.abs(xi - ref_xi).max())
        dh = float(np.abs(np.asarray(stats["mean_height"]) - ref_h).max())
        wall = time.perf_counter() - t0
        print(f"four {name}: B={B} {T} ticks on 4 cards vs one card: "
              f"max |dxi| {d:.3e}, max |d mean height| {dh:.3e} "
              f"(atol {atol}); wall incl. compile {wall:.1f} s vs one "
              f"card {t_one:.1f} s", flush=True)
        assert np.isfinite(xi).all() and d < atol and dh < atol, (d, dh)
    return devs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="only the four-card sharded rollouts vs one card")
    args = ap.parse_args()

    from mpc_limx_control_tpu.utils import compile_cache
    compile_cache.enable()

    if args.four:
        devs = run_four()
    else:
        from mpc_limx_control_tpu.core.config import ControllerConfig

        devs = require_gpu(1)
        card = card_line()
        print(card, flush=True)
        phase(1, "device", f"{devs[0].platform} {devs[0].device_kind}; "
                           f"card {card}; jax {jax.__version__}")
        cfg = ControllerConfig.walking()
        t0 = time.perf_counter()
        phase_rollouts(cfg)
        phase_solves(cfg, card)
        phase_session()
        phase_quality()
        phase_card_tests()
        print(f"all phases {time.perf_counter() - t0:.1f} s", flush=True)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))


if __name__ == "__main__":
    main()
