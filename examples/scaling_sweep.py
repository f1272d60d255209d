"""Scaling sweep: batched MPC throughput vs device count (BASELINE
config 5 shape).

On a multi-chip host this sweeps real meshes of 1..N chips; on a
single-chip or CPU host, set XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu to exercise the sharded code path on virtual devices
(the collective structure is identical; absolute numbers are CPU-bound).

Usage: python examples/scaling_sweep.py [--batch-per-device 512] [--iters 5]
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from mpc_limx_control_tpu.core.config import ControllerConfig
from mpc_limx_control_tpu.control import rollout as ro
from mpc_limx_control_tpu.parallel import mesh as pmesh


def bench_mesh(cfg, devices, batch_per_device, iters):
    mesh = pmesh.make_mesh(devices)
    B = batch_per_device * len(devices)
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    key = jax.random.PRNGKey(0)
    s0 = s0.replace(xi=s0.xi.at[:, 9].add(
        0.05 * jax.random.normal(key, (B,), jnp.float32)))
    s0 = pmesh.shard_leading(s0, mesh)
    step = pmesh.sharded_batch_step(cfg, mesh)

    st, stats = step(s0, jnp.asarray(0.0, jnp.float32))
    np.asarray(st.xi[0])        # sync

    t0 = time.perf_counter()
    for k in range(iters):
        st, stats = step(st, jnp.asarray(float(k), jnp.float32))
    np.asarray(st.xi[0])
    dt = time.perf_counter() - t0
    return {
        "devices": len(devices),
        "batch": B,
        "solves_per_s": B * iters / dt,
        "step_ms": dt / iters * 1e3,
        "mean_height": float(stats["mean_height"]),
    }


def bench_mesh_rollout(cfg, devices, batch_per_device, steps):
    """Weak-scaling measurement on the deployment shape: a device-resident
    multi-step rollout (pmesh.sharded_rollout) instead of per-step host
    dispatch — on virtual CPU meshes the host dispatch dominates and would
    measure Python, not the sharded program."""
    mesh = pmesh.make_mesh(devices)
    B = batch_per_device * len(devices)
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    key = jax.random.PRNGKey(0)
    s0 = s0.replace(xi=s0.xi.at[:, 9].add(
        0.05 * jax.random.normal(key, (B,), jnp.float32)))
    s0 = pmesh.shard_leading(s0, mesh)
    run = pmesh.sharded_rollout(cfg, mesh, steps)

    final, stats = run(s0, jnp.asarray(0.0, jnp.float32))
    np.asarray(final.xi[0])     # sync

    t0 = time.perf_counter()
    final, stats = run(s0, jnp.asarray(0.0, jnp.float32))
    np.asarray(final.xi[0])
    dt = time.perf_counter() - t0
    return {
        "devices": len(devices),
        "batch": B,
        "steps": steps,
        "solves_per_s": B * steps / dt,
        "step_ms": dt / steps * 1e3,
        "mean_height": float(stats["mean_height"][-1]),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-per-device", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rollout-steps", type=int, default=0,
                    help="if >0, measure the device-resident multi-step "
                         "rollout instead of per-step dispatch")
    ap.add_argument("--out", type=str, default="",
                    help="write the sweep result as a JSON artifact")
    args = ap.parse_args()

    cfg = ControllerConfig.walking()
    devs = jax.devices()
    counts = sorted({1, 2, len(devs) // 2, len(devs)} - {0})
    results = []
    for n in counts:
        if n > len(devs):
            continue
        if args.rollout_steps > 0:
            r = bench_mesh_rollout(cfg, devs[:n], args.batch_per_device,
                                   args.rollout_steps)
        else:
            r = bench_mesh(cfg, devs[:n], args.batch_per_device, args.iters)
        results.append(r)
        print(json.dumps(r))
    effs = {}
    if len(results) > 1:
        base = results[0]["solves_per_s"]
        for r in results[1:]:
            eff = r["solves_per_s"] / (base * r["devices"])
            effs[r["devices"]] = round(eff, 3)
            print(f"devices={r['devices']}: scaling efficiency {eff:.2f}")
    if args.out:
        import platform
        with open(args.out, "w") as fh:
            json.dump({
                "mode": ("rollout" if args.rollout_steps > 0
                         else "per-step"),
                "platform": jax.devices()[0].platform,
                "host": platform.machine(),
                "results": results,
                "weak_scaling_efficiency": effs,
                "note": ("virtual CPU devices share host cores: "
                         "efficiency reflects collective/sharding "
                         "overhead structure, not chip throughput"
                         if jax.devices()[0].platform == "cpu" else ""),
            }, fh, indent=1)


if __name__ == "__main__":
    main()
