"""Batched TRON1 walking/standing demo (BASELINE configs 2-4).

Runs B perturbed scenarios closed-loop on the available device, logs
structured per-step metrics, and writes a trajectory plot.

Usage:
    python examples/run_walking.py [--batch 256] [--steps 2000]
        [--velocity 0.5] [--mode walk|stand] [--estimator truth|kf]
        [--out chiprun_out/walk]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from mpc_limx_control_tpu.utils import compile_cache

compile_cache.enable()

from mpc_limx_control_tpu.core.config import ControllerConfig
from mpc_limx_control_tpu.control import rollout as ro
from mpc_limx_control_tpu.utils.profiling import MetricsLogger, Timer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--velocity", type=float, default=0.5)
    ap.add_argument("--mode", choices=("walk", "stand"), default="walk")
    ap.add_argument("--estimator", choices=("truth", "kf"),
                    default="truth")
    ap.add_argument("--out", type=str, default=str(
        Path(__file__).resolve().parent.parent / "chiprun_out" / "walk"))
    args = ap.parse_args()

    import dataclasses
    if args.mode == "stand":
        cfg = ControllerConfig.standing()
    else:
        cfg = ControllerConfig.walking(velocity=(args.velocity, 0.0, 0.0))
    if args.estimator == "kf":
        cfg = dataclasses.replace(cfg, estimator_mode="kf")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    s0 = ro.initial_plant_state(cfg, batch=(args.batch,))
    key = jax.random.PRNGKey(0)
    s0 = s0.replace(xi=s0.xi.at[:, 9:12].add(
        0.05 * jax.random.normal(key, (args.batch, 3), jnp.float32)))

    roll = jax.jit(lambda s: ro.batched_rollout(cfg, s, args.steps))
    with Timer() as tc:
        np.asarray(roll(s0)[0].xi[0, 0])              # compile warm-up
    print(f"(compile: {tc.elapsed:.1f}s)")
    with Timer() as t:
        final, metrics = roll(s0)
        np.asarray(final.xi[0, 0])                    # device sync
    sim_rate = args.batch * args.steps / t.elapsed
    print(f"simulated {args.batch} x {args.steps} ticks in {t.elapsed:.1f}s "
          f"({sim_rate:,.0f} ticks/s)")
    metrics = jax.tree.map(np.asarray, metrics)

    h = metrics["height"]            # [B, T]
    v = metrics["velocity"]          # [B, T, 3]
    with MetricsLogger(out / "metrics.jsonl") as log:
        for k in range(0, args.steps, 50):
            log.log(k,
                    mean_height=h[:, k].mean(),
                    mean_vx=v[:, k, 0].mean(),
                    max_qp_residual=metrics["qp_residual"][:, k].max())

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        t_ms = np.arange(args.steps)
        fig, axes = plt.subplots(3, 1, figsize=(9, 8), sharex=True)
        for b in range(min(8, args.batch)):
            axes[0].plot(t_ms, h[b], lw=0.7)
            axes[1].plot(t_ms, v[b, :, 0], lw=0.7)
            axes[2].plot(t_ms, v[b, :, 1], lw=0.7)
        axes[0].set_ylabel("height [m]")
        axes[0].axhline(cfg.base_height, ls="--", c="k", lw=0.5)
        axes[1].set_ylabel("vx [m/s]")
        axes[1].axhline(cfg.desired_velocity[0], ls="--", c="k", lw=0.5)
        axes[2].set_ylabel("vy [m/s]")
        axes[2].set_xlabel("tick (1 kHz)")
        fig.tight_layout()
        fig.savefig(out / "walking.png", dpi=120)
        print(f"wrote {out / 'walking.png'}")
    except Exception as e:                       # matplotlib optional
        print(f"(no plot: {e})")

    print("final mean height:", float(h[:, -200:].mean()),
          " mean vx:", float(v[:, -200:, 0].mean()))


if __name__ == "__main__":
    main()
