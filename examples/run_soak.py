"""Long-run endurance soak with checkpoint/resume.

Drives control/rollout.py::soak_rollout in host-side chunks, saving the
full batched PlantState (orbax when available, .npz fallback —
utils/checkpoint.py) after every chunk and appending per-window stats to
a JSONL, so a minute-scale (or hour-scale) soak survives preemption: kill
it at any point and rerun with --resume to continue from the last
checkpoint instead of tick 0.  The reference has no analogue (a Gazebo
session lost is a session rerun); on a batched soak the state worth
keeping is a few hundred KB.

Usage:
    python examples/run_soak.py --batch 64 --windows 60 --window 1000 \
        [--estimator truth|kf] [--checkpoint-every 10] [--resume] \
        [--out chiprun_out/soak]
"""

import argparse
import dataclasses
import json
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
from mpc_limx_control_tpu.utils import checkpoint as ckpt

GAIT_CYCLE = 600  # walking(): 0.3 s swing + 0.3 s stance at 1 kHz


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--windows", type=int, default=60)
    ap.add_argument("--window", type=int, default=1000)
    ap.add_argument("--checkpoint-every", type=int, default=10,
                    help="windows per checkpoint chunk")
    ap.add_argument("--estimator", choices=("truth", "kf"),
                    default="truth")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", type=str, default=str(
        Path(__file__).resolve().parent.parent / "chiprun_out" / "soak"))
    args = ap.parse_args()

    cfg = ControllerConfig.walking()
    if args.estimator == "kf":
        cfg = dataclasses.replace(cfg, estimator_mode="kf")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ck_path = out / f"state_{args.estimator}"
    stats_path = out / f"stats_{args.estimator}.jsonl"

    B = args.batch
    s0 = ro.initial_plant_state(cfg, batch=(B,))
    s0 = s0.replace(xi=s0.xi.at[:, 9].add(
        0.05 * jax.random.normal(jax.random.PRNGKey(7), (B,),
                                 jnp.float32)))
    it0 = jnp.asarray((np.arange(B) * GAIT_CYCLE) // B, jnp.float32)
    chunk0 = 0

    like = {"state": s0, "it0": it0, "chunk": jnp.zeros((), jnp.int32)}
    if args.resume and (ck_path.exists()
                        or ck_path.with_suffix(".npz").exists()):
        tree = ckpt.restore(ck_path, like)
        s0, it0 = tree["state"], tree["it0"]
        chunk0 = int(tree["chunk"])
        print(f"resumed from chunk {chunk0} "
              f"(tick {chunk0 * args.checkpoint_every * args.window})")
    elif not args.resume and stats_path.exists():
        stats_path.unlink()

    per = args.checkpoint_every
    n_chunks = (args.windows + per - 1) // per
    roll = jax.jit(lambda s, it: ro.soak_rollout(
        cfg, s, per, args.window, start_iteration=it))

    s, it = s0, it0
    for c in range(chunk0, n_chunks):
        s, stats = roll(s, it)
        stats = {k: np.asarray(v) for k, v in stats.items()}
        it = it + per * args.window
        with open(stats_path, "a") as fh:
            for w in range(per):
                row = {"window": c * per + w}
                row.update({k: float(v[w]) for k, v in stats.items()})
                fh.write(json.dumps(row) + "\n")
        ckpt.save(ck_path, {"state": s, "it0": it,
                            "chunk": jnp.asarray(c + 1, jnp.int32)})
        print(f"chunk {c + 1}/{n_chunks} "
              f"(tick {(c + 1) * per * args.window}): "
              f"h_mean {stats['height_mean'][-1]:.4f} "
              f"vx {stats['vx_mean'][-1]:.4f} -> checkpointed")

    # stationarity summary over everything recorded (incl. pre-resume)
    rows = [json.loads(ln) for ln in open(stats_path)]
    stats_all = {k: np.asarray([r[k] for r in rows])
                 for k in rows[0] if k != "window"}
    stats_all["nonfinite_ticks"] = stats_all["nonfinite_ticks"].astype(
        np.int64)
    summ = ro.soak_stationary(stats_all)
    print(json.dumps(summ, indent=1))


if __name__ == "__main__":
    main()
