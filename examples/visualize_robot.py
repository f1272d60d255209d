"""Stick-figure visualization of the TRON1 kinematic chain.

The analogue of the reference's scripts/visualize_urdf.py (pinocchio +
meshcat viewer of the URDF at a random q): renders the base box and both
leg chains from the analytic FK at a given or random joint configuration,
to a PNG.

Usage: python examples/visualize_robot.py [--q q0,...,q5] [--out robot.png]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")   # pure visualization

import jax.numpy as jnp
import numpy as np

from mpc_limx_control_tpu.core.config import LegOffsets
from mpc_limx_control_tpu.models.kinematics import _rx, _ry, leg_geometry


def chain_points(offsets: LegOffsets, q3, side):
    """Joint positions along one leg: base->abad->hip->knee->contact."""
    g = leg_geometry(offsets, side, jnp.float64)
    q3 = jnp.asarray(q3, jnp.float64)
    r0 = _rx(q3[0])
    r01 = r0 @ _ry(q3[1])
    r012 = r01 @ _ry(q3[2])
    p_abad = g.abad
    p_hip = p_abad + r0 @ g.hip
    p_knee = p_hip + r01 @ g.knee
    p_contact = p_knee + r012 @ g.foot
    return np.array([np.zeros(3), np.asarray(p_abad), np.asarray(p_hip),
                     np.asarray(p_knee), np.asarray(p_contact)])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--q", type=str, default=None,
                    help="six comma-separated joint angles (rad)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=str(
        Path(__file__).resolve().parent.parent / "chiprun_out"
        / "robot.png"))
    args = ap.parse_args()

    if args.q:
        q = np.asarray([float(v) for v in args.q.split(",")])
        assert q.shape == (6,)
    else:
        rng = np.random.default_rng(args.seed)
        q = rng.uniform(-0.6, 0.6, 6)
    print("q =", np.round(q, 3))

    off = LegOffsets()
    left = chain_points(off, q[:3], "left")
    right = chain_points(off, q[3:], "right")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    for pts, color, name in ((left, "tab:blue", "left"),
                             (right, "tab:red", "right")):
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], "-o", color=color,
                label=f"{name} leg")
        ax.scatter(*pts[-1], color=color, s=60, marker="v")
    # base box
    ax.scatter(0, 0, 0, color="k", s=120, marker="s", label="base")
    ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
    ax.set_title("TRON1 point-foot FK (analytic chain)")
    ax.legend()
    lim = 0.9
    ax.set_xlim(-lim / 2, lim / 2)
    ax.set_ylim(-lim / 2, lim / 2)
    ax.set_zlim(-lim, 0.1)
    fig.tight_layout()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(args.out, dpi=120)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
