"""Profiling and observability utilities.

The reference's only tracing is chrono microsecond prints inside the IK
loop (include/pinocchio_kinematics.h:94-100); its only metrics are cout
status lines (SURVEY.md §5).  Here:

* :class:`Timer` — wall-clock scope timer with forced device sync (fetches
  a scalar).
* :func:`measure_throughput` — solves/s + latency percentiles for any
  jitted step function.
* :class:`MetricsLogger` — structured per-step metrics to JSONL (tracking
  error, QP residuals, GRFs...), the replacement for the reference's ROS
  odom topics and stdout lines.
* :func:`trace` — context manager around jax.profiler for TensorBoard
  traces of the compiled pipeline.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np


def _sync(tree) -> None:
    """Force real completion: fetch one scalar element to host."""
    leaves = jax.tree.leaves(tree)
    if leaves:
        np.asarray(jnp.ravel(leaves[0])[0])


class Timer:
    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0


def measure_throughput(step_fn: Callable, args: tuple, batch: int,
                       iters: int = 10, warmup: int = 1) -> dict:
    """Time `iters` calls of step_fn(*args) with device sync per call.

    Returns dict with solves/s (batch*iters/total), per-call latency
    stats (p50/p90/max), all in seconds.
    """
    for _ in range(warmup):
        _sync(step_fn(*args))
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(step_fn(*args))
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)
    total = float(lat.sum())
    return {
        "solves_per_s": batch * iters / total,
        "p50_s": float(np.percentile(lat, 50)),
        "p90_s": float(np.percentile(lat, 90)),
        "max_s": float(lat.max()),
        "total_s": total,
    }


class MetricsLogger:
    """Append structured per-step metrics as JSON lines."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step)}
        for k, v in metrics.items():
            if hasattr(v, "tolist"):
                v = np.asarray(v)
                rec[k] = v.tolist() if v.ndim else float(v)
            else:
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace scope writing to `log_dir` (view with
    TensorBoard or Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
