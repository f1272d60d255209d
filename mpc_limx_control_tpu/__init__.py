"""mpc_limx_control_tpu — a batched MPC engine for the limX TRON1 point-foot
biped, written in JAX and run on an NVIDIA GPU.

A from-scratch re-design (JAX / XLA / Pallas / sharding) of the capability set of
the C++/ROS reference `Fleming-Sung/mpc-limX-control`:

  * generic condensed linear-MPC pipeline (reference: src/QPSolver.cpp)
  * SRBD stance-force MPC for TRON1 (reference: include/mpcQP.h, corrected)
  * gait schedule / foot placement / swing trajectory
    (reference: include/MPCController.h)
  * analytic + iterative leg kinematics (reference: include/pinocchio_kinematics.h)
  * batched Kalman-filter state estimation (reference: include/stateEstimator.h)
  * scripted "fake" state source (reference: include/state_estimator_fake.h)
  * closed-loop rollout harness (reference: src/qpSolver_test.cpp,
    src/linear_mpc_example.cpp)
  * scenario-batched execution sharded over a device mesh.

Everything in the compute path is pure-functional, jit-compiled, and vmappable
over a scenario batch axis; multi-chip scaling uses `jax.sharding` over a
`('data',)` mesh.
"""

__version__ = "0.1.0"

from mpc_limx_control_tpu.core import config, types  # noqa: F401
