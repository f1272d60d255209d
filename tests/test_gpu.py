"""Tests that need the NVIDIA GPU (marker `gpu`): skipped on the CPU by the
`gpu` fixture, run on the card by `python chip_smoke.py`.

The Triton walking-QP kernel compiled for the card must reproduce the XLA
composition (ops/mpc_fused_pallas.py:_xla_solve at "highest" matmul
precision) across horizons and batch sizes, padding included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_limx_control_tpu.ops import mpc_fused_pallas as fused
from test_mpc_fused import _small_cfg, _walking_inputs, _warm

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("N", [8, 20])
@pytest.mark.parametrize("B", [1, 5, 130, 4096])
def test_kernel_on_card_matches_xla(gpu, N, B):
    cfg, Ad, Bd_t, x_ref, xi0 = _walking_inputs(
        B, jax.random.PRNGKey(3), cfg=_small_cfg(N))
    k = fused._QPConsts(cfg.srbd, two_feet=False)
    z_w, y_w = _warm(B, N)
    with jax.default_matmul_precision("highest"):
        sol_r, (z_r, y_r) = jax.jit(
            lambda *a: fused._xla_solve(k, *a))(Ad, Bd_t, x_ref, xi0,
                                                z_w, y_w)
    z, y, res = fused.fused_walking_qp(Ad, Bd_t, x_ref, xi0, z_w, y_w,
                                       **k.kernel_kw())
    scale = float(jnp.max(jnp.abs(z_r))) + 1.0
    np.testing.assert_allclose(np.asarray(z), np.asarray(z_r),
                               atol=1e-3 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_r),
                               atol=1e-3 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(res), np.asarray(sol_r.residual),
                               atol=1e-3, rtol=1e-2)
