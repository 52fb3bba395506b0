"""The port's samplers against vexpress_tpu's on the CPU: DPM-Solver++ (2M)
tables, `build_step` and `step` over a 12-step grid, and stochastic DDIM
(eta > 0) with JAX's noise draw replayed, all at 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vexpress_tpu.diffusion.ddim import DDIMScheduler as JDDIM
from vexpress_tpu.diffusion.dpm_solver import DPMSolverMultistepScheduler as JDPM
from vexpress_tpu.diffusion.dpm_solver import DpmState as JState
from vexpress_torch.diffusion import DDIMScheduler as TDDIM
from vexpress_torch.diffusion import DPMSolverMultistepScheduler as TDPM
from vexpress_torch.diffusion import DpmState as TState

from .torch_port_utils import rand, t

STEPS = 12
SHAPE = (3, 8, 8, 4)


def _outputs(n):
    return [rand(SHAPE, 100 + i) for i in range(n)]


@pytest.mark.parametrize("pred", ["v_prediction", "epsilon"])
def test_dpm_tables_match_jax(pred):
    js, ts_ = JDPM(prediction_type=pred), TDPM(prediction_type=pred)
    grid = js.timesteps(STEPS)
    np.testing.assert_array_equal(ts_.timesteps(STEPS), grid)
    for tt in grid:
        got = ts_._alpha_sigma_lambda(int(tt))
        ref = js._alpha_sigma_lambda(jnp.asarray(int(tt)))
        np.testing.assert_allclose(np.array(got, np.float32), np.array(ref, np.float32),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pred", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("idx0", [0, 5])  # 5: the grid trimmed by strength < 1
def test_dpm_build_step_matches_jax(pred, idx0):
    js, ts_ = JDPM(prediction_type=pred), TDPM(prediction_type=pred)
    jfn, tfn = jax.jit(js.build_step(STEPS)), ts_.build_step(STEPS)
    x = rand(SHAPE, 1)
    jx, jprev, jhas = jnp.asarray(x), jnp.zeros(SHAPE), jnp.zeros((), bool)
    tx, tprev, thas = t(x), torch.zeros(SHAPE), False
    for i, out in enumerate(_outputs(STEPS - idx0)):
        jx, jprev, jhas = jfn(jnp.asarray(out), jnp.asarray(idx0 + i), jx, jprev, jhas)
        tx, tprev, thas = tfn(t(out), idx0 + i, tx, tprev, thas)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), rtol=1e-6, atol=1e-6)


def test_dpm_step_matches_jax():
    js, ts_ = JDPM(), TDPM()
    grid = js.timesteps(STEPS)
    x = rand(SHAPE, 2)
    jx, jstate = jnp.asarray(x), js.init_state(jnp.asarray(x))
    tx, tstate = t(x), ts_.init_state(t(x))
    for i, out in enumerate(_outputs(STEPS)):
        jx, jstate = js.step(jnp.asarray(out), i, grid, jx, jstate)
        tx, tstate = ts_.step(t(out), i, grid, tx, tstate)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {i}")
    assert isinstance(jstate, JState) and isinstance(tstate, TState) and tstate.has_prev


@pytest.mark.parametrize("step_index", [0, 11, 24])
def test_ddim_eta_step_replays_jax_noise(step_index):
    js, ts_ = JDDIM(), TDDIM()
    n, eta = 25, 0.5
    timestep = int(js.timesteps(n)[step_index])
    out, sample = rand(SHAPE, 3), rand(SHAPE, 4)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))  # the draw step() makes
    ref = np.asarray(js.step(jnp.asarray(out), timestep, jnp.asarray(sample), n, eta=eta,
                             noise_key=key))
    got = ts_.step(t(out), timestep, t(sample), n, eta=eta, noise=t(noise)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="noise"):
        ts_.step(t(out), timestep, t(sample), n, eta=eta)
