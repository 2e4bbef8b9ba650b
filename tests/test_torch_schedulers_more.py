"""The port's PNDM (PLMS), LMS, Euler and Euler-ancestral schedulers against
the JAX schedulers (tables and single steps within 1e-6, chains of steps in
rel-L2 within 1e-6) and against the independent numpy steppers of
tests/test_scheduler_golden.py (at that file's own tolerance, which holds
the f32 JAX schedulers to the float64 steppers). Both packages compute in
f32 from the same f32-rounded tables; the port integrates the LMS
coefficients with scipy's quad, the JAX package with a 2049-point
trapezoid, whose error reaches ~1e-6 of a coefficient at 50 steps: the
coefficient tables are held to JAX's at 3e-6 relative and to scipy's
float64 integrals at f32 rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_scheduler_golden as golden
from e4t_diffusion_tpu.diffusion import schedulers as jax_sched

from e4t_diffusion_torch.diffusion import schedulers as sched

from torch_parity import rel_l2

TOL = 1e-6
# the JAX package's trapezoid LMS coefficients against quad's (measured
# 2.0e-6 relative at 50 steps)
LMS_COEFF_RTOL = 3e-6
# tiny f32 pipeline trajectories, port against JAX
TRAJECTORY_REL_L2 = 1e-4
NEW = ["plms", "lms", "euler", "euler_ancestral"]
CONFIGS = {
    "sd_v1": {},
    "v_pred_alpha_one": dict(prediction_type="v_prediction",
                             set_alpha_to_one=True),
}


def _pair(name, cfg_kwargs):
    return (jax_sched.SCHEDULER_MAPPING[name](
                jax_sched.NoiseScheduleConfig(**cfg_kwargs)),
            sched.SCHEDULER_MAPPING[name](
                sched.NoiseScheduleConfig(**cfg_kwargs)))


def test_mapping_has_the_six_schedulers():
    assert sorted(sched.SCHEDULER_MAPPING) == sorted(
        jax_sched.SCHEDULER_MAPPING)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("steps", [3, 20, 50])
def test_tables_match(name, steps):
    js, ts = _pair(name, {})
    jstate, tstate = js.init(steps), ts.init(steps)
    for key, jv in jstate.items():
        if jv is None:
            continue
        tv = tstate[key]
        tv = tv.numpy() if isinstance(tv, torch.Tensor) else np.asarray(tv)
        rtol = LMS_COEFF_RTOL if key == "lms_coeffs" else 0
        np.testing.assert_allclose(tv, np.asarray(jv), rtol=rtol, atol=TOL,
                                   err_msg=key)
    if name == "lms":  # scipy's quad in float64, rounded to f32
        _, sigmas = sched._sigma_grid(sched.NoiseScheduleConfig(), steps)
        want = [[golden._lms_coeff(min(t + 1, 4), t, j, sigmas)
                 if j <= t else 0.0 for j in range(4)] for t in range(steps)]
        np.testing.assert_array_equal(tstate["lms_coeffs"].numpy(),
                                      np.asarray(want, np.float32))
    if hasattr(js, "init_noise_sigma"):
        assert ts.init_noise_sigma(tstate) == float(js.init_noise_sigma(
            jstate))


def _latents(seed, shape=(2, 4, 8, 8)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name,steps", [("plms", 4), ("plms", 10),
                                        ("lms", 4), ("lms", 10),
                                        ("euler", 4), ("euler_ancestral", 4),
                                        ("euler_ancestral", 10)])
def test_step_chain_matches(name, steps, cfg):
    """Chains of steps on the same model outputs and noise, carries and
    scale_model_input included: PNDM steps once per timestep (n + 1)."""
    js, ts = _pair(name, CONFIGS[cfg])
    jstate, tstate = js.init(steps), ts.init(steps)
    n_evals = len(tstate["timesteps"])
    assert n_evals == len(jstate["timesteps"]) == (
        steps + 1 if name == "plms" else steps)
    if hasattr(js, "init_carry"):
        jstate = js.init_carry(jstate, (2, 4, 8, 8), jnp.float32)
        tstate = ts.init_carry(tstate, (2, 4, 8, 8), torch.float32)
    x_j = jnp.asarray(_latents(0))
    x_t = torch.from_numpy(_latents(0))
    for i in range(n_evals):
        assert rel_l2(ts.scale_model_input(tstate, i, x_t),
                      js.scale_model_input(jstate, i, x_j)) <= TOL
        eps = _latents(100 + i)
        kw_j, kw_t = {}, {}
        if ts.stochastic:
            noise = _latents(200 + i)
            kw_j, kw_t = ({"noise": jnp.asarray(noise)},
                          {"noise": torch.from_numpy(noise)})
        jstate, x_j = js.step(jstate, i, jnp.asarray(eps), x_j, **kw_j)
        tstate, x_t = ts.step(tstate, i, torch.from_numpy(eps), x_t, **kw_t)
        assert rel_l2(x_t, x_j) <= TOL, f"step {i}"


def test_euler_ancestral_needs_noise():
    ts = sched.EulerAncestralDiscreteScheduler()
    assert ts.stochastic and not sched.PNDMScheduler.stochastic
    x = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError, match="noise"):
        ts.step(ts.init(2), 0, x, x)


def _run_port(scheduler, n_evals, start, with_noise=False):
    state = scheduler.init(golden.STEPS)
    if hasattr(scheduler, "init_carry"):
        state = scheduler.init_carry(state, (golden.DIM,), torch.float32)
    x = torch.tensor(start, dtype=torch.float32)
    outs = []
    for i in range(n_evals):
        kwargs = ({"noise": torch.tensor(golden.NOISE[i], dtype=torch.float32)}
                  if with_noise else {})
        state, x = scheduler.step(
            state, i, torch.tensor(golden.EPS[i], dtype=torch.float32), x,
            **kwargs)
        outs.append(x.double().numpy())
    return outs


def test_golden_numpy_steppers():
    """Per step against the float64 diffusers-0.14 steppers."""
    cfg = sched.NoiseScheduleConfig()
    _, sigmas = golden._sigma_grid()
    cases = [
        ("euler_ancestral", sched.EulerAncestralDiscreteScheduler(cfg),
         golden.STEPS, golden.X0 * (sigmas[0] ** 2 + 1) ** 0.5, True,
         golden.ref_euler_ancestral),
        ("lms", sched.LMSDiscreteScheduler(cfg), golden.STEPS,
         golden.X0 * sigmas[0], False, golden.ref_lms),
        ("plms", sched.PNDMScheduler(cfg), golden.STEPS + 1, golden.X0,
         False, golden.ref_pndm_plms),
    ]
    for label, scheduler, n_evals, start, noisy, ref in cases:
        golden._assert_per_step(_run_port(scheduler, n_evals, start, noisy),
                                ref(), label)


@pytest.fixture(scope="module")
def tiny_world():
    from torch_parity import jax_tiny, port_tiny, sampling_args

    jm, params = jax_tiny(seed=21)
    modules, sds = port_tiny(params)
    jax_args, port_args = sampling_args(jm, params, modules, sds, seed=22)
    return jm, modules, jax_args[:2] + jax_args[3:], port_args


@pytest.mark.parametrize("name", ["euler_ancestral", "plms"])
def test_trajectory_matches_jax(name, tiny_world, monkeypatch):
    """make_trajectory_fn on the tiny modules: every post-step latent
    against JAX's, Euler-ancestral with JAX's per-step noise handed to the
    port's draw, PLMS with its n + 1 evaluations. f32 latents in rel-L2
    (measured ~2e-6 a step for PLMS; the bound leaves room for summation
    order)."""
    import jax

    from e4t_diffusion_tpu.diffusion.pipeline import (
        make_trajectory_fn as jax_trajectory_fn)

    from e4t_diffusion_torch.diffusion import pipeline as pl

    steps = 3
    # the trajectory takes no VAE parameters
    jm, modules, jax_args, port_args = tiny_world
    js, ts = _pair(name, {})
    want = np.asarray(jax_trajectory_fn(jm, js, steps, 7.5, 0.1)(*jax_args))
    noise = [torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.fold_in(jax_args[-1], i), port_args[1].shape)))
        for i in range(steps)]
    draws = []

    def step_noise(shape, generator, device, dtype):
        draws.append(shape)
        return noise[len(draws) - 1].to(device, dtype)

    monkeypatch.setattr(pl, "_step_noise", step_noise)
    torch.set_num_threads(1)
    got = pl.make_trajectory_fn(modules, ts, steps, 7.5, 0.1)(
        *port_args).numpy()
    n_evals = steps + 1 if name == "plms" else steps
    assert got.shape == want.shape == (n_evals, 2, 4, 8, 8)
    assert len(draws) == (steps if ts.stochastic else 0)
    for i in range(n_evals):
        assert rel_l2(got[i], want[i]) <= TRAJECTORY_REL_L2, f"step {i}"
