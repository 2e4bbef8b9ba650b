"""The port's DDIM and DPM-Solver++ (2M) against the JAX schedulers, within
1e-6: the per-step tables and single steps elementwise, chains of steps in
rel-L2. Both compute in f32 from the same f32-rounded tables. Along a chain
the x0 predictions reach O(20) at the noisy end (x / alpha with alpha
~0.07), where one f32 ulp is ~2e-6, so a chain is compared in rel-L2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.diffusion import schedulers as jax_sched

from e4t_diffusion_torch.diffusion import schedulers as sched

from torch_parity import rel_l2

TOL = 1e-6
CONFIGS = {
    "sd_v1": {},
    "v_pred_alpha_one": dict(prediction_type="v_prediction",
                             set_alpha_to_one=True),
}


def _pair(name, cfg_kwargs):
    jcls = jax_sched.SCHEDULER_MAPPING[name]
    tcls = sched.SCHEDULER_MAPPING[name]
    return (jcls(jax_sched.NoiseScheduleConfig(**cfg_kwargs)),
            tcls(sched.NoiseScheduleConfig(**cfg_kwargs)))


@pytest.mark.parametrize("name", ["ddim", "dpm_solver++"])
@pytest.mark.parametrize("steps", [3, 20, 50])
def test_tables_match(name, steps):
    js, ts = _pair(name, {})
    jstate, tstate = js.init(steps), ts.init(steps)
    for key, jv in jstate.items():
        if jv is None:
            continue
        tv = tstate[key]
        tv = tv.numpy() if isinstance(tv, torch.Tensor) else np.asarray(tv)
        np.testing.assert_allclose(tv, np.asarray(jv), atol=TOL, err_msg=key)


def _latents(seed, shape=(2, 4, 8, 8)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name,steps", [("ddim", 4), ("dpm_solver++", 4),
                                        ("dpm_solver++", 20)])
def test_step_chain_matches(name, steps, cfg):
    """Chains of steps on the same model outputs, carries included."""
    js, ts = _pair(name, CONFIGS[cfg])
    jstate, tstate = js.init(steps), ts.init(steps)
    if hasattr(js, "init_carry"):
        jstate = js.init_carry(jstate, (2, 4, 8, 8), jnp.float32)
    x_j = jnp.asarray(_latents(0))
    x_t = torch.from_numpy(_latents(0))
    for i in range(steps):
        eps = _latents(100 + i)
        jstate, x_j = js.step(jstate, i, jnp.asarray(eps), x_j)
        tstate, x_t = ts.step(tstate, i, torch.from_numpy(eps), x_t)
        assert rel_l2(x_t, x_j) <= TOL, f"step {i}"


def test_ddim_eta_step_matches():
    js, ts = _pair("ddim", {})
    jstate, tstate = js.init(5), ts.init(5)
    x, eps, noise = _latents(1), _latents(2), _latents(3)
    for i in range(5):
        _, jx = js.step(jstate, i, jnp.asarray(eps), jnp.asarray(x), eta=0.7,
                        noise=jnp.asarray(noise))
        _, tx = ts.step(tstate, i, torch.from_numpy(eps), torch.from_numpy(x),
                        eta=0.7, noise=torch.from_numpy(noise))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=TOL)


def test_ddim_eta_needs_noise():
    ts = sched.DDIMScheduler()
    x = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError, match="noise"):
        ts.step(ts.init(2), 0, x, x, eta=0.5)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_ddpm_forward_process_matches(cfg):
    """add_noise, get_velocity and the loss target (epsilon or v) at
    timesteps across the schedule."""
    js = jax_sched.DDPMScheduler(jax_sched.NoiseScheduleConfig(**CONFIGS[cfg]))
    ts = sched.DDPMScheduler(sched.NoiseScheduleConfig(**CONFIGS[cfg]))
    x, noise = _latents(4, (3, 4, 8, 8)), _latents(5, (3, 4, 8, 8))
    t = np.array([0, 421, 999])
    jargs = (jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t))
    targs = (torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(t))
    for name in ("add_noise", "get_velocity", "target"):
        want = np.asarray(getattr(js, name)(*jargs))
        got = getattr(ts, name)(*targs).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=name)


def test_ddpm_rejects_unknown_prediction_type():
    ts = sched.DDPMScheduler(sched.NoiseScheduleConfig(
        prediction_type="sample"))
    x = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError, match="prediction type"):
        ts.target(x, x, torch.tensor([3]))
