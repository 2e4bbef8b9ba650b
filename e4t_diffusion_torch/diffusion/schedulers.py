"""Diffusion noise schedulers: DDPM's forward process for training, and
DDIM, PNDM (PLMS), LMS, Euler, Euler-ancestral and DPM-Solver++ (2M) for
sampling.

Counterpart of ``e4t_diffusion_tpu/diffusion/schedulers.py`` (diffusers
v0.14 numerics: scaled_linear betas, rounded timestep grids with
steps_offset, final_alpha_cumprod handling, the sigma grids and
``scale_model_input`` of the sigma-based families). A scheduler's
``init(n, device)`` builds its per-step tables in numpy (float64) and
stores them as f32 tensors, with the per-step branches as host booleans;
``init_carry(state, shape, dtype)`` (where a scheduler has one) adds the
history it carries between steps as tensors; ``step(state, i,
model_output, sample, noise=None)`` computes the update in f32 and returns
``(state, sample)`` in the sample's dtype. A sampling loop evaluates the
model once for each entry of ``state["timesteps"]`` (PNDM: ``n + 1``) and
passes per-step noise where the scheduler's ``stochastic`` is true.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.integrate
import torch


@dataclasses.dataclass(frozen=True)
class NoiseScheduleConfig:
    """SD v1 defaults (CompVis/stable-diffusion-v1-4 scheduler config)."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    clip_sample: bool = False


def make_betas(cfg: NoiseScheduleConfig) -> np.ndarray:
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end,
                           cfg.num_train_timesteps, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                           cfg.num_train_timesteps, dtype=np.float64) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        t = np.arange(cfg.num_train_timesteps, dtype=np.float64)

        def f(x):
            return np.cos((x / cfg.num_train_timesteps + 0.008)
                          / 1.008 * np.pi / 2) ** 2
        return np.clip(1.0 - f(t + 1) / f(t), 0, 0.999)
    raise ValueError(cfg.beta_schedule)


def alphas_cumprod(cfg: NoiseScheduleConfig) -> np.ndarray:
    return np.cumprod(1.0 - make_betas(cfg))


class DDPMScheduler:
    """The training-time forward process: diffusers DDPMScheduler
    ``add_noise`` / ``get_velocity`` and the loss target. Coefficients are
    gathered from f32 alphas_cumprod and computed in the sample's dtype."""

    def __init__(self, config: NoiseScheduleConfig = NoiseScheduleConfig()):
        self.config = config
        self._ac = torch.as_tensor(alphas_cumprod(config), dtype=torch.float32)

    def _coeffs(self, x: torch.Tensor, timesteps: torch.Tensor):
        ac = self._ac.to(x.device)[timesteps.long()].to(x.dtype)
        shape = (-1,) + (1,) * (x.dim() - 1)
        return ac.sqrt().reshape(shape), (1.0 - ac).sqrt().reshape(shape)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        sqrt_ac, sqrt_1m = self._coeffs(original, timesteps)
        return sqrt_ac * original + sqrt_1m * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        sqrt_ac, sqrt_1m = self._coeffs(sample, timesteps)
        return sqrt_ac * noise - sqrt_1m * sample

    def target(self, latents: torch.Tensor, noise: torch.Tensor,
               timesteps: torch.Tensor) -> torch.Tensor:
        """The epsilon or v target of ``prediction_type``."""
        if self.config.prediction_type == "epsilon":
            return noise
        if self.config.prediction_type == "v_prediction":
            return self.get_velocity(latents, noise, timesteps)
        raise ValueError(
            f"Unknown prediction type {self.config.prediction_type}")


def _timestep_grid(cfg: NoiseScheduleConfig, num_steps: int) -> np.ndarray:
    """diffusers v0.14 grid: descending rounded multiples + steps_offset."""
    ratio = cfg.num_train_timesteps // num_steps
    ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64)
    return ts + cfg.steps_offset


def _f32(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _pred_x0_eps(cfg, sample, model_output, alpha_t):
    """(pred_x0, eps) under the configured prediction_type."""
    beta_t = 1.0 - alpha_t
    if cfg.prediction_type == "epsilon":
        x0 = (sample - beta_t ** 0.5 * model_output) / alpha_t ** 0.5
        eps = model_output
    elif cfg.prediction_type == "v_prediction":
        x0 = alpha_t ** 0.5 * sample - beta_t ** 0.5 * model_output
        eps = alpha_t ** 0.5 * model_output + beta_t ** 0.5 * sample
    elif cfg.prediction_type == "sample":
        x0 = model_output
        eps = (sample - alpha_t ** 0.5 * x0) / beta_t ** 0.5
    else:
        raise ValueError(cfg.prediction_type)
    return x0, eps


class DDIMScheduler:
    """DDIM sampling (eta=0 deterministic; eta>0 takes per-step noise)."""

    stochastic = False

    def __init__(self, config: NoiseScheduleConfig = NoiseScheduleConfig()):
        self.config = config

    def init(self, num_steps: int, device="cpu") -> Dict[str, torch.Tensor]:
        cfg = self.config
        ac = alphas_cumprod(cfg)
        ts = _timestep_grid(cfg, num_steps)
        prev_ts = ts - cfg.num_train_timesteps // num_steps
        final_ac = 1.0 if cfg.set_alpha_to_one else ac[0]
        alpha_t = ac[np.clip(ts, 0, cfg.num_train_timesteps - 1)]
        alpha_prev = np.where(prev_ts >= 0,
                              ac[np.clip(prev_ts, 0, None)], final_ac)
        return {
            "timesteps": torch.as_tensor(ts.astype(np.int64), device=device),
            "alpha_t": _f32(alpha_t, device),
            "alpha_prev": _f32(alpha_prev, device),
        }

    def scale_model_input(self, state, i, sample):
        return sample

    def step(self, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, eta: float = 0.0,
             noise: Optional[torch.Tensor] = None
             ) -> Tuple[dict, torch.Tensor]:
        cfg = self.config
        a_t = state["alpha_t"][i]
        a_prev = state["alpha_prev"][i]
        x0, eps = _pred_x0_eps(cfg, sample.float(), model_output.float(), a_t)
        if cfg.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        if eta > 0.0:
            if noise is None:
                raise ValueError("eta > 0 requires noise")
            var = (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)
            std = eta * torch.sqrt(var)
            dir_coeff = torch.sqrt(1.0 - a_prev - std ** 2)
            prev = torch.sqrt(a_prev) * x0 + dir_coeff * eps + std * noise
        else:
            prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        return state, prev.to(sample.dtype)


class PNDMScheduler:
    """PLMS (PNDM with skip_prk_steps, the SD default): the second-to-last
    timestep is evaluated twice, so a run of ``n`` steps evaluates the model
    ``n + 1`` times. diffusers' counter-dependent branches are fixed per
    step at init (linear-multistep weights, the timestep pair, whether the
    step stores, reuses or appends); the state carries the last four model
    outputs (newest first) and the sample the first step stores."""

    stochastic = False

    def __init__(self, config: NoiseScheduleConfig = NoiseScheduleConfig()):
        self.config = config

    def init(self, num_steps: int, device="cpu") -> Dict[str, torch.Tensor]:
        cfg = self.config
        ac = alphas_cumprod(cfg)
        ratio = cfg.num_train_timesteps // num_steps
        base = ((np.arange(num_steps) * ratio).round().astype(np.int64)
                + cfg.steps_offset)
        # skip_prk: the second-to-last timestep twice
        ts = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
        n = len(ts)
        weights = np.zeros((n, 5), dtype=np.float64)  # [w_eps, w_e1..w_e4]
        t_pairs = np.zeros((n, 2), dtype=np.int64)    # (timestep, prev)
        use_cur = np.zeros(n, dtype=bool)
        store_cur = np.zeros(n, dtype=bool)
        append_et = np.zeros(n, dtype=bool)
        ets_len = 0
        for counter, t in enumerate(ts):
            prev_t = t - ratio
            if counter != 1:
                ets_len = min(ets_len, 3) + 1
                append_et[counter] = True
            else:
                prev_t, t = t, t + ratio
            if ets_len == 1 and counter == 0:
                weights[counter] = [1, 0, 0, 0, 0]
                store_cur[counter] = True
            elif ets_len == 1 and counter == 1:
                weights[counter] = [0.5, 0.5, 0, 0, 0]
                use_cur[counter] = True
            elif ets_len == 2:
                weights[counter] = [0, 3 / 2, -1 / 2, 0, 0]
            elif ets_len == 3:
                weights[counter] = [0, 23 / 12, -16 / 12, 5 / 12, 0]
            else:
                weights[counter] = [0, 55 / 24, -59 / 24, 37 / 24, -9 / 24]
            t_pairs[counter] = (t, prev_t)
        final_ac = 1.0 if cfg.set_alpha_to_one else ac[0]
        alpha_t = ac[np.clip(t_pairs[:, 0], 0, cfg.num_train_timesteps - 1)]
        alpha_prev = np.where(t_pairs[:, 1] >= 0,
                              ac[np.clip(t_pairs[:, 1], 0, None)], final_ac)
        return {
            "timesteps": torch.as_tensor(ts, device=device),
            "alpha_t": _f32(alpha_t, device),
            "alpha_prev": _f32(alpha_prev, device),
            "weights": _f32(weights, device),
            "use_cur": use_cur,
            "store_cur": store_cur,
            "append_et": append_et,
            "ets": None,
            "cur_sample": None,
        }

    def init_carry(self, state, sample_shape, dtype):
        device = state["alpha_t"].device
        return {**state,
                "ets": torch.zeros((4, *sample_shape), dtype=dtype,
                                   device=device),
                "cur_sample": torch.zeros(sample_shape, dtype=dtype,
                                          device=device)}

    def scale_model_input(self, state, i, sample):
        return sample

    def step(self, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None
             ) -> Tuple[dict, torch.Tensor]:
        ets = state["ets"]
        if state["append_et"][i]:  # newest at index 0
            ets = torch.cat([model_output[None].to(ets.dtype), ets[:-1]])
        cur_sample = (sample.to(ets.dtype) if state["store_cur"][i]
                      else state["cur_sample"])
        sample_eff = cur_sample if state["use_cur"][i] else sample
        w = state["weights"][i]
        combined = (w[0] * model_output.float() + w[1] * ets[0].float()
                    + w[2] * ets[1].float() + w[3] * ets[2].float()
                    + w[4] * ets[3].float())
        a_t, a_prev = state["alpha_t"][i], state["alpha_prev"][i]
        s = sample_eff.float()
        if self.config.prediction_type == "v_prediction":
            combined = a_t ** 0.5 * combined + (1 - a_t) ** 0.5 * s
        denom = a_t * (1 - a_prev) ** 0.5 + (a_t * (1 - a_t) * a_prev) ** 0.5
        prev = (a_prev / a_t) ** 0.5 * s - (a_prev - a_t) * combined / denom
        return ({**state, "ets": ets, "cur_sample": cur_sample},
                prev.to(sample.dtype))


def _sigma_grid(cfg: NoiseScheduleConfig, num_steps: int):
    """diffusers v0.14 *Discrete grids: float linspace timesteps descending,
    sigmas interpolated from ((1-ac)/ac)^0.5, 0 appended."""
    ac = alphas_cumprod(cfg)
    sigmas_train = ((1 - ac) / ac) ** 0.5
    ts = np.linspace(0, cfg.num_train_timesteps - 1, num_steps,
                     dtype=np.float64)[::-1].copy()
    sigmas = np.interp(ts, np.arange(cfg.num_train_timesteps), sigmas_train)
    return ts, np.concatenate([sigmas, [0.0]])


class _SigmaScheduler:
    """The sigma-parameterised samplers: the sample lives in sigma space
    (initial noise times the largest sigma) and the model sees it scaled by
    ``1 / sqrt(sigma^2 + 1)``."""

    stochastic = False

    def __init__(self, config: NoiseScheduleConfig = NoiseScheduleConfig()):
        self.config = config

    def init(self, num_steps: int, device="cpu") -> Dict[str, torch.Tensor]:
        ts, sigmas = _sigma_grid(self.config, num_steps)
        return {
            "timesteps": torch.as_tensor(np.round(ts).astype(np.int64),
                                         device=device),
            "timesteps_f": _f32(ts, device),
            "sigmas": _f32(sigmas, device),
            "sigma_max": float(np.float32(sigmas).max()),
        }

    def init_noise_sigma(self, state) -> float:
        return state["sigma_max"]

    def scale_model_input(self, state, i, sample):
        sigma = state["sigmas"][i].to(sample.dtype)
        return sample / torch.sqrt(sigma ** 2 + 1.0)

    def _pred_x0(self, state, i, model_output, sample):
        """x0 from the un-scaled (sigma-space) sample."""
        sigma = state["sigmas"][i]
        s, m = sample.float(), model_output.float()
        pt = self.config.prediction_type
        if pt == "epsilon":
            return s - sigma * m
        if pt == "v_prediction":
            return (m * (-sigma / torch.sqrt(sigma ** 2 + 1))
                    + s / (sigma ** 2 + 1))
        if pt == "sample":
            return m
        raise ValueError(pt)


class EulerDiscreteScheduler(_SigmaScheduler):
    """diffusers EulerDiscreteScheduler (deterministic, s_churn = 0)."""

    def step(self, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None
             ) -> Tuple[dict, torch.Tensor]:
        sigma, sigma_next = state["sigmas"][i], state["sigmas"][i + 1]
        x0 = self._pred_x0(state, i, model_output, sample)
        d = (sample.float() - x0) / sigma
        prev = sample.float() + (sigma_next - sigma) * d
        return state, prev.to(sample.dtype)


class EulerAncestralDiscreteScheduler(_SigmaScheduler):
    """diffusers EulerAncestralDiscreteScheduler: every step takes a
    standard normal ``noise`` of the sample's shape."""

    stochastic = True

    def step(self, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None
             ) -> Tuple[dict, torch.Tensor]:
        if noise is None:
            raise ValueError("euler_ancestral requires per-step noise")
        sigma, sigma_to = state["sigmas"][i], state["sigmas"][i + 1]
        x0 = self._pred_x0(state, i, model_output, sample)
        var = sigma_to ** 2 * (sigma ** 2 - sigma_to ** 2) / sigma ** 2
        sigma_up = torch.sqrt(torch.clamp(var, min=0.0))
        sigma_down = torch.sqrt(torch.clamp(sigma_to ** 2 - sigma_up ** 2,
                                            min=0.0))
        d = (sample.float() - x0) / sigma
        prev = (sample.float() + (sigma_down - sigma) * d
                + noise.float() * sigma_up)
        return state, prev.to(sample.dtype)


def _lms_coefficient(sigmas: np.ndarray, order: int, t: int, j: int
                     ) -> float:
    """diffusers' ``get_lms_coefficient``: the integral over [sigma_t,
    sigma_t+1] of the Lagrange basis polynomial of sigma_{t-j} on the last
    ``order`` sigmas."""

    def basis(tau):
        prod = 1.0
        for k in range(order):
            if k != j:
                prod *= ((tau - sigmas[t - k])
                         / (sigmas[t - j] - sigmas[t - k]))
        return prod

    return scipy.integrate.quad(basis, sigmas[t], sigmas[t + 1],
                                epsrel=1e-4)[0]


class LMSDiscreteScheduler(_SigmaScheduler):
    """diffusers LMSDiscreteScheduler (order 4): Adams-Bashforth over the
    sigma grid. The coefficients are integrated at init into an (n, 4)
    table (newest first); the state carries the last four derivatives."""

    lms_order = 4

    def init(self, num_steps: int, device="cpu") -> Dict[str, torch.Tensor]:
        state = super().init(num_steps, device)
        _, sigmas = _sigma_grid(self.config, num_steps)
        coeffs = np.zeros((num_steps, self.lms_order), np.float64)
        for t in range(num_steps):
            order = min(t + 1, self.lms_order)
            for j in range(order):
                coeffs[t, j] = _lms_coefficient(sigmas, order, t, j)
        return {**state, "lms_coeffs": _f32(coeffs, device), "derivs": None}

    def init_carry(self, state, sample_shape, dtype):
        return {**state, "derivs": torch.zeros(
            (self.lms_order, *sample_shape), dtype=torch.float32,
            device=state["sigmas"].device)}

    def step(self, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None
             ) -> Tuple[dict, torch.Tensor]:
        sigma = state["sigmas"][i]
        x0 = self._pred_x0(state, i, model_output, sample)
        d = (sample.float() - x0) / sigma
        derivs = torch.cat([d[None], state["derivs"][:-1]])
        w = state["lms_coeffs"][i]
        delta = sum(w[k] * derivs[k] for k in range(self.lms_order))
        prev = sample.float() + delta
        return {**state, "derivs": derivs}, prev.to(sample.dtype)


class DPMSolverMultistepScheduler:
    """DPM-Solver++ (2M), diffusers v0.14 defaults: solver_order=2,
    algorithm_type='dpmsolver++', lower_order_final=True. The order used
    at each step is fixed at init; the state carries the previous step's
    x0 prediction."""

    stochastic = False

    def __init__(self, config: NoiseScheduleConfig = NoiseScheduleConfig(),
                 solver_order: int = 2, lower_order_final: bool = True):
        self.config = config
        self.solver_order = solver_order
        self.lower_order_final = lower_order_final

    def init(self, num_steps: int, device="cpu") -> Dict[str, torch.Tensor]:
        cfg = self.config
        ac = alphas_cumprod(cfg)
        # diffusers set_timesteps: linspace(0, T-1, n+1).round()[::-1][:-1]
        ts = (np.linspace(0, cfg.num_train_timesteps - 1, num_steps + 1)
              .round()[::-1][:-1].astype(np.int64).copy())
        alpha = np.sqrt(ac)
        sigma = np.sqrt(1 - ac)
        lam = np.log(alpha) - np.log(sigma)
        n = num_steps
        use_order2 = np.array([
            i >= 1 and self.solver_order >= 2
            and not (self.lower_order_final and n < 15 and i == n - 1)
            for i in range(n)])
        t_prev = np.concatenate([[0], ts[:-1]])   # s1 at step i is ts[i-1]
        t_next = np.concatenate([ts[1:], [0]])    # diffusers prev_timestep

        def gather(arr, idx):
            return _f32(arr[np.clip(idx, 0, len(arr) - 1)], device)

        return {
            "timesteps": torch.as_tensor(ts, device=device),
            "lam_t": gather(lam, t_next),
            "lam_s0": gather(lam, ts),
            "lam_s1": gather(lam, t_prev),
            "alpha_T": gather(alpha, t_next),
            "sigma_T": gather(sigma, t_next),
            "alpha_s0": gather(alpha, ts),
            "sigma_s0": gather(sigma, ts),
            "use_order2": use_order2,
            "m_prev": None,
        }

    def init_noise_sigma(self, state) -> float:
        return 1.0

    def scale_model_input(self, state, i, sample):
        return sample

    def _to_x0(self, state, i, model_output, sample):
        a, s = state["alpha_s0"][i], state["sigma_s0"][i]
        mo, x = model_output.float(), sample.float()
        pt = self.config.prediction_type
        if pt == "epsilon":
            return (x - s * mo) / a
        if pt == "v_prediction":
            return a * x - s * mo
        if pt == "sample":
            return mo
        raise ValueError(pt)

    def step(self, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None
             ) -> Tuple[dict, torch.Tensor]:
        x = sample.float()
        m0 = self._to_x0(state, i, model_output, sample)
        h = state["lam_t"][i] - state["lam_s0"][i]
        alpha_T, sigma_T = state["alpha_T"][i], state["sigma_T"][i]
        # 1st order: (sigma_t / sigma_s0) x - alpha_t (e^-h - 1) m0
        prev = ((sigma_T / state["sigma_s0"][i]) * x
                - alpha_T * (torch.exp(-h) - 1.0) * m0)
        if state["use_order2"][i]:
            # 2nd-order multistep correction with D1 = (m0 - m1) / r0
            r0 = (state["lam_s0"][i] - state["lam_s1"][i]) / h
            d1 = (m0 - state["m_prev"]) / r0
            prev = prev - 0.5 * alpha_T * (torch.exp(-h) - 1.0) * d1
        return {**state, "m_prev": m0}, prev.to(sample.dtype)


SCHEDULER_MAPPING = {
    "ddim": DDIMScheduler,
    "plms": PNDMScheduler,
    "lms": LMSDiscreteScheduler,
    "euler": EulerDiscreteScheduler,
    "euler_ancestral": EulerAncestralDiscreteScheduler,
    "dpm_solver++": DPMSolverMultistepScheduler,
}
