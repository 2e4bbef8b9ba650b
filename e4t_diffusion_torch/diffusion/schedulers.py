"""Diffusion noise schedulers: DDPM's forward process for training, and
DDIM and DPM-Solver++ (2M) for sampling.

Counterpart of ``e4t_diffusion_tpu/diffusion/schedulers.py`` (diffusers
v0.14 numerics: scaled_linear betas, rounded timestep grids with
steps_offset, final_alpha_cumprod handling). A scheduler's ``init(n,
device)`` builds its per-step tables in numpy (float64) and stores them as
f32 tensors; ``step(state, i, model_output, sample)`` computes the update
in f32 and returns it in the sample's dtype. PNDM, LMS, Euler and
Euler-ancestral come in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
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


class DPMSolverMultistepScheduler:
    """DPM-Solver++ (2M), diffusers v0.14 defaults: solver_order=2,
    algorithm_type='dpmsolver++', lower_order_final=True. The order used
    at each step is fixed at init; the state carries the previous step's
    x0 prediction."""

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
    "dpm_solver++": DPMSolverMultistepScheduler,
}
