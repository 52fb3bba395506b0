"""DDIM scheduler, stateless. Counterpart of vexpress_tpu/diffusion/ddim.py.

The configuration V-Express uses at inference: scaled_linear betas
[0.00085, 0.012], 1000 train steps, v-prediction, zero-terminal-SNR beta
rescale, trailing timestep spacing, clip_sample=False. Schedule tables are
host numpy; `step` is fp32 torch math on the sample's device. `build_step`
puts one grid's alphas on the device once and indexes them with a device
step index, so its step makes no host-to-device copy and can be captured in
a CUDA graph. With eta > 0 the caller draws the step's unit noise (from its
own torch.Generator) and passes it in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    clip_sample: bool = False
    steps_offset: int = 1
    prediction_type: str = "v_prediction"
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"
    set_alpha_to_one: bool = True


def _make_betas(config: SchedulerConfig) -> np.ndarray:
    n = config.num_train_timesteps
    if config.beta_schedule == "scaled_linear":
        return np.linspace(config.beta_start**0.5, config.beta_end**0.5, n, dtype=np.float64) ** 2
    if config.beta_schedule == "linear":
        return np.linspace(config.beta_start, config.beta_end, n, dtype=np.float64)
    raise ValueError(f"unsupported beta_schedule: {config.beta_schedule}")


def _rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Shi et al. 2023 (arXiv:2305.08891): rescale so alphas_cumprod[-1] == 0."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, at = alphas_bar_sqrt[0].copy(), alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = (alphas_bar_sqrt - at) * a0 / (a0 - at)
    alphas_bar = alphas_bar_sqrt**2
    alphas = np.concatenate([alphas_bar[0:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


class DDIMScheduler:
    """Stateless DDIM: `timesteps(n)` is a pure function and `step` takes
    everything it needs."""

    def __init__(self, config: Optional[SchedulerConfig] = None, **kwargs):
        if config is None:
            config = SchedulerConfig(**kwargs)
        elif kwargs:
            config = dataclasses.replace(config, **kwargs)
        self.config = config
        betas = _make_betas(config)
        if config.rescale_betas_zero_snr:
            betas = _rescale_zero_terminal_snr(betas)
        self.betas = betas.astype(np.float32)
        self.alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        self.final_alpha_cumprod = (np.float32(1.0) if config.set_alpha_to_one
                                    else self.alphas_cumprod[0])
        self.init_noise_sigma = 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Inference timestep schedule (int64, descending)."""
        n = self.config.num_train_timesteps
        if num_inference_steps > n:
            raise ValueError(f"num_inference_steps {num_inference_steps} > {n}")
        spacing = self.config.timestep_spacing
        if spacing == "trailing":
            ts = np.round(np.arange(n, 0, -n / num_inference_steps)).astype(np.int64) - 1
        elif spacing == "leading":
            step_ratio = n // num_inference_steps
            ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
            ts = ts.astype(np.int64) + self.config.steps_offset
        elif spacing == "linspace":
            ts = np.linspace(0, n - 1, num_inference_steps).round()[::-1].copy().astype(np.int64)
        else:
            raise ValueError(f"unsupported timestep_spacing: {spacing}")
        return ts

    def _alphas(self, timestep: int, num_inference_steps: int) -> Tuple[np.float32, np.float32]:
        """alphas_cumprod at `timestep` and at the step's previous timestep."""
        t = int(timestep)
        prev_t = t - self.config.num_train_timesteps // num_inference_steps
        return (self.alphas_cumprod[t],
                self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod)

    def step(self, model_output: torch.Tensor, timestep: int, sample: torch.Tensor,
             num_inference_steps: int, eta: float = 0.0,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One DDIM step (diffusers DDIMScheduler.step with clip_sample off);
        returns prev_sample in sample's dtype. eta=0 is deterministic; eta > 0
        adds the DDIM paper's (Song et al. 2020, eq. 12) term sigma * noise,
        sigma = eta * sqrt((1-a_prev)/(1-a_t)) * sqrt(1 - a_t/a_prev), and
        needs `noise` (unit Gaussian, sample's shape)."""
        dev = sample.device
        a_t, a_prev = (torch.tensor(np.float32(a), dtype=torch.float32, device=dev)
                       for a in self._alphas(timestep, num_inference_steps))
        return self._update(model_output, sample, a_t, a_prev, eta, noise)

    def build_step(self, num_inference_steps: int, eta: float = 0.0, device="cpu"):
        """`step` over the grid `timesteps(num_inference_steps)`, its alphas
        put on `device` once: `fn(model_output, idx, sample, noise=None)`
        takes the grid index `idx` (a 0-d int64 tensor on `device`, or an
        int) and equals `step` at the grid's timestep `idx` bitwise."""
        pairs = [self._alphas(t, num_inference_steps) for t in self.timesteps(num_inference_steps)]
        a_t, a_prev = (torch.tensor(np.array(col, np.float32), device=device)
                       for col in zip(*pairs))

        def fn(model_output: torch.Tensor, idx, sample: torch.Tensor,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
            idx = torch.as_tensor(idx, device=a_t.device)  # take: no host read of idx
            return self._update(model_output, sample, a_t.take(idx), a_prev.take(idx), eta,
                                noise)

        return fn

    def _update(self, model_output: torch.Tensor, sample: torch.Tensor,
                alpha_prod_t: torch.Tensor, alpha_prod_prev: torch.Tensor, eta: float,
                noise: Optional[torch.Tensor]) -> torch.Tensor:
        """The step's arithmetic from the two alphas, 0-d fp32 tensors."""
        if eta != 0.0 and noise is None:
            raise ValueError("eta > 0 requires noise (stochastic DDIM)")
        cfg = self.config
        beta_prod_t = 1.0 - alpha_prod_t
        x = sample.float()
        out = model_output.float()
        sqrt_a, sqrt_b = torch.sqrt(alpha_prod_t), torch.sqrt(beta_prod_t)
        if cfg.prediction_type == "epsilon":
            pred_x0 = (x - sqrt_b * out) / torch.clamp(sqrt_a, min=1e-12)
            pred_eps = out
        elif cfg.prediction_type == "v_prediction":
            pred_x0 = sqrt_a * x - sqrt_b * out
            pred_eps = sqrt_a * out + sqrt_b * x
        elif cfg.prediction_type == "sample":
            pred_x0 = out
            pred_eps = (x - sqrt_a * pred_x0) / torch.clamp(sqrt_b, min=1e-12)
        else:
            raise ValueError(f"unsupported prediction_type: {cfg.prediction_type}")
        if cfg.clip_sample:
            pred_x0 = pred_x0.clamp(-1.0, 1.0)
        if eta == 0.0:
            prev = (torch.sqrt(alpha_prod_prev) * pred_x0
                    + torch.sqrt(1.0 - alpha_prod_prev) * pred_eps)
        else:
            variance = ((1.0 - alpha_prod_prev) / torch.clamp(beta_prod_t, min=1e-20)
                        * (1.0 - alpha_prod_t / alpha_prod_prev))
            sigma = eta * torch.sqrt(torch.clamp(variance, min=0.0))
            dir_coeff = torch.sqrt(torch.clamp(1.0 - alpha_prod_prev - sigma**2, min=0.0))
            prev = (torch.sqrt(alpha_prod_prev) * pred_x0 + dir_coeff * pred_eps
                    + sigma * noise.float())
        return prev.to(sample.dtype)
