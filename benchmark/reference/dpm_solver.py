"""DPM-Solver++ (2M) multistep scheduler with explicit state. Counterpart of
vexpress_tpu/diffusion/dpm_solver.py.

Lu et al. 2022, "DPM-Solver++" (arXiv:2211.01095), algorithm 2: the
data-prediction multistep variant of order 2, the final step lowered to
first order, no thresholding. It uses DDIM's schedule tables (scaled_linear
betas, zero-terminal-SNR rescale, trailing spacing), so it drops into the
inference configuration unchanged; with zero-terminal SNR, alpha_bar is
clamped to [1e-8, 1 - 1e-8] so lambda stays finite. There is no mutable
scheduler state: the caller threads the previous step's x0 prediction and a
flag through the loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ddim import DDIMScheduler, SchedulerConfig

_PREDICTION_TYPES = ("epsilon", "v_prediction", "sample")


class DpmState(NamedTuple):
    """Multistep history threaded through the denoise loop."""

    prev_x0: torch.Tensor  # x0 prediction at the previous model call
    has_prev: bool  # prev_x0 is valid (step_index > 0)


class DPMSolverMultistepScheduler:
    """DPM-Solver++ (2M) on DDIM's beta/alpha tables and timestep grid."""

    order = 2

    def __init__(self, config: Optional[SchedulerConfig] = None, **kwargs):
        self._ddim = DDIMScheduler(config, **kwargs)
        self.config = self._ddim.config
        self.init_noise_sigma = 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return self._ddim.timesteps(num_inference_steps)

    def init_state(self, sample: torch.Tensor) -> DpmState:
        return DpmState(prev_x0=torch.zeros_like(sample, dtype=torch.float32), has_prev=False)

    def _pred_x0(self, out: torch.Tensor, x: torch.Tensor, sqrt_a, sqrt_b) -> torch.Tensor:
        pt = self.config.prediction_type
        if pt == "epsilon":
            return (x - sqrt_b * out) / torch.clamp(sqrt_a, min=1e-12)
        if pt == "v_prediction":
            return sqrt_a * x - sqrt_b * out
        if pt == "sample":
            return out
        raise ValueError(f"unsupported prediction_type: {pt}")

    def _alpha_sigma_lambda(self, t: int) -> Tuple[float, float, float]:
        """alpha_t, sigma_t and lambda_t = log(alpha_t / sigma_t) at table
        index t, in fp32, alpha_bar clamped away from 0 and 1."""
        a_bar = np.clip(np.float32(self._ddim.alphas_cumprod[t]), np.float32(1e-8),
                        np.float32(1.0 - 1e-8))
        alpha, sigma = np.sqrt(a_bar), np.sqrt(np.float32(1.0) - a_bar)
        return alpha, sigma, np.log(alpha) - np.log(sigma)

    # ---------------------------------------------------------- table step

    def tables(self, num_inference_steps: int) -> dict:
        """`build_step`'s per-step constants over the grid, computed in
        float64 on the host, then fp32 (numpy arrays by name)."""
        ts = self.timesteps(num_inference_steps)
        a_bar_raw = self._ddim.alphas_cumprod[ts].astype(np.float64)
        a_bar = np.clip(a_bar_raw, 1e-8, 1.0 - 1e-8)
        alpha = np.sqrt(a_bar)
        sigma = np.sqrt(1.0 - a_bar)
        lam = np.log(alpha) - np.log(sigma)
        # target: the next grid point; after the last, the clean endpoint
        # (alpha 1, sigma 0, lambda +inf), where the first-order update
        # returns x0 exactly
        alpha_p = np.concatenate([alpha[1:], [1.0]])
        sigma_p = np.concatenate([sigma[1:], [0.0]])
        lam_p = np.concatenate([lam[1:], [np.inf]])
        h = lam_p - lam
        h_safe = np.where(np.isfinite(h), h, 1.0)
        h_last = np.concatenate([[1.0], lam[1:] - lam[:-1]])
        tables = dict(
            sqrt_a=np.sqrt(a_bar_raw),
            sqrt_b=np.sqrt(1.0 - a_bar_raw),
            ratio=sigma_p / np.maximum(sigma, 1e-20),
            alpha_p=alpha_p,
            emh=np.expm1(-h),  # expm1(-inf) == -1
            emh_safe=np.expm1(-h_safe),
            inv_2r=h_safe / np.maximum(2.0 * h_last, 1e-20),  # 1/(2r), r = h_last/h
        )
        return {k: v.astype(np.float32) for k, v in tables.items()}

    def build_step(self, num_inference_steps: int, device="cpu"):
        """The step over the whole grid, its constants (`tables`) put on
        `device` once: `fn(model_output, idx, sample, prev_x0, has_prev) ->
        (prev_sample, x0, has_prev')`; thread the last two back in as the
        multistep state. `idx` (grid index) and `has_prev` are 0-d tensors on
        `device` (an int and a bool also do): the step reads neither on the
        host, so it can be captured in a CUDA graph. Matches `step()`."""
        n = num_inference_steps
        tables = {k: torch.tensor(v, device=device) for k, v in self.tables(n).items()}
        if self.config.prediction_type not in _PREDICTION_TYPES:
            raise ValueError(f"unsupported prediction_type: {self.config.prediction_type}")

        def fn(model_output: torch.Tensor, idx, sample: torch.Tensor,
               prev_x0: torch.Tensor, has_prev):
            idx = torch.as_tensor(idx, device=device)
            has_prev = torch.as_tensor(has_prev, device=device)

            def c(name):
                return tables[name].take(idx)

            x = sample.float()
            x0 = self._pred_x0(model_output.float(), x, c("sqrt_a"), c("sqrt_b"))
            base = c("ratio") * x
            inv_2r = c("inv_2r")
            d = (1.0 + inv_2r) * x0 - inv_2r * prev_x0
            second = base - c("alpha_p") * c("emh_safe") * d
            first = base - c("alpha_p") * c("emh") * x0
            # the second-order update where there is a previous x0 and a
            # next grid point; the selection keeps either update bitwise
            prev = torch.where(has_prev & (idx > 0) & (idx < n - 1), second, first)
            return prev.to(sample.dtype), x0, torch.ones_like(has_prev)

        return fn

    # ------------------------------------------------------------------ step

    def step(self, model_output: torch.Tensor, step_index: int, timesteps: np.ndarray,
             sample: torch.Tensor, state: DpmState) -> Tuple[torch.Tensor, DpmState]:
        """One DPM-Solver++ (2M) step at `step_index` of the descending grid
        `timesteps`; returns (prev_sample, new_state)."""
        n = len(timesteps)
        dev = sample.device

        def f32(x) -> torch.Tensor:
            return torch.tensor(np.float32(x), dtype=torch.float32, device=dev)

        t = int(timesteps[step_index])
        a_bar = np.float32(self._ddim.alphas_cumprod[t])
        x = sample.float()
        x0 = self._pred_x0(model_output.float(), x, torch.sqrt(f32(a_bar)),
                           torch.sqrt(f32(1.0 - a_bar)))
        if step_index == n - 1:  # final step: sigma(prev) = 0, x_prev = x0
            return x0.to(sample.dtype), DpmState(prev_x0=x0, has_prev=True)
        _, sigma_t, lam_t = self._alpha_sigma_lambda(t)
        alpha_p, sigma_p, lam_p = self._alpha_sigma_lambda(int(timesteps[step_index + 1]))
        h = lam_p - lam_t
        ratio = f32(sigma_p / max(sigma_t, np.float32(1e-20)))
        emh = f32(np.expm1(-h))
        first = ratio * x - f32(alpha_p) * emh * x0
        if step_index == 0 or not state.has_prev:
            prev = first
        else:
            _, _, lam_pp = self._alpha_sigma_lambda(int(timesteps[step_index - 1]))
            inv_2r = f32(np.float32(1.0) / (np.float32(2.0) * ((lam_t - lam_pp) / h)))
            d = (1.0 + inv_2r) * x0 - inv_2r * state.prev_x0
            prev = ratio * x - f32(alpha_p) * emh * d
        return prev.to(sample.dtype), DpmState(prev_x0=x0, has_prev=True)
