"""Shared layers: GEGLU feed-forward, timestep embeddings, temporal PE.

Counterpart of vexpress_tpu/ops/layers.py. Parameter names follow the torch
checkpoint keys (ff.net.0.proj, ff.net.2, time_embedding.linear_{1,2}).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU by dtype: the tanh approximation in bf16 (its error is below bf16
    rounding), the exact erf form in fp32."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward: proj to 2*inner, gate with GELU, project back."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class Gelu(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


def gelu_feed_forward(dim: int, mult: int = 4) -> nn.Sequential:
    """Perceiver-style FF: LayerNorm -> Linear(no bias) -> GELU -> Linear(no
    bias); keys ff.0 (norm), ff.1, ff.3 as in the torch checkpoint."""
    inner = int(dim * mult)
    return nn.Sequential(nn.LayerNorm(dim, eps=1e-5), nn.Linear(dim, inner, bias=False), Gelu(),
                         nn.Linear(inner, dim, bias=False))


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers `Timesteps` semantics), fp32."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)
    emb = timesteps.to(torch.float32)[:, None] * emb[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2 on the sinusoidal embedding."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


def get_sinusoidal_positional_encoding(d_model: int, max_len: int) -> np.ndarray:
    """Temporal positional encoding table [1, max_len, d_model] (AnimateDiff PE)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe = np.zeros((1, max_len, d_model), dtype=np.float32)
    pe[0, :, 0::2] = np.sin(position * div_term)
    pe[0, :, 1::2] = np.cos(position * div_term)
    return pe
