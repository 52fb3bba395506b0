"""UNet building blocks. Counterpart of vexpress_tpu/models/blocks.py.

Conv stacks run NCHW with frames folded into the batch; transformer blocks
take (N, h*w, C) tokens in the same row-major order as the JAX package.
Reference-net KV injection is explicit: `BasicTransformerBlock` returns the
norm2 hidden state (the bank) and `TemporalBasicTransformerBlock` takes it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .attention import Attention
from .layers import FeedForward


class ResnetBlock(nn.Module):
    """GroupNorm-SiLU-Conv x2 with the timestep-embedding add
    (diffusers ResnetBlock2D, time_embedding_norm="default")."""

    def __init__(self, in_channels: int, out_channels: int, eps: float = 1e-5, groups: int = 32,
                 temb_channels: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2 + 3x3 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class BasicTransformerBlock(nn.Module):
    """Reference-net block: self-attn, bank capture, cross-attn, GEGLU FF.
    Returns (hidden_states, bank) with bank = norm2(hidden)."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor):
        x = x + self.attn1(self.norm1(x))
        bank = self.norm2(x)
        x = x + self.attn2(bank, encoder_hidden_states)
        x = x + self.ff(self.norm3(x))
        return x, bank


class TemporalBasicTransformerBlock(nn.Module):
    """Denoising-net block: self-attn, reference attn1_5, audio attn2, FF and
    the optional per-pixel temporal attention attn_temp.

    With `ref_kv` given, attn1_5 attends to the reference bank scaled by
    `ref_scale` and attn2 to the audio tokens scaled by `audio_scale`. With
    `ref_kv=None` (blocks outside the fusion set) attn1_5 self-attends its
    norm1_5 output and neither branch is scaled."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int,
                 use_temporal_attention: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm1_5 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1_5 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)
        self.use_temporal_attention = use_temporal_attention
        if use_temporal_attention:
            self.norm_temp = nn.LayerNorm(dim, eps=1e-5)
            self.attn_temp = Attention(dim, heads, dim_head)

    def forward(self, x: torch.Tensor, audio_kv: torch.Tensor, ref_kv: Optional[torch.Tensor],
                ref_scale, audio_scale, zero_uncond_kv: bool = False,
                frames: int = 1) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        if ref_kv is None:
            x = x + self.attn1_5(self.norm1_5(x))
            x = x + self.attn2(self.norm2(x), audio_kv, zero_kv_first_half=zero_uncond_kv)
        else:
            x = x + ref_scale * self.attn1_5(self.norm1_5(x), ref_kv,
                                             zero_kv_first_half=zero_uncond_kv)
            x = x + audio_scale * self.attn2(self.norm2(x), audio_kv,
                                             zero_kv_first_half=zero_uncond_kv)
        x = x + self.ff(self.norm3(x))
        if self.use_temporal_attention:
            # LayerNorm commutes with the frame permutation, so the
            # transpose-free temporal attention applies here too
            x = x + self.attn_temp(self.norm_temp(x), temporal_frames=frames)
        return x


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 conv in -> transformer blocks -> 1x1 conv out + residual
    (Transformer2DModel / Transformer3DModel, use_linear_projection=False).
    `temporal=True` builds TemporalBasicTransformerBlocks (denoising net),
    else BasicTransformerBlocks, which also return their banks."""

    def __init__(self, in_channels: int, heads: int, cross_attention_dim: int, depth: int = 1,
                 temporal: bool = False, use_temporal_attention: bool = False,
                 groups: int = 32):
        super().__init__()
        dim_head = in_channels // heads
        self.temporal = temporal
        self.norm = nn.GroupNorm(groups, in_channels, eps=1e-6)
        self.proj_in = nn.Conv2d(in_channels, in_channels, 1)
        if temporal:
            blocks = [TemporalBasicTransformerBlock(in_channels, heads, dim_head,
                                                    cross_attention_dim, use_temporal_attention)
                      for _ in range(depth)]
        else:
            blocks = [BasicTransformerBlock(in_channels, heads, dim_head, cross_attention_dim)
                      for _ in range(depth)]
        self.transformer_blocks = nn.ModuleList(blocks)
        self.proj_out = nn.Conv2d(in_channels, in_channels, 1)

    def forward(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor,
                ref_kv: Optional[Sequence[torch.Tensor]] = None, ref_scale=None,
                audio_scale=None, zero_uncond_kv: bool = False, frames: int = 1):
        n, c, h, w = x.shape
        hs = self.proj_in(self.norm(x))
        hs = hs.permute(0, 2, 3, 1).reshape(n, h * w, c)
        banks = []
        for i, blk in enumerate(self.transformer_blocks):
            if self.temporal:
                hs = blk(hs, encoder_hidden_states, None if ref_kv is None else ref_kv[i],
                         ref_scale, audio_scale, zero_uncond_kv, frames)
            else:
                hs, bank = blk(hs, encoder_hidden_states)
                banks.append(bank)
        hs = hs.reshape(n, h, w, c).permute(0, 3, 1, 2)
        out = self.proj_out(hs) + x
        if self.temporal:
            return out
        return out, banks
