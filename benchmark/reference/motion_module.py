"""AnimateDiff-style temporal motion module. Counterpart of
vexpress_tpu/models/motion_module.py: per-pixel attention across frames with
a sinusoidal temporal position encoding, run transpose-free on (b*f, d, c)
tokens (the frame axis rides inside the attention einsums)."""

from __future__ import annotations

import torch
from torch import nn

from .attention import Attention
from .layers import FeedForward, get_sinusoidal_positional_encoding


class TemporalTransformerBlock(nn.Module):
    """Two temporal self-attention sublayers + GEGLU FF."""

    def __init__(self, dim: int, heads: int, max_len: int, num_attention_blocks: int = 2):
        super().__init__()
        self.max_len = max_len
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-5) for _ in range(num_attention_blocks)])
        self.attention_blocks = nn.ModuleList(
            [Attention(dim, heads, dim // heads) for _ in range(num_attention_blocks)])
        self.ff_norm = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)
        self.register_buffer("pe", torch.from_numpy(get_sinusoidal_positional_encoding(dim, max_len)),
                             persistent=False)

    def forward(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        if frames > self.max_len:
            raise ValueError(
                f"temporal attention got {frames} frames but "
                f"temporal_position_encoding_max_len={self.max_len}; split the video "
                f"into context windows of <= {self.max_len} frames (pipelines.context).")
        b = x.shape[0] // frames
        pe_rows = self.pe[0, :frames].to(x.dtype).repeat(b, 1)[:, None, :]  # (b*f, 1, c)
        for norm, attn in zip(self.norms, self.attention_blocks):
            x = x + attn(norm(x) + pe_rows, temporal_frames=frames)
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer3D(nn.Module):
    """norm -> proj_in -> temporal blocks -> proj_out + residual."""

    def __init__(self, in_channels: int, heads: int = 8, num_transformer_block: int = 1,
                 max_len: int = 32, groups: int = 32):
        super().__init__()
        self.norm = nn.GroupNorm(groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, in_channels)
        self.transformer_blocks = nn.ModuleList(
            [TemporalTransformerBlock(in_channels, heads, max_len)
             for _ in range(num_transformer_block)])
        self.proj_out = nn.Linear(in_channels, in_channels)

    def forward(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        n, c, h, w = x.shape  # (B*F, C, H, W)
        hs = self.norm(x).permute(0, 2, 3, 1).reshape(n, h * w, c)
        hs = self.proj_in(hs)
        for blk in self.transformer_blocks:
            hs = blk(hs, frames)
        hs = self.proj_out(hs)
        return hs.reshape(n, h, w, c).permute(0, 3, 1, 2) + x


class TemporalMotionModule(nn.Module):
    """VanillaTemporalModule wrapper; key prefix motion_modules.{j}.temporal_transformer."""

    def __init__(self, in_channels: int, heads: int = 8, num_transformer_block: int = 1,
                 max_len: int = 32, groups: int = 32):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3D(in_channels, heads, num_transformer_block,
                                                          max_len, groups)

    def forward(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        return self.temporal_transformer(x, frames)
