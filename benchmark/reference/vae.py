"""AutoencoderKL (sd-vae-ft-mse geometry). Counterpart of
vexpress_tpu/models/vae.py: encoder (4 down blocks + attention mid block),
decoder (attention mid block + 4 up blocks), quant/post-quant 1x1 convs.
Public methods take and return channels-last (N, H, W, C) as in the JAX
package; inside, everything runs NCHW. The mid-block attention is a plain
single-head softmax attention. Latent scaling is the pipeline's job."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ResnetBlock, Upsample


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


class VAEDownsample(nn.Module):
    """Asymmetric (right/bottom) pad, then a stride-2 VALID conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAEAttention(nn.Module):
    """Single-head self-attention of the mid block (q/k/v with bias)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        hs = self.group_norm(x).permute(0, 2, 3, 1).reshape(n, h * w, c)
        q, k, v = self.to_q(hs), self.to_k(hs), self.to_v(hs)
        logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * (c**-0.5)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        hs = self.to_out[0](torch.einsum("bqk,bkc->bqc", weights, v))
        return hs.reshape(n, h, w, c).permute(0, 3, 1, 2) + x


class MidBlockVAE(nn.Module):
    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels, 1e-6, groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class DownEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int, groups: int,
                 add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels, 1e-6, groups)
            for j in range(layers)])
        self.downsamplers = (nn.ModuleList([VAEDownsample(out_channels)])
                             if add_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int, groups: int,
                 add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels, 1e-6, groups)
            for j in range(layers)])
        self.upsamplers = (nn.ModuleList([Upsample(out_channels, out_channels)])
                           if add_upsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block, g, i < len(ch) - 1)
            for i in range(len(ch))])
        self.mid_block = MidBlockVAE(ch[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_block = MidBlockVAE(ch[0], g)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block + 1, g, i < len(ch) - 1)
            for i in range(len(ch))])
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, H, W, 3) in [-1, 1] -> posterior (mean, logvar), each
        (N, H/8, W/8, 4); logvar clipped to [-30, 20]."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        moments = self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) in [-1, 1] -> posterior mean (N, H/8, W/8, 4)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        moments = self.quant_conv(self.encoder(x))
        mean = moments[:, : self.config.latent_channels]
        return mean.permute(0, 2, 3, 1)

    def encode_sample(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A sample of the posterior: mean + exp(logvar / 2) * noise, with
        `noise` (N, H/8, W/8, 4) given or drawn from `generator`."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(N, h, w, 4) -> (N, H, W, 3) in [-1, 1]."""
        z = z.to(self.dtype).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
