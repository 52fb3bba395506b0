"""The 2D reference net. Counterpart of vexpress_tpu/models/unet_2d.py: an
SD1.5 UNet run once on the reference latent at t=0 that returns, beside its
sample, the norm2 hidden state of every transformer block (16 banks for SD1.5)
in down -> mid -> up order. Its conv_norm_out/conv_out head is kept so a
checkpoint loads strictly."""

from __future__ import annotations

from typing import Tuple

import torch

from .unet_3d import UNetBody, UNetConfig
from .unet_blocks import RefFeatures


class ReferenceUNet2D(UNetBody):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__(config, temporal=False)

    def forward(
        self,
        sample: torch.Tensor,  # (B, H, W, C_in) reference latent
        timesteps: torch.Tensor,  # (B,) int, always 0 in V-Express
        encoder_hidden_states: torch.Tensor,  # (B, L, cross_dim)
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        cfg = self.config
        b = sample.shape[0]
        dt = self.dtype
        temb = self.time_embed(timesteps, b)
        x = sample.to(dt).permute(0, 3, 1, 2)
        ctx = encoder_hidden_states.to(dt)
        refs = RefFeatures()

        x = self.conv_in(x)
        skips = [x]
        # midup fusion never reads the down-block banks, so they are not captured
        down_refs = refs if cfg.fusion_blocks == "full" else None
        for blk in self.down_blocks:
            x, states = blk(x, temb, ctx, down_refs, None, 1)
            skips.extend(states)
        x = self.mid_block(x, temb, ctx, refs, None, 1)
        n_skips = cfg.layers_per_block + 1
        for blk in self.up_blocks:
            use, skips = skips[-n_skips:], skips[:-n_skips]
            x = blk(x, list(use), temb, ctx, refs, None, 1)
        x = self.head(x)
        return x.permute(0, 2, 3, 1), tuple(refs.feats)
