"""V-Kps Guider: encodes rendered keypoint images to a latent-resolution
feature added after the denoising UNet's conv_in. Counterpart of
vexpress_tpu/models/vkps_guider.py: conv_in -> 3x(conv, stride-2 conv) ->
conv_out, SiLU between convs, per-frame 2D convs with frames in the batch."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class VKpsGuider(nn.Module):
    def __init__(self, conditioning_embedding_channels: int = 320,
                 block_out_channels: Tuple[int, ...] = (16, 32, 96, 256),
                 conditioning_channels: int = 3):
        super().__init__()
        chans = block_out_channels
        self.conv_in = nn.Conv2d(conditioning_channels, chans[0], 3, padding=1)
        blocks = []
        for i in range(len(chans) - 1):
            blocks.append(nn.Conv2d(chans[i], chans[i], 3, padding=1))
            blocks.append(nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(chans[-1], conditioning_embedding_channels, 3, padding=1)

    def forward(self, kps_images: torch.Tensor) -> torch.Tensor:
        """kps_images: (B, F, H, W, 3) in [0, 1] -> (B, F, H/8, W/8, C)."""
        b, f, h, w, c = kps_images.shape
        x = kps_images.reshape(b * f, h, w, c).to(self.conv_in.weight.dtype).permute(0, 3, 1, 2)
        x = F.silu(self.conv_in(x))
        for blk in self.blocks:
            x = F.silu(blk(x))
        x = self.conv_out(x)
        return x.permute(0, 2, 3, 1).reshape(b, f, x.shape[2], x.shape[3], x.shape[1])
