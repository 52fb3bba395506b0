"""UNet down/mid/up blocks shared by the 2D reference net and the 3D denoising
net. Counterpart of vexpress_tpu/models/unet_blocks.py.

`temporal=False` builds reference-net blocks, whose transformer blocks emit
bank features; `temporal=True` builds denoising-net blocks, which consume
them (plus optional motion modules). Banks flow positionally in forward
order: down -> mid -> up.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from .blocks import Downsample, ResnetBlock, SpatialTransformer, Upsample
from .motion_module import TemporalMotionModule


class RefFeatures:
    """Cursor over the ordered reference bank features (read side) or
    accumulator (write side)."""

    def __init__(self, feats: Optional[Sequence[torch.Tensor]] = None):
        self.feats: List[torch.Tensor] = list(feats) if feats is not None else []
        self._cursor = 0

    def push(self, banks: Sequence[torch.Tensor]) -> None:
        self.feats.extend(banks)

    def pop(self) -> torch.Tensor:
        if self._cursor >= len(self.feats):
            raise ValueError(
                f"ran out of reference features: block requested feature #{self._cursor} "
                f"but only {len(self.feats)} were provided. The denoising UNet needs "
                f"config.num_ref_features tensors in down->mid->up order (see "
                f"UNetConfig.ref_feature_shapes).")
        feat = self.feats[self._cursor]
        self._cursor += 1
        return feat


def _ref_for(refs, i: int):
    if refs is None:
        return None
    return refs.pop() if isinstance(refs, RefFeatures) else refs[i]


class _BlockCommon(nn.Module):
    def _make(self, channels: int, heads: int, cross_attention_dim: int, temporal: bool,
              use_temporal_attention: bool, use_motion: bool, motion_heads: int,
              motion_blocks: int, motion_max_len: int, groups: int, n: int, has_attention: bool):
        self.temporal = temporal
        self.attentions = nn.ModuleList(
            [SpatialTransformer(channels, heads, cross_attention_dim, temporal=temporal,
                                use_temporal_attention=use_temporal_attention, groups=groups)
             for _ in range(n)]) if has_attention else None
        self.motion_modules = nn.ModuleList(
            [TemporalMotionModule(channels, motion_heads, motion_blocks, motion_max_len, groups)
             for _ in range(n)]) if (temporal and use_motion) else None

    def _attend(self, i, x, ctx, refs, scales, frames, zero_uncond_kv):
        if self.attentions is not None:
            st = self.attentions[i]
            if self.temporal:
                ref_i = _ref_for(refs, i)
                x = st(x, ctx, None if ref_i is None else (ref_i,), scales[0], scales[1],
                       zero_uncond_kv, frames)
            else:
                x, banks = st(x, ctx)
                if refs is not None:  # None: outside the fusion set, no capture
                    refs.push(banks)
        if self.motion_modules is not None:
            x = self.motion_modules[i](x, frames)
        return x


class DownBlock(_BlockCommon):
    """CrossAttnDownBlock{2,3}D / DownBlock{2,3}D."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 cross_attention_dim: int, num_layers: int = 2, heads: int = 8,
                 has_attention: bool = True, add_downsample: bool = True, temporal: bool = False,
                 use_temporal_attention: bool = False, use_motion: bool = False,
                 motion_heads: int = 8, motion_blocks: int = 1, motion_max_len: int = 32,
                 eps: float = 1e-5, groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_channels if i == 0 else out_channels, out_channels, eps, groups,
                         temb_channels) for i in range(num_layers)])
        self._make(out_channels, heads, cross_attention_dim, temporal, use_temporal_attention,
                   use_motion, motion_heads, motion_blocks, motion_max_len, groups, num_layers,
                   has_attention)
        self.downsamplers = (nn.ModuleList([Downsample(out_channels, out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, ctx, refs, scales, frames: int, zero_uncond_kv: bool = False):
        output_states = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            x = self._attend(i, x, ctx, refs, scales, frames, zero_uncond_kv)
            output_states.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            output_states.append(x)
        return x, output_states


class MidBlock(_BlockCommon):
    """UNetMidBlock{2,3}DCrossAttn."""

    def __init__(self, in_channels: int, temb_channels: int, cross_attention_dim: int,
                 num_layers: int = 1, heads: int = 8, temporal: bool = False,
                 use_temporal_attention: bool = False, use_motion: bool = False,
                 motion_heads: int = 8, motion_blocks: int = 1, motion_max_len: int = 32,
                 eps: float = 1e-5, groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_channels, in_channels, eps, groups, temb_channels)
             for _ in range(num_layers + 1)])
        self._make(in_channels, heads, cross_attention_dim, temporal, use_temporal_attention,
                   use_motion, motion_heads, motion_blocks, motion_max_len, groups, num_layers,
                   True)

    def forward(self, x, temb, ctx, refs, scales, frames: int, zero_uncond_kv: bool = False):
        x = self.resnets[0](x, temb)
        for i in range(len(self.attentions)):
            x = self._attend(i, x, ctx, refs, scales, frames, zero_uncond_kv)
            x = self.resnets[i + 1](x, temb)
        return x


class UpBlock(_BlockCommon):
    """CrossAttnUpBlock{2,3}D / UpBlock{2,3}D with skip concatenation.
    `skip_channels` lists the channels of the skips in the order they are
    popped."""

    def __init__(self, prev_channels: int, out_channels: int, skip_channels: Sequence[int],
                 temb_channels: int, cross_attention_dim: int, heads: int = 8,
                 has_attention: bool = True, add_upsample: bool = True, temporal: bool = False,
                 use_temporal_attention: bool = False, use_motion: bool = False,
                 motion_heads: int = 8, motion_blocks: int = 1, motion_max_len: int = 32,
                 eps: float = 1e-5, groups: int = 32):
        super().__init__()
        n = len(skip_channels)
        self.resnets = nn.ModuleList(
            [ResnetBlock((prev_channels if i == 0 else out_channels) + skip_channels[i],
                         out_channels, eps, groups, temb_channels) for i in range(n)])
        self._make(out_channels, heads, cross_attention_dim, temporal, use_temporal_attention,
                   use_motion, motion_heads, motion_blocks, motion_max_len, groups, n,
                   has_attention)
        self.upsamplers = (nn.ModuleList([Upsample(out_channels, out_channels)])
                           if add_upsample else None)

    def forward(self, x, skips: List[torch.Tensor], temb, ctx, refs, scales, frames: int,
                zero_uncond_kv: bool = False):
        skips = list(skips)  # popped below; a checkpoint recompute passes the same list again
        for i, resnet in enumerate(self.resnets):
            x = torch.cat([x, skips.pop()], dim=1)
            x = resnet(x, temb)
            x = self._attend(i, x, ctx, refs, scales, frames, zero_uncond_kv)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x
