"""The 3D denoising UNet. Counterpart of vexpress_tpu/models/unet_3d.py.

SD1.5 topology inflated to video: per-frame spatial convs and attention
(frames folded into the batch), reference KV injection through attn1_5,
audio cross-attention through attn2, and AnimateDiff motion modules.

Public layout as in the JAX package: video tensors are (B, F, H, W, C),
reference features an ordered tuple of (B, L_p, C_p) tensors in
down -> mid -> up order. Inside, the conv stacks run NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import TimestepEmbedding, get_timestep_embedding
from .unet_blocks import DownBlock, MidBlock, UpBlock


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD1.5 UNet geometry + V-Express additions (unet_additional_kwargs)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 8  # SD1.5 naming: this is the HEAD COUNT
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    unet_use_temporal_attention: bool = False
    # "full": every cross-attn block fuses the reference bank (what V-Express
    # uses); "midup": mid and up blocks only, down blocks run the plain forward
    fusion_blocks: str = "full"
    use_motion_module: bool = True
    motion_module_mid_block: bool = True
    motion_num_attention_heads: int = 8
    motion_num_transformer_block: int = 1
    motion_max_len: int = 32
    # the port's training setting, in the configuration file; the reference
    # runs inference only and does not read it
    gradient_checkpointing: bool = False

    @classmethod
    def from_diffusers_json(cls, path: str, **overrides) -> "UNetConfig":
        """From a diffusers UNet2DConditionModel config.json (the reference's
        --unet_config_path, inference.py:30,77-90): geometry fields only; the
        V-Express additions come from `overrides`."""
        import json

        with open(path) as f:
            d = json.load(f)
        names = ("in_channels", "out_channels", "block_out_channels", "layers_per_block",
                 "attention_head_dim", "cross_attention_dim", "norm_num_groups", "norm_eps",
                 "flip_sin_to_cos", "freq_shift")
        kw = {k: tuple(d[k]) if isinstance(d[k], list) else d[k] for k in names if k in d}
        if isinstance(kw.get("attention_head_dim"), tuple):
            raise ValueError("per-block attention_head_dim lists (SDXL-style configs) are not "
                             "supported; V-Express uses the SD1.5 UNet geometry (uniform "
                             "attention_head_dim, reference inference.py:30)")
        kw.update(overrides)
        return cls(**kw)

    def __post_init__(self):
        if self.fusion_blocks not in ("full", "midup"):
            raise ValueError(f"fusion_blocks must be 'full' or 'midup', got {self.fusion_blocks!r}")

    @property
    def num_ref_features(self) -> int:
        """3*lp + 1 + 3*(lp+1) banks for "full", 1 + 3*(lp+1) for "midup"."""
        n_down = 3 * self.layers_per_block if self.fusion_blocks == "full" else 0
        return n_down + 1 + 3 * (self.layers_per_block + 1)

    def ref_feature_shapes(self, height: int, width: int) -> Tuple[Tuple[int, int], ...]:
        """(seq_len, channels) of each reference feature at latent res (h, w)."""
        shapes = []
        ch = self.block_out_channels
        if self.fusion_blocks == "full":
            for i in range(3):
                h, w = height >> i, width >> i
                shapes += [(h * w, ch[i])] * self.layers_per_block
        shapes.append(((height >> 3) * (width >> 3), ch[-1]))
        for j, i in enumerate((2, 1, 0)):
            h, w = height >> (2 - j), width >> (2 - j)
            shapes += [(h * w, ch[i])] * (self.layers_per_block + 1)
        return tuple(shapes)


def skip_channels(cfg: UNetConfig) -> List[int]:
    """Channels of the skip states the down path pushes, in push order."""
    ch = cfg.block_out_channels
    skips = [ch[0]]
    for i in range(4):
        skips += [ch[i]] * cfg.layers_per_block
        if i != 3:
            skips.append(ch[i])
    return skips


class UNetBody(nn.Module):
    """conv_in, down/mid/up blocks and the output head shared by both UNets."""

    def __init__(self, cfg: UNetConfig, temporal: bool):
        super().__init__()
        self.config = cfg
        ch = cfg.block_out_channels
        temb_ch = ch[0] * 4
        cross = cfg.cross_attention_dim
        common = dict(heads=cfg.attention_head_dim, temporal=temporal,
                      use_temporal_attention=temporal and cfg.unet_use_temporal_attention,
                      eps=cfg.norm_eps, groups=cfg.norm_num_groups)
        if temporal:
            common.update(use_motion=cfg.use_motion_module,
                          motion_heads=cfg.motion_num_attention_heads,
                          motion_blocks=cfg.motion_num_transformer_block,
                          motion_max_len=cfg.motion_max_len)

        self.time_embedding = TimestepEmbedding(ch[0], temb_ch)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            DownBlock(ch[max(i - 1, 0)], ch[i], temb_ch, cross, num_layers=cfg.layers_per_block,
                      has_attention=i != 3, add_downsample=i != 3, **common)
            for i in range(4)])
        mid_kw = dict(common)
        if temporal:
            mid_kw["use_motion"] = cfg.use_motion_module and cfg.motion_module_mid_block
        self.mid_block = MidBlock(ch[-1], temb_ch, cross, num_layers=1, **mid_kw)
        skips = skip_channels(cfg)
        rev = list(reversed(ch))
        ups = []
        prev = ch[-1]
        for i in range(4):
            use, skips = skips[-(cfg.layers_per_block + 1):], skips[:-(cfg.layers_per_block + 1)]
            ups.append(UpBlock(prev, rev[i], list(reversed(use)), temb_ch, cross,
                               has_attention=i != 0, add_upsample=i != 3, **common))
            prev = rev[i]
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[0], eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def time_embed(self, timesteps: torch.Tensor, b: int) -> torch.Tensor:
        cfg = self.config
        t = torch.as_tensor(timesteps, device=self.conv_in.weight.device).reshape(-1).expand(b)
        t_emb = get_timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                                       cfg.freq_shift).to(self.dtype)
        return self.time_embedding(t_emb)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class DenoisingUNet3D(UNetBody):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__(config, temporal=True)

    def forward(
        self,
        sample: torch.Tensor,  # (B, F, H, W, C_in) latent video
        timesteps: torch.Tensor,  # (B,) int
        audio_tokens: torch.Tensor,  # (B, F, L_audio, cross_dim)
        ref_features: Sequence[torch.Tensor],  # tuple of (B, L_p, C_p)
        kps_features: Optional[torch.Tensor] = None,  # (B, F, H, W, block0_ch)
        ref_scale=1.0,
        audio_scale=1.0,
        zero_uncond_kv: bool = False,  # CFG batches [uncond; cond] with zero uncond KV
    ) -> torch.Tensor:
        cfg = self.config
        if len(ref_features) != cfg.num_ref_features:
            raise ValueError(
                f"DenoisingUNet3D needs config.num_ref_features={cfg.num_ref_features} "
                f"reference features in down->mid->up order but got {len(ref_features)}; "
                f"see UNetConfig.ref_feature_shapes for the expected shapes.")
        b, f, h, w, c_in = sample.shape
        dt = self.dtype
        ch = cfg.block_out_channels
        temb = self.time_embed(timesteps, b).repeat_interleave(f, dim=0)  # (B*F, 4*ch0)

        x = sample.reshape(b * f, h, w, c_in).to(dt).permute(0, 3, 1, 2)
        ctx = audio_tokens.reshape(b * f, audio_tokens.shape[2], audio_tokens.shape[3]).to(dt)
        refs = tuple(r.to(dt) for r in ref_features)
        scales = (torch.as_tensor(ref_scale, dtype=dt, device=x.device),
                  torch.as_tensor(audio_scale, dtype=dt, device=x.device))

        x = self.conv_in(x)
        if kps_features is not None:
            x = x + kps_features.reshape(b * f, h, w, ch[0]).to(dt).permute(0, 3, 1, 2)

        lp = cfg.layers_per_block
        midup = cfg.fusion_blocks == "midup"

        cursor = 0
        skips = [x]
        for i, blk in enumerate(self.down_blocks):
            n_refs = 0 if (i == 3 or midup) else lp
            block_refs = None if (midup and i != 3) else refs[cursor : cursor + n_refs]
            cursor += n_refs
            x, states = blk(x, temb, ctx, block_refs, scales, f, zero_uncond_kv)
            skips.extend(states)

        x = self.mid_block(x, temb, ctx, refs[cursor : cursor + 1], scales, f,
                zero_uncond_kv)
        cursor += 1

        for i, blk in enumerate(self.up_blocks):
            n_refs = 0 if i == 0 else lp + 1
            block_refs = refs[cursor : cursor + n_refs]
            cursor += n_refs
            use, skips = skips[-(lp + 1):], skips[:-(lp + 1)]
            x = blk(x, list(use), temb, ctx, block_refs, scales, f, zero_uncond_kv)

        x = self.head(x)
        return x.permute(0, 2, 3, 1).reshape(b, f, h, w, cfg.out_channels)
