"""Wav2Vec2 audio encoder (wav2vec2-base-960h geometry). Counterpart of
vexpress_tpu/models/wav2vec2.py: conv feature extractor (GroupNorm on the
first layer) -> feature projection -> grouped positional conv -> post-LN
transformer layers. Module names follow the transformers checkpoint keys
(feature_extractor.conv_layers.{i}.conv, encoder.layers.{i}.attention.q_proj,
...); the positional conv holds its effective weight, not weight-norm parts.
Waveforms are (B, T); outputs (B, frames, hidden)."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

import torch
from torch import nn

from .layers import gelu


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    do_normalize: bool = True  # waveform zero-mean/unit-var (processor)

    def num_output_frames(self, num_samples: int) -> int:
        n = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


def normalize_waveform(waveform: torch.Tensor) -> torch.Tensor:
    """Per-utterance zero-mean unit-variance normalization (the processor's)."""
    mean = waveform.mean(dim=-1, keepdim=True)
    var = waveform.var(dim=-1, keepdim=True, unbiased=False)
    return (waveform - mean) / torch.sqrt(var + 1e-7)


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, s: int, norm: bool, eps: float):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, stride=s, bias=False)
        # GroupNorm(num_groups=channels): per-channel normalization over time
        self.layer_norm = nn.GroupNorm(c_out, c_out, eps=eps) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return gelu(x)


class FeatureEncoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList([
            _ConvLayer(dims[i], dims[i + 1], k, s, i == 0, cfg.layer_norm_eps)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) waveform -> (B, frames, conv_dim[-1])."""
        h = x[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class _FeedForward(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(d, inner)
        self.output_dense = nn.Linear(inner, d)


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (do_stable_layer_norm=False)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.attention = _SelfAttention(d)
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(d, cfg.intermediate_size)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads
        a = self.attention
        q = (a.q_proj(x) * hd**-0.5).reshape(b, t, self.heads, hd)
        k = a.k_proj(x).reshape(b, t, self.heads, hd)
        v = a.v_proj(x).reshape(b, t, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, t, d)
        x = self.layer_norm(x + a.out_proj(attn))
        ff = self.feed_forward.output_dense(gelu(self.feed_forward.intermediate_dense(x)))
        return self.final_layer_norm(x + ff)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.drop_last = k % 2 == 0  # SamePad for an even kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = self.conv(x.transpose(1, 2))
        if self.drop_last:
            pos = pos[:, :, :-1]
        return gelu(pos).transpose(1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList([EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm(h + self.pos_conv_embed(h))
        for layer in self.layers:
            h = layer(h)
        return h


class Wav2Vec2Model(nn.Module):
    def __init__(self, config: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        self.config = config
        self.feature_extractor = FeatureEncoder(config)
        self.feature_projection = FeatureProjection(config)
        self.encoder = Encoder(config)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        """waveform: (B, T) raw 16 kHz audio -> last_hidden_state (B, frames, hidden)."""
        waveform = waveform.to(self.feature_projection.projection.weight.dtype)
        if self.config.do_normalize:
            waveform = normalize_waveform(waveform)
        feats = self.feature_extractor(waveform)
        return self.encoder(self.feature_projection(feats))


def convert_wav2vec2_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """transformers Wav2Vec2Model.state_dict() -> this module's state dict.
    The keys are the same; the weight-normed positional conv (weight_g and
    weight_v, or the parametrizations' original0/original1) becomes its
    effective weight g * v / ||v||, the norm over dims (0, 1) per kernel tap
    (torch weight_norm with dim=2), in fp32; masked_spec_embed is dropped."""
    sd = {k: torch.as_tensor(v).float() for k, v in state_dict.items()
          if not k.endswith("masked_spec_embed")}
    pat = r"pos_conv_embed\.conv\.(weight_g|parametrizations\.weight\.original0)$"
    g_key = next((k for k in sd if re.search(pat, k)), None)
    v_key = next((k for k in sd if re.search(pat.replace("weight_g", "weight_v")
                                              .replace("original0", "original1"), k)), None)
    if g_key and v_key:
        g, v = sd.pop(g_key), sd.pop(v_key)
        norm = torch.sqrt((v**2).sum(dim=(0, 1), keepdim=True))
        sd["encoder.pos_conv_embed.conv.weight"] = g * v / norm
    return sd
