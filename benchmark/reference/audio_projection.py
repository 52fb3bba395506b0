"""Audio projection: a perceiver resampler turning 10 wav2vec2 frame
embeddings into 5 audio tokens per video frame. Counterpart of
vexpress_tpu/models/audio_projection.py; keys follow the torch checkpoint
(layers.{i}.0 attention, layers.{i}.1.{0,1,3} feed-forward)."""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import gelu_feed_forward


class PerceiverAttention(nn.Module):
    """Queries from the latents, keys/values from concat(x, latents); the
    dim_head**-0.5 logit scale is split as two fourth roots on q and k."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, l, _ = latents.shape
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)

        def split_heads(t):
            return t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        scale = 1.0 / math.sqrt(math.sqrt(self.dim_head))
        logits = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), (k * scale).float())
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        return self.to_out(out.transpose(1, 2).reshape(b, l, -1))


class AudioProjection(nn.Module):
    def __init__(self, dim: int = 768, depth: int = 4, dim_head: int = 64, heads: int = 12,
                 num_queries: int = 5, embedding_dim: int = 768, output_dim: int = 768,
                 ff_mult: int = 4, max_seq_len: int = 10):
        super().__init__()
        self.pos_emb = nn.Embedding(max_seq_len, embedding_dim)
        self.latents = nn.Parameter(torch.randn(1, num_queries, dim) * dim**-0.5)
        self.proj_in = nn.Linear(embedding_dim, dim)
        self.layers = nn.ModuleList([
            nn.ModuleList([PerceiverAttention(dim, dim_head, heads),
                           gelu_feed_forward(dim, ff_mult)])
            for _ in range(depth)])
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = nn.LayerNorm(output_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, seq <= max_seq_len, embedding_dim) -> (N, num_queries, output_dim)."""
        n, seq, _ = x.shape
        dt = self.proj_in.weight.dtype
        x = x.to(dt) + self.pos_emb.weight[None, :seq]
        latents = self.latents.expand(n, -1, -1)
        x = self.proj_in(x)
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return self.norm_out(self.proj_out(latents))
