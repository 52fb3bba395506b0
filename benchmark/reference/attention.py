"""Plain multi-head attention for the reference models: softmax(QK^T)V in
fp32 with explicit matmuls, no fused or hand-written kernel. The module
layout (to_q, to_k, to_v, to_out.0) and the zero-KV CFG shortcut follow
vexpress_torch/ops/attention.py, so the same weights load into both."""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

# the logits of one query chunk, (b, heads, chunk, lk) fp32, stay under this
LOGIT_BUDGET = 1 << 28


def _attend(q, k, v, scale):
    """(B, Lq, H, D) x (B, Lk, H, D) -> (B, Lq, H, D)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Attention over (B, L, H*D) tensors, the queries in chunks that bound
    the logits (each chunk sees every key, so the result is exact)."""
    b, lq, inner = q.shape
    lk = k.shape[1]
    d = inner // heads
    q, k, v = (t.reshape(t.shape[0], t.shape[1], heads, d) for t in (q, k, v))
    chunk = max(1, min(lq, LOGIT_BUDGET // max(b * heads * lk, 1)))
    outs = [_attend(q[:, s : s + chunk], k, v, d**-0.5) for s in range(0, lq, chunk)]
    return torch.cat(outs, dim=1).reshape(b, lq, inner)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, frames: int,
                       heads: int) -> torch.Tensor:
    """Self-attention across the frames of (b*f, d, heads*e) tensors."""
    bf, d_tok, inner = q.shape
    b, e = bf // frames, inner // heads

    def split(t):  # (b*f, d, h*e) -> (b*d, f, h*e)
        return t.reshape(b, frames, d_tok, inner).transpose(1, 2).reshape(b * d_tok, frames, inner)

    o = sdpa(split(q), split(k), split(v), heads)
    return o.reshape(b, d_tok, frames, inner).transpose(1, 2).reshape(bf, d_tok, inner)


class Attention(nn.Module):
    """diffusers-style attention: to_q/to_k/to_v (no bias), to_out.0 (bias)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None, qkv_bias: bool = False,
                 out_bias: bool = True):
        super().__init__()
        inner = heads * dim_head
        kv_dim = query_dim if cross_attention_dim is None else cross_attention_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def _attend(self, hs: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        q, k, v = self.to_q(hs), self.to_k(kv), self.to_v(kv)
        if k.shape[0] != q.shape[0]:
            # one KV bank (the reference features) shared by every frame
            reps = q.shape[0] // k.shape[0]
            k, v = (t.repeat_interleave(reps, dim=0) for t in (k, v))
        return sdpa(q, k, v, self.heads)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                zero_kv_first_half: bool = False,
                temporal_frames: Optional[int] = None) -> torch.Tensor:
        if temporal_frames is not None:
            x = hidden_states
            o = temporal_attention(self.to_q(x), self.to_k(x), self.to_v(x), temporal_frames,
                                   self.heads)
            return self.to_out[0](o)
        kv = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        # zero_kv_first_half is a shortcut of the program's; the reference
        # attends to the zero keys and values as they are
        return self.to_out[0](self._attend(hidden_states, kv))
