"""Multi-head attention primitives.

Counterpart of vexpress_tpu/ops/attention.py. The four attention flavors of
the V-Express stack (spatial self-attention, reference KV injection attn1_5,
audio cross-attention attn2, temporal motion attention) reduce to `sdpa` over
(batch, seq, heads*dim) tensors, with the softmax in fp32 whatever the compute
dtype. `sdpa` sends the shapes that vexpress_tpu sends to its Pallas flash
kernel (Lq and Lk multiples of 128, Lk >= 512) to `flash.flash_sdpa`, which
launches the Hopper kernel for CUDA tensors; every other shape runs as plain
torch matmuls and softmax.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .flash import flash_sdpa, flash_supported

# bound the fp32 logits transient (b, heads, chunk, lk) of the plain path
_LOGIT_BUDGET = 1 << 28


def _flash_eligible(lq: int, lk: int) -> bool:
    return flash_supported(lq, lk) and lk >= 512


def _attend(q, k, v, scale):
    """(B, Lq, H, D) x (B, Lk, H, D) -> (B, Lq, H, D), fp32 softmax."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _attend_tiny_kv(q, k, v, scale):
    """Exact attention for very short KV (audio attn2: 5 tokens): the Lk axis
    is unrolled, so everything stays (B, Lq, H, D)-shaped. Softmax in fp32."""
    lk = k.shape[1]
    qf, kf = q.float(), k.float()
    logits = [(qf * kf[:, j][:, None]).sum(-1) * scale for j in range(lk)]  # (B, Lq, H)
    m = logits[0]
    for j in range(1, lk):
        m = torch.maximum(m, logits[j])
    exps = [torch.exp(lg - m) for lg in logits]
    denom = exps[0]
    for j in range(1, lk):
        denom = denom + exps[j]
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j in range(lk):
        out = out + (exps[j] / denom)[..., None] * v[:, j].float()[:, None]
    return out.to(v.dtype)


def _attend_short(q, k, v, scale):
    """`_attend` for short sequences (Lq, Lk <= 64), one head at a time."""
    outs = []
    for i in range(q.shape[2]):
        logits = torch.einsum("bqd,bkd->bqk", q[:, :, i].float(), k[:, :, i].float())
        weights = torch.softmax(logits * scale, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bqk,bkd->bqd", weights, v[:, :, i]))
    return torch.stack(outs, dim=2)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    q_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over (B, L, H*D) tensors; fp32 softmax,
    output in the input dtype. Long query sequences on the plain path run in
    chunks (exact: each chunk sees all keys)."""
    b, lq, inner = q.shape
    lk = k.shape[1]
    d = inner // heads
    if scale is None:
        scale = d**-0.5

    if q_chunk is None and _flash_eligible(lq, lk):
        return flash_sdpa(q, k, v, heads, scale)

    q = q.reshape(b, lq, heads, d)
    k = k.reshape(b, lk, heads, d)
    v = v.reshape(b, lk, heads, d)

    if q_chunk is None:
        if b * heads * lq * lk > _LOGIT_BUDGET:
            q_chunk = max(128, _LOGIT_BUDGET // max(b * heads * lk, 1))
        else:
            q_chunk = lq

    if q_chunk >= lq:
        if lk <= 8 and lq > 64:
            attend = _attend_tiny_kv
        elif lq <= 64 and lk <= 64:
            attend = _attend_short
        else:
            attend = _attend
        return attend(q, k, v, scale).reshape(b, lq, inner)

    outs = [_attend(q[:, s : s + q_chunk], k, v, scale) for s in range(0, lq, q_chunk)]
    return torch.cat(outs, dim=1).reshape(b, lq, inner)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, frames: int,
                       heads: int) -> torch.Tensor:
    """Self-attention across frames without the (b f) d c -> (b d) f c
    rearrange: q, k, v stay (b*f, d, heads*e) and the frame axis rides in
    the per-head einsums; fp32 softmax, output in v's dtype."""
    bf, d_tok, inner = q.shape
    b, e = bf // frames, inner // heads
    outs = []
    for i in range(heads):
        sl = slice(i * e, (i + 1) * e)
        qh = q[:, :, sl].reshape(b, frames, d_tok, e)
        kh = k[:, :, sl].reshape(b, frames, d_tok, e)
        vh = v[:, :, sl].reshape(b, frames, d_tok, e)
        logits = torch.einsum("bqde,bkde->bdqk", qh.float(), kh.float())
        w = torch.softmax(logits * e**-0.5, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bdqk,bkde->bqde", w, vh))
    return torch.stack(outs, dim=3).reshape(bf, d_tok, inner)


class Attention(nn.Module):
    """Multi-head attention mirroring diffusers `Attention`: to_q/to_k/to_v
    (no bias), to_out.0 (bias)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None, qkv_bias: bool = False,
                 out_bias: bool = True):
        super().__init__()
        inner = heads * dim_head
        kv_dim = query_dim if cross_attention_dim is None else cross_attention_dim
        self.heads, self.dim_head, self.qkv_bias = heads, dim_head, qkv_bias
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def _temporal(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        """Self-attention across frames of x (b*f, d, c) (`temporal_attention`)."""
        o = temporal_attention(self.to_q(x), self.to_k(x), self.to_v(x), frames, self.heads)
        return self.to_out[0](o)

    def _attend(self, hs: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        q, k, v = self.to_q(hs), self.to_k(kv), self.to_v(kv)
        if k.shape[0] != q.shape[0]:
            # KV shared across a folded query axis (the reference bank shared
            # by all frames): group the queries instead of copying the KV
            bq, lq, inner = q.shape
            bkv = k.shape[0]
            if bq % bkv:
                raise ValueError(f"query batch {bq} not a multiple of kv batch {bkv}")
            out = sdpa(q.reshape(bkv, (bq // bkv) * lq, inner), k, v, self.heads)
            return out.reshape(bq, lq, inner)
        return sdpa(q, k, v, self.heads)

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        zero_kv_first_half: bool = False,
        temporal_frames: Optional[int] = None,
    ) -> torch.Tensor:
        if temporal_frames is not None:
            if encoder_hidden_states is not None or zero_kv_first_half:
                raise ValueError("temporal attention is self-attention without the CFG shortcut")
            return self._temporal(hidden_states, temporal_frames)
        kv = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        to_out = self.to_out[0]
        if zero_kv_first_half:
            # CFG batches [uncond; cond] whose uncond KV inputs are all zero:
            # with bias-free to_k/to_v, K = V = 0, the uniform softmax times
            # V is 0, and that half's output is to_out's bias exactly
            if self.qkv_bias:
                raise ValueError("the zero-KV shortcut requires bias-free to_k/to_v")
            bq, bkv = hidden_states.shape[0], kv.shape[0]
            if bq % 2 or bkv % 2:
                raise ValueError(f"CFG batches must be even, got {bq}, {bkv}")
            out_c = to_out(self._attend(hidden_states[bq // 2 :], kv[bkv // 2 :]))
            inner = self.heads * self.dim_head
            bias_row = to_out(torch.zeros((1, 1, inner), dtype=out_c.dtype, device=out_c.device))
            return torch.cat([bias_row.expand(out_c.shape), out_c], dim=0)
        return to_out(self._attend(hidden_states, kv))
