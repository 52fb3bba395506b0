"""K2: forward-only flash attention with the exponential taken in bf16.

Counterpart of vexpress_tpu/ops/flash_lite.py (`flash_lite_fwd`, Pallas body
`_fwd_kernel`), which the JAX package's `flash_sdpa` takes in place of the
library kernel when VEXPRESS_FLASH_LITE=1. On the card K2 is the LITE variant
of csrc/flash_fwd.cu (`vx_flash_fwd_tma` with `lite`), launched by
`flash.flash_sdpa`; this module holds its plain version, which `flash_sdpa`
runs on CPU tensors and `chip_smoke.py` holds the kernel against, and
`lite_packed_exp`, the rounding of the bf16 kernel's packed exp.

What K2 computes, per (batch, head), over keys in blocks of bk = min(512, Lk):
  q_s = q * scale, the scale cast to q's dtype and the product rounded to it;
  s = q_s k^T in fp32; m_new = max(m, rowmax(s));
  p = exp(bf16(s - m_new)) rounded to bf16 (natural-log units), for fp32
  inputs too; corr = exp(m - m_new) in fp32;
  l = l corr + sum(fp32(p)); acc = acc corr + p v in fp32;
  out = acc / l in q's dtype.
The bf16 kernel takes p as 2^x on packed bf16 pairs (ex2.approx.ftz.bf16x2),
x = bf16(bf16(s - m_new) log2(e)): `lite_packed_exp`, which
`flash_lite_reference(..., packed_exp=True)` uses in place of the exp.
(x is formed from log2(e) split into two bf16; it differs by one bf16 ulp
from the rounded fp32 product for 1.2% of the bf16 inputs in [-88, 0].)
"""

from __future__ import annotations

from typing import Optional

import torch

from .launches import counts

BLOCK_K = 512  # the TPU kernel's key block
# log2(e) as the sum of two bf16 (csrc/flash_fwd_wgmma.cuh: LOG2E_HI2, LOG2E_LO2)
LOG2E_HI, LOG2E_LO = 1.4453125, -0.00262451171875
_LOGIT_BUDGET = 1 << 28  # fp32 (B, H, chunk, bk) logits per query chunk


def lite_supported(lq: int, lk: int, d: int) -> bool:
    """The shapes the JAX package sends to K2 (vexpress_tpu/ops/flash.py:63)."""
    return lq % min(2048, lq) == 0 and lk % min(BLOCK_K, lk) == 0 and d % 8 == 0


def lite_packed_exp(x: torch.Tensor) -> torch.Tensor:
    """K2's probability as the bf16 kernel computes it from x = s - m_new
    (fp32, natural-log units): y = bf16(x); z = bf16(y LOG2E_HI +
    bf16(y LOG2E_LO)), the product by log2(e) = LOG2E_HI + LOG2E_LO (both
    bf16) as the kernel's two bf16x2 FMAs form it (each product is exact in
    fp32, and so is their sum); then bf16(2^z), the power of two rounded to
    nearest as a correctly rounded ex2 would give it. In fp32."""
    y = x.to(torch.bfloat16).float()
    z = (y * LOG2E_HI + (y * LOG2E_LO).to(torch.bfloat16).float()).to(torch.bfloat16).float()
    return torch.exp2(z).to(torch.bfloat16).float()


def flash_lite_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                         scale: Optional[float] = None, block_k: int = BLOCK_K,
                         packed_exp: bool = False) -> torch.Tensor:
    """Plain torch version of K2 over packed (B, L, H*D) tensors, in the
    semantics of the module docstring with key blocks of min(block_k, Lk);
    with `packed_exp`, p is `lite_packed_exp(s - m_new)`. Queries run in
    chunks that bound the logits (rows are independent)."""
    counts["flash_lite_reference"] += 1
    b, lq, inner = q.shape
    lk = k.shape[1]
    d = inner // heads
    if scale is None:
        scale = d**-0.5
    bk = min(block_k, lk)
    if lk % bk:
        raise ValueError(f"flash_lite_reference: Lk={lk} is not a multiple of its block {bk}")
    q_s = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    qh = q_s.reshape(b, lq, heads, d).transpose(1, 2).float()
    kh = k.reshape(b, lk, heads, d).transpose(1, 2).float()
    vh = v.reshape(b, lk, heads, d).transpose(1, 2).float()
    q_chunk = max(1, _LOGIT_BUDGET // max(b * heads * bk, 1))
    outs = []
    for s0 in range(0, lq, q_chunk):
        qc = qh[:, :, s0 : s0 + q_chunk]
        m = torch.full(qc.shape[:3] + (1,), -torch.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape, device=q.device)
        for j in range(0, lk, bk):
            s = qc @ kh[:, :, j : j + bk].transpose(-1, -2)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            if packed_exp:
                p = lite_packed_exp(s - m_new)
            else:
                p = torch.exp((s - m_new).to(torch.bfloat16).float()).to(torch.bfloat16).float()
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p @ vh[:, :, j : j + bk]
            m = m_new
        outs.append(acc / l)
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, lq, inner).to(q.dtype)
