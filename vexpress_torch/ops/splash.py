"""T2: the splash-attention MHA forward with a full mask (the attention-variant
bench's splash rows).

Counterpart of tools/bench_attn_variants.py's `splash_at`, which runs the JAX
library's Pallas TPU splash attention (`make_splash_mha` over a
`MultiHeadMask` of `FullMask` per head), vmapped over the batch, on q already
multiplied by the scale. On the card the kernel is K1's bf16 forward
(csrc/flash_fwd_wgmma.cuh) in P mode SPLIT (csrc/splash_fwd.cu,
`vx_splash_mha_fwd`; the source note there says what bounds it and how it
keeps p unrounded), its launch geometry from `flash_tma.variant_geometry`;
this module holds the wrapper and the plain version.

What T2 computes, per (batch, head) over (B, H, L, D) tensors
(splash_attention_kernel.py:696-843 of the library): s = q k^T in fp32 with no
scale (the caller scaled q); fp32 running max m and sum l over key blocks;
p = exp(s - m) in fp32; acc += p v with v widened to fp32 and p not rounded;
out = acc / l once, at the end, in the input dtype. The mask is always full,
as the repo builds it, so there is no mask argument.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_tma
from .flash import _library, _raise_on, _stream
from .flash_variants import (blocked_attention, check_bhld, check_kernel_tensors,
                             check_library_tile, launch_geometry, padded_head_dim, strides_arg)
from .launches import counts, shapes

# (block_q, block_kv, padded head dim) of every instantiation in csrc/splash_fwd.cu
TILINGS = frozenset(flash_tma.T2_TILES)


def splash_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         block_kv: int = 64) -> torch.Tensor:
    """Plain torch version of T2 over (B, H, L, D) tensors: fp32 p into an
    fp32 P V over key blocks of min(block_kv, Lk), one division by l at the
    end."""
    check_bhld("splash_mha_reference", q, k, v)
    counts["splash_mha_reference"] += 1
    return blocked_attention(q, k, v, 1.0, block_kv, p_dtype=None)


def splash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, block_q: int = 64,
                   block_kv: int = 64, d_target: Optional[int] = None) -> torch.Tensor:
    """Full-mask splash MHA over (B, H, L, D) tensors, q already scaled.

    CUDA tensors launch csrc/splash_fwd.cu on the current stream: bf16, D =
    40, (block_q, block_kv, padded head dim) in `TILINGS`, block_q | Lq,
    block_kv | Lk, each tensor contiguous or a head-major view of a packed
    (B, L, H*D) one; anything else on the card raises. CPU tensors run
    `splash_mha_reference` with key blocks of `block_kv`."""
    check_bhld("splash_mha_fwd", q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dp = padded_head_dim(d, d_target)
    if q.device.type == "cpu":
        return splash_mha_reference(q, k, v, block_kv=block_kv)
    check_kernel_tensors("splash_mha_fwd", q, k, v)
    tiling = (block_q, block_kv, dp)
    if tiling not in TILINGS:
        raise ValueError(f"splash_mha_fwd has no instantiation for (block_q, block_kv, padded D) "
                         f"= {tiling}; it has {sorted(TILINGS)}")
    geom = launch_geometry("splash_mha_fwd", "t2", tiling, q, k)
    out = torch.empty_like(q)  # a head-major view's layout, for a packed q
    lib = _library()
    check_library_tile(lib, "t2", tiling)
    with torch.cuda.device(q.device):
        rc = lib.vx_splash_mha_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
                                   lq, lk, d, geom, strides_arg(out), block_q, block_kv, dp,
                                   _stream(q))
    _raise_on(rc, "T2 splash forward")
    counts["splash_fwd"] += 1
    shapes[("splash_fwd", b, h, lq, lk, d) + tiling] += 1
    return out
