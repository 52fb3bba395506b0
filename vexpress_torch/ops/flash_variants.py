"""T1: K1's forward at other tilings (the attention-variant bench's rows).

Counterpart of tools/bench_attn_variants.py's `flash_at` and `flash_bb`,
which run the JAX library's Pallas TPU `flash_attention` at other
`BlockSizes` (block_b 1, 2, 4; block_q and block_k 512 to 2048) and with the
head dim zero-padded to 64 or 128. On the card the kernel is K1's bf16
forward (csrc/flash_fwd_wgmma.cuh: TMA, an mbarrier ring, wgmma) with its
tiling as template parameters (csrc/flash_variants.cu, `vx_flash_fwd_variant`;
the source note there says what bounds it and what the tiling does), its
launch geometry from `flash_tma.variant_geometry`; this module holds the
wrapper and the plain version.

What T1 computes, per (batch, head) over (B, H, L, D) tensors, is the
library forward's function: s = q k^T in fp32 times `scale`; fp32 running max
m and sum l over key blocks; p = exp(s - m) in fp32, summed into l unrounded
and rounded to the input dtype for P V (flash_attention.py:471 of the
library); out = acc / l in the input dtype. Zero head-dim padding changes no
logit and no kept output column, so `d_target` selects the kernel's
instantiation and leaves the function as it is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import flash_tma
from .flash import _check_tiling, _library, _raise_on, _stream
from .launches import counts, shapes

HEAD_DIM = flash_tma.VARIANT_HEAD_DIM  # the bench's head dim, the only one instantiated
# (block_q, block_k, padded head dim, heads_per_block) of every instantiation
# in csrc/flash_variants.cu
TILINGS = frozenset(flash_tma.T1_TILES)
_LOGIT_BUDGET = 1 << 28  # fp32 (B, H, chunk, block_k) logits per query chunk
_tiles_checked = {"t1": set(), "t2": set()}  # tilings whose library tile was checked


def padded_head_dim(d: int, d_target: Optional[int]) -> int:
    """The head dim the kernel computes with: d_target (default d) rounded
    up to the mma depth 16 (40 -> 48, 64, 128)."""
    d_target = d if d_target is None else d_target
    if d_target < d:
        raise ValueError(f"d_target={d_target} is below the head dim {d}")
    return -(-d_target // 16) * 16


def check_bhld(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """(B, H, L, D) q and k, v of one shape, one dtype and one device."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name} takes (B, H, L, D) tensors, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v disagree in dtype or device: {q.dtype}, {k.dtype}, "
                         f"{v.dtype} on {q.device}, {k.device}, {v.device}")


def check_kernel_tensors(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the T1 and T2 kernels take besides their tiling and the maps'
    rules (`flash_tma.tma_violations`): bf16, D = 40, 16-byte aligned
    tensors with a contiguous head dim on one CUDA device, k and v of one
    layout. (B, H, L, D) tensors and head-major views of packed (B, L, H*D)
    ones both qualify."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name} kernel takes bfloat16, got {q.dtype}")
    if q.shape[3] != HEAD_DIM:
        raise ValueError(f"{name} kernel is instantiated for head dim {HEAD_DIM}, got {q.shape[3]}")
    for t_name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs 16-byte aligned tensors with a contiguous "
                             f"head dim ({t_name})")
    if k.stride() != v.stride():
        raise ValueError(f"{name} kernel needs k and v of one layout, got strides {k.stride()} "
                         f"and {v.stride()}")


def strides_arg(*tensors: torch.Tensor):
    """(batch, head, row) element strides of each tensor, as the kernels read them."""
    st = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(st))(*st)


@functools.lru_cache(maxsize=256)
def _variant_geometry(name: str, kind: str, tiling: tuple, shape: tuple, q_strides: tuple,
                      kv_strides: tuple):
    """flash_tma's geometry of one T1 (`kind` "t1") or T2 ("t2") launch, as
    the library reads it, once per tiling, shape and layout; raises where TMA
    or the kernel cannot take it."""
    geom = flash_tma.variant_geometry(kind, tiling, *shape, q_strides, kv_strides)
    bad = flash_tma.tma_violations(geom)
    if bad:
        raise ValueError(f"{name} kernel cannot take this launch: " + "; ".join(bad))
    return flash_tma.variant_geometry_arg(geom)


def launch_geometry(name: str, kind: str, tiling: tuple, q: torch.Tensor, k: torch.Tensor):
    """The geometry argument of a T1 or T2 launch over q and k (v has k's layout)."""
    b, h, lq, d = q.shape
    return _variant_geometry(name, kind, tiling, (b, h, lq, k.shape[2], d), q.stride()[:3],
                             k.stride()[:3])


def check_library_tile(lib, kind: str, tiling: tuple) -> None:
    """Before the first launch at `tiling`: the library's instantiation
    (vx_flash_fwd_variant_tile or vx_splash_mha_tile) has flash_tma's tiling."""
    entry, what = (("vx_flash_fwd_variant_tile", "T1 variant forward") if kind == "t1"
                   else ("vx_splash_mha_tile", "T2 splash forward"))
    _check_tiling(lib, tuple(tiling), entry, flash_tma.VARIANT_TILE_FIELDS,
                  lambda *t: flash_tma.variant_tile(kind, t), _tiles_checked[kind], what)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      block_k: int, p_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Online-softmax attention over (B, H, L, D) tensors in fp32, as the
    library's TPU kernels compute it: logits q k^T times `scale` over key
    blocks of min(block_k, Lk), running max m and sum l, p = exp(s - m) summed
    into l unrounded and rounded to `p_dtype` (None: kept fp32) for P V, one
    division by l at the end, the result in q's dtype. Queries run in chunks
    that bound the logits (rows are independent)."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    bk = min(block_k, lk)
    if lk % bk:
        raise ValueError(f"Lk={lk} is not a multiple of the key block {bk}")
    kf, vf = k.float(), v.float()
    q_chunk = max(1, _LOGIT_BUDGET // max(b * h * bk, 1))
    outs = []
    for s0 in range(0, lq, q_chunk):
        qc = q[:, :, s0 : s0 + q_chunk].float()
        m = torch.full(qc.shape[:3] + (1,), -torch.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape, device=q.device)
        for j in range(0, lk, bk):
            s = (qc @ kf[:, :, j : j + bk].transpose(-1, -2)) * scale
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            if p_dtype is not None:
                p = p.to(p_dtype).float()
            acc = acc * corr + p @ vf[:, :, j : j + bk]
            m = m_new
        outs.append(acc / l)
    return torch.cat(outs, dim=2).to(q.dtype)


def flash_fwd_variant_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                                *, block_k: int = 64) -> torch.Tensor:
    """Plain torch version of T1 over (B, H, L, D) tensors, in the semantics of
    the module docstring with key blocks of min(block_k, Lk)."""
    check_bhld("flash_fwd_variant_reference", q, k, v)
    counts["flash_fwd_variant_reference"] += 1
    return blocked_attention(q, k, v, scale, block_k, p_dtype=v.dtype)


def flash_fwd_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *,
                      block_q: int = 64, block_k: int = 64, heads_per_block: int = 1,
                      d_target: Optional[int] = None) -> torch.Tensor:
    """Non-causal attention over (B, H, L, D) tensors at one of T1's tilings.

    CUDA tensors launch csrc/flash_variants.cu on the current stream: bf16,
    D = 40, (block_q, block_k, padded head dim, heads_per_block) in `TILINGS`,
    block_q | Lq, block_k | Lk, heads_per_block | B*H, each tensor contiguous
    or a head-major view of a packed (B, L, H*D) one; anything else on the
    card raises. CPU tensors run `flash_fwd_variant_reference` with key
    blocks of `block_k`."""
    check_bhld("flash_fwd_variant", q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dp = padded_head_dim(d, d_target)
    if q.device.type == "cpu":
        return flash_fwd_variant_reference(q, k, v, scale, block_k=block_k)
    check_kernel_tensors("flash_fwd_variant", q, k, v)
    tiling = (block_q, block_k, dp, heads_per_block)
    if tiling not in TILINGS:
        raise ValueError(f"flash_fwd_variant has no instantiation for (block_q, block_k, "
                         f"padded D, heads_per_block) = {tiling}; it has {sorted(TILINGS)}")
    geom = launch_geometry("flash_fwd_variant", "t1", tiling, q, k)
    out = torch.empty_like(q)  # a head-major view's layout, for a packed q
    lib = _library()
    check_library_tile(lib, "t1", tiling)
    with torch.cuda.device(q.device):
        rc = lib.vx_flash_fwd_variant(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      b, h, lq, lk, d, geom, strides_arg(out), float(scale),
                                      block_q, block_k, dp, heads_per_block, _stream(q))
    _raise_on(rc, "T1 variant forward")
    counts["flash_fwd_variant"] += 1
    shapes[("flash_fwd_variant", b, h, lq, lk, d) + tiling] += 1
    return out
