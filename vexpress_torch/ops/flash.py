"""Flash attention: the hand-written Hopper kernels and their plain versions.

Counterpart of vexpress_tpu/ops/flash.py, whose `flash_sdpa` calls the JAX
library's Pallas TPU flash-attention kernel (and, under a gradient, its two
backward kernels). Here the kernels are `csrc/flash_fwd.cu` (forward, with an
optional log-sum-exp output: bf16 through TMA and wgmma,
`csrc/flash_fwd_wgmma.cuh`, with its host-side geometry in `flash_tma.py`;
fp32 through TMA and tf32 wgmma at fp32's accuracy, each operand split into
two tf32 parts, `csrc/flash_fwd_tf32.cuh`, `split_tf32` below its
arithmetic) and `csrc/flash_bwd.cu` (dk/dv and dq: bf16 through TMA and
wgmma, `csrc/flash_bwd_wgmma.cuh`, with its host geometry in `flash_tma.py`
too; fp32 through TMA and tf32 wgmma, 3xTF32 as the fp32 forward,
`csrc/flash_bwd_tf32.cuh`, `flash_sdpa_bwd_tf32_emulated` below its
arithmetic), CUDA C++ for sm_90a,
built by nvcc into one plain-C shared library under `vexpress_torch/_build/`
at first use and called through ctypes. The same library holds the
attention-variant bench's kernels T1 and T2 (`ops/flash_variants.py`,
`ops/splash.py`): the bf16 forward of `csrc/flash_fwd_wgmma.cuh` at the
bench's tilings, with their geometry in `flash_tma.py` too.

`flash_sdpa` sends CUDA tensors to the kernels and CPU tensors to
`flash_sdpa_reference`, the same function in plain torch, which autograd
differentiates. On the card, a call whose inputs need a gradient goes through
`FlashAttention`, whose backward launches the backward kernels. There is no
fallback between kernel and plain version: a CUDA tensor that the kernels
cannot take, a failed build or a failed launch raises.

With `FLASH_LITE` on (VEXPRESS_FLASH_LITE=1 at import, as the JAX package
reads it), the shapes of `flash_lite.lite_supported` go to K2 instead: the
LITE variant of csrc/flash_fwd.cu on the card, `flash_lite_reference` on the
CPU. K2 has no backward, so it is for inference processes only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import torch

from . import flash_tma
from .flash_lite import flash_lite_reference, lite_supported
from .launches import counts, shapes

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_HEAD_DIMS = (40, 80, 160)
_ROWS = 64  # rows per block; Lq and Lk must be multiples of it
_LOGIT_BUDGET = 1 << 26  # fp32 (B, H, chunk, Lk) elements per chunk of the plain backward
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")

# K2 in place of K1 where its shapes allow (see the module docstring); tests
# and chip_smoke.py set the attribute
FLASH_LITE = os.environ.get("VEXPRESS_FLASH_LITE", "0") == "1"

_lib = None
_lib_lock = threading.Lock()


def flash_supported(lq: int, lk: int) -> bool:
    return lq % 128 == 0 and lk % 128 == 0 and lq >= 128 and lk >= 128


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the flash kernels are built from csrc/*.cu at first use")


def build() -> pathlib.Path:
    """Compile every csrc/*.cu for sm_90a (one nvcc per source, all at once)
    and link them into one library under _build/; once per content of csrc/.
    Returns the library's path."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for f in sorted(_CSRC.iterdir()):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    out = _BUILD / f"libvx_flash_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    arch = list(NVCC_FLAGS)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs = [pathlib.Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen([nvcc, *arch, "-Xcompiler", "-fPIC", "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for src, obj in zip(sources, objs)]
        errors = []
        for src, proc in zip(sources, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {src.name} failed ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        lib = pathlib.Path(tmp) / "lib.so"
        proc = subprocess.run([nvcc, *arch, "-shared", "-o", str(lib), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.vx_flash_fwd_tma.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, f, p]
            lib.vx_flash_fwd_tma.restype = i
            lib.vx_flash_fwd_tile.argtypes = [i, p]
            lib.vx_flash_fwd_tile.restype = i
            lib.vx_flash_fwd_f32_split.argtypes = [p, p, p, p, i, i, i, i, i, f, p]
            lib.vx_flash_fwd_f32_split.restype = i
            lib.vx_flash_fwd_f32.argtypes = [p, p, p, i, i, i, i, i, i, p, f, p]
            lib.vx_flash_fwd_f32.restype = i
            lib.vx_flash_fwd_f32_tile.argtypes = [i, p]
            lib.vx_flash_fwd_f32_tile.restype = i
            lib.vx_flash_bwd_f32_split.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
            lib.vx_flash_bwd_f32_split.restype = i
            lib.vx_flash_bwd_dkv_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p, f, p]
            lib.vx_flash_bwd_dkv_f32.restype = i
            lib.vx_flash_bwd_dq_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, p, f, p]
            lib.vx_flash_bwd_dq_f32.restype = i
            lib.vx_flash_bwd_f32_tile.argtypes = [i, p]
            lib.vx_flash_bwd_f32_tile.restype = i
            lib.vx_flash_bwd_dkv_tma.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p, f, p]
            lib.vx_flash_bwd_dkv_tma.restype = i
            lib.vx_flash_bwd_dq_tma.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p, f, p]
            lib.vx_flash_bwd_dq_tma.restype = i
            lib.vx_flash_bwd_tile.argtypes = [i, p]
            lib.vx_flash_bwd_tile.restype = i
            lib.vx_flash_fwd_variant.argtypes = [p, p, p, p, i, i, i, i, i, p, p, f, i, i, i, i,
                                                 p]
            lib.vx_flash_fwd_variant.restype = i
            lib.vx_flash_fwd_variant_tile.argtypes = [i, i, i, i, p]
            lib.vx_flash_fwd_variant_tile.restype = i
            lib.vx_splash_mha_fwd.argtypes = [p, p, p, p, i, i, i, i, i, p, p, i, i, i, p]
            lib.vx_splash_mha_fwd.restype = i
            lib.vx_splash_mha_tile.argtypes = [i, i, i, p]
            lib.vx_splash_mha_tile.restype = i
            lib.vx_error_string.argtypes = [i]
            lib.vx_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


# ------------------------------------------------------------ plain versions


def flash_sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                         scale: Optional[float] = None, q_chunk: Optional[int] = None,
                         return_lse: bool = False):
    """Plain torch version of the forward kernel: fp32 logits and softmax,
    queries in chunks that bound the (B, H, chunk, Lk) logits to ~2^28
    elements. With `return_lse`, also the (B, H, Lq) fp32 log-sum-exp of the
    scaled logits, as the kernel writes it under a gradient."""
    counts["flash_sdpa_reference"] += 1
    b, lq, inner = q.shape
    lk = k.shape[1]
    d = inner // heads
    if scale is None:
        scale = d**-0.5
    if q_chunk is None:
        q_chunk = max(1, (1 << 28) // max(b * heads * lk, 1))
    kf = k.reshape(b, lk, heads, d).float()
    vf = v.reshape(b, lk, heads, d).float()
    qh = q.reshape(b, lq, heads, d)
    outs, lses = [], []
    for s in range(0, lq, q_chunk):
        logits = torch.einsum("bqhd,bkhd->bhqk", qh[:, s : s + q_chunk].float(), kf) * scale
        w = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", w, vf))
        if return_lse:
            lses.append(torch.logsumexp(logits, dim=-1))
    out = torch.cat(outs, dim=1).reshape(b, lq, inner).to(q.dtype)
    if return_lse:
        return out, torch.cat(lses, dim=2)
    return out


def flash_sdpa_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, heads: int,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the backward kernels: (dq, dk, dv) of
    `flash_sdpa` from the forward's output `o` and log-sum-exp `lse`, in fp32
    chunk by chunk over queries (P = exp(scale q k^T - lse),
    dS = P (do v^T - rowsum(do o)), dq = scale dS k, dk = scale dS^T q,
    dv = P^T do), so no full (Lq, Lk) logits are kept."""
    counts["flash_sdpa_bwd_reference"] += 1
    b, lq, inner = q.shape
    lk = k.shape[1]
    d = inner // heads
    if scale is None:
        scale = d**-0.5
    q_chunk = max(1, _LOGIT_BUDGET // max(b * heads * lk, 1))
    kf = k.reshape(b, lk, heads, d).float()
    vf = v.reshape(b, lk, heads, d).float()
    qh, oh, doh = (x.reshape(b, lq, heads, d) for x in (q, o, do))
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dqs = []
    for s in range(0, lq, q_chunk):
        qc, doc = qh[:, s : s + q_chunk].float(), doh[:, s : s + q_chunk].float()
        di = (doc * oh[:, s : s + q_chunk].float()).sum(-1).transpose(1, 2)  # (b, h, c)
        p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale
                      - lse[:, :, s : s + q_chunk, None].float())
        dv += torch.einsum("bhqk,bqhd->bkhd", p, doc)
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", doc, vf) - di[..., None])
        dqs.append(torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale)
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qc) * scale
    dq = torch.cat(dqs, dim=1).reshape(b, lq, inner).to(q.dtype)
    return dq, dk.reshape(b, lk, inner).to(k.dtype), dv.reshape(b, lk, inner).to(v.dtype)


# The fp32 kernel's arithmetic (csrc/flash_fwd_tf32.cuh): each operand as two
# tf32 parts. Column 8j + i of the transposed v's parts holds key
# 8j + TF32_KEY_ORDER[i] (the kernel's perm_key).
TF32_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to tf32 as cvt.rna.tf32.f32 rounds it: half of the
    last kept place (bit 13) added to the magnitude, which rounds ties away
    from zero, then the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 x, as the fp32 kernel's split pass and its split of
    p compute them: hi = tf32(x), lo = tf32(x - hi), so hi + lo holds x to
    about 2^-22 of itself and a product is hi hi + hi lo + lo hi to fp32's
    accuracy."""
    x = x.float()
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _transposed(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, H*D) -> (B, H, D, L) with each group of 8 rows of L in
    TF32_KEY_ORDER: the transposed parts' layout before the split."""
    b, n, inner = x.shape
    d = inner // heads
    return (x.float().reshape(b, n // 8, 8, heads, d)[:, :, list(TF32_KEY_ORDER)]
            .permute(0, 3, 4, 1, 2).reshape(b, heads, d, n))


def tf32_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
               qmul: float = 1.0) -> Tuple[torch.Tensor, ...]:
    """Plain version of the fp32 forward's split pass (csrc/flash_fwd.cu:
    tf32_split, tf32_split_vt): the hi and lo parts of q * qmul (the product
    rounded to fp32; K2's scale, else 1), of k, both (B, L, H*D), and of v
    transposed to (B, H, D, Lk) with each group of 8 keys in
    TF32_KEY_ORDER: (qh, ql, kh, kl, vh, vl)."""
    qs = q.float() * torch.tensor(qmul, dtype=torch.float32, device=q.device)
    return (*split_tf32(qs), *split_tf32(k), *split_tf32(_transposed(v, heads)))


# the fp32 backward's parts, in the order the split pass writes them
# (csrc/flash_bwd.cu's Tf32BwdParts): 8 of q's size, then 6 of k's
TF32_BWD_PARTS = ("qh", "ql", "doh", "dol", "qth", "qtl", "doth", "dotl",
                  "kh", "kl", "vh", "vl", "kth", "ktl")


def tf32_bwd_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                   heads: int) -> dict:
    """Plain version of the fp32 backward's split pass (csrc/flash_bwd.cu:
    vx_flash_bwd_f32_split): the hi and lo parts of q, do, k and v in their
    own (B, L, H*D) layout, and of q, do and k transposed to (B, H, D, L)
    with each group of 8 rows in TF32_KEY_ORDER; keyed by TF32_BWD_PARTS."""
    out = {}
    for name, x in (("q", q), ("do", do), ("k", k), ("v", v)):
        out[name + "h"], out[name + "l"] = split_tf32(x)
    for name, x in (("qt", q), ("dot", do), ("kt", k)):
        out[name + "h"], out[name + "l"] = split_tf32(_transposed(x, heads))
    return {name: out[name] for name in TF32_BWD_PARTS}


def _tf32_a(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an accumulator (..., rows, R) taken as A fragments: its
    columns in TF32_KEY_ORDER within each 8-column group, as the kernel's
    registers pair them with the transposed parts' k-indices."""
    *lead, rows, n = x.shape
    perm = x.reshape(*lead, rows, n // 8, 8)[..., list(TF32_KEY_ORDER)].reshape(*lead, rows, n)
    return split_tf32(perm)


def _ss3(ah, al, bh, bl) -> torch.Tensor:
    """A B^T taken as hi hi + hi lo + lo hi (a tf32 product of two tf32
    values is exact in fp32; the sums fp32)."""
    return ah @ bh.transpose(-1, -2) + ah @ bl.transpose(-1, -2) + al @ bh.transpose(-1, -2)


def _rs3(a: torch.Tensor, bh: torch.Tensor, bl: torch.Tensor, products: int = 3) -> torch.Tensor:
    """A B over a ring tile, A an accumulator split as `_tf32_a` splits it,
    B the transposed part's (hi, lo) columns of the tile: hi hi + hi lo +
    lo hi (`products` 1: hi hi alone)."""
    ah, al = _tf32_a(a)
    if products == 1:
        return ah @ bh.transpose(-1, -2)
    return ah @ bh.transpose(-1, -2) + ah @ bl.transpose(-1, -2) + al @ bh.transpose(-1, -2)


def flash_sdpa_bwd_tf32_emulated(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 do: torch.Tensor, lse: torch.Tensor, di: torch.Tensor,
                                 heads: int, scale: Optional[float] = None,
                                 products: int = 3,
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fp32 backward kernels' arithmetic (csrc/flash_bwd_tf32.cuh) in
    plain torch: (dq, dk, dv) from the parts `tf32_bwd_parts` gives, at
    flash_tma.F32_BWD_TILES's tiling. S and dP over the head dim as hi hi +
    hi lo + lo hi of the row-major parts, summed over the cluster's column
    slices (D=160: two halves, added); P = 2^(S scale log2 e - lse log2 e),
    dS = P (dP - di) in fp32; each ring tile's dQ (dq kernel, key tiles) and
    dV, dK (dk/dv kernel, query tiles) from P, dS split as the kernel's
    registers hold them and the transposed parts, added into the sums tile
    by tile in the kernel's order; dQ divided by its rows' sums r of P, and
    dk/dv's P taken against lse + ln r. `products` 1 takes every product as one
    TF32 product (hi hi): the control the fp32 bars must reject. The tensor
    cores' truncating sums within a tile are not modelled (the card tests
    and chip_smoke.py hold the kernels themselves to the bars)."""
    from . import flash_tma

    b, lq, inner = q.shape
    lk, d = k.shape[1], inner // heads
    if scale is None:
        scale = d**-0.5
    parts = tf32_bwd_parts(q, k, v, do, heads)
    if products == 1:
        parts = {n: (x if n.endswith("h") else torch.zeros_like(x)) for n, x in parts.items()}
    t = flash_tma.f32_bwd_tile(d)
    dh = d // t["cluster"]
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * log2e
    lse2 = lse.float() * log2e  # (B, H, Lq)
    rows = {n: parts[n].reshape(b, -1, heads, d).transpose(1, 2)  # (B, H, L, D)
            for n in ("qh", "ql", "doh", "dol", "kh", "kl", "vh", "vl")}

    def sdp(q_rows, k_rows):
        """S (B, H, |q_rows|, |k_rows|) and dP over the cluster's column
        slices, each slice's 3xTF32 sum, the slices added."""
        s = dp = None
        for c in range(0, d, dh):
            cs = slice(c, c + dh)
            part_s = _ss3(*(rows[n][:, :, r, cs] for n, r in
                            (("qh", q_rows), ("ql", q_rows), ("kh", k_rows), ("kl", k_rows))))
            part_dp = _ss3(*(rows[n][:, :, r, cs] for n, r in
                             (("doh", q_rows), ("dol", q_rows), ("vh", k_rows), ("vl", k_rows))))
            s = part_s if s is None else s + part_s
            dp = part_dp if dp is None else dp + part_dp
        return s, dp

    def p_ds(s, dp, q_rows, lse2):
        p = torch.exp2(s * scale_log2 - lse2[:, :, q_rows, None])
        return p, p * (dp - di[:, :, q_rows, None].float())

    # dq: the key axis in ring tiles; the rows' sums r of P (tile sums added
    # in fp64) divide dQ, and lse + ln r goes to dk/dv
    rk = t["dq_rows"]
    dq = torch.zeros(b, heads, lq, d)
    r_sum = torch.zeros(b, heads, lq, dtype=torch.float64)
    for r in range(0, lk, rk):
        tile = slice(r, r + rk)
        s, dp = sdp(slice(None), tile)
        p, ds = p_ds(s, dp, slice(None), lse2)
        r_sum += p.sum(-1).double()
        dq = dq + _rs3(ds, parts["kth"][..., tile], parts["ktl"][..., tile], products)
    lse2 = (lse.double() + torch.log(r_sum)).float() * log2e
    # dk/dv: the query axis in ring tiles, each tile's products added in order
    rq = t["dkv_rows"]
    dk = torch.zeros(b, heads, lk, d)
    dv = torch.zeros(b, heads, lk, d)
    for r in range(0, lq, rq):
        tile = slice(r, r + rq)
        s, dp = sdp(tile, slice(None))
        p, ds = p_ds(s, dp, tile, lse2)
        dv = dv + _rs3(p.transpose(-1, -2), parts["doth"][..., tile], parts["dotl"][..., tile],
                       products)
        dk = dk + _rs3(ds.transpose(-1, -2), parts["qth"][..., tile], parts["qtl"][..., tile],
                       products)
    scale_t = torch.tensor(scale, dtype=torch.float32)
    dq = dq * (scale_t.double() / r_sum[..., None]).float()
    return tuple(x.transpose(1, 2).reshape(b, -1, inner) for x in (dq, dk * scale_t, dv))


# ------------------------------------------------------------------ kernels


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_sdpa takes (B, L, H*D) tensors, got {q.shape}, {k.shape}, {v.shape}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_sdpa shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.shape[2] % heads:
        raise ValueError(f"inner dim {q.shape[2]} is not a multiple of heads={heads}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_sdpa dtypes disagree: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_sdpa devices disagree: {q.device}, {k.device}, {v.device}")


def _check_kernel_inputs(heads: int, **tensors: torch.Tensor) -> None:
    """What the CUDA kernels take: CUDA tensors as `check_kernel_layout` says."""
    if tensors["q"].device.type != "cuda":
        raise ValueError(f"flash kernels: unsupported device {tensors['q'].device}")
    check_kernel_layout(heads, **tensors)


def check_kernel_layout(heads: int, **tensors: torch.Tensor) -> None:
    """What the CUDA kernels take on any device: bf16 or fp32, D in
    KERNEL_HEAD_DIMS, Lq and Lk multiples of 64, contiguous 16-byte aligned
    tensors of q's dtype and device."""
    q = tensors["q"]
    b, lq, inner = q.shape
    lk, d = tensors["k"].shape[1], inner // heads
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash kernels take {KERNEL_DTYPES}, got {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels take head dims {KERNEL_HEAD_DIMS}, got {d}")
    if lq % _ROWS or lk % _ROWS:
        raise ValueError(f"flash kernels need Lq, Lk multiples of {_ROWS}, got {lq}, {lk}")
    if b * heads > 65535:
        raise ValueError(f"flash kernel grid: B*H={b * heads} exceeds 65535")
    for name, t in tensors.items():
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash kernels: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernels need contiguous 16-byte aligned tensors ({name})")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"flash {what} launch failed: {_library().vx_error_string(rc).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_tiles_checked = set()
_f32_tiles_checked = set()
_bwd_tiles_checked = set()
_f32_bwd_tiles_checked = set()


def _check_tiling(lib, key, entry: str, fields, host_tile, checked: set, what: str) -> None:
    """Before the first launch at `key` (a head dim, or a tuple such as
    T1's tiling): the library's tiling (its `entry`, called with the key's
    values) must be flash_tma's (`host_tile(*key)`), from which the launch
    geometry is computed. A key with no instantiation is left to the launch
    to refuse."""
    if key in checked:
        return
    args = key if isinstance(key, tuple) else (key,)
    out = (ctypes.c_longlong * len(fields))()
    if getattr(lib, entry)(*args, out) != 0:
        return
    built, host = dict(zip(fields, out)), host_tile(*args)
    if built != host:
        raise RuntimeError(f"flash {what} at {'D=' if len(args) == 1 else ''}{key}: the library's "
                           f"tiling {built} is not ops/flash_tma.py's {host}")
    checked.add(key)


def _check_tile(lib, d: int) -> None:
    """The forward's tiling (`vx_flash_fwd_tile`) against flash_tma.tile."""
    _check_tiling(lib, d, "vx_flash_fwd_tile", flash_tma.TILE_FIELDS, flash_tma.tile,
                  _tiles_checked, "forward")


def _check_f32_tile(lib, d: int) -> None:
    """The fp32 forward's tiling (`vx_flash_fwd_f32_tile`) against flash_tma.f32_tile."""
    _check_tiling(lib, d, "vx_flash_fwd_f32_tile", flash_tma.F32_TILE_FIELDS,
                  flash_tma.f32_tile, _f32_tiles_checked, "fp32 forward")


def _check_bwd_tile(lib, d: int) -> None:
    """The backward's tiling (`vx_flash_bwd_tile`) against flash_tma.bwd_tile."""
    _check_tiling(lib, d, "vx_flash_bwd_tile", flash_tma.BWD_TILE_FIELDS, flash_tma.bwd_tile,
                  _bwd_tiles_checked, "backward")


def _check_f32_bwd_tile(lib, d: int) -> None:
    """The fp32 backward's tiling (`vx_flash_bwd_f32_tile`) against flash_tma.f32_bwd_tile."""
    _check_tiling(lib, d, "vx_flash_bwd_f32_tile", flash_tma.F32_BWD_TILE_FIELDS,
                  flash_tma.f32_bwd_tile, _f32_bwd_tiles_checked, "fp32 backward")


@functools.lru_cache(maxsize=256)
def _tma_geometry(b: int, lq: int, lk: int, heads: int, d: int):
    """flash_tma's geometry of one bf16 launch, as `vx_flash_fwd_tma` reads
    it, once per shape; raises where TMA or the kernel cannot take it."""
    geom = flash_tma.fwd_geometry(b, lq, lk, heads, d)
    bad = flash_tma.tma_violations(geom)
    if bad:
        raise ValueError("flash forward kernel cannot take this launch: " + "; ".join(bad))
    return flash_tma.geometry_arg(geom)


@functools.lru_cache(maxsize=256)
def _f32_geometry(b: int, lq: int, lk: int, heads: int, d: int):
    """flash_tma's geometry of one fp32 launch, as `vx_flash_fwd_f32` reads
    it, once per shape; raises where TMA or the kernel cannot take it."""
    geom = flash_tma.f32_geometry(b, lq, lk, heads, d)
    bad = flash_tma.tma_violations(geom)
    if bad:
        raise ValueError("flash fp32 forward kernel cannot take this launch: " + "; ".join(bad))
    return flash_tma.f32_geometry_arg(geom)


@functools.lru_cache(maxsize=256)
def _bwd_tma_geometry(b: int, lq: int, lk: int, heads: int, d: int, kernel: str):
    """flash_tma's geometry of one launch of the bf16 backward's `kernel`
    ("dkv" or "dq"), as `vx_flash_bwd_*_tma` reads it, and its parts of the
    query axis, once per shape; raises where TMA or the kernel cannot take it."""
    geom = flash_tma.bwd_geometry(b, lq, lk, heads, d, kernel)
    bad = flash_tma.tma_violations(geom)
    if bad:
        raise ValueError(f"flash backward {kernel} kernel cannot take this launch: "
                         + "; ".join(bad))
    return flash_tma.bwd_geometry_arg(geom), geom["grid"][2]


@functools.lru_cache(maxsize=256)
def _f32_bwd_geometry(b: int, lq: int, lk: int, heads: int, d: int, kernel: str):
    """flash_tma's geometry of one launch of the fp32 backward's `kernel`
    ("dkv" or "dq"), as `vx_flash_bwd_*_f32` reads it, and its parts of the
    query axis, once per shape; raises where TMA or the kernel cannot take it."""
    geom = flash_tma.f32_bwd_geometry(b, lq, lk, heads, d, kernel)
    bad = flash_tma.tma_violations(geom)
    if bad:
        raise ValueError(f"flash fp32 backward {kernel} kernel cannot take this launch: "
                         + "; ".join(bad))
    return flash_tma.f32_bwd_geometry_arg(geom), geom["grid"][2]


def _launch_fwd(q, k, v, heads: int, scale: float, with_lse: bool = False, lite: bool = False):
    """csrc/flash_fwd.cu on the current stream: K1, or K2 with `lite`; bf16
    through the TMA/wgmma kernel, fp32 through the split pass
    (`launch_f32_split`) and the 3xTF32 TMA/wgmma kernel on its parts.
    Returns (out, lse or None)."""
    _check_kernel_inputs(heads, q=q, k=k, v=v)
    b, lq, inner = q.shape
    lk, d = k.shape[1], inner // heads
    bf16 = q.dtype == torch.bfloat16
    geom = (_tma_geometry if bf16 else _f32_geometry)(b, lq, lk, heads, d)
    lib = _library()
    (_check_tile if bf16 else _check_f32_tile)(lib, d)
    out = torch.empty_like(q)
    lse = (torch.empty((b, heads, lq), dtype=torch.float32, device=q.device) if with_lse
           else None)
    lse_ptr = None if lse is None else lse.data_ptr()
    with torch.cuda.device(q.device):
        if bf16:
            rc = lib.vx_flash_fwd_tma(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      lse_ptr, int(lite), b, heads, lq, lk, d, geom,
                                      float(scale), _stream(q))
        else:
            # K2's q * scale is rounded to fp32 before the split; K1's scale
            # stays in the exponent
            parts = launch_f32_split(q, k, v, heads, float(scale) if lite else 1.0)
            rc = lib.vx_flash_fwd_f32(parts.data_ptr(), out.data_ptr(), lse_ptr, int(lite), b,
                                      heads, lq, lk, d, geom, float(scale), _stream(q))
    name = "flash_lite_fwd" if lite else "flash_fwd"
    _raise_on(rc, "K2 forward" if lite else "forward")
    counts[name] += 1
    shapes[(name, b, lq, lk, d)] += 1
    return out, lse


def launch_f32_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                     qmul: float = 1.0) -> torch.Tensor:
    """The fp32 forward's split pass (csrc/flash_fwd.cu: `tf32_split`,
    `tf32_split_vt`) on the current stream, into a scratch buffer allocated
    here: `tf32_parts`' six tensors flattened one after the other. Contiguous
    fp32 CUDA tensors as `_launch_fwd` checks them."""
    b, lq, inner = q.shape
    lk, d = k.shape[1], inner // heads
    parts = torch.empty(2 * q.numel() + 4 * k.numel(), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _library().vx_flash_fwd_f32_split(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               parts.data_ptr(), b, heads, lq, lk, d,
                                               float(qmul), _stream(q))
    _raise_on(rc, "fp32 split")
    return parts


def launch_f32_bwd_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                         heads: int, need_dkv: bool = True) -> torch.Tensor:
    """The fp32 backward's split pass (csrc/flash_bwd.cu:
    vx_flash_bwd_f32_split) on the current stream, into a scratch buffer
    allocated here: `tf32_bwd_parts`' fourteen tensors flattened one after
    the other (the transposed parts of q and do written for `need_dkv`; the
    dq kernel, which reads k's, always runs). Contiguous fp32 CUDA tensors
    as `launch_bwd` checks them."""
    b, lq, inner = q.shape
    lk, d = k.shape[1], inner // heads
    parts = torch.empty(8 * q.numel() + 6 * k.numel(), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _library().vx_flash_bwd_f32_split(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               do.data_ptr(), parts.data_ptr(), b, heads, lq, lk,
                                               d, int(need_dkv), _stream(q))
    _raise_on(rc, "fp32 backward split")
    return parts


def launch_lite(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                scale: float) -> torch.Tensor:
    """K2, the LITE variant of csrc/flash_fwd.cu, on the current stream. The
    kernel multiplies q by the scale cast to q's dtype, as the TPU kernel does."""
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    return _launch_fwd(q, k, v, heads, scale_q, lite=True)[0]


def bwd_di(do: torch.Tensor, o: torch.Tensor, heads: int) -> torch.Tensor:
    """di = rowsum(do * o) per (batch, head, query), fp32 (B, H, Lq): the
    plain reduction before the backward kernels (the TPU path leaves it to
    XLA)."""
    b, lq, inner = o.shape
    return ((do.float() * o.float()).reshape(b, lq, heads, inner // heads).sum(-1)
            .transpose(1, 2).contiguous())


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
               lse: torch.Tensor, di: torch.Tensor, heads: int, scale: float,
               need_dq: bool = True, need_dkv: bool = True):
    """csrc/flash_bwd.cu on the current stream: the dk/dv kernel when
    `need_dkv`, the dq kernel when `need_dq`; returns (dq, dk, dv) with None
    for a gradient not asked for. CUDA tensors only, at every head dim (40,
    80, 160). bf16 runs the TMA/wgmma kernels (csrc/flash_bwd_wgmma.cuh).
    fp32 runs the split pass (`launch_f32_bwd_split`) and the 3xTF32
    TMA/wgmma kernels on its parts (csrc/flash_bwd_tf32.cuh): the dq kernel
    first, also where only dk and dv are asked for, since it gives the dk/dv
    kernel the log-sum-exp of the backward's own logits (`launch_f32_dq`,
    `launch_f32_dkv`). Where the dk/dv kernel splits the query axis, its
    fp32 workspace is allocated here and `flash_bwd_dkv_sum` adds the parts,
    counted as its own launch."""
    _check_kernel_inputs(heads, q=q, k=k, v=v, do=do)
    b, lq, inner = q.shape
    lk, d = k.shape[1], inner // heads
    for name, t in (("lse", lse), ("di", di)):
        if (t.shape != (b, heads, lq) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device or t.data_ptr() % 16):
            raise ValueError(f"flash backward needs a contiguous 16-byte aligned fp32 {name} of "
                             f"shape {(b, heads, lq)} on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if q.dtype == torch.float32:
        parts = launch_f32_bwd_split(q, k, v, do, heads, need_dkv)
        lse_dkv = torch.empty_like(lse) if need_dkv else None
        dq = launch_f32_dq(parts, q, k, lse, di, heads, scale, lse_dkv)
        dk, dv = launch_f32_dkv(parts, q, k, lse_dkv, di, heads, scale) if need_dkv else (None,
                                                                                         None)
        return dq if need_dq else None, dk, dv
    geoms = {kernel: _bwd_tma_geometry(b, lq, lk, heads, d, kernel)
             for kernel, need in (("dkv", need_dkv), ("dq", need_dq)) if need}
    lib = _library()
    _check_bwd_tile(lib, d)
    dq = torch.empty_like(q) if need_dq else None
    dk = torch.empty_like(k) if need_dkv else None
    dv = torch.empty_like(v) if need_dkv else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr())
    with torch.cuda.device(q.device):
        stream = _stream(q)
        if need_dkv:
            geom, parts = geoms["dkv"]
            ws = (torch.empty((2, parts, b, lk, inner), dtype=torch.float32, device=q.device)
                  if parts > 1 else None)
            rc = lib.vx_flash_bwd_dkv_tma(*args, dk.data_ptr(), dv.data_ptr(),
                                          None if ws is None else ws.data_ptr(), b, heads, lq,
                                          lk, d, geom, float(scale), stream)
            _raise_on(rc, "backward dk/dv")
            _count_dkv(b, lq, lk, d, parts)
        if need_dq:
            rc = lib.vx_flash_bwd_dq_tma(*args, dq.data_ptr(), b, heads, lq, lk, d,
                                         geoms["dq"][0], float(scale), stream)
            _raise_on(rc, "backward dq")
            _count_dq(b, lq, lk, d)
    return dq, dk, dv


def _count_dkv(b: int, lq: int, lk: int, d: int, parts: int) -> None:
    counts["flash_bwd_dkv"] += 1
    shapes[("flash_bwd_dkv", b, lq, lk, d)] += 1
    if parts > 1:
        counts["flash_bwd_dkv_sum"] += 1


def _count_dq(b: int, lq: int, lk: int, d: int) -> None:
    counts["flash_bwd_dq"] += 1
    shapes[("flash_bwd_dq", b, lq, lk, d)] += 1


def launch_f32_dq(parts: torch.Tensor, q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                  di: torch.Tensor, heads: int, scale: float,
                  lse_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fp32 dq kernel (csrc/flash_bwd_tf32.cuh) on the split pass's
    `parts` of q's and k's shapes, with `launch_bwd`'s checks made: returns
    dq, and fills `lse_out` (or nothing, if None) with the log-sum-exp of the
    kernel's own logits, which `launch_f32_dkv` then takes."""
    b, lq, inner = q.shape
    lk, d = k.shape[1], inner // heads
    geom = _f32_bwd_geometry(b, lq, lk, heads, d, "dq")[0]
    lib = _library()
    _check_f32_bwd_tile(lib, d)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.vx_flash_bwd_dq_f32(parts.data_ptr(), lse.data_ptr(), di.data_ptr(),
                                     dq.data_ptr(), None if lse_out is None else lse_out.data_ptr(),
                                     b, heads, lq, lk, d, geom, float(scale), _stream(q))
    _raise_on(rc, "backward dq")
    _count_dq(b, lq, lk, d)
    return dq


def launch_f32_dkv(parts: torch.Tensor, q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                   di: torch.Tensor, heads: int, scale: float):
    """The fp32 dk/dv kernel (csrc/flash_bwd_tf32.cuh) on the split pass's
    `parts`, `lse` the dq kernel's corrected one; returns (dk, dv)."""
    b, lq, inner = q.shape
    lk, d = k.shape[1], inner // heads
    geom, n_parts = _f32_bwd_geometry(b, lq, lk, heads, d, "dkv")
    lib = _library()
    _check_f32_bwd_tile(lib, d)
    dk = torch.empty_like(k)
    dv = torch.empty_like(k)
    ws = (torch.empty((2, n_parts, b, lk, inner), dtype=torch.float32, device=q.device)
          if n_parts > 1 else None)
    with torch.cuda.device(q.device):
        rc = lib.vx_flash_bwd_dkv_f32(parts.data_ptr(), lse.data_ptr(), di.data_ptr(),
                                      dk.data_ptr(), dv.data_ptr(),
                                      None if ws is None else ws.data_ptr(), b, heads, lq, lk, d,
                                      geom, float(scale), _stream(q))
    _raise_on(rc, "backward dk/dv")
    _count_dkv(b, lq, lk, d, n_parts)
    return dk, dv


def flash_sdpa_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor, heads: int, scale: float,
                   need_dq: bool = True, need_dkv: bool = True):
    """(dq, dk, dv) of the attention whose forward gave `o` and `lse`; a
    gradient not asked for is None.

    CUDA tensors: `bwd_di`, then `launch_bwd` (the backward kernels, which
    check what they read). CPU tensors run `flash_sdpa_bwd_reference`."""
    if q.device.type == "cpu":
        dq, dk, dv = flash_sdpa_bwd_reference(q, k, v, o, lse, do, heads, scale)
        return (dq if need_dq else None, dk if need_dkv else None, dv if need_dkv else None)
    return launch_bwd(q, k, v, do, lse, bwd_di(do, o, heads), heads, scale, need_dq, need_dkv)


def flash_sdpa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                   scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the forward kernel with its log-sum-exp output on CUDA
    tensors, `flash_sdpa_reference(..., return_lse=True)` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_sdpa_reference(q, k, v, heads, scale, return_lse=True)
    return _launch_fwd(q, k, v, heads, scale, with_lse=True)


class FlashAttention(torch.autograd.Function):
    """K1 with a gradient: the forward saves (q, k, v, out, lse); the backward
    runs `flash_sdpa_bwd`, skipping the dk/dv kernel when neither k nor v
    needs a gradient and the dq kernel when q does not."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        out, lse = flash_sdpa_fwd(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq, dk, dv = flash_sdpa_bwd(q, k, v, out, lse, do.contiguous(), ctx.heads, ctx.scale,
                                    need_dq=need_q, need_dkv=need_k or need_v)
        return dq, dk if need_k else None, dv if need_v else None, None, None


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
               scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal multi-head attention over packed (B, L, H*D) tensors.

    CUDA tensors launch csrc/flash_fwd.cu on the current stream (bf16 or fp32,
    D in {40, 80, 160}, Lq and Lk multiples of 64, contiguous); when grad mode
    is on and an input requires a gradient, through `FlashAttention`, whose
    backward launches csrc/flash_bwd.cu. Anything else on the card raises. CPU
    tensors run `flash_sdpa_reference`.

    With `FLASH_LITE` on, shapes that `lite_supported` takes go to K2
    (`launch_lite` on the card, `flash_lite_reference` on the CPU); K2 has no
    backward, so an input that requires a gradient raises."""
    _check(q, k, v, heads)
    d = q.shape[2] // heads
    if scale is None:
        scale = d**-0.5
    if FLASH_LITE and lite_supported(q.shape[1], k.shape[1], d):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            raise ValueError("VEXPRESS_FLASH_LITE is on and an attention input requires a "
                             "gradient: K2 has no backward (turn VEXPRESS_FLASH_LITE off "
                             "for training)")
        if q.device.type == "cpu":
            return flash_lite_reference(q, k, v, heads, scale)
        return launch_lite(q, k, v, heads, scale)
    if q.device.type == "cpu":
        return flash_sdpa_reference(q, k, v, heads, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, heads, scale)
    return _launch_fwd(q, k, v, heads, scale)[0]
