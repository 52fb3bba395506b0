"""The arithmetic of K1's and K2's fp32 forward (csrc/flash_fwd_tf32.cuh,
"3xTF32") on the CPU: the tf32 split (ops/flash.py::split_tf32, which the
kernel's split pass and its split of p mirror; tf32_parts, the split pass's
plain version) and attention computed from split products against the fp32
plain versions under chip_smoke.py's unchanged fp32 bars. A single TF32
product is the control: it must fail the mean bar, which shows that the bar
tells the two apart.

Emulation: a tf32 value has 11 significant bits, so a product of two is
exact in fp32 and each split product is an fp32 matrix product of tf32-valued
operands, summed as the fp32 matmul sums them (rounded to nearest). The
tensor cores round their fp32 sums toward zero; the kernel keeps that chain
one key tile long (csrc/flash_fwd_tf32.cuh), which this emulation does not
model: the card tests and chip_smoke.py hold the kernel itself to the bars.
Inputs from a numpy seed.
"""

import numpy as np
import pytest
import torch

from chip_smoke import K2_EXACT_BAR, LSE_BAR, within_k1_bar
from vexpress_torch.ops import flash
from vexpress_torch.ops.flash_lite import flash_lite_reference

HEAD_DIMS = (40, 80, 160)
L = 1024  # Lq = Lk


def _qkv(d, heads=2, seed=0):
    rng = np.random.default_rng(seed + d)
    return [torch.from_numpy(rng.standard_normal((1, L, heads * d), dtype=np.float32))
            for _ in range(3)]


def _heads(x, heads):
    """(B, L, H*D) -> (B, H, L, D)"""
    b, n, inner = x.shape
    return x.reshape(b, n, heads, inner // heads).transpose(1, 2)


def _product(a, b, terms):
    """a @ b as the kernel takes it: terms 3 (hi hi + hi lo + lo hi), 2
    (a b_hi + a b_lo, a exact in tf32: K2's bf16-valued p) or 1 (hi hi: a
    single TF32 product)."""
    ah, al = flash.split_tf32(a)
    bh, bl = flash.split_tf32(b)
    if terms == 1:
        return ah @ bh
    if terms == 2:
        assert torch.equal(ah, a)  # a is exact in tf32 (K2's bf16-valued p)
        return a @ bh + a @ bl
    return ah @ bh + ah @ bl + al @ bh


def _k1_emulated(q, k, v, heads, terms):
    """K1's output and natural-log LSE with S = Q K^T and P V each taken as
    `terms` split products (one softmax over all keys: the online softmax's
    fp32 rescaling is the plain version's too)."""
    d = q.shape[-1] // heads
    scale = d**-0.5
    qh, kh, vh = (_heads(x, heads) for x in (q, k, v))
    s = _product(qh, kh.transpose(-1, -2), terms)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2((s - m) * (scale * 1.4426950408889634))
    l = p.sum(-1, keepdim=True)
    out = _product(p, vh, terms) / l
    lse = (m * scale).squeeze(-1) + torch.log(l.squeeze(-1))
    return out.transpose(1, 2).reshape(q.shape), lse


def _bar(out, ref):
    err = (out - ref).abs()
    return within_k1_bar(False, float(err.max()), float(err.mean()), float(ref.std()))


def test_split_rebuilds_x():
    """hi and lo are tf32 values (low 13 bits zero), hi is x rounded to
    nearest with ties away from zero, and hi + lo is x to 2^-21 of itself,
    over magnitudes from 2^-60 to 2^60."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(100_000) * 2.0 ** rng.integers(-60, 60, 100_000))
                         .astype(np.float32))
    hi, lo = flash.split_tf32(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    x64, hi64 = x.double(), hi.double()
    ulp = 2.0 ** (torch.floor(torch.log2(x64.abs())) - 10)  # of a tf32 value near |x|
    assert bool(((x64 - hi64).abs() <= ulp / 2).all())
    assert float(((hi64 + lo.double() - x64).abs() / x64.abs()).max()) <= 2.0**-21


def test_split_rounds_ties_away_from_zero():
    one, half_ulp = 1.0, 2.0**-11  # 1 + 2^-11 lies halfway between 1 and 1 + 2^-10
    x = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp / 2, 0.0],
                     dtype=torch.float32)
    hi, lo = flash.split_tf32(x)
    assert hi.tolist() == [one + 2 * half_ulp, -(one + 2 * half_ulp), one, 0.0]
    assert lo.tolist() == [-half_ulp, half_ulp, half_ulp / 2, 0.0]


@pytest.mark.parametrize("qmul", [1.0, 40**-0.5])
def test_split_pass_layout(qmul):
    """tf32_parts: q * qmul (rounded to fp32) and k split in their own
    layout; v transposed to (B, H, D, Lk) with column 8j + i holding key
    8j + TF32_KEY_ORDER[i]; every part's sum rebuilds its tensor."""
    b, heads, lq, lk, d = 2, 3, 64, 128, 40
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads * d), dtype=np.float32))
               for n in (lq, lk, lk))
    qh, ql, kh, kl, vh, vl = flash.tf32_parts(q, k, v, heads, qmul)
    assert qh.shape == q.shape and kh.shape == k.shape and vh.shape == (b, heads, d, lk)
    qs = q * torch.tensor(qmul, dtype=torch.float32)
    assert torch.equal(torch.stack(flash.split_tf32(qs)), torch.stack([qh, ql]))
    assert torch.equal(torch.stack(flash.split_tf32(k)), torch.stack([kh, kl]))
    vt = _heads(v, heads).transpose(-1, -2)  # (B, H, D, Lk), keys in order
    for j in range(lk // 8):
        for i, key in enumerate(flash.TF32_KEY_ORDER):
            col = vt[..., 8 * j + key]
            assert torch.equal(vh[..., 8 * j + i], flash.split_tf32(col)[0])
            assert torch.equal(vl[..., 8 * j + i], flash.split_tf32(col)[1])
    assert sorted(flash.TF32_KEY_ORDER) == list(range(8))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_3xtf32_attention_within_fp32_bars(d):
    """3xTF32 products in S and P V: K1's fp32 bar and the LSE bar against
    flash_sdpa_reference."""
    q, k, v = _qkv(d)
    ref, ref_lse = flash.flash_sdpa_reference(q, k, v, 2, return_lse=True)
    out, lse = _k1_emulated(q, k, v, 2, terms=3)
    ok, tol = _bar(out, ref)
    assert ok, tol
    assert float((lse - ref_lse).abs().max()) <= LSE_BAR


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_single_tf32_product_fails_the_mean_bar(d):
    """The control: one TF32 product (10 mantissa bits) in S and P V misses
    the fp32 mean bar, so the bar tells 3xTF32 from TF32."""
    q, k, v = _qkv(d)
    ref = flash.flash_sdpa_reference(q, k, v, 2)
    out, _ = _k1_emulated(q, k, v, 2, terms=1)
    err = (out - ref).abs()
    ok, tol = _bar(out, ref)
    assert not ok
    assert float(err.mean()) > 5 * 1e-5 * float(ref.std()), tol  # misses by more than 5x


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k2_two_term_pv_within_fp32_bars(d):
    """K2's p is bf16-valued, exact in tf32: P V_hi + P V_lo is P V to fp32's
    accuracy (K1's fp32 bar against the fp32 product on the same p)."""
    q, k, v = _qkv(d)
    scale = torch.tensor(d**-0.5, dtype=torch.float32)
    s = _heads(q * scale, 2) @ _heads(k, 2).transpose(-1, -2)
    p = torch.exp((s - s.amax(-1, keepdim=True)).to(torch.bfloat16).float())
    p = p.to(torch.bfloat16).float()
    l = p.sum(-1, keepdim=True)
    vh = _heads(v, 2)
    ok, tol = _bar(_product(p, vh, 2) / l, (p.double() @ vh.double() / l.double()).float())
    assert ok, tol


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k2_emulated_within_k2_bars(d):
    """K2 as the fp32 kernel computes it (q * scale split, S in three
    products, p = bf16(exp(bf16(s - m))), P V in two) over one key block:
    within chip_smoke.k2_row's bars against flash_lite_reference over the
    same block (K1's bf16 bar) and against exact attention (K2_EXACT_BAR)."""
    q, k, v = _qkv(d)
    scale = torch.tensor(d**-0.5, dtype=torch.float32)
    s = _product(_heads(q * scale, 2), _heads(k, 2).transpose(-1, -2), 3)
    p = torch.exp((s - s.amax(-1, keepdim=True)).to(torch.bfloat16).float())
    p = p.to(torch.bfloat16).float()
    out = (_product(p, _heads(v, 2), 2) / p.sum(-1, keepdim=True)).transpose(1, 2)
    out = out.reshape(q.shape)
    plain = flash_lite_reference(q, k, v, 2, float(scale), block_k=L)
    err = (out - plain).abs()
    ok, tol = within_k1_bar(True, float(err.max()), float(err.mean()), float(plain.std()))
    assert ok, tol
    exact = flash.flash_sdpa_reference(q, k, v, 2)
    assert float((out - exact).abs().max()) < K2_EXACT_BAR
