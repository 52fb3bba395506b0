"""T1 (csrc/flash_variants.cu) and T2 (csrc/splash_fwd.cu) against their plain
versions on the card, at every instantiation, at a small shape; the wrappers
refuse what the kernels do not take. Marked `cuda`: without a CUDA device every
test skips. On a machine with an H100:

    python -m pytest tests/test_torch_attn_variants_cuda.py -q -m cuda --noconftest
"""

import pytest
import torch

from chip_smoke import within_variant_bar
from vexpress_torch.ops import flash_variants, launches, splash

pytestmark = pytest.mark.cuda

B, H, L, D = 2, 4, 512, 40  # B*H divisible by 4, L by 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, H, L, D, generator=g, device=dev).to(dtype) for _ in range(3)]


def _within_bar(out, plain):
    plain = plain.float()
    err = (out.float() - plain).abs()
    ok, tol = within_variant_bar(float(err.max()), float(err.mean()), float(plain.std()),
                                 float(plain.abs().max()))
    return ok and bool(torch.isfinite(out).all()), (float(err.max()), float(err.mean()), tol)


def _assert_matches(out, plain):
    ok, why = _within_bar(out, plain)
    assert ok, why


@pytest.mark.parametrize("tiling", sorted(flash_variants.TILINGS))
def test_t1_matches_plain(dev, tiling):
    bq, bk, dp, hb = tiling
    q, k, v = _qkv(dev)
    launches.reset()
    out = flash_variants.flash_fwd_variant(q, k, v, D**-0.5, block_q=bq, block_k=bk,
                                           heads_per_block=hb, d_target=dp)
    torch.cuda.synchronize()
    assert dict(launches.counts) == {"flash_fwd_variant": 1}
    assert dict(launches.shapes) == {("flash_fwd_variant", B, H, L, L, D) + tiling: 1}
    _assert_matches(out, flash_variants.flash_fwd_variant_reference(q, k, v, D**-0.5,
                                                                    block_k=bk))


@pytest.mark.parametrize("tiling", sorted(splash.TILINGS))
def test_t2_matches_plain(dev, tiling):
    bq, bkv, dp = tiling
    q, k, v = _qkv(dev, seed=1)
    qs = q * torch.tensor(D**-0.5, dtype=q.dtype, device=dev)
    launches.reset()
    out = splash.splash_mha_fwd(qs, k, v, block_q=bq, block_kv=bkv, d_target=dp)
    torch.cuda.synchronize()
    assert dict(launches.counts) == {"splash_fwd": 1}
    assert dict(launches.shapes) == {("splash_fwd", B, H, L, L, D) + tiling: 1}
    _assert_matches(out, splash.splash_mha_reference(qs, k, v, block_kv=bkv))


def test_bar_tells_rounded_p_from_fp32_p(dev):
    """Each kernel against the other's plain version on the same pre-scaled
    q fails the bar: T1 rounds p to bf16 for P V, T2 keeps it fp32."""
    q, k, v = _qkv(dev, seed=2)
    qs = q * torch.tensor(D**-0.5, dtype=q.dtype, device=dev)
    t1 = flash_variants.flash_fwd_variant(qs, k, v, 1.0)
    t2 = splash.splash_mha_fwd(qs, k, v)
    t1_plain = flash_variants.flash_fwd_variant_reference(qs, k, v, 1.0)
    t2_plain = splash.splash_mha_reference(qs, k, v)
    _assert_matches(t1, t1_plain)
    _assert_matches(t2, t2_plain)
    assert not _within_bar(t1, t2_plain)[0]
    assert not _within_bar(t2, t1_plain)[0]


def test_t1_rejects_what_it_does_not_take(dev):
    q, k, v = _qkv(dev)
    launches.reset()
    with pytest.raises(ValueError, match="bfloat16"):
        flash_variants.flash_fwd_variant(*(t.float() for t in (q, k, v)), D**-0.5)
    with pytest.raises(ValueError, match="no instantiation"):
        flash_variants.flash_fwd_variant(q, k, v, D**-0.5, block_q=256)
    with pytest.raises(ValueError, match="head dim 40"):
        flash_variants.flash_fwd_variant(*(torch.nn.functional.pad(t, (0, 8)) for t in (q, k, v)),
                                         D**-0.5)
    assert not launches.counts


def test_t2_rejects_what_it_does_not_take(dev):
    q, k, v = _qkv(dev)
    launches.reset()
    with pytest.raises(ValueError, match="bfloat16"):
        splash.splash_mha_fwd(*(t.half() for t in (q, k, v)))
    with pytest.raises(ValueError, match="no instantiation"):
        splash.splash_mha_fwd(q, k, v, block_q=128, block_kv=64)
    assert not launches.counts


def test_kernel_refusal_surfaces_without_fallback(dev, monkeypatch):
    """A tiling the wrapper lets through but the library has no
    instantiation for: the launch error surfaces and no plain version runs."""
    q, k, v = _qkv(dev)
    monkeypatch.setattr(flash_variants, "TILINGS", flash_variants.TILINGS | {(128, 128, 48, 1)})
    monkeypatch.setattr(splash, "TILINGS", splash.TILINGS | {(64, 128, 48)})
    launches.reset()
    with pytest.raises(RuntimeError, match="T1 variant forward launch failed"):
        flash_variants.flash_fwd_variant(q, k, v, D**-0.5, block_q=128, block_k=128)
    with pytest.raises(RuntimeError, match="T2 splash forward launch failed"):
        splash.splash_mha_fwd(q, k, v, block_q=64, block_kv=128)
    assert not launches.counts
